"""ctypes loader for the native host runtime (_native/host.cpp).

Build-on-first-use: compiles the C++ translation unit with the system
toolchain into a content-hashed cache directory (no install step, no
pybind11 dependency).  Every entry point has a NumPy fallback, so the
framework works — just slower on the host stage — without a compiler.

Set ``ALAC_NO_NATIVE=1`` to force the NumPy fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading

import numpy as np

_SRC = pathlib.Path(__file__).parent / "_native" / "host.cpp"
#: Build cache: ALAC_NATIVE_CACHE, else ``.native_cache`` in the checkout
#: (listed in .gitignore); the library is keyed by a hash of its source.
_CACHE = pathlib.Path(
    os.environ.get("ALAC_NATIVE_CACHE")
    or pathlib.Path(__file__).resolve().parent.parent / ".native_cache"
)
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False

_I64P = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_I32P = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_U32P = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
_U8P = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_U16P = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
_I8P = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")


#: -fwrapv: the encoder core relies on wrapping int32 arithmetic (the
#: C#/i32 semantics the whole codec is specified in); without it signed
#: overflow in the FIR products is UB under -O3.
_BASE_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-fwrapv"]


def _build() -> pathlib.Path | None:
    src = _SRC.read_bytes() + " ".join(_BASE_FLAGS).encode()
    tagged = hashlib.sha256(src).hexdigest()[:16]
    out = _CACHE / f"libalachost-{tagged}.so"
    if out.exists():
        return out
    _CACHE.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    # -march=native: build-on-first-use targets the running host, so
    # the full local ISA is safe (FMA/AVX roughly halves the autocorr
    # and pack loops); fall back for compilers/targets without it.
    # Integer results are ISA-independent (-fwrapv semantics) and the
    # one FP routine fixes its summation order manually.
    for flags in (
        ["-march=native", "-fopenmp"], ["-fopenmp"],
        ["-march=native"], [],
    ):
        cmd = [
            "g++", *_BASE_FLAGS, *flags,
            str(_SRC), "-o", str(tmp),
        ]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            tmp.replace(out)
            return out
        except (subprocess.SubprocessError, OSError, FileNotFoundError):
            continue
    return None


def get_lib() -> ctypes.CDLL | None:
    """The loaded native library, or None (fallback mode)."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        from .config import DEFAULT

        if os.environ.get("ALAC_NO_NATIVE") or not DEFAULT.native:
            return None
        try:
            path = _build()
            if path is None:
                return None
            lib = ctypes.CDLL(str(path))
            lib.alac_native_abi_version.restype = ctypes.c_int32
            if lib.alac_native_abi_version() != 5:
                return None
            lib.alac_pack_frames.argtypes = [
                _U8P, ctypes.c_int64, _I64P, _I64P,
                ctypes.c_int64, ctypes.c_int64, _U32P,
            ]
            lib.alac_pack_frames.restype = None
            lib.alac_parse_headers.argtypes = (
                [_U8P, ctypes.c_int64, _I64P, _I64P, ctypes.c_int64]
                + [_I32P] * 5
                + [_U8P, _U8P] + [_I32P] * 15
            )
            lib.alac_parse_headers.restype = ctypes.c_int64
            lib.alac_pack_bits.argtypes = [
                _U32P, _U8P, ctypes.c_int64, _U8P, ctypes.c_int64,
            ]
            lib.alac_pack_bits.restype = ctypes.c_int64
            lib.alac_rice_encode.argtypes = [
                _I32P, ctypes.c_int64,
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32, ctypes.c_int32,
                _U8P, ctypes.c_int64,
            ]
            lib.alac_rice_encode.restype = ctypes.c_int64
            lib.alac_predictor_errors.argtypes = [
                _I32P, ctypes.c_int64, _I32P,
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, _I32P,
            ]
            lib.alac_predictor_errors.restype = None
            lib.alac_pack_symbol_frames.argtypes = [
                _U32P, _U8P, _I64P,
                _U16P, _U32P, _I8P,
                _I32P, _U8P, ctypes.c_int64, ctypes.c_int64,
                _U8P, ctypes.c_int64, _I64P,
            ]
            lib.alac_pack_symbol_frames.restype = None
            lib.alac_pack_chunk_frames.argtypes = [
                _U32P, _U8P, _I64P,
                _U32P, _U8P,
                _U32P, _U32P, _U32P, _I8P,
                _I32P, _U8P, ctypes.c_int64, ctypes.c_int64,
                _U8P, ctypes.c_int64, _I64P,
            ]
            lib.alac_pack_chunk_frames.restype = None
            lib.alac_pack_pair_frames.argtypes = [
                _U32P, _U8P, _I64P,
                _U32P, _U8P,
                _U32P, _U32P, _U32P, _I8P,
                _I32P, _U8P,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                _U8P, ctypes.c_int64, _I64P,
            ]
            lib.alac_pack_pair_frames.restype = None
            lib.alac_pack_pair_frames4.argtypes = (
                lib.alac_pack_pair_frames.argtypes
            )
            lib.alac_pack_pair_frames4.restype = None
            lib.alac_pack_pair_frames8.argtypes = (
                lib.alac_pack_pair_frames.argtypes
            )
            lib.alac_pack_pair_frames8.restype = None
            lib.alac_pack_simd_width.argtypes = []
            lib.alac_pack_simd_width.restype = ctypes.c_int64
            lib.alac_decorr_window.argtypes = [
                _I32P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                _U8P, ctypes.c_int32, _I32P,
            ]
            lib.alac_decorr_window.restype = None
            lib.alac_autocorr.argtypes = [
                _I32P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
                np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            ]
            lib.alac_autocorr.restype = None
            _lib = lib
        except OSError:
            _lib = None
        return _lib


def available() -> bool:
    return get_lib() is not None


def pack_frames_native(
    blob: np.ndarray, offsets: np.ndarray, sizes: np.ndarray, nwords: int
) -> np.ndarray | None:
    """Ragged frames -> (B, nwords) big-endian-packed uint32, or None."""
    lib = get_lib()
    if lib is None:
        return None
    B = len(offsets)
    words = np.empty((B, nwords), dtype=np.uint32)
    lib.alac_pack_frames(
        np.ascontiguousarray(blob, np.uint8),
        np.int64(blob.size),
        np.ascontiguousarray(offsets, np.int64),
        np.ascontiguousarray(sizes, np.int64),
        np.int64(B),
        np.int64(nwords),
        words,
    )
    return words


def parse_headers_native(
    blob: np.ndarray,
    offsets: np.ndarray,
    sizes: np.ndarray,
    sample_size: np.ndarray,
    kmod: np.ndarray,
    init_history: np.ndarray,
    hist_mult4: np.ndarray,
    max_samples: np.ndarray,
):
    """Parse all headers in C++. Returns a dict of arrays + status, or None."""
    lib = get_lib()
    if lib is None:
        return None
    B = len(offsets)
    i32 = lambda shape: np.zeros(shape, np.int32)  # noqa: E731
    out = dict(
        is_stereo=np.zeros(B, np.uint8),
        is_compressed=np.zeros(B, np.uint8),
        n_samples=i32(B), ub=i32(B), rss=i32(B),
        interlacing_shift=i32(B), interlacing_leftweight=i32(B),
        payload_pos=i32(B), entropy_pos=i32(B),
        order=i32((B, 2)), quant=i32((B, 2)), rice_mult=i32((B, 2)),
        rc=i32((B, 2, 32)),
        kmod=i32(B), init_history=i32(B), kmask=i32(B),
        status=i32(B),
    )
    rcflat = out["rc"].reshape(-1)
    ret = lib.alac_parse_headers(
        np.ascontiguousarray(blob, np.uint8),
        np.int64(blob.size),
        np.ascontiguousarray(offsets, np.int64),
        np.ascontiguousarray(sizes, np.int64),
        np.int64(B),
        np.ascontiguousarray(sample_size, np.int32),
        np.ascontiguousarray(kmod, np.int32),
        np.ascontiguousarray(init_history, np.int32),
        np.ascontiguousarray(hist_mult4, np.int32),
        np.ascontiguousarray(max_samples, np.int32),
        out["is_stereo"], out["is_compressed"], out["n_samples"],
        out["ub"], out["rss"],
        out["interlacing_shift"], out["interlacing_leftweight"],
        out["payload_pos"], out["entropy_pos"],
        out["order"].reshape(-1), out["quant"].reshape(-1),
        out["rice_mult"].reshape(-1), rcflat,
        out["kmod"], out["init_history"], out["kmask"],
        out["status"],
    )
    out["first_bad"] = int(ret) - 1 if ret else -1
    return out


# -- encoder-side wrappers ----------------------------------------------


def pack_bits_native(vals, widths, out, bitpos: int) -> int | None:
    lib = get_lib()
    if lib is None:
        return None
    return int(
        lib.alac_pack_bits(
            np.ascontiguousarray(vals, np.uint32),
            np.ascontiguousarray(widths, np.uint8),
            np.int64(len(vals)),
            out,
            np.int64(bitpos),
        )
    )


def rice_encode_native(
    vals, rss, init_hist, kmod, mult, kmask, out, bitpos: int
) -> int | None:
    lib = get_lib()
    if lib is None:
        return None
    return int(
        lib.alac_rice_encode(
            np.ascontiguousarray(vals, np.int32),
            np.int64(len(vals)),
            np.int32(rss), np.int32(init_hist), np.int32(kmod),
            np.int32(mult), np.int32(kmask),
            out,
            np.int64(bitpos),
        )
    )


def predictor_errors_native(sig, coefs, order, quant, rss):
    """Returns errs (n,) int32 and mutates coefs in place, or None."""
    lib = get_lib()
    if lib is None:
        return None
    sig = np.ascontiguousarray(sig, np.int32)
    errs = np.empty_like(sig)
    lib.alac_predictor_errors(
        sig, np.int64(len(sig)), coefs,
        np.int32(order), np.int32(quant), np.int32(rss), errs,
    )
    return errs


#: Shape-keyed row-buffer recycler for the frame packers (opt-in via
#: reuse=True).  A fresh np.empty((F, out_stride)) per chunk mmaps
#: ~6-13 MB whose pages fault on first write INSIDE the timed pack, a
#: large share of the pack stage for the AVX-512 packer.  Contract: rows returned
#: from a reuse=True call are invalidated by the NEXT reuse=True call
#: with the same shape on the same thread — the production callers
#: (codec/encoder_tpu._pack_host*) consume rows into payload bytes
#: before returning, so nothing retains them.  Thread-local, so the
#: encode pipeline's pack worker and any caller thread never alias.
_row_cache = threading.local()


def _rows_for(F: int, out_stride: int, reuse: bool):
    if not reuse:
        return np.empty((F, out_stride), np.uint8), np.zeros(F, np.int64)
    cache = getattr(_row_cache, "bufs", None)
    if cache is None:
        cache = _row_cache.bufs = {}
    key = (F, out_stride)
    hit = cache.get(key)
    if hit is None:
        # Bound the cache: distinct chunk shapes are few (one per
        # (chunk_frames, stride) pair), but a pathological caller mix
        # must not pin unbounded memory.
        if len(cache) >= 8:
            cache.clear()
        hit = cache[key] = (
            np.empty((F, out_stride), np.uint8), np.zeros(F, np.int64),
        )
    hit[1][:] = 0
    return hit


def pack_symbol_frames_native(
    hv, hw, h_off, v16, v32, wid, n, stereo, out_stride: int
):
    """Assemble coded frames from device-encoder symbol planes, or None.

    Returns (out (F, out_stride) uint8, end_bits (F,) int64).
    """
    lib = get_lib()
    if lib is None:
        return None
    F = len(n)
    # FastBitWriter stores every byte below each frame's end position
    # exactly once, so the rows need no pre-zeroing.
    out = np.empty((F, out_stride), np.uint8)
    end_bits = np.zeros(F, np.int64)
    lib.alac_pack_symbol_frames(
        np.ascontiguousarray(hv, np.uint32),
        np.ascontiguousarray(hw, np.uint8),
        np.ascontiguousarray(h_off, np.int64),
        np.ascontiguousarray(v16, np.uint16),
        np.ascontiguousarray(v32, np.uint32),
        np.ascontiguousarray(wid, np.int8),
        np.ascontiguousarray(n, np.int32),
        np.ascontiguousarray(stereo, np.uint8),
        np.int64(F),
        np.int64(v16.shape[1]),
        out,
        np.int64(out_stride),
        end_bits,
    )
    return out, end_bits


def pack_chunk_frames_native(
    hv, hw, h_off, extra, extra_w, c0, c1, c2, ws, n, stereo,
    out_stride: int, reuse: bool = False,
):
    """Assemble coded frames from device-merged 96-bit chunk planes, or
    None when the native tier is unavailable.

    ``extra``: optional (F, S) uint32 extra-bits plane (interleaved
    channel fields per sample); ``extra_w``: (F,) uint8 per-frame field
    width in bits (0 = frame has no extra section).  Returns
    (out (F, out_stride) uint8, end_bits (F,) int64); with
    ``reuse=True`` the rows come from the thread-local recycler (see
    ``_rows_for``) and are invalidated by the next same-shape call.
    """
    lib = get_lib()
    if lib is None:
        return None
    F = len(n)
    # FastBitWriter stores every byte below each frame's end position
    # exactly once, so the rows need no pre-zeroing.
    out, end_bits = _rows_for(F, out_stride, reuse)
    if extra is None:
        extra = np.zeros(1, np.uint32)
        extra_w = np.zeros(F, np.uint8)
    lib.alac_pack_chunk_frames(
        np.ascontiguousarray(hv, np.uint32),
        np.ascontiguousarray(hw, np.uint8),
        np.ascontiguousarray(h_off, np.int64),
        np.ascontiguousarray(extra, np.uint32),
        np.ascontiguousarray(extra_w, np.uint8),
        np.ascontiguousarray(c0, np.uint32),
        np.ascontiguousarray(c1, np.uint32),
        np.ascontiguousarray(c2, np.uint32),
        np.ascontiguousarray(ws, np.int8),
        np.ascontiguousarray(n, np.int32),
        np.ascontiguousarray(stereo, np.uint8),
        np.int64(F),
        np.int64(c0.shape[1]),
        out,
        np.int64(out_stride),
        end_bits,
    )
    return out, end_bits


def pack_pair_frames_native(
    hv, hw, h_off, extra, extra_w, ph, pm, pl, pws, n, stereo,
    num_samples: int, out_stride: int, reuse: bool = False,
):
    """Assemble coded frames from device-merged PAIR planes
    (ops/encode.merge_pair_chunks: one <=96-bit field per two samples),
    or None when the native tier is unavailable.

    Precondition: every pws value is in [-1, 96].  A pws of -1 is a
    LEGAL no-op — the field is skipped and contributes zero bits; the
    quad path (codec/encoder_tpu, ALAC_ENC_QUAD) depends on this: it
    intentionally passes planes where quad-fat frames' lanes carry -1
    widths (those rows come out garbage and are repacked from pair
    rows, _repack_fat_frames).  Values in (96, 127] are what the
    caller must never pass:
    batches whose ``fat`` flag is set (a pair that does not fit 96
    bits) must route to the classic chunk path instead.
    ``num_samples`` is the per-frame sample capacity S (the extra-bits
    plane stays per-sample, (F, S)); the pair planes are (2F, ceil(S/2)).
    Returns (out (F, out_stride) uint8, end_bits (F,) int64).
    """
    lib = get_lib()
    if lib is None:
        return None
    F = len(n)
    out, end_bits = _rows_for(F, out_stride, reuse)
    if extra is None:
        extra = np.zeros(1, np.uint32)
        extra_w = np.zeros(F, np.uint8)
    # ALAC_ENC_PAIR_ILV selects the writer interleave (byte-identical
    # output on every input — groups that can't lockstep fall back to
    # frame-at-a-time inside each kernel):
    #   2 — two scalar writers (the r3 default),
    #   4 — four scalar writers (recorded loss, DESIGN.md §7e),
    #   8 — the AVX-512 eight-lane SIMD writer (r5; on binaries built
    #       without AVX-512 F+BW+VBMI2 it delegates to 2, so "8" is
    #       always safe to request),
    #   auto (default) — 8 when this binary carries the SIMD packer
    #       (alac_pack_simd_width() == 8; about 2x the two-writer
    #       kernel on warm rows of music-width planes), else 2.
    ilv = os.environ.get("ALAC_ENC_PAIR_ILV", "auto")
    if ilv == "auto":
        ilv = "8" if lib.alac_pack_simd_width() == 8 else "2"
    fn = {
        "4": lib.alac_pack_pair_frames4,
        "8": lib.alac_pack_pair_frames8,
    }.get(ilv, lib.alac_pack_pair_frames)
    fn(
        np.ascontiguousarray(hv, np.uint32),
        np.ascontiguousarray(hw, np.uint8),
        np.ascontiguousarray(h_off, np.int64),
        np.ascontiguousarray(extra, np.uint32),
        np.ascontiguousarray(extra_w, np.uint8),
        np.ascontiguousarray(ph, np.uint32),
        np.ascontiguousarray(pm, np.uint32),
        np.ascontiguousarray(pl, np.uint32),
        np.ascontiguousarray(pws, np.int8),
        np.ascontiguousarray(n, np.int32),
        np.ascontiguousarray(stereo, np.uint8),
        np.int64(F),
        np.int64(num_samples),
        np.int64(ph.shape[1]),
        out,
        np.int64(out_stride),
        end_bits,
    )
    return out, end_bits


def decorr_window_native(
    pcm_i32: np.ndarray, w: int, ub8: int, lw: int, sh: int,
    stereo_f: np.ndarray, wide: bool,
) -> np.ndarray | None:
    """Fused Levinson-window decorrelation: (F, S, 2) int32 PCM ->
    (2F, w) int32 signal lanes [A of all frames, B of all frames], or
    None when the native tier is unavailable.

    One read of the PCM window + one write of the signal matrix vs the
    NumPy fallback's ~6 passes (codec/encoder_tpu._prep); arithmetic is
    performed in the same work dtype NumPy uses (int64 when ``wide``,
    wrapping int32 otherwise), so the outputs are bit-identical.
    """
    lib = get_lib()
    if lib is None:
        return None
    pcm_i32 = np.ascontiguousarray(pcm_i32, np.int32)
    F, S, _ = pcm_i32.shape
    sig = np.empty((2 * F, w), np.int32)
    lib.alac_decorr_window(
        pcm_i32, np.int64(F), np.int64(S), np.int64(w),
        np.int32(ub8), np.int32(lw), np.int32(sh),
        np.ascontiguousarray(stereo_f, np.uint8), np.int32(bool(wide)),
        sig,
    )
    return sig


def autocorr_native(x, order: int):
    """(order+1, B) float64 lag autocorrelation of (B, S) int32 lanes,
    or None when the native tier is unavailable.

    Single pass per lane over an L1-resident double buffer vs the
    NumPy fallback's order+1 full-batch einsum sweeps
    (codec/encoder.levinson_coefs_batch); summation order differs, which
    only perturbs coefficient rounding — both sides of the host/device
    byte-identity contract choose coefficients through the same path.
    """
    lib = get_lib()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, np.int32)
    B, S = x.shape
    r = np.empty((order + 1, B), np.float64)
    lib.alac_autocorr(x, np.int64(B), np.int64(S), np.int32(order), r)
    return r
