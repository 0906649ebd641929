"""Batch ALAC encoding with the sequential stages on the accelerator.

Splits encoding the way the decoder's pipeline splits decoding
(SURVEY.md §2.5 "PP", mirrored):

  host   — batch prep: batched Levinson coefficients over a window-
           sized decorrelation (one einsum over the lane batch,
           codec/encoder.levinson_coefs_batch), the extra-bits
           side-channel plane, vectorized header/coef bit fields;
  device — extra-bits strip + stereo decorrelation + channel fold
           (elementwise; XLA fuses them into the prologue —
           ops/encode.encode_stages_pcm), then the two per-sample
           automatons, frame-per-lane with stereo channels folded into
           extra lanes (ops/encode.py): forward adaptive FIR residuals,
           the Rice emitter, and the per-sample 96-bit chunk merge
           (merge_symbol_chunks) so the host packer writes ONE
           multi-word field per channel-sample;
  host   — whole-batch chunk packing (native alac_pack_chunk_frames;
           BitWriter fallback).

Large batches run as a bounded pipeline (<= 2 device batches in flight):
prep of chunk k+1 and packing of chunk k-1 overlap the device's work on
chunk k, mirroring decode_blob's dispatch discipline
(parallel/pipeline.py).

Output payloads are byte-identical to codec/encoder.AlacEncoder given
the same configuration — tests/test_encoder_tpu.py enforces equality,
which transitively inherits the whole decode-side parity pyramid.
"""

from __future__ import annotations

import numpy as np

from .. import native
from ..ops.lpc import MAX_ORDER, LpcParams, reverse_coefs
from .cookie import CodecParams
from .encoder import AlacEncoder, EncoderConfig, levinson_coefs_batch

#: Frames per device batch in the pipelined path (2*chunk lanes on
#: device; 4096-sample frames at 2048 lanes stage ~32 MB of planes).
CHUNK_FRAMES = 1024


def _header_bits(enc: AlacEncoder, n: int, nch: int, ub: int,
                 coefs_per_ch: list[list[int]]) -> tuple[list[int], list[int]]:
    """All bit fields preceding the extra-bits/entropy sections."""
    vals, widths = enc._header_fields(n, nch, ub, 0)
    if nch == 2:
        vals += [enc.config.interlacing_shift, enc.config.interlacing_leftweight]
        widths += [8, 8]
    else:
        vals += [0]  # mono filler bits (AlacFile.cs:457-459)
        widths += [16]
    for coefs in coefs_per_ch:
        pv, pw = enc._prediction_fields(coefs, enc.config.order)
        vals += pv
        widths += pw
    return vals, widths


def _normalize_frames(frames, S: int):
    """-> (padded (F, S, 2) int, ns_f (F,), stereo_f (F,) bool).

    ``frames`` may be a single (F, S, ch) array (the zero-copy batch
    API: a reshaped view of contiguous PCM) or a list of per-frame
    (n, ch) arrays with mixed lengths/channel counts.
    """
    if isinstance(frames, np.ndarray):
        if frames.ndim != 3:
            raise ValueError("array input must be (F, S, channels)")
        F, n, nch = frames.shape
        if n > S:
            raise ValueError(f"frames of {n} samples exceed {S}")
        if nch not in (1, 2):
            raise ValueError(f"1 or 2 channels, got {nch}")
        ns_f = np.full(F, n, np.int32)
        stereo_f = np.full(F, nch == 2)
        if n == S and nch == 2:
            return frames, ns_f, stereo_f
        padded = np.zeros((F, S, 2), frames.dtype)
        padded[:, :n, :nch] = frames
        return padded, ns_f, stereo_f
    F = len(frames)
    ns_f = np.zeros(F, np.int32)
    stereo_f = np.zeros(F, bool)
    shapes = {np.asarray(f).shape for f in frames}
    if len(shapes) == 1:
        a = np.asarray(frames)
        if a.ndim == 2:
            a = a[:, :, None]
        return _normalize_frames(a, S)
    padded = np.zeros((F, S, 2), np.int64)
    for f, pcm in enumerate(frames):
        pcm = np.asarray(pcm)
        if pcm.ndim == 1:
            pcm = pcm[:, None]
        n, nch = pcm.shape
        if nch not in (1, 2):
            raise ValueError(f"1 or 2 channels, got {nch}")
        if n > S:
            raise ValueError(f"frame of {n} samples exceeds {S}")
        ns_f[f] = n
        stereo_f[f] = nch == 2
        padded[f, :n, :nch] = pcm
    return padded, ns_f, stereo_f


def _prep(frames, params: CodecParams, cfg: EncoderConfig, enc: AlacEncoder):
    """Host prep: split/decorrelate, batched Levinson, header fields.

    Returns a dict with everything the dispatch and pack stages need.
    """
    S = params.max_samples_per_frame
    ub = cfg.uncompressed_bytes
    order = cfg.order
    padded, ns_f, stereo_f = _normalize_frames(frames, S)
    F = len(ns_f)
    B = 2 * F  # channel-folded lanes: [A of all frames, B of all frames]

    # The full-frame extra-bits strip / stereo decorrelation / channel
    # fold run on DEVICE (ops/encode.encode_stages_pcm) — elementwise
    # work XLA fuses into the automaton prologue, shedding two host
    # passes over the chunk.  The host keeps
    # only (a) the extra-bits side-channel plane (packed host-side) and
    # (b) a Levinson-window-sized decorrelation for coefficient choice.
    ub8 = 8 * ub
    pcm_i32 = np.ascontiguousarray(padded, np.int32)  # <=24-bit always fits
    if ub:
        extra_pl = (pcm_i32 & ((1 << ub8) - 1)).astype(np.uint32)
    else:
        extra_pl = None
    sh, lw = cfg.interlacing_shift, cfg.interlacing_leftweight
    # Product domain: |cb| * leftweight can pass 2^31 only when the
    # post-strip width exceeds 16 bits (24-bit no-extra-bits content).
    wide = params.sample_size - ub8 > 16
    ns = np.concatenate([ns_f, np.where(stereo_f, ns_f, 0)]).astype(np.int32)
    rss_l = np.concatenate(
        [params.sample_size - 8 * ub + stereo_f.astype(np.int32)] * 2
    ).astype(np.int32)

    # ---- batched coefficient choice (identical to _choose_coefs by
    # construction: both go through levinson_coefs_batch) ----
    if order in (0, 0x1F) or not cfg.adaptive_coefs:
        seed = enc._seed_coefs(order)
        ncoef = len(seed)
        coef_mat = np.tile(np.asarray(seed, np.int32), (B, 1))
    else:
        ncoef = order
        w = min(cfg.levinson_window or S, S)
        # Window-only host decorrelation: Levinson reads just the first
        # w samples of each lane, and decorrelation is per-sample, so
        # the windowed fold equals the full fold's prefix.  Native
        # tier: one fused pass (alac_decorr_window, bit-identical by
        # matching the work dtype) vs ~6 NumPy array sweeps.
        sig_w = native.decorr_window_native(
            pcm_i32, w, ub8, lw, sh, stereo_f, wide
        )
        if sig_w is None:
            work_dtype = np.int64 if wide else np.int32
            hiw = pcm_i32[:, :w].astype(work_dtype)
            if ub8:
                hiw >>= ub8
            if lw != 0:
                cbw = hiw[:, :, 0] - hiw[:, :, 1]
                caw = hiw[:, :, 1] + ((cbw * lw) >> sh)
            else:
                caw, cbw = hiw[:, :, 0], hiw[:, :, 1]
            stw = stereo_f[:, None]
            sig_w = np.empty((B, w), np.int32)
            np.copyto(sig_w[:F], np.where(stw, caw, hiw[:, :, 0]))
            np.copyto(sig_w[F:], np.where(stw, cbw, 0))
        coef_mat = levinson_coefs_batch(
            sig_w, np.minimum(ns, w), order, cfg.quant
        )
    coef_mat = np.where(ns[:, None] > 0, coef_mat, 0)

    # ---- header/coef bit fields ----
    uniform = (
        ns_f.size > 0
        and (ns_f == ns_f[0]).all()
        and (stereo_f == stereo_f[0]).all()
    )
    # Emitted coef-field count per channel (order 31 emits all 31; order
    # 0 emits none — _prediction_fields, AlacFile.cs:577-596 mirrored).
    emitted = 31 if order == 0x1F else order
    if uniform:
        nch = 2 if stereo_f[0] else 1
        coefs0 = [[0] * ncoef] * nch
        tv, tw = _header_bits(enc, int(ns_f[0]), nch, ub, coefs0)
        H = len(tv)
        hw_row = np.asarray(tw, np.uint8)
        hv_mat = np.tile(np.asarray(tv, np.uint32), (F, 1))
        # coef fields sit at the tail of each channel's prediction block
        if emitted:
            a_end = H - (4 + emitted) * (nch - 1)
            hv_mat[:, a_end - emitted : a_end] = (
                coef_mat[:F, :emitted] & 0xFFFF
            )
            if nch == 2:
                hv_mat[:, H - emitted : H] = coef_mat[F:, :emitted] & 0xFFFF
        hv_all = hv_mat.reshape(-1)
        hw_all = np.tile(hw_row, F)
        h_off = np.arange(F + 1, dtype=np.int64) * H
        hbits = np.full(F, int(hw_row.astype(np.int64).sum()), np.int64)
    else:
        hv_parts, hw_parts = [], []
        h_off = np.zeros(F + 1, np.int64)
        hbits = np.zeros(F, np.int64)
        for f in range(F):
            nch = 2 if stereo_f[f] else 1
            coefs_per_ch = [coef_mat[f, :ncoef].tolist()]
            if nch == 2:
                coefs_per_ch.append(coef_mat[F + f, :ncoef].tolist())
            hv, hw = _header_bits(enc, int(ns_f[f]), nch, ub, coefs_per_ch)
            hv_parts.append(np.asarray(hv, np.uint32))
            hw_parts.append(np.asarray(hw, np.uint8))
            h_off[f + 1] = h_off[f] + len(hv)
            hbits[f] = sum(hw)
        hv_all = np.concatenate(hv_parts) if F else np.zeros(0, np.uint32)
        hw_all = np.concatenate(hw_parts) if F else np.zeros(0, np.uint8)

    # ---- extra-bits side-channel plane (A:B interleaved per sample) ----
    if ub:
        ea = extra_pl[:, :, 0]
        eb = extra_pl[:, :, 1]
        extra_plane = np.where(stereo_f[:, None], (ea << ub8) | eb, ea)
        extra_w = np.where(stereo_f, 2 * ub8, ub8).astype(np.uint8)
        extra_bits = extra_w.astype(np.int64) * ns_f
    else:
        extra_plane = None
        extra_w = None
        extra_bits = 0

    return {
        "F": F, "S": S, "B": B, "order": order, "ncoef": ncoef,
        "pcm": pcm_i32, "lw": lw, "sh": sh, "ub8": ub8, "wide": wide,
        "ns": ns, "ns_f": ns_f, "stereo_f": stereo_f,
        "rss_l": rss_l, "coef_mat": coef_mat,
        "hv": hv_all, "hw": hw_all, "h_off": h_off,
        "hbits": hbits + extra_bits,
        "extra_plane": extra_plane, "extra_w": extra_w,
    }


def _enc_pairs() -> bool:
    """Pair-plane packing (ops/encode.merge_pair_chunks + the native
    two-frame interleaved pair packer): ON by default when the native
    tier is available — it halves both the host pack stage's per-field
    bookkeeping and the chunk-plane D2H (13 B/pair vs 13 B/sample).
    ALAC_ENC_PAIR=0 forces the classic per-sample chunk planes; =1
    requires the native tier (there is no pure-Python pair packer)."""
    import os

    from .. import native

    mode = os.environ.get("ALAC_ENC_PAIR", "auto")
    if mode not in ("auto", "0", "1"):
        raise ValueError(f"ALAC_ENC_PAIR={mode!r}: expected auto, 0 or 1")
    if mode == "0":
        return False
    ok = native.available()
    if mode == "1" and not ok:
        raise RuntimeError(
            "ALAC_ENC_PAIR=1 requires the native host tier "
            "(the pair packer has no Python fallback)"
        )
    return ok


def _enc_quads() -> bool:
    """Quad-plane packing (ops/encode.merge_quad_chunks): fold adjacent
    PAIRS into one <=96-bit field so the host packer writes one field
    per FOUR samples; quad-fat frames (a quad past 96 bits — adjacent
    escape symbols) are repacked from slice-fetched pair rows
    (_repack_fat_frames), so output stays byte-identical on every
    input.

    OFF by default — a measured NEGATIVE result for the host pack
    stage (quads packed slower than pairs on the same planes).  The
    pair packer's two-field fold (ALAC_PAIR2)
    already reaches one accumulator push per FOUR samples whenever two
    pairs fit 64 bits (typical music pairs are ~20-28 bits), and two
    ~48-bit quads never fit one push — so quads halve the width-plane
    bookkeeping but forfeit the fold, a net loss.  What quads DO halve
    is plane D2H (13 B per 4 samples vs per 2), available via
    ALAC_ENC_QUAD=1 where that transfer binds."""
    import os

    mode = os.environ.get("ALAC_ENC_QUAD", "0")
    if mode not in ("auto", "0", "1"):
        raise ValueError(f"ALAC_ENC_QUAD={mode!r}: expected auto, 0 or 1")
    return mode == "1"


def _dispatch(prep, params: CodecParams, cfg: EncoderConfig, mesh=None,
              pairs: bool | None = None):
    """Stage the prepped batch onto the device (async); with a mesh,
    DP-shard the frames (parallel.mesh.encode_stages_pcm_spmd).

    ``pairs`` (default: auto) selects the pair-merged plane layout for
    the native pair packer — on both the single-device and the mesh
    path (the fold is elementwise, so it shards with the frames).
    Device-pack dispatches stay on the classic per-sample chunk planes
    (pack_frames_device consumes those)."""
    import jax.numpy as jnp

    from ..ops.encode import RiceEncParams, encode_stages_pcm

    if pairs is None:
        pairs = _enc_pairs() and not _enc_device_pack()
    prep["pairs"] = pairs
    # Quads ride on the pair path (same packer, halved field count);
    # the extra-bits plane keeps its own per-SAMPLE count inside the
    # packer, so batches with an extra plane stay on pairs.
    quads = pairs and _enc_quads() and prep["extra_plane"] is None
    prep["quads"] = quads
    if pairs:
        # Non-fitting pairs (fat flag) re-dispatch the classic planes;
        # see _pack_host_pairs.  The closure re-enters this function
        # with pairs forced off, so prep["pairs"] is reset for _pack's
        # routing if the fallback fires.
        prep["_classic_dispatch"] = lambda: _dispatch(
            prep, params, cfg, mesh=mesh, pairs=False
        )

    B, S, order = prep["B"], prep["S"], prep["order"]
    coef_tab = np.zeros((B, MAX_ORDER), np.int32)
    coef_tab[:, : prep["ncoef"]] = prep["coef_mat"][:, :MAX_ORDER]
    rc = reverse_coefs(coef_tab, np.full(B, order, np.int32))
    lp = LpcParams(
        order=jnp.asarray(np.full(B, order, np.int32)),
        quant=jnp.asarray(np.full(B, cfg.quant, np.int32)),
        rc=jnp.asarray(rc),
        rss=jnp.asarray(prep["rss_l"]),
    )
    rp = RiceEncParams(
        rss=lp.rss,
        kmod=jnp.asarray(np.full(B, params.rice_kmodifier, np.int32)),
        init_history=jnp.asarray(
            np.full(B, params.rice_initial_history, np.int32)
        ),
        mult=jnp.asarray(
            np.full(B, params.rice_history_mult_for(cfg.rice_modifier), np.int32)
        ),
        kmask=jnp.asarray(np.full(B, params.rice_kmodifier_mask, np.int32)),
    )
    max_order = 0 if order in (0, 31) else order
    if mesh is not None:
        from ..parallel.mesh import encode_stages_pcm_spmd

        # Planes come back (2, F, ...) channel-major (sharded on F);
        # the packers flatten to the (2F, ...) lane layout after the
        # host fetch (_fetch_lane_major) — reshaping the sharded array
        # on device would force a cross-shard gather.
        return encode_stages_pcm_spmd(
            prep["pcm"], prep["stereo_f"], prep["ns"], lp, rp, mesh, S,
            max_order=max_order, lw=prep["lw"], sh=prep["sh"],
            ub8=prep["ub8"], wide=prep["wide"], pairs=pairs, quads=quads,
        )
    return encode_stages_pcm(
        jnp.asarray(prep["pcm"]), jnp.asarray(prep["stereo_f"]),
        jnp.asarray(prep["ns"]), lp, rp, S, max_order=max_order,
        lw=prep["lw"], sh=prep["sh"], ub8=prep["ub8"], wide=prep["wide"],
        pairs=pairs, quads=quads,
    )


def _enc_device_pack() -> bool:
    """Opt-in device-side frame packing (ops/encode.pack_frames_device):
    the coded bytes leave the chip instead of ~13 B/sample of chunk
    planes, and the host pack stage drops to header-OR + slicing.
    OFF by default: per-bit-granularity word assembly is irreducibly
    gather/scatter-bound, and both formulations lost by more than an
    order of magnitude to the native host packer on the accelerator
    this was first built for.  Not measured on a GPU yet, where gathers
    are native (ROADMAP D6).  Kept as an opt-in + parity-tested
    alternative backend."""
    import os

    return os.environ.get("ALAC_ENC_DEVICE_PACK", "0") == "1"


#: Device-pack output rows are bucketed to multiples of this many
#: 32-bit words so jit recompiles are bounded across chunk sizes.
_PACK_STRIDE_STEP = 256


def _or_header(row, hv_f, hw_f) -> None:
    """OR a frame's ragged header fields into its row's zeroed prefix
    (the device-packed body starts at bit hbits, so header and body bit
    ranges are disjoint and OR-compose; native alac_pack_bits and the
    BitWriter fallback both OR rather than overwrite)."""
    from .. import native

    if native.pack_bits_native(hv_f, hw_f, row, 0) is None:
        from .bitwriter import BitWriter

        w = BitWriter()
        for v, wd in zip(hv_f.tolist(), hw_f.tolist()):
            w.write(int(v), int(wd))
        hb = np.frombuffer(w.getvalue(), np.uint8)
        row[: hb.size] |= hb


def _pack_device(prep, planes, timings: dict | None):
    """Device-pack variant of :func:`_pack`: the chunk planes stay on
    device; :func:`ops.encode.pack_frames_device` assembles the frame
    bodies and the host only ORs the ragged header fields into each
    row's zeroed prefix and slices payloads."""
    import time as _time

    import os
    import jax.numpy as jnp

    from ..ops.encode import pack_frames_device, pack_frames_device_scatter

    _t0 = _time.perf_counter()
    c0_d, c1_d, c2_d, ws_d, bits_d, bad_d = planes
    bits = np.asarray(bits_d).astype(np.int64)
    if bool(np.asarray(bad_d).any()):
        raise RuntimeError("encoder state desync: raw < 0")
    F = prep["F"]
    total_bits = prep["hbits"] + bits[:F] + bits[F:]
    need = int(total_bits.max()) // 32 + 2 if F else 2
    stride_words = -(-need // _PACK_STRIDE_STEP) * _PACK_STRIDE_STEP
    pargs = (
        jnp.asarray(c0_d), jnp.asarray(c1_d), jnp.asarray(c2_d),
        jnp.asarray(ws_d),
        jnp.asarray(prep["ns_f"].astype(np.int32)),
        jnp.asarray(prep["stereo_f"]),
        jnp.asarray(prep["hbits"].astype(np.int32)),
    )
    # Two bit-identical formulations; scatter is the default.
    impl = os.environ.get("ALAC_ENC_PACK_IMPL", "scatter")
    if impl not in ("gather", "scatter"):
        raise ValueError(f"ALAC_ENC_PACK_IMPL must be gather/scatter, got {impl!r}")
    if impl == "scatter":
        rows_d, end_d = pack_frames_device_scatter(
            *pargs, stride_words=stride_words
        )
    else:
        rows_d, end_d = pack_frames_device(*pargs, stride_words=stride_words)
    rows = np.asarray(rows_d).copy()
    end_bits = np.asarray(end_d)
    _t1 = _time.perf_counter()
    hv, hw, h_off = prep["hv"], prep["hw"], prep["h_off"]
    payloads = []
    for f in range(F):
        _or_header(rows[f], hv[h_off[f]:h_off[f + 1]], hw[h_off[f]:h_off[f + 1]])
        payloads.append(rows[f, : -(-int(end_bits[f]) // 8)].tobytes())
    if timings is not None:
        timings["emit_wait_s"] = timings.get("emit_wait_s", 0.0) + _t1 - _t0
        timings["plane_bytes"] = timings.get("plane_bytes", 0) + rows.nbytes
        timings["pack_s"] = (
            timings.get("pack_s", 0.0) + _time.perf_counter() - _t1
        )
    return payloads


def _pack(prep, planes, timings: dict | None):
    """Assemble payload bytes (device-pack variant under the flag).

    Mesh dispatches (channel-major 3-dim planes) always pack on host:
    pack_frames_device wants flat single-device lane planes, and
    reshaping a sharded array would gather it to one device anyway."""
    if prep.get("pairs"):
        return _pack_host_pairs(prep, planes, timings)
    if (
        _enc_device_pack()
        and prep["extra_plane"] is None
        and not prep.get("mesh")
    ):
        return _pack_device(prep, planes, timings)
    return _pack_host(prep, planes, timings)


def _pack_host_pairs(prep, planes, timings: dict | None):
    """Read back the pair planes (merge_pair_chunks layout) and
    assemble payload bytes via the native two-frame pair packer.

    A set ``fat`` flag (some pair's combined width exceeds 96 bits —
    unreachable for real content, but the packer's 3-word field cannot
    represent it) re-dispatches the batch on the classic per-sample
    chunk planes and packs those instead: correctness never depends on
    the fast layout fitting.

    Under ``prep["quads"]`` the dispatch also returned quad planes
    (adjacent pairs folded, ops/encode.merge_quad_chunks).  The small
    per-lane ``qfat`` flag is fetched first; every frame whose quads
    all fit (<= 96 bits — 16-bit content in practice, minus the odd
    transient frame with two adjacent ~50-bit pairs) is packed from
    the quad planes by the SAME native packer with per-frame count
    ceil(n/2) (one field per FOUR samples); the few fat frames are
    then repacked from pair-plane rows slice-fetched for just those
    lanes.  Only the planes actually packed cross D2H."""
    import time as _time

    from .. import native

    _t0 = _time.perf_counter()
    if prep.get("quads"):
        (ph_d, pm_d, pl_d, pws_d, bits_d, bad_d, fat_d,
         qh_d, qm_d, ql_d, qws_d, qfat_d) = planes
    else:
        ph_d, pm_d, pl_d, pws_d, bits_d, bad_d, fat_d = planes
        qfat_d = None
    fat = np.asarray(fat_d)
    if bool(fat.any()):
        prep["pairs"] = False
        return _pack_host(prep, prep["_classic_dispatch"](), timings)
    F = prep["F"]
    frame_fat = np.zeros(F, bool)
    use_quads = False
    if qfat_d is not None:
        qfat = np.asarray(qfat_d).reshape(-1)  # mesh: (2, F) -> (2F,)
        frame_fat = qfat[:F] | qfat[F:]
        # Quad packing pays only when most frames ride it; a majority-
        # fat batch (24-bit-ish content) just packs pairs wholesale.
        use_quads = frame_fat.sum() <= F // 2
    # Mesh dispatches return channel-major (2, F, ...) shards; flatten
    # to the packer's (2F, ...) lane layout after the fetch.
    if use_quads:
        ph = _fetch_lane_major(qh_d, 2)
        pm = _fetch_lane_major(qm_d, 2)
        pl = _fetch_lane_major(ql_d, 2)
        pws = _fetch_lane_major(qws_d, 2)
    else:
        ph = _fetch_lane_major(ph_d, 2)
        pm = _fetch_lane_major(pm_d, 2)
        pl = _fetch_lane_major(pl_d, 2)
        pws = _fetch_lane_major(pws_d, 2)
    bits = _fetch_lane_major(bits_d, 1).astype(np.int64)
    if bool(np.asarray(bad_d).any()):
        raise RuntimeError("encoder state desync: raw < 0")
    _t1 = _time.perf_counter()
    total_bits = prep["hbits"] + bits[:F] + bits[F:]
    out_stride = int(total_bits.max()) // 8 + 8 if F else 8
    # Quad planes reuse the pair packer verbatim: its only use of the
    # per-frame count is fields = ceil(count/2), so handing it
    # ceil(n/2) yields ceil(n/4) quad fields (extra plane is None on
    # the quad path — _dispatch gates on that).  Fat frames' rows
    # contain a -1 width the packer skips; their bytes are garbage and
    # are replaced by the subset repack below.
    ns_eff = (prep["ns_f"] + 1) // 2 if use_quads else prep["ns_f"]
    packed = native.pack_pair_frames_native(
        prep["hv"], prep["hw"], prep["h_off"],
        prep["extra_plane"], prep["extra_w"],
        ph, pm, pl, pws, ns_eff, prep["stereo_f"].astype(np.uint8),
        prep["S"], out_stride,
        # Recycled rows (native._rows_for): the payload slices below
        # copy out of them before this function returns, so the
        # next-chunk invalidation contract holds.
        reuse=True,
    )
    if packed is None:  # native tier vanished mid-run; classic fallback
        prep["pairs"] = False
        return _pack_host(prep, prep["_classic_dispatch"](), timings)
    out, end_bits = packed
    if use_quads and frame_fat.any():
        sub = _repack_fat_frames(
            prep, frame_fat, (ph_d, pm_d, pl_d, pws_d), out_stride
        )
        if sub is None:  # native tier vanished mid-run
            prep["pairs"] = False
            return _pack_host(prep, prep["_classic_dispatch"](), timings)
        out2, end2 = sub
        idx = np.flatnonzero(frame_fat)
        out[idx] = out2
        end_bits[idx] = end2
    payloads = [
        out[f, : -(-int(end_bits[f]) // 8)].tobytes() for f in range(F)
    ]
    if timings is not None:
        timings["emit_wait_s"] = timings.get("emit_wait_s", 0.0) + _t1 - _t0
        timings["plane_bytes"] = timings.get("plane_bytes", 0) + (
            ph.nbytes + pm.nbytes + pl.nbytes + pws.nbytes
        )
        timings["pack_s"] = (
            timings.get("pack_s", 0.0) + _time.perf_counter() - _t1
        )
    return payloads


def _repack_fat_frames(prep, frame_fat, pair_planes, out_stride):
    """Repack the quad-fat frames from PAIR-plane rows.

    ``pair_planes`` are still device-resident; only the fat frames'
    lanes (channel A and B rows) are gathered on device and fetched —
    for the typical <=1% fat fraction this keeps the extra D2H
    negligible instead of doubling it.  Returns (out2 (K, out_stride)
    uint8, end2 (K,) int64) for the K fat frames, or None without the
    native tier."""
    from .. import native

    F = prep["F"]
    idx = np.flatnonzero(frame_fat)
    K = idx.size

    def rows(x):
        a = x
        if getattr(a, "ndim", 2) == 3:  # mesh: channel-major (2, F, ...)
            g = np.asarray(a[:, idx])
            return np.ascontiguousarray(g).reshape(2 * K, *g.shape[2:])
        return np.asarray(a[np.concatenate([idx, F + idx])])

    ph, pm, pl, pws = (rows(x) for x in pair_planes)
    h_off = prep["h_off"]
    hv_parts = [prep["hv"][h_off[f] : h_off[f + 1]] for f in idx]
    hw_parts = [prep["hw"][h_off[f] : h_off[f + 1]] for f in idx]
    h_off2 = np.zeros(K + 1, np.int64)
    np.cumsum([len(p) for p in hv_parts], out=h_off2[1:])
    hv2 = (
        np.concatenate(hv_parts) if K else np.zeros(0, prep["hv"].dtype)
    )
    hw2 = (
        np.concatenate(hw_parts) if K else np.zeros(0, prep["hw"].dtype)
    )
    return native.pack_pair_frames_native(
        hv2, hw2, h_off2, None, None,
        ph, pm, pl, pws, prep["ns_f"][idx],
        prep["stereo_f"][idx].astype(np.uint8),
        prep["S"], out_stride,
    )


def _fetch_lane_major(x, ndim_flat: int) -> np.ndarray:
    """Fetch a chunk plane to host in the packer's flat (2F, ...) lane
    layout.  Mesh dispatches return channel-major (2, F, ...) shards
    (encode_stages_pcm_spmd) — flattening after the fetch is a free
    view, where a device-side reshape would gather across shards."""
    a = np.asarray(x)
    if a.ndim == ndim_flat + 1:
        a = np.ascontiguousarray(a).reshape(-1, *a.shape[2:])
    return a


def _pack_host(prep, planes, timings: dict | None):
    """Read back the chunk planes and assemble payload bytes."""
    import time as _time

    from .. import native

    _t0 = _time.perf_counter()
    c0_d, c1_d, c2_d, ws_d, bits_d, bad_d = planes
    c0 = _fetch_lane_major(c0_d, 2)
    c1 = _fetch_lane_major(c1_d, 2)
    c2 = _fetch_lane_major(c2_d, 2)
    ws = _fetch_lane_major(ws_d, 2)
    bits = _fetch_lane_major(bits_d, 1).astype(np.int64)
    if bool(np.asarray(bad_d).any()):
        raise RuntimeError("encoder state desync: raw < 0")
    _t1 = _time.perf_counter()
    F = prep["F"]
    total_bits = prep["hbits"] + bits[:F] + bits[F:]
    out_stride = int(total_bits.max()) // 8 + 8 if F else 8
    packed = native.pack_chunk_frames_native(
        prep["hv"], prep["hw"], prep["h_off"],
        prep["extra_plane"], prep["extra_w"],
        c0, c1, c2, ws, prep["ns_f"], prep["stereo_f"].astype(np.uint8),
        out_stride,
        # Recycled rows (native._rows_for): the payload slices below
        # copy out before return, honoring the invalidation contract.
        reuse=True,
    )
    if packed is not None:
        out, end_bits = packed
        payloads = [
            out[f, : -(-int(end_bits[f]) // 8)].tobytes() for f in range(F)
        ]
    else:
        payloads = _pack_py(prep, c0, c1, c2, ws)
    if timings is not None:
        timings["emit_wait_s"] = timings.get("emit_wait_s", 0.0) + _t1 - _t0
        timings["plane_bytes"] = timings.get("plane_bytes", 0) + (
            c0.nbytes + c1.nbytes + c2.nbytes + ws.nbytes
        )
        timings["pack_s"] = (
            timings.get("pack_s", 0.0) + _time.perf_counter() - _t1
        )
    return payloads


def _pack_py(prep, c0, c1, c2, ws):
    """Pure-Python packing fallback (no native library)."""
    from .bitwriter import BitWriter

    F, S = prep["F"], prep["S"]
    hv, hw, h_off = prep["hv"], prep["hw"], prep["h_off"]
    extra_plane, extra_w = prep["extra_plane"], prep["extra_w"]
    payloads = []
    for f in range(F):
        w = BitWriter()
        for v, wd in zip(
            hv[h_off[f] : h_off[f + 1]].tolist(),
            hw[h_off[f] : h_off[f + 1]].tolist(),
        ):
            w.write(int(v), int(wd))
        n = int(prep["ns_f"][f])
        if extra_plane is not None and extra_w[f]:
            eb = int(extra_w[f])
            for i in range(n):
                w.write(int(extra_plane[f, i]), eb)
        lanes = [f, F + f] if prep["stereo_f"][f] else [f]
        for lane in lanes:
            for i in range(n):
                b = int(ws[lane, i])
                if b <= 32:
                    w.write(int(c2[lane, i]), b)
                elif b <= 64:
                    w.write(int(c1[lane, i]), b - 32)
                    w.write(int(c2[lane, i]), 32)
                else:
                    w.write(int(c0[lane, i]), b - 64)
                    w.write(int(c1[lane, i]), 32)
                    w.write(int(c2[lane, i]), 32)
        payloads.append(w.getvalue())
    return payloads


def encode_frames_tpu(
    frames,
    params: CodecParams,
    config: EncoderConfig | None = None,
    timings: dict | None = None,
    chunk_frames: int | None = None,
    mesh=None,
) -> list[bytes]:
    """Encode PCM frames in device batches.

    ``frames``: list of (n, ch) int arrays (mixed lengths/channels), or
    a single (F, S, ch) array — the zero-copy batch form for uniform
    full frames (e.g. a reshaped view of contiguous PCM).

    Compressed path only (``force_uncompressed`` frames have no
    sequential stage worth a device trip — use AlacEncoder).

    Batches larger than ``chunk_frames`` (default CHUNK_FRAMES) run as a
    bounded pipeline: host prep of the next chunk and packing of the
    previous overlap the device automatons (<= 2 chunks in flight).

    ``timings``: optional dict receiving per-stage wall times summed
    over chunks — ``prep_s``, ``emit_wait_s`` (blocking plane readback;
    ``plane_bytes`` records the transfer size), ``pack_s``.

    ``mesh``: optional ``jax.sharding.Mesh`` — DP-shards each chunk's
    frames across the mesh (parallel.mesh.encode_stages_pcm_spmd; the
    same embarrassing frame parallelism as decode's ``decode_files
    (mesh=)``).  Chunks are padded with silent full frames to the mesh
    granularity; pad payloads are dropped before returning.
    """
    import time as _time

    cfg = config or EncoderConfig()
    if cfg.force_uncompressed:
        raise ValueError("device encoder handles the compressed path only")
    if cfg.uncompressed_bytes > 2:
        # The combined per-sample extra-bits field (A:B interleaved) must
        # fit one u32 plane value; the host AlacEncoder covers ub=3.
        raise ValueError("device encoder supports uncompressed_bytes <= 2")
    import queue as _queue
    import threading as _threading

    enc = AlacEncoder(params, cfg)  # validates params/config like the host
    F = len(frames)
    if F == 0:
        return []
    # A mesh multiplies the chunk so every shard still sees a full
    # device batch.
    step = chunk_frames or (
        CHUNK_FRAMES * mesh.devices.size if mesh is not None
        else CHUNK_FRAMES
    )
    payloads: list[bytes] = []

    # Pack runs on a worker thread: the native packer (ctypes) and the
    # big NumPy readbacks release the GIL, so on a multicore host pack
    # of chunk k-1 genuinely overlaps prep of chunk k+1 while the
    # device runs chunk k — the three-stage pipeline the stage-resolved
    # bench bound assumes (bench_lib.run_encode_benchmark).  The
    # 2-deep queue keeps <=2 chunks in flight, same as decode_blob's
    # dispatch discipline.  Single worker + FIFO queue preserves
    # payload order.
    q: "_queue.Queue" = _queue.Queue(maxsize=2)
    failure: list[BaseException] = []

    def _pack_worker():
        while True:
            item = q.get()
            if item is None:
                return
            try:
                got = _pack(item[0], item[1], timings)
                payloads.extend(got[: item[0].get("real_frames", len(got))])
            except BaseException as e:  # propagate to the dispatch loop
                failure.append(e)
                return

    worker = _threading.Thread(target=_pack_worker, daemon=True)
    worker.start()

    def _enqueue(item):
        while True:
            if failure:
                raise failure[0]
            try:
                q.put(item, timeout=0.2)
                return
            except _queue.Full:
                continue

    n_dev = mesh.devices.size if mesh is not None else 1
    S = params.max_samples_per_frame
    for lo in range(0, F, step):
        chunk = frames[lo : lo + step]
        real = len(chunk)
        if mesh is not None and real % n_dev:
            # Pad to the shard granularity with silent full frames;
            # their payloads are dropped below (``real`` bound).
            pad = n_dev - real % n_dev
            fill = [np.zeros((S, 2), np.int32)] * pad
            chunk = (
                [np.asarray(fr) for fr in chunk] + fill
                if not isinstance(chunk, np.ndarray)
                else list(chunk) + fill
            )
        _t0 = _time.perf_counter()
        prep = _prep(chunk, params, cfg, enc)
        prep["real_frames"] = real
        prep["mesh"] = mesh is not None
        planes = _dispatch(prep, params, cfg, mesh=mesh)  # async
        if timings is not None:
            timings["prep_s"] = (
                timings.get("prep_s", 0.0) + _time.perf_counter() - _t0
            )
        _enqueue((prep, planes))
    _enqueue(None)
    worker.join()
    if failure:
        raise failure[0]
    return payloads
