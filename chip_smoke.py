"""Smoke run of the main path on one GPU: the quickest proof that the
system starts on the card and is bit-exact there.

    python chip_smoke.py            # one GPU
    python chip_smoke.py --four     # the mesh paths over four GPUs

Phases, in one process (the walls printed beside them are smoke timings,
not benchmark numbers):

1. device: the card's name and power limit, JAX's device kind and count,
   the native host library's pack SIMD width;
2. catalog, made from ``--seed``: 12 tracks of 16-bit/44.1 kHz stereo
   music of 3 minutes, 4 tracks of 24-bit/96 kHz stereo of 1 minute with
   the extra-bits side channel (``uncompressed_bytes=1``), one mono
   16-bit track and one track of uncompressed frames, written as .m4a
   with ``encode_files(device=True)`` and checked byte for byte against
   the host ``AlacEncoder`` on a sample of frames per format;
3. decode: ``decode_files`` over the whole catalog bit-exact against the
   PCM, the scalar oracle (codec/scalar.py) on sampled frames, and
   ``ALACFileReader`` seek + read against the PCM slice;
4. kernel parity: the GPU decode kernel (route "triton") against the XLA
   scans (route "scan") at the production dispatch size, 4096 samples per
   frame, for every corpus kind, with tolerance 0.

``--four`` runs only the mesh decode (device row assembly, the default:
the blob replicated) and the mesh encode over four GPUs, each compared
with the same work on one GPU in this process.

Exits non-zero, printing no result, when JAX finds no GPU or a phase
fails.  The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import io
import json
import os
import sys
import tempfile
import time

import numpy as np

#: Catalog, per the smoke contract: (name, tracks, seconds, rate, bits,
#: channels, encoder options).
CATALOG = (
    ("cd16", 12, 180.0, 44100, 16, 2, {}),
    ("hires24", 4, 60.0, 96000, 24, 2, {"uncompressed_bytes": 1}),
    ("mono16", 1, 60.0, 44100, 16, 1, {}),
    ("raw16", 1, 20.0, 44100, 16, 2, {"force_uncompressed": True}),
)
FRAME = 4096


def log(msg: str) -> None:
    print(msg, flush=True)


@dataclasses.dataclass
class Track:
    fmt: str
    pcm: np.ndarray  # (n, channels) int32
    rate: int
    bits: int
    options: dict


def build_catalog(seed: int, scale: float = 1.0) -> list[Track]:
    """Music-like PCM for every track of CATALOG; ``scale`` shortens the
    tracks (CPU tests)."""
    from alacnet_tpu.bench_lib import _music_pcm

    rng = np.random.default_rng(seed)
    tracks = []
    for fmt, count, seconds, rate, bits, ch, opts in CATALOG:
        for _ in range(count):
            n = max(1, int(seconds * rate * scale))
            tracks.append(Track(fmt, _music_pcm(n, bits, ch, rng), rate, bits, opts))
    return tracks


def _frames_of(path):
    """(params, per-frame payload bytes) of an .m4a file."""
    from alacnet_tpu.container import demux

    data = open(path, "rb").read()
    info = demux.parse(io.BytesIO(data))
    offs = info.tables.frame_file_offsets()
    sizes = info.tables.frame_byte_sizes
    return info.params, [data[o : o + s] for o, s in zip(offs, sizes)]


def encode_catalog(tracks, outdir: str, seed: int, sample: int = 64, mesh=None):
    """Write every track with the device encoder (``encode_files``, one
    pooled call per format) and check ``sample`` frames per format byte
    for byte against the host AlacEncoder.  Returns the paths."""
    from alacnet_tpu import AlacEncoder, EncoderConfig, encode_files

    rng = np.random.default_rng(seed + 1)
    paths = [os.path.join(outdir, f"t{i:02d}_{t.fmt}.m4a") for i, t in enumerate(tracks)]
    for fmt in dict.fromkeys(t.fmt for t in tracks):
        idx = [i for i, t in enumerate(tracks) if t.fmt == fmt]
        cfg = EncoderConfig(**tracks[idx[0]].options)
        encode_files(
            [tracks[i].pcm for i in idx], [paths[i] for i in idx],
            tracks[idx[0]].rate, tracks[idx[0]].bits, config=cfg,
            max_samples_per_frame=FRAME, device=True, mesh=mesh,
        )
        picks = []
        for i in idx:
            nf = -(-tracks[i].pcm.shape[0] // FRAME)
            picks += [(i, nf - 1)]  # the partial last frame
            picks += [(i, int(f)) for f in rng.integers(0, nf, -(-sample // len(idx)))]
        checked = 0
        for i, f in picks:
            params, frames = _frames_of(paths[i])
            want = AlacEncoder(params, cfg).encode_frame(
                tracks[i].pcm[f * FRAME : (f + 1) * FRAME]
            )
            if frames[f] != want:
                raise AssertionError(f"{fmt}: track {i} frame {f} differs from the host encoder")
            checked += 1
        log(f"  encode {fmt}: {len(idx)} files, {checked} frames byte-identical to the host encoder")
    return paths


def _oracle(params, payload: bytes, nch: int) -> np.ndarray:
    """Scalar-oracle decode of one frame -> (n, nch) int32."""
    from alacnet_tpu.codec.scalar import AlacFrameDecoder

    out = [0] * (params.max_samples_per_frame * nch * 3 + 16)
    nbytes = AlacFrameDecoder(params, nch).decode_frame(payload, out)
    ss = params.sample_size
    n = nbytes // ((ss // 8) * nch)
    if ss == 16:
        return np.array(out[: n * nch], np.int32).reshape(-1, nch)
    b = np.array(out[: n * nch * 3], np.int64).reshape(-1, nch, 3)
    vals = b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16)
    return np.where(vals >= 1 << 23, vals - (1 << 24), vals).astype(np.int32)


def decode_catalog(tracks, paths, seed: int, oracle_frames: int = 2, mesh=None):
    """decode_files over the catalog, bit-exact against the PCM, plus the
    scalar oracle on sampled frames.  Returns the decoded PCM list."""
    from alacnet_tpu import decode_files

    got = decode_files(paths, mesh=mesh)
    for i, (t, r) in enumerate(zip(tracks, got)):
        if r.pcm.shape != t.pcm.shape or not np.array_equal(r.pcm, t.pcm):
            raise AssertionError(f"decode_files: track {i} ({t.fmt}) is not bit-exact")
    total = sum(t.pcm.size for t in tracks)
    log(f"  decode_files: {len(tracks)} files, {total} samples bit-exact")
    if mesh is not None:
        return got
    rng = np.random.default_rng(seed + 2)
    for fmt in dict.fromkeys(t.fmt for t in tracks):
        i = next(i for i, t in enumerate(tracks) if t.fmt == fmt)
        params, frames = _frames_of(paths[i])
        for f in rng.integers(0, len(frames), oracle_frames):
            ref = _oracle(params, frames[f], tracks[i].pcm.shape[1])
            if not np.array_equal(ref, tracks[i].pcm[f * FRAME : f * FRAME + len(ref)]):
                raise AssertionError(f"oracle: {fmt} frame {f} disagrees")
        log(f"  scalar oracle {fmt}: {oracle_frames} frames agree")
    return got


def check_reader(track: Track, path: str, count: int = 10000) -> None:
    """ALACFileReader: seek to the middle, read, compare with the PCM."""
    from alacnet_tpu import ALACFileReader
    from alacnet_tpu.pcm import parse_pcm_bytes

    nch = track.pcm.shape[1]
    with open(path, "rb") as f:
        r = ALACFileReader(f)
        align = r.wave_format.block_align
        mid = track.pcm.shape[0] // 2
        r.position = mid * align
        got = parse_pcm_bytes(r.read(count * align), align // nch, nch)
    want = track.pcm[mid : mid + count]
    if not np.array_equal(got, want):
        raise AssertionError("ALACFileReader seek+read differs from the PCM")
    log(f"  ALACFileReader: seek to sample {mid}, {len(got)} samples match")


def kernel_parity(batch: int, route: str, kinds=None, frame: int = FRAME,
                  distinct: int = 256) -> None:
    """The decode kernel vs the XLA scans, bit for bit, at ``batch``
    lanes of ``frame`` samples for every corpus kind."""
    import jax
    import jax.numpy as jnp

    from alacnet_tpu.bench_lib import CORPUS_KINDS, make_corpus_frames
    from alacnet_tpu.codec.framemeta_vec import parse_frame_headers_vec
    from alacnet_tpu.ops.frame_decode import FrameMetaArrays, decode_frames_packed
    from alacnet_tpu.parallel.pipeline import pad_frame_batch, span_max_order

    for kind in kinds or CORPUS_KINDS:
        frames, params = make_corpus_frames(
            num_distinct=min(distinct, batch), frame_samples=frame, kind=kind
        )
        fb = pad_frame_batch(parse_frame_headers_vec(
            [frames[i % len(frames)] for i in range(batch)], params
        ))
        args = (jnp.asarray(fb.words), jnp.asarray(FrameMetaArrays.pack_host(fb)))
        outs = {}
        for r in (route, "scan"):
            t0 = time.perf_counter()
            compiled = decode_frames_packed.lower(
                *args, num_samples=frame, route=r, max_order=span_max_order(fb)
            ).compile()
            t_c = time.perf_counter() - t0
            t0 = time.perf_counter()
            outs[r] = jax.block_until_ready(compiled(*args))
            t_r = time.perf_counter() - t0
            log(f"  [{kind}] {r}: B={fb.batch} W={fb.words.shape[1]} compile "
                f"{t_c:.2f} s, first run {t_r * 1e3:.1f} ms (smoke timing)")
            log(f"    memory_analysis: {compiled.memory_analysis()}")
        (a, na), (b, nb) = outs[route], outs["scan"]
        if not (np.array_equal(np.asarray(a), np.asarray(b))
                and np.array_equal(np.asarray(na), np.asarray(nb))):
            bad = int((np.asarray(a) != np.asarray(b)).sum())
            raise AssertionError(f"{kind}: {route} vs scan, {bad} samples differ")
        log(f"  [{kind}] {route} == scan bit for bit ({int(np.asarray(na).sum())} samples)")


def four_gpu(tracks, outdir: str, seed: int) -> None:
    """Mesh decode (device row assembly) and mesh encode over four GPUs,
    each against the same work on one GPU."""
    import jax

    from alacnet_tpu import decode_files
    from alacnet_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(jax.devices()[:4])
    one = os.path.join(outdir, "one")
    four = os.path.join(outdir, "four")
    os.makedirs(one)
    os.makedirs(four)
    t0 = time.perf_counter()
    p1 = encode_catalog(tracks, one, seed)
    t1 = time.perf_counter()
    p4 = encode_catalog(tracks, four, seed, mesh=mesh)
    t4 = time.perf_counter()
    for a, b in zip(p1, p4):
        if open(a, "rb").read() != open(b, "rb").read():
            raise AssertionError(f"mesh encode differs from one GPU: {b}")
    log(f"  mesh encode == one-GPU encode byte for byte, {len(p4)} files "
        f"(smoke timing: 1 GPU {t1 - t0:.1f} s, 4 GPUs {t4 - t1:.1f} s)")
    t0 = time.perf_counter()
    ref = decode_files(p1)
    t1 = time.perf_counter()
    got = decode_catalog(tracks, p1, seed, mesh=mesh)
    t4 = time.perf_counter()
    for a, b in zip(ref, got):
        if not np.array_equal(a.pcm, b.pcm):
            raise AssertionError("mesh decode differs from one GPU")
    log(f"  mesh decode == one-GPU decode bit for bit "
        f"(smoke timing: 1 GPU {t1 - t0:.2f} s, 4 GPUs {t4 - t1:.2f} s)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU mesh decode and encode")
    args = ap.parse_args(argv)
    try:
        import jax

        from alacnet_tpu import native
        from alacnet_tpu.bench_lib import device_info, gpu_name_and_power_limit
        from alacnet_tpu.config import DEFAULT
        from alacnet_tpu.utils.compile_cache import enable_compile_cache
    except ImportError as e:
        print(f"chip_smoke: cannot import the package ({e}); run it from "
              "the root of a checkout", file=sys.stderr)
        return 2
    dev = device_info()
    if dev["platform"] != "gpu":
        print(f"chip_smoke: no GPU (JAX's first device is {dev['platform']}, "
              f"{dev['kind']}); this smoke runs only on a GPU", file=sys.stderr)
        return 1
    need = 4 if args.four else 1
    if dev["count"] < need:
        print(f"chip_smoke: needs {need} GPUs, JAX sees {dev['count']}",
              file=sys.stderr)
        return 1
    enable_compile_cache()

    t_all = time.perf_counter()
    log("== device")
    log(f"  {gpu_name_and_power_limit()}")
    log(f"  jax {jax.__version__}: {dev['kind']} x{dev['count']}")
    lib = native.get_lib()
    simd = lib.alac_pack_simd_width() if lib is not None else "unavailable"
    log(f"  native host library: alac_pack_simd_width() = {simd}")
    log(f"  batch_limit = {DEFAULT.batch_limit} frames, device_pack = {DEFAULT.device_pack}")

    log("== catalog")
    t0 = time.perf_counter()
    tracks = build_catalog(args.seed)
    frames = sum(-(-t.pcm.shape[0] // FRAME) for t in tracks)
    log(f"  {len(tracks)} tracks, {sum(t.pcm.shape[0] for t in tracks)} "
        f"sample frames per channel, {frames} ALAC frames "
        f"(smoke timing {time.perf_counter() - t0:.1f} s)")
    with tempfile.TemporaryDirectory(prefix="alac_smoke_") as outdir:
        if args.four:
            log("== four GPUs")
            four_gpu(tracks, outdir, args.seed)
        else:
            t0 = time.perf_counter()
            paths = encode_catalog(tracks, outdir, args.seed)
            log(f"  device encode (smoke timing {time.perf_counter() - t0:.1f} s)")
            log("== decode")
            t0 = time.perf_counter()
            decode_catalog(tracks, paths, args.seed)
            i = next(i for i, t in enumerate(tracks) if t.fmt == "hires24")
            check_reader(tracks[i], paths[i])
            log(f"  (smoke timing {time.perf_counter() - t0:.1f} s)")
            log("== kernel parity")
            kernel_parity(DEFAULT.batch_limit, "triton")
    log(f"== all phases passed (smoke timing {time.perf_counter() - t_all:.1f} s)")
    print(json.dumps({"ok": True, "device": dev}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
