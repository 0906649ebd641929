"""Command-line interface — the demo/CLI layer (L4).

Replaces the reference's interactive playback demo
(/root/reference/ALACDecoderDemo/Program.cs:22-66) with reproducible
commands: metadata inspection, decode-to-WAV (with a mid-stream
reposition exercise mirroring the demo's seek-to-middle), WAV-to-ALAC
encode, and a throughput benchmark with a machine-readable report.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def _cmd_info(args) -> int:
    from . import parse

    with open(args.path, "rb") as f:
        info = parse(f)
    n = info.tables.num_samples()
    rate = info.sample_rate_or_default()
    print(f"file:          {args.path}")
    print(f"channels:      {info.num_channels_or_default()}")
    print(f"sample rate:   {rate} Hz")
    print(f"bits/sample:   {info.bits_per_sample_or_default()}")
    print(f"frames:        {info.tables.num_frames}")
    print(f"samples:       {n}")
    if n >= 0:
        print(f"duration:      {n / rate:.3f} s")
    print(f"max frame:     {info.params.max_frame_bytes} bytes")
    print(f"mdat:          {info.mdat_len} bytes @ {info.mdat_offset}")
    return 0


def _cmd_decode(args) -> int:
    from .batch import decode_file
    from .pcm import write_wav
    from .reader import ALACFileReader

    t0 = time.perf_counter()
    if args.stream:
        # Bounded-memory path: decode in resumable chunks and stream the
        # WAV body, patching the RIFF sizes at the end.
        import struct

        from .batch import DecodeCursor, decode_resumable
        from .pcm import format_pcm_bytes

        from .container import demux

        # Stream metadata up front (not from the first decoded chunk):
        # a zero-frame file must still produce a valid empty WAV.
        with open(args.path, "rb") as src:
            info = demux.parse(src)
        rate = info.sample_rate_or_default()
        bits = info.bits_per_sample_or_default()
        ch = info.num_channels_or_default()
        bps = -(-bits // 8)
        cursor = DecodeCursor(args.path)
        out_path = args.output or (args.path + ".wav")
        nsamples = 0
        with open(out_path, "wb") as f:
            write_wav(f, b"", rate, bits, ch)  # placeholder sizes
            while not cursor.done:
                part, cursor = decode_resumable(cursor, max_frames=args.stream)
                f.write(format_pcm_bytes(part.pcm, bps))
                nsamples += part.num_samples
            data_len = nsamples * bps * ch
            f.seek(4)
            f.write(struct.pack("<I", 36 + data_len))
            f.seek(40)
            f.write(struct.pack("<I", data_len))
        dt = time.perf_counter() - t0
        print(
            f"streamed {nsamples} samples ({ch}ch {bits}-bit {rate} Hz) "
            f"to {out_path} in {dt:.3f}s"
        )
        return 0
    if args.seek_middle:
        # Exercise the streaming reader + mid-stream reposition, like the
        # reference demo (Program.cs:49).
        with open(args.path, "rb") as f:
            reader = ALACFileReader(f)
            reader.position = reader.length // 2
            data = reader.read(reader.length)
            wf = reader.wave_format
            rate, bits, ch = wf.sample_rate, wf.bits_per_sample, wf.channels
            nsamples = len(data) // wf.block_align
            pcm: bytes | np.ndarray = data
    else:
        dec = decode_file(args.path)
        rate, bits, ch = dec.sample_rate, dec.bits_per_sample, dec.channels
        nsamples, pcm = dec.num_samples, dec.pcm
    dt = time.perf_counter() - t0
    if args.output:
        with open(args.output, "wb") as f:
            write_wav(f, pcm, rate, bits, ch)
    rt = (nsamples / rate) / dt if dt > 0 else float("inf")
    print(
        f"decoded {nsamples} samples ({ch}ch {bits}-bit {rate} Hz) "
        f"in {dt:.3f}s — {nsamples / dt / 1e6:.2f} Msamples/s "
        f"({rt:.0f}x realtime)"
    )
    return 0


def _cmd_encode(args) -> int:
    from .codec.encoder import EncoderConfig, encode_m4a
    from .pcm import read_wav

    with open(args.path, "rb") as f:
        pcm, rate, bits = read_wav(f)
    if args.bits:
        bits = args.bits
    cfg = EncoderConfig(order=args.order)
    mesh = None
    if args.mesh:
        from .parallel.mesh import make_mesh

        mesh = make_mesh()
    t0 = time.perf_counter()
    with open(args.output, "wb") as f:
        encode_m4a(f, pcm, rate, bits, cfg, device=args.device, mesh=mesh)
    dt = time.perf_counter() - t0
    import os

    ratio = os.path.getsize(args.output) / max(1, pcm.size * (bits // 8))
    print(
        f"encoded {pcm.shape[0]} samples in {dt:.3f}s — ratio {ratio:.3f}"
    )
    return 0


def _cmd_batch_encode(args) -> int:
    """Encode many .wav files into .m4a in pooled device batches.

    The encode mirror of batch-decode (codec.encoder.encode_files):
    frames from every same-format input share the chunked device
    pipeline; --mesh DP-shards them over every local device.
    """
    import os

    from .codec.encoder import EncoderConfig, encode_files
    from .pcm import read_wav

    pcms, rates, bits_l, outs = [], [], [], []
    os.makedirs(args.out_dir, exist_ok=True)
    used: set[str] = set()
    for path in args.paths:
        with open(path, "rb") as f:
            pcm, rate, bits = read_wav(f)
        pcms.append(pcm)
        rates.append(rate)
        bits_l.append(args.bits or bits)
        stem = os.path.splitext(os.path.basename(path))[0]
        name, k = stem + ".m4a", 1
        while name in used:
            name = f"{stem}.{k}.m4a"
            k += 1
        used.add(name)
        outs.append(os.path.join(args.out_dir, name))
    mesh = None
    if args.mesh:
        from .parallel.mesh import make_mesh

        mesh = make_mesh()
    cfg = EncoderConfig(order=args.order)
    t0 = time.perf_counter()
    encode_files(pcms, outs, rates, bits_l, cfg, mesh=mesh)
    dt = time.perf_counter() - t0
    total = sum(p.shape[0] for p in pcms)
    coded = sum(os.path.getsize(o) for o in outs)
    raw = sum(p.size * (b // 8) for p, b in zip(pcms, bits_l))
    print(
        f"encoded {len(pcms)} files, {total} samples in {dt:.3f}s — "
        f"{total / dt / 1e6:.2f} Msamples/s, ratio {coded / max(1, raw):.3f}"
    )
    return 0


def _cmd_batch_decode(args) -> int:
    """Decode many .m4a files in pooled device batches -> .wav files.

    The multi-file production path (batch.decode_files): frames from all
    inputs share device dispatches; --mesh shards the lane axis over
    every local device (multi-chip DP).
    """
    import os

    from .batch import decode_files
    from .pcm import write_wav

    mesh = None
    if args.mesh:
        from .parallel.mesh import make_mesh

        mesh = make_mesh()
    t0 = time.perf_counter()
    results = decode_files(args.paths, strict=not args.lenient, mesh=mesh)
    dt = time.perf_counter() - t0
    total = sum(r.num_samples for r in results)
    bad = sum(len(r.bad_frames) for r in results)
    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)
        used: set[str] = set()
        for r in results:
            stem = os.path.splitext(os.path.basename(r.path))[0]
            name, k = stem + ".wav", 1
            while name in used:  # same basename from different dirs
                name = f"{stem}.{k}.wav"
                k += 1
            used.add(name)
            with open(os.path.join(args.out_dir, name), "wb") as f:
                write_wav(f, r.pcm, r.sample_rate, r.bits_per_sample, r.channels)
    print(
        f"decoded {len(results)} files, {total} samples in {dt:.3f}s — "
        f"{total / dt / 1e6:.2f} Msamples/s"
        + (f", {bad} bad frames skipped" if bad else "")
        + (f", wavs in {args.out_dir}" if args.out_dir else "")
    )
    return 0


def _cmd_verify(args) -> int:
    """Decode, losslessly re-encode, decode again, compare bit-for-bit."""
    import io

    from .batch import decode_file, decode_streams
    from .codec.encoder import EncoderConfig, encode_m4a

    dec = decode_file(args.path)
    buf = io.BytesIO()
    encode_m4a(
        buf,
        dec.pcm.astype(np.int32),
        dec.sample_rate,
        dec.bits_per_sample,
        EncoderConfig(order=args.order),
    )
    buf.seek(0)
    (redec,) = decode_streams([buf])
    ok = np.array_equal(redec.pcm, dec.pcm)
    ratio = buf.getbuffer().nbytes / max(
        1, dec.pcm.size * (dec.bits_per_sample // 8)
    )
    print(
        f"{'OK' if ok else 'MISMATCH'}: {dec.num_samples} samples, "
        f"re-encode ratio {ratio:.3f}"
        + (f", {len(dec.bad_frames)} bad frames" if len(dec.bad_frames) else "")
    )
    return 0 if ok else 1


def _cmd_stats(args) -> int:
    """Decode file(s) and print pipeline counters."""
    from .batch import decode_files
    from .utils.observability import GLOBAL_STATS

    GLOBAL_STATS.reset()
    results = decode_files(args.paths)
    total = sum(r.num_samples for r in results)
    print(json.dumps({"files": len(results), "samples": total,
                      **GLOBAL_STATS.snapshot()}))
    return 0


def _cmd_bench(args) -> int:
    from .bench_lib import (
        gpu_name_and_power_limit, require_gpu, run_benchmark,
        run_e2e_benchmark, run_full_benchmark,
    )

    require_gpu()
    if args.full:
        result = run_full_benchmark(repeats=args.repeats)
    elif args.e2e:
        result = run_e2e_benchmark(repeats=args.repeats)
    else:
        result = run_benchmark(
            batch=args.batch,
            seconds_of_audio=args.seconds,
            bits=args.bits,
            repeats=args.repeats,
            kind=args.kind,
        )
    result["card"] = gpu_name_and_power_limit()
    print(json.dumps(result))
    return 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="alac-tpu",
        description="Batch ALAC codec on JAX (decode/encode/info/bench)",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("info", help="print stream metadata")
    p.add_argument("path")
    p.set_defaults(fn=_cmd_info)

    p = sub.add_parser("decode", help="decode .m4a to .wav")
    p.add_argument("path")
    p.add_argument("output", nargs="?", default=None)
    p.add_argument(
        "--seek-middle",
        action="store_true",
        help="reposition to the stream middle first (demo parity)",
    )
    p.add_argument(
        "--stream",
        type=int,
        nargs="?",
        const=4096,
        default=0,
        metavar="FRAMES",
        help="bounded-memory streaming decode, FRAMES frames per chunk",
    )
    p.set_defaults(fn=_cmd_decode)

    p = sub.add_parser("encode", help="encode .wav to .m4a (lossless)")
    p.add_argument("path")
    p.add_argument("output")
    p.add_argument("--order", type=int, default=6)
    p.add_argument("--bits", type=int, default=0)
    p.add_argument(
        "--device", action="store_true",
        help="run the sequential encode stages batched on the accelerator",
    )
    p.add_argument(
        "--mesh", action="store_true",
        help="DP-shard the encode frames over all visible devices",
    )
    p.set_defaults(fn=_cmd_encode)

    p = sub.add_parser(
        "batch-encode",
        help="encode many .wav files into .m4a in pooled device batches",
    )
    p.add_argument("paths", nargs="+")
    p.add_argument("--out-dir", required=True, help="one .m4a per input")
    p.add_argument("--order", type=int, default=6)
    p.add_argument(
        "--bits", type=int, default=0, help="override the WAV bit depth"
    )
    p.add_argument(
        "--mesh", action="store_true",
        help="DP-shard the pooled frames over every local device",
    )
    p.set_defaults(fn=_cmd_batch_encode)

    p = sub.add_parser(
        "batch-decode",
        help="decode many .m4a files in pooled device batches",
    )
    p.add_argument("paths", nargs="+")
    p.add_argument("--out-dir", default=None, help="write one .wav per input")
    p.add_argument(
        "--lenient", action="store_true",
        help="skip undecodable frames instead of raising",
    )
    p.add_argument(
        "--mesh", action="store_true",
        help="shard batches over every local device (multi-chip DP)",
    )
    p.set_defaults(fn=_cmd_batch_decode)

    p = sub.add_parser(
        "verify", help="decode -> lossless re-encode -> compare bit-for-bit"
    )
    p.add_argument("path")
    p.add_argument("--order", type=int, default=6)
    p.set_defaults(fn=_cmd_verify)

    p = sub.add_parser("stats", help="decode files and print pipeline counters")
    p.add_argument("paths", nargs="+")
    p.set_defaults(fn=_cmd_stats)

    p = sub.add_parser(
        "bench", help="synthetic decode throughput benchmark (GPU only)"
    )
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--seconds", type=float, default=60.0)
    p.add_argument("--bits", type=int, default=16)
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument(
        "--kind",
        default="music",
        help="corpus kind: music|spiky|silence|orders|hires24|fat24",
    )
    p.add_argument(
        "--e2e", action="store_true",
        help="sustained decode_blob pipeline (host parse + H2D + device)",
    )
    p.add_argument(
        "--full", action="store_true",
        help="e2e + per-kind device decode + encode",
    )
    p.set_defaults(fn=_cmd_bench)

    args = ap.parse_args(argv)
    from .utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
