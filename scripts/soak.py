"""Soak test: encode a mixed-format synthetic album, batch-decode it,
verify every file bit-exactly, and report pipeline throughput.

    python scripts/soak.py [--minutes 10] [--outdir /tmp/alac_soak] [--out x.json]

Exercises the full production path end to end: DEVICE encoder (XLA
automatons + native chunk packer) byte-checked against the host
encoder per file -> muxer -> demux -> pooled batched device decode
(the platform's route, ops/route.py) -> ragged assembly, across 16/24-bit,
mono/stereo, multiple rates and predictor orders, mdat-first layouts
and chunk gaps.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np

import alacnet_tpu
from alacnet_tpu.codec.encoder import EncoderConfig
from alacnet_tpu.utils.observability import GLOBAL_STATS


def synth(n: int, channels: int, bits: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(n, dtype=np.float64)
    amp = (1 << (bits - 1)) * 0.15
    f = 0.003 + 0.0005 * np.sin(t * 3e-5 + seed)
    chans = []
    for c in range(channels):
        sig = (
            amp * np.sin(np.cumsum(f) + c)
            + 0.4 * amp * np.sin(np.cumsum(2.1 * f))
            + rng.normal(0, amp * 0.015, n)
        )
        chans.append(sig)
    lim = 1 << (bits - 1)
    return np.clip(np.stack(chans, 1), -lim, lim - 1).astype(np.int32)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--minutes", type=float, default=10.0)
    ap.add_argument("--outdir", default="/tmp/alac_soak")
    ap.add_argument("--out", default=None, help="write a JSON artifact")
    args = ap.parse_args()
    os.makedirs(args.outdir, exist_ok=True)

    specs = [
        ("t16s_o6", 44100, 16, 2, EncoderConfig(order=6), {}),
        ("t16m_o31", 44100, 16, 1, EncoderConfig(order=31), {}),
        ("t24s_eb", 96000, 24, 2, EncoderConfig(order=4, uncompressed_bytes=1), {}),
        ("t16s_mdat1", 48000, 16, 2, EncoderConfig(order=8), {"mdat_first": True}),
        ("t16s_gap", 44100, 16, 2, EncoderConfig(order=2), {"chunk_gap": 64}),
        ("t24s_o6", 44100, 24, 2, EncoderConfig(order=6), {}),
    ]
    per_file = int(args.minutes * 60 / len(specs))
    paths, sources = [], []
    enc_match = True
    t0 = time.time()
    dev_s = 0.0
    for i, (name, rate, bits, ch, cfg, kw) in enumerate(specs):
        pcm = synth(rate * per_file, ch, bits, seed=i)
        path = os.path.join(args.outdir, f"{name}.m4a")
        # Device pipeline (XLA automatons + native packer) ...
        td = time.time()
        buf = io.BytesIO()
        alacnet_tpu.encode_m4a(buf, pcm, rate, bits, cfg, device=True, **kw)
        dev_s += time.time() - td
        # ... byte-checked against the host encoder on the same PCM.
        want = io.BytesIO()
        alacnet_tpu.encode_m4a(want, pcm, rate, bits, cfg, **kw)
        if buf.getvalue() != want.getvalue():
            enc_match = False
            print(f"ENCODER MISMATCH: {name}")
        with open(path, "wb") as f:
            f.write(buf.getvalue())
        paths.append(path)
        sources.append(pcm)
    enc_s = time.time() - t0
    total = sum(p.shape[0] for p in sources)
    print(
        f"encoded {total} samples across {len(paths)} files in {enc_s:.1f}s "
        f"(device leg {dev_s:.1f}s, host==device bytes: {enc_match})"
    )

    GLOBAL_STATS.reset()
    t0 = time.time()
    results = alacnet_tpu.decode_files(paths)
    dec_s = time.time() - t0
    ok = all(
        np.array_equal(r.pcm, src) for r, src in zip(results, sources)
    )
    print(
        f"decoded in {dec_s:.2f}s end-to-end "
        f"({total / dec_s / 1e6:.1f} Msamples/s incl host+IO) "
        f"bit_exact={ok}"
    )
    print("stats:", GLOBAL_STATS.snapshot())
    if args.out:
        with open(args.out, "w") as f:
            json.dump(
                {
                    "device": __import__(
                        "alacnet_tpu.bench_lib", fromlist=["device_info"]
                    ).device_info(),
                    "minutes": args.minutes,
                    "files": len(paths),
                    "total_samples": int(total),
                    "encode_s": round(enc_s, 2),
                    "encode_device_s": round(dev_s, 2),
                    "encode_host_device_bytes_equal": bool(enc_match),
                    "decode_s": round(dec_s, 2),
                    "decode_msps_incl_host_io": round(total / dec_s / 1e6, 1),
                    "decode_bit_exact": bool(ok),
                    "all_ok": bool(ok and enc_match),
                    "note": (
                        "correctness soak: its walls include file I/O and"
                        " host work and are not benchmark numbers"
                    ),
                },
                f, indent=1,
            )
            f.write("\n")
        print(f"wrote {args.out}")
    return 0 if (ok and enc_match) else 1


if __name__ == "__main__":
    raise SystemExit(main())
