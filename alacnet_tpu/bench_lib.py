"""Benchmark harness: decode and encode throughput on the accelerator.

Every record names the device it ran on (``device``: platform, kind and
count).  The entry points (``bench.py``, ``alac-tpu bench``) refuse to
run without a GPU; a CPU number is never reported as a device number.
Times are host-clock walls around work that ends in
``block_until_ready``, the first call of each shape excluded (compile
and warm-up are set-up), reported as the median and the minimum of
``repeats`` runs.

  * :func:`run_benchmark` — device stage for one corpus kind: the
    production spans (``plan_blob_batches``), inputs staged on the
    device, each span's decode dispatched and waited on.
  * :func:`run_e2e_benchmark` — ``decode_blob`` end to end over a mixed
    corpus: native header parse, H2D, device decode, PCM consumed on the
    device (``sink=``).
  * :func:`run_encode_benchmark` — ``encode_frames_tpu`` end to end and
    its device stage alone.

Corpus kinds span the decoder's divergence extremes: ``music`` (order-6
adaptive FIR, the common case), ``spiky`` (escape-heavy: low Rice
history + outliers force the 9-ones + raw-rss escape,
AlacFile.cs:196-202), ``silence`` (zero-run blocks, AlacFile.cs:231-249),
``orders`` (orders 0/1/4/8/31 mixed with partial frames), ``hires24``
and ``fat24`` (24-bit with the extra-bits side channel).
"""

from __future__ import annotations

import statistics
import subprocess
import time

import jax
import jax.numpy as jnp
import numpy as np

from .codec.cookie import default_cookie
from .codec.encoder import AlacEncoder, EncoderConfig
from .ops.frame_decode import FrameMetaArrays, decode_frames_packed
from .parallel.pipeline import pad_frame_batch

#: North-star: 1000x realtime, 44.1 kHz stereo (BASELINE.json).
NORTH_STAR_MSAMPLES = 88.2


def device_info() -> dict:
    """The device a result was measured on, as JAX reports it."""
    d = jax.devices()[0]
    return {
        "platform": d.platform,
        "kind": d.device_kind,
        "count": len(jax.devices()),
    }


def gpu_name_and_power_limit() -> str:
    """``name, power.limit`` of the first card, as nvidia-smi reports it
    (a card below its maximum power limit runs slower under load)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({type(e).__name__})"
    return out.strip().splitlines()[0] if out.strip() else "unavailable"


def require_gpu() -> dict:
    """Device info, or SystemExit(2) when JAX finds no GPU: a measurement
    never falls back to the CPU."""
    info = device_info()
    if info["platform"] != "gpu":
        raise SystemExit(
            f"no GPU: JAX's first device is {info['platform']!r} "
            f"({info['kind']}); this measurement runs only on a GPU"
        )
    return info


def _walls(fn, repeats: int) -> list[float]:
    """Seconds per call of ``fn`` (which returns device arrays), after one
    untimed warm-up call."""
    jax.block_until_ready(fn())
    ts = []
    for _ in range(max(1, repeats)):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return ts


def _timing(ts: list[float], samples: int, prefix: str = "") -> dict:
    med = statistics.median(ts)
    return {
        f"{prefix}median_s": med,
        f"{prefix}min_s": min(ts),
        f"{prefix}runs": len(ts),
        f"{prefix}msps": samples / med / 1e6,
    }


CORPUS_KINDS = ("music", "spiky", "silence", "orders", "hires24", "fat24")


def _music_pcm(n: int, bits: int, channels: int, rng) -> np.ndarray:
    t = np.arange(n)
    amp = (1 << (bits - 1)) * 0.12
    chans = []
    for c in range(channels):
        sig = (
            amp * np.sin(t * 0.013 + c)
            + 0.5 * amp * np.sin(t * 0.0913 + 2.7 * c)
            + 0.1 * amp * np.sin(t * 0.537)
            + rng.normal(0, amp * 0.01, n)
        )
        chans.append(sig)
    lim = 1 << (bits - 1)
    return np.clip(np.stack(chans, axis=1), -lim, lim - 1).astype(np.int32)


def make_kind_frames(
    kind: str,
    num_distinct: int,
    frame_samples: int,
    params,
    bits: int = 16,
    channels: int = 2,
    seed: int = 42,
) -> list[bytes]:
    """Encode ``num_distinct`` distinct frames of one corpus kind."""
    rng = np.random.default_rng(seed)
    n = num_distinct * frame_samples
    lim = 1 << (bits - 1)
    if kind == "music":
        pcm = _music_pcm(n, bits, channels, rng)
        orders, sizes = [6], [frame_samples]
    elif kind == "spiky":
        # Mostly-small residuals keep Rice history (and k) low; outlier
        # spikes then overflow the unary budget -> escape path.
        pcm = rng.integers(-40, 40, (n, channels)).astype(np.int32)
        spikes = rng.random((n, channels)) < 0.01
        pcm = np.where(
            spikes, rng.integers(-lim, lim, (n, channels)), pcm
        ).astype(np.int32)
        orders, sizes = [4], [frame_samples]
    elif kind == "silence":
        pcm = np.zeros((n, channels), np.int32)
        idx = rng.integers(0, n, max(1, n // 2048))
        pcm[idx, 0] = rng.integers(1, 1000, idx.size)
        orders, sizes = [4], [frame_samples]
    elif kind == "hires24":
        # 24-bit content with ~9 bits of unpredictable low-order
        # content: realistic 24/96 material compresses to ~50-60%.
        pcm = _music_pcm(n, 24, channels, rng)
        pcm = np.clip(
            pcm + rng.integers(-400, 400, pcm.shape),
            -(1 << 23), (1 << 23) - 1,
        ).astype(np.int32)
        orders, sizes = [6], [frame_samples]
        # ub=1 extra-bits is how real encoders handle 24-bit (the 16-bit
        # coef grid can't predict a 24-bit-scale signal below ~2^13
        # residuals; the low byte rides the raw side channel instead):
        # ~17 KB coded frames.
        encs = [AlacEncoder(params, EncoderConfig(order=o, uncompressed_bytes=1))
                for o in orders]
        payloads = []
        pos = 0
        for i in range(num_distinct):
            payloads.append(encs[i % len(encs)].encode_frame(
                pcm[pos : pos + frame_samples]))
            pos = (pos + frame_samples) % (n - frame_samples + 1)
        return payloads
    elif kind == "fat24":
        # The worst legal ALAC frame shape: near-white 24-bit noise with
        # the ub=1 extra-bits side channel — ~28-33 KB coded.
        pcm = rng.integers(-(1 << 23), 1 << 23, (n, channels)).astype(np.int32)
        enc = AlacEncoder(params, EncoderConfig(order=6, uncompressed_bytes=1))
        return [
            enc.encode_frame(pcm[i * frame_samples : (i + 1) * frame_samples])
            for i in range(num_distinct)
        ]
    elif kind == "orders":
        # Quiet content: order-0 passthrough codes the raw residual, so
        # loud PCM would produce pathological frame sizes no real encoder
        # emits (it would pick a higher order or a raw frame instead).
        pcm = (_music_pcm(n, bits, channels, rng) / 64).astype(np.int32)
        orders = [0, 1, 4, 8, 31]
        sizes = [frame_samples, frame_samples // 2, frame_samples // 4]
    else:
        raise ValueError(f"unknown corpus kind {kind!r}")
    payloads = []
    encs = [AlacEncoder(params, EncoderConfig(order=o)) for o in orders]
    pos = 0
    for i in range(num_distinct):
        sz = sizes[i % len(sizes)]
        if pos + sz > n:
            pos = 0
        payloads.append(encs[i % len(encs)].encode_frame(pcm[pos : pos + sz]))
        pos += sz
    return payloads


def make_corpus_frames(
    num_distinct: int = 32,
    frame_samples: int = 4096,
    bits: int = 16,
    channels: int = 2,
    order: int = 6,
    seed: int = 42,
    kind: str = "music",
) -> tuple[list[bytes], "object"]:
    """Encode ``num_distinct`` frames of one kind; returns (payloads, params)."""
    if kind in ("hires24", "fat24"):
        bits = 24
    params = default_cookie(96000 if bits == 24 else 44100, bits, channels, frame_samples)
    if kind == "music" and order != 6:
        rng = np.random.default_rng(seed)
        pcm = _music_pcm(num_distinct * frame_samples, bits, channels, rng)
        enc = AlacEncoder(params, EncoderConfig(order=order))
        return [
            enc.encode_frame(pcm[i * frame_samples : (i + 1) * frame_samples])
            for i in range(num_distinct)
        ], params
    return (
        make_kind_frames(
            kind, num_distinct, frame_samples, params, bits, channels, seed
        ),
        params,
    )


def _staged_spans(blob, offsets, sizes, params, batch_limit: int):
    """The production spans of a corpus (plan_blob_batches order, host
    word packing), staged on the device: a list of
    (words, packed_meta, max_order, samples)."""
    from .parallel.pipeline import plan_blob_batches, span_max_order

    perm, _, spans, span_batch = plan_blob_batches(
        blob, offsets, sizes, params, batch_limit, strict=True
    )
    staged = []
    for lo, hi in spans:
        fb = pad_frame_batch(span_batch(perm[lo:hi]))
        staged.append((
            jnp.asarray(fb.words), jnp.asarray(FrameMetaArrays.pack_host(fb)),
            span_max_order(fb),
            int(np.clip(fb.n_samples[: hi - lo], 0, None).sum()),
        ))
    jax.block_until_ready([s[:2] for s in staged])
    return staged


def _corpus_blob(payloads):
    sizes = np.array([len(p) for p in payloads], np.int64)
    offsets = np.concatenate(([0], np.cumsum(sizes)))[:-1]
    return np.frombuffer(b"".join(payloads), np.uint8), offsets, sizes


def run_benchmark(
    batch: int = 4096,
    seconds_of_audio: float | None = None,
    bits: int = 16,
    channels: int = 2,
    frame_samples: int = 4096,
    repeats: int = 3,
    kind: str = "music",
    route: str | None = None,
) -> dict:
    """Device-stage decode throughput for one corpus kind.

    ``route`` (ops/route.py) defaults to the platform's route; every
    span's output is checked bit for bit against the XLA scan route.
    """
    from .ops.route import decode_route

    if seconds_of_audio:
        batch = max(1, int(seconds_of_audio * 44100 / frame_samples))
    distinct, params = make_corpus_frames(
        num_distinct=min(batch, 32), frame_samples=frame_samples,
        bits=bits, channels=channels, kind=kind,
    )
    bits = params.sample_size  # 24-bit kinds override the argument
    payloads = [distinct[i % len(distinct)] for i in range(batch)]
    route = route or decode_route()
    staged = _staged_spans(*_corpus_blob(payloads), params, batch)
    samples = sum(s[3] for s in staged)

    def run():
        return [
            decode_frames_packed(w, m, frame_samples, route=route, max_order=mo)
            for w, m, mo, _ in staged
        ]

    ts = _walls(run, repeats)
    parity_ok = True
    for (w, m, mo, _), (out, n) in zip(staged, run()):
        ref, ref_n = decode_frames_packed(w, m, frame_samples, route="scan")
        parity_ok = parity_ok and bool(
            jnp.array_equal(out, ref) & jnp.array_equal(n, ref_n)
        )
    t = _timing(ts, samples)
    return {
        "metric": "device decode throughput (%d-bit %dch, %s corpus)"
        % (bits, channels, kind),
        "value": round(t["msps"], 3),
        "unit": "Msamples/s",
        "vs_baseline": round(t["msps"] / NORTH_STAR_MSAMPLES, 4),
        **t,
        "batch_frames": batch,
        "spans": len(staged),
        "samples": samples,
        "route": route,
        "parity_ok": parity_ok,
        "device": device_info(),
    }


def _mixed_pool(
    frame_samples: int, bits: int, distinct_per_kind: int = 12, seed: int = 7
):
    """Distinct frames across all corpus kinds + their params."""
    params = default_cookie(44100, bits, 2, frame_samples)
    pool = []
    kinds = [k for k in CORPUS_KINDS if k not in ("hires24", "fat24")]  # single cookie
    for k, kind in enumerate(kinds):
        pool.extend(
            make_kind_frames(
                kind, distinct_per_kind, frame_samples, params, bits,
                seed=seed + 13 * k,
            )
        )
    return pool, params


def run_e2e_benchmark(
    total_frames: int = 3 * 4096,
    frame_samples: int = 4096,
    bits: int = 16,
    batch_limit: int | None = None,
    repeats: int = 3,
    seed: int = 7,
) -> dict:
    """``decode_blob`` end to end over a mixed corpus, PCM consumed on
    the device (``sink=``).  The wall covers the native header parse,
    planning, H2D, every dispatch and the device decode; the host stage
    (parse + planning + packing, no device work) is timed alone beside
    it."""
    from .config import DEFAULT
    from .parallel.pipeline import decode_blob, plan_blob_batches

    if batch_limit is None:
        batch_limit = DEFAULT.batch_limit
    pool, params = _mixed_pool(frame_samples, bits, seed=seed)
    rng = np.random.default_rng(seed)
    idx = rng.permutation(
        np.repeat(np.arange(len(pool)), -(-total_frames // len(pool)))[
            :total_frames
        ]
    )
    blob, offsets, sizes = _corpus_blob([pool[i] for i in idx])

    @jax.jit
    def _account(n, acc):
        return acc + jnp.sum(n)

    total = {"n": 0}

    def run():
        acc = {"n": jnp.zeros((), jnp.int32)}

        def sink(out, n, orig_b):
            acc["n"] = _account(n[:orig_b], acc["n"])

        _, _, status = decode_blob(
            blob, offsets, sizes, params, frame_samples,
            batch_limit=batch_limit, sink=sink,
        )
        assert not status.any(), "bench corpus must parse cleanly"
        return acc["n"]

    ts = _walls(run, repeats)
    total["n"] = int(run())

    def host_stage():
        perm, _, spans, span_batch = plan_blob_batches(
            blob, offsets, sizes, params, batch_limit, strict=True
        )
        for lo, hi in spans:
            fb = span_batch(perm[lo:hi], device_rows=DEFAULT.device_pack)
            if DEFAULT.device_pack:
                fb = fb[0]
            FrameMetaArrays.pack_host(pad_frame_batch(fb))

    host = []
    for _ in range(max(1, repeats)):
        t0 = time.perf_counter()
        host_stage()
        host.append(time.perf_counter() - t0)
    t = _timing(ts, total["n"])
    return {
        "metric": "decode_blob end to end, mixed corpus",
        "value": round(t["msps"], 3),
        "unit": "Msamples/s",
        "vs_baseline": round(t["msps"] / NORTH_STAR_MSAMPLES, 4),
        **t,
        **_timing(host, total["n"], "host_"),
        "total_frames": total_frames,
        "total_samples": total["n"],
        "batch_limit": batch_limit,
        "device_pack": DEFAULT.device_pack,
        "native_parser": _native_available(),
        "device": device_info(),
    }


def _native_available() -> bool:
    from . import native

    return native.available()


def run_full_benchmark(repeats: int = 3) -> dict:
    """End-to-end decode, per-kind device decode and encode, one record."""
    e2e = run_e2e_benchmark(repeats=repeats)
    kinds = {}
    parity = True
    for kind in CORPUS_KINDS:
        r = run_benchmark(batch=4096, repeats=repeats, kind=kind)
        kinds[kind] = r["value"]
        parity = parity and r["parity_ok"]
    enc = run_encode_benchmark(repeats=repeats)
    return {
        **e2e,
        "device_msps_by_kind": kinds,
        "device_msps_harmonic_mean": round(
            statistics.harmonic_mean(kinds.values()), 3
        ),
        "encode": enc,
        "parity_ok": parity,
    }


def run_encode_benchmark(
    num_frames: int = 2048,
    frame_samples: int = 4096,
    bits: int = 16,
    repeats: int = 3,
    seed: int = 9,
) -> dict:
    """Device encoder throughput: ``encode_frames_tpu`` end to end (host
    prep, device stages, host pack, pipelined) and the device stage of
    one prepared batch alone."""
    from .codec.encoder_tpu import _dispatch, _prep, encode_frames_tpu

    rng = np.random.default_rng(seed)
    S, F = frame_samples, num_frames
    pcm = _music_pcm(F * S, bits, 2, rng).reshape(F, S, 2)
    params = default_cookie(44100, bits, 2, S)
    cfg = EncoderConfig(order=6)
    e2e = _walls(lambda: encode_frames_tpu(pcm, params, cfg), repeats)
    prep = _prep(pcm, params, cfg, AlacEncoder(params, cfg))
    dev = _walls(lambda: _dispatch(prep, params, cfg), repeats)
    return {
        "metric": "device encode end to end (%d-bit stereo music)" % bits,
        **_timing(e2e, F * S),
        **_timing(dev, F * S, "device_"),
        "frames": F,
        "device": device_info(),
    }
