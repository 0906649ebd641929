"""Device (JAX) batch encoder vs the host encoder: byte equality.

Byte-identical payloads make the device encoder inherit the host
encoder's entire validation pyramid (golden vectors, scalar-oracle round
trips, device decode parity) for free; an extra lossless round trip
through the device decoder closes the loop end-to-end on-device.
"""

import numpy as np
import pytest

from alacnet_tpu.codec.cookie import default_cookie
from alacnet_tpu.codec.encoder import AlacEncoder, EncoderConfig
from alacnet_tpu.codec.encoder_tpu import encode_frames_tpu

from .corpus import tone

S = 256


def _host_payloads(frames, params, cfg):
    enc = AlacEncoder(params, cfg)
    return [enc.encode_frame(f) for f in frames]


CASES = [
    ("stereo16_order6", 16, 2, EncoderConfig(order=6), "music"),
    ("stereo16_order0", 16, 2, EncoderConfig(order=0), "music"),
    ("stereo16_order31", 16, 2, EncoderConfig(order=31), "music"),
    ("stereo16_nodecorr", 16, 2,
     EncoderConfig(order=4, interlacing_leftweight=0), "music"),
    ("mono16_order4", 16, 1, EncoderConfig(order=4), "music"),
    ("stereo24_order4", 24, 2, EncoderConfig(order=4), "music"),
    ("stereo24_extrabits", 24, 2,
     EncoderConfig(order=4, uncompressed_bytes=1), "music"),
    ("silence_zeroruns", 16, 2, EncoderConfig(order=4), "silence"),
    ("noise_escapes", 16, 2, EncoderConfig(order=2), "noise"),
]


def _signal(kind, bits, ch, rng):
    if kind == "music":
        return tone(S * 3 + 57, ch, bits, noise=3000.0 if bits == 24 else 60.0)
    if kind == "silence":
        pcm = np.zeros((S * 3, ch), np.int32)
        pcm[40, 0] = 7
        pcm[500:520] = 3
        return pcm
    lim = 1 << (bits - 1)
    return rng.integers(-lim, lim, (S * 3, ch)).astype(np.int32)


@pytest.mark.parametrize("name,bits,ch,cfg,kind", CASES, ids=[c[0] for c in CASES])
def test_device_encoder_byte_equal(name, bits, ch, cfg, kind, rng):
    params = default_cookie(44100, bits, ch, max_samples_per_frame=S)
    pcm = _signal(kind, bits, ch, rng)
    frames = [pcm[i : i + S] for i in range(0, pcm.shape[0], S)]
    want = _host_payloads(frames, params, cfg)
    got = encode_frames_tpu(frames, params, cfg)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"frame {i}: device payload differs from host"


def test_device_encoder_mixed_batch_roundtrip(rng):
    """Mono + stereo + partial frames in one device batch, decoded back
    bit-exactly by the device decoder."""
    from alacnet_tpu.codec.framemeta_vec import parse_frame_headers_vec
    from alacnet_tpu.parallel.pipeline import decode_frame_batch

    params = default_cookie(44100, 16, 2, max_samples_per_frame=S)
    cfg = EncoderConfig(order=4)
    frames = [
        tone(S, 2, 16, seed=1),
        tone(S // 2 + 9, 2, 16, seed=2),  # partial (hassize)
        tone(S, 1, 16, seed=3),  # mono
        np.zeros((S, 2), np.int32),  # zero runs
    ]
    payloads = encode_frames_tpu(frames, params, cfg)
    fb = parse_frame_headers_vec(payloads, params)
    out, n = decode_frame_batch(fb, S)
    for i, pcm in enumerate(frames):
        nch = pcm.shape[1]
        assert n[i] == pcm.shape[0]
        np.testing.assert_array_equal(out[i, : n[i], :nch], pcm)


def test_zero_run_lengths_matches_walk(rng):
    from alacnet_tpu.ops.encode import zero_run_lengths

    errs = np.zeros((3, 32), np.int32)
    errs[0, [0, 5, 9]] = [3, -1, 2]
    errs[1, :] = 0
    errs[2, 30] = 4
    n = np.array([32, 20, 10], np.int32)
    got = np.asarray(zero_run_lengths(errs, n, 32))
    for b in range(3):
        for i in range(32):
            run = 0
            while i + 1 + run < n[b] and errs[b, i + 1 + run] == 0:
                run += 1
            assert got[b, i] == min(run, 0xFFFF), (b, i)


@pytest.mark.parametrize(
    "name,bits,ch,cfg,kind",
    [c for c in CASES if c[3].uncompressed_bytes == 0],
    ids=[c[0] for c in CASES if c[3].uncompressed_bytes == 0],
)
def test_device_pack_byte_equal(name, bits, ch, cfg, kind, rng, monkeypatch):
    """ALAC_ENC_DEVICE_PACK=1: frame bodies assembled on device
    (ops/encode.pack_frames_device), host only ORs headers — payloads
    byte-identical to the host packer across every ub=0 case
    (silence/zero-run compaction, escapes, mono, partial frames)."""
    monkeypatch.setenv("ALAC_ENC_DEVICE_PACK", "1")
    params = default_cookie(44100, bits, ch, max_samples_per_frame=S)
    pcm = _signal(kind, bits, ch, rng)
    frames = [pcm[i : i + S] for i in range(0, pcm.shape[0], S)]
    want = _host_payloads(frames, params, cfg)
    got = encode_frames_tpu(frames, params, cfg)
    assert got == want


def test_device_pack_extrabits_falls_back(rng, monkeypatch):
    """ub != 0 keeps the host packer under the flag (the device packer
    does not cover the extra-bits plane) — still byte-identical."""
    monkeypatch.setenv("ALAC_ENC_DEVICE_PACK", "1")
    cfg = EncoderConfig(order=4, uncompressed_bytes=1)
    params = default_cookie(44100, 24, 2, max_samples_per_frame=S)
    pcm = _signal("music", 24, 2, rng)
    frames = [pcm[i : i + S] for i in range(0, pcm.shape[0], S)]
    assert encode_frames_tpu(frames, params, cfg) == _host_payloads(
        frames, params, cfg
    )


@pytest.mark.parametrize("impl", ["gather", "scatter"])
def test_pack_frames_device_adversarial_widths(rng, impl):
    """Both device pack formulations against a pure BitWriter on
    synthetic chunk planes: dense 1-bit symbol runs (33+ symbols inside
    one 32-bit output word — the K=34 gather window's worst case),
    zero-width gaps, 96-bit chunks spanning words, mono and partial
    frames."""
    import jax.numpy as jnp

    from alacnet_tpu.ops.encode import (
        pack_frames_device, pack_frames_device_scatter,
    )
    from alacnet_tpu.codec.bitwriter import BitWriter

    pack = pack_frames_device if impl == "gather" else (
        lambda *a, stride_words: pack_frames_device_scatter(
            *a, stride_words=stride_words
        )
    )

    F, S2 = 6, 160
    n = np.array([160, 160, 97, 160, 1, 160], np.int32)
    stereo = np.array([1, 1, 0, 1, 1, 0], bool)
    hbits = np.array([61, 3, 32, 17, 80, 1], np.int32)
    B = 2 * F
    ws = np.zeros((B, S2), np.int8)
    # lane styles: dense 1-bit, mixed, wide 96-bit, sparse with gaps
    ws[0] = 1                                  # 160 one-bit symbols
    ws[1] = rng.integers(0, 12, S2)
    ws[2, ::4] = np.int8(81)                   # max merged width
    ws[3] = rng.integers(0, 3, S2)
    ws[4, 0] = 33
    ws[5] = rng.integers(0, 96, S2) % 33
    for lane in range(6, B):
        ws[lane] = rng.integers(0, 14, S2)
    c0 = np.zeros((B, S2), np.uint32)
    c1 = np.zeros((B, S2), np.uint32)
    c2 = np.zeros((B, S2), np.uint32)
    r = rng.integers(0, 1 << 32, (3, B, S2), dtype=np.uint64).astype(np.uint32)
    w = ws.astype(np.int64)
    c2[:] = np.where(w >= 32, r[2], r[2] & ((1 << np.minimum(w, 31)) - 1))
    wm = np.clip(w - 32, 0, 32)
    c1[:] = np.where(wm >= 32, r[1], r[1] & ((1 << np.minimum(wm, 31)) - 1))
    wh = np.clip(w - 64, 0, 32)
    c0[:] = np.where(wh >= 32, r[0], r[0] & ((1 << np.minimum(wh, 31)) - 1))

    total = hbits.astype(np.int64).copy()
    for f in range(F):
        lanes = [f, F + f] if stereo[f] else [f]
        for lane in lanes:
            total[f] += int(w[lane, : n[f]].sum())
    stride_words = int(total.max()) // 32 + 2
    rows, end_bits = pack(
        jnp.asarray(c0), jnp.asarray(c1), jnp.asarray(c2), jnp.asarray(ws),
        jnp.asarray(n), jnp.asarray(stereo), jnp.asarray(hbits),
        stride_words=stride_words,
    )
    rows, end_bits = np.asarray(rows), np.asarray(end_bits)
    for f in range(F):
        bw = BitWriter()
        rem = int(hbits[f])  # zeroed header prefix
        while rem > 0:
            bw.write(0, min(rem, 32))
            rem -= min(rem, 32)
        for lane in ([f, F + f] if stereo[f] else [f]):
            for i in range(int(n[f])):
                b = int(w[lane, i])
                if b <= 32:
                    bw.write(int(c2[lane, i]), b)
                elif b <= 64:
                    bw.write(int(c1[lane, i]), b - 32)
                    bw.write(int(c2[lane, i]), 32)
                else:
                    bw.write(int(c0[lane, i]), b - 64)
                    bw.write(int(c1[lane, i]), 32)
                    bw.write(int(c2[lane, i]), 32)
        assert int(end_bits[f]) == bw.bitpos, f"frame {f} end_bits"
        ref = bw.getvalue()
        assert rows[f, : len(ref)].tobytes() == ref, f"frame {f} bytes"


def test_device_pack_scatter_impl_byte_equal(rng, monkeypatch):
    """ALAC_ENC_PACK_IMPL=scatter through the full pipeline: payloads
    byte-identical to the host packer."""
    monkeypatch.setenv("ALAC_ENC_DEVICE_PACK", "1")
    monkeypatch.setenv("ALAC_ENC_PACK_IMPL", "scatter")
    params = default_cookie(44100, 16, 2, max_samples_per_frame=S)
    pcm = _signal("silence", 16, 2, rng)
    pcm[: S // 2] = _signal("noise", 16, 2, rng)[: S // 2]
    frames = [pcm[i : i + S] for i in range(0, pcm.shape[0], S)]
    cfg = EncoderConfig(order=4)
    assert encode_frames_tpu(frames, params, cfg) == _host_payloads(
        frames, params, cfg
    )


@pytest.mark.parametrize("impl", ["gather", "scatter"])
def test_device_pack_randomized_sweep(rng, impl, monkeypatch):
    """Randomized property sweep for the device packers through the
    full pipeline: random orders/quants/leftweights, random content
    classes (tonal, noise, silence, tiny), random frame lengths and
    mono/stereo mixes — payloads byte-identical to the host encoder."""
    monkeypatch.setenv("ALAC_ENC_DEVICE_PACK", "1")
    monkeypatch.setenv("ALAC_ENC_PACK_IMPL", impl)
    for trial in range(12):
        order = int(rng.choice([0, 1, 2, 4, 6, 8, 31]))
        lw = int(rng.choice([0, 1, 2, 4]))
        cfg = EncoderConfig(order=order, interlacing_leftweight=lw)
        params = default_cookie(44100, 16, 2, max_samples_per_frame=S)
        frames = []
        for _ in range(int(rng.integers(1, 6))):
            n = int(rng.integers(1, S + 1))
            ch = int(rng.choice([1, 2]))
            kind = rng.random()
            if kind < 0.3:
                pcm = np.zeros((n, ch), np.int32)
                if n > 3:
                    pcm[n // 3, 0] = int(rng.integers(1, 50))
            elif kind < 0.6:
                pcm = rng.integers(-32768, 32767, (n, ch)).astype(np.int32)
            else:
                t = np.arange(n)
                pcm = np.stack(
                    [(3000 * np.sin(t * 0.07 + c)).astype(np.int32)
                     for c in range(ch)], axis=1,
                )
            frames.append(pcm)
        got = encode_frames_tpu(frames, params, cfg)
        want = _host_payloads(frames, params, cfg)
        assert got == want, f"trial {trial} order={order} lw={lw}"
