"""Device pipeline vs source PCM: bit-exactness across the feature matrix.

The corpus round-trips through the scalar oracle are established in
test_encoder_roundtrip.py; here the batched JAX pipeline must reproduce
the same PCM bit-for-bit (SURVEY.md §7 step 3-4).
"""

import io

import numpy as np
import pytest

from alacnet_tpu.batch import decode_streams
from alacnet_tpu.codec.framemeta import parse_frame_headers
from alacnet_tpu.container import demux
from alacnet_tpu.errors import UnsupportedFormatError
from alacnet_tpu.parallel.pipeline import decode_payloads

from .corpus import encode_to_bytes, standard_cases, tone


def device_decode(data: bytes):
    info = demux.parse(io.BytesIO(data))
    offs = info.tables.frame_file_offsets()
    sizes = info.tables.frame_byte_sizes
    payloads = [data[o : o + s] for o, s in zip(offs, sizes)]
    out, n = decode_payloads(
        payloads, info.params, info.params.max_samples_per_frame
    )
    nch = info.num_channels_or_default()
    return np.concatenate([out[f, : n[f], :nch] for f in range(len(payloads))])


@pytest.mark.parametrize(
    "name,pcm,bits,cfg,mux_kwargs",
    standard_cases(),
    ids=[c[0] for c in standard_cases()],
)
def test_device_bit_exact(name, pcm, bits, cfg, mux_kwargs):
    data = encode_to_bytes(pcm, 44100, bits, cfg, **mux_kwargs)
    got = device_decode(data)
    src = pcm if pcm.ndim == 2 else pcm[:, None]
    np.testing.assert_array_equal(got, src)


def test_mixed_file_batch():
    """16/24-bit, mono/stereo frames pooled into one device batch."""
    from alacnet_tpu.codec.encoder import EncoderConfig

    pcm16 = tone(5000, 2, 16)
    pcm24 = tone(6000, 2, 24, noise=3000.0)
    mono = tone(4500, 1, 16, seed=5)
    streams = [
        io.BytesIO(encode_to_bytes(pcm16, 44100, 16, EncoderConfig(order=6))),
        io.BytesIO(
            encode_to_bytes(pcm24, 96000, 24, EncoderConfig(order=4, uncompressed_bytes=1))
        ),
        io.BytesIO(encode_to_bytes(mono, 44100, 16, EncoderConfig(order=31))),
    ]
    results = decode_streams(streams)
    np.testing.assert_array_equal(results[0].pcm, pcm16)
    np.testing.assert_array_equal(results[1].pcm, pcm24)
    np.testing.assert_array_equal(results[2].pcm, mono)
    assert results[1].sample_rate == 96000
    assert results[2].channels == 1


def test_unsupported_prediction_type_raises():
    """ptype != 0 rejected at header parse (AlacFile.cs:650,660)."""
    data = encode_to_bytes(tone(4096 * 2, 2, 16), 44100, 16)
    info = demux.parse(io.BytesIO(data))
    offs = info.tables.frame_file_offsets()
    sizes = info.tables.frame_byte_sizes
    payload = bytearray(data[offs[0] : offs[0] + sizes[0]])
    # Full frame (hassize=0): tag(3)+4+12+hassize(1)+ub(2)+comp(1)+sh(8)+lw(8)
    # = 39 bits; prediction type A is bits 39-42; set to 15.
    payload[4] |= 0b00000001  # bit 39
    payload[5] |= 0b11100000  # bits 40-42
    with pytest.raises(UnsupportedFormatError):
        parse_frame_headers([bytes(payload)], info.params)


def test_unsupported_channel_tag_raises():
    data = encode_to_bytes(tone(3000, 2, 16), 44100, 16)
    info = demux.parse(io.BytesIO(data))
    offs = info.tables.frame_file_offsets()
    payload = bytearray(data[offs[0] : offs[0] + 16])
    payload[0] = 0b01100000  # tag 3
    with pytest.raises(UnsupportedFormatError):
        parse_frame_headers([bytes(payload)], info.params)


def test_forced_fused_pipeline_cpu(monkeypatch):
    """kernel="fused" runs the GPU kernel on the CPU, interpreted, through
    the production pipeline: the extra-bits re-OR, the raw path and
    channel B chaining off channel A's end positions around the kernel.
    """
    from alacnet_tpu.codec.encoder import EncoderConfig
    from alacnet_tpu.config import DEFAULT
    from alacnet_tpu.ops import rice_lpc_kernel as _k

    S = 64  # samples/frame: keeps the interpreted kernel fast
    calls = {"kernel": 0}
    real = _k.rice_lpc

    def spy(*a, **kw):
        calls["kernel"] += 1
        assert kw.get("interpret"), "CPU kernel decode must interpret"
        return real(*a, **kw)

    monkeypatch.setattr(_k, "rice_lpc", spy)
    monkeypatch.setattr(DEFAULT, "kernel", "fused")
    cases = [
        # extra-bits side channel + re-OR around the kernel
        (tone(40 * S, 2, 24, noise=3000.0), 24,
         EncoderConfig(order=4, uncompressed_bytes=1), 96000),
        # stereo 16-bit with a hassize partial tail frame
        (tone(30 * S + 17, 2, 16), 16, EncoderConfig(order=6), 44100),
        # mono: channel B's loop runs zero steps
        (tone(10 * S, 1, 16, seed=5), 16, EncoderConfig(order=31), 44100),
        # raw path: uncompressed frames bypass the kernel
        (tone(8 * S, 2, 16, seed=11), 16,
         EncoderConfig(force_uncompressed=True), 44100),
    ]
    for pcm, bits, cfg, rate in cases:
        data = encode_to_bytes(pcm, rate, bits, cfg, max_samples_per_frame=S)
        got = device_decode(data)
        src = pcm if pcm.ndim == 2 else pcm[:, None]
        np.testing.assert_array_equal(got, src)
    assert calls["kernel"] > 0, "kernel never ran under kernel='fused'"
