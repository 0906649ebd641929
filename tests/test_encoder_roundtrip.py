"""Differential round-trip: encoder -> container -> scalar oracle -> PCM.

Establishes the corpus-level oracle the JAX device path is tested against
(SURVEY.md §7 step 1: pin bit-exactness before any device work).
"""

import io

import numpy as np
import pytest

from alacnet_tpu.codec.scalar import AlacFrameDecoder
from alacnet_tpu.container import demux

from .corpus import standard_cases


def oracle_decode(data: bytes) -> tuple[np.ndarray, "demux.StreamInfo"]:
    """Decode every frame with the scalar oracle -> (samples, channels)."""
    info = demux.parse(io.BytesIO(data))
    nch = info.num_channels_or_default()
    ss = info.bits_per_sample_or_default()
    dec = AlacFrameDecoder(info.params, nch)
    offsets = info.tables.frame_file_offsets()
    sizes = info.tables.frame_byte_sizes
    durs = info.tables.frame_durations()
    outs = []
    for f in range(info.tables.num_frames):
        payload = data[offsets[f] : offsets[f] + sizes[f]]
        outbuf = [0] * (info.params.max_samples_per_frame * nch * 3)
        dec.decode_frame(payload, outbuf)
        if ss == 16:
            vals = np.array(outbuf[: durs[f] * nch], dtype=np.int32).reshape(-1, nch)
        else:
            b = np.array(outbuf[: durs[f] * nch * 3], dtype=np.int64).reshape(-1, nch, 3)
            vals = b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16)
            vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals).astype(np.int32)
        outs.append(vals)
    return np.concatenate(outs), info


@pytest.mark.parametrize(
    "name,pcm,bits,cfg,mux_kwargs",
    standard_cases(),
    ids=[c[0] for c in standard_cases()],
)
def test_roundtrip_bit_exact(name, pcm, bits, cfg, mux_kwargs):
    from .corpus import encode_to_bytes

    data = encode_to_bytes(pcm, 44100, bits, cfg, **mux_kwargs)
    got, info = oracle_decode(data)
    assert info.sample_rate == 44100
    assert info.sample_size == bits
    src = pcm if pcm.ndim == 2 else pcm[:, None]
    np.testing.assert_array_equal(got, src)


def test_compression_is_real():
    """Compressed frames must actually be smaller than raw PCM."""
    from .corpus import encode_to_bytes, tone

    pcm = tone(4096 * 4, 2, 16)
    data = encode_to_bytes(pcm, 44100, 16)
    assert len(data) < pcm.size * 2 * 0.8


def test_zero_history_kz_quirk_roundtrip():
    """Initial history 0 + a leading zero sample drives the zero-run k
    through clz(0) — 40 in the reference's ladder (AlacFile.cs:190), so
    k=16, not the 8 a plain 32-bit clz would give. Round-trips only if
    encoder, oracle and device decoders all honor the quirk."""
    import dataclasses

    import numpy as np

    from alacnet_tpu.codec.cookie import default_cookie
    from alacnet_tpu.codec.encoder import AlacEncoder, EncoderConfig
    from .corpus import tone

    params = dataclasses.replace(
        default_cookie(44100, 16, 2, max_samples_per_frame=256),
        rice_initial_history=0,
    )
    pcm = tone(256, 2, 16)
    pcm[:4] = 0  # leading zeros with h=0 trigger the kz=clz(0) path
    pcm[100:130] = 0
    enc = AlacEncoder(params, EncoderConfig(order=4))
    payload = enc.encode_frame(pcm)

    # oracle
    from alacnet_tpu.codec.scalar import AlacFrameDecoder

    dec = AlacFrameDecoder(params, 2)
    out = [0] * (256 * 2)
    dec.decode_frame(payload, out)
    np.testing.assert_array_equal(
        np.array(out, np.int32).reshape(-1, 2), pcm
    )

    # device path
    from alacnet_tpu.codec.framemeta_vec import parse_frame_headers_vec
    from alacnet_tpu.parallel.pipeline import decode_frame_batch

    fb = parse_frame_headers_vec([payload], params)
    dev, n = decode_frame_batch(fb, 256)
    np.testing.assert_array_equal(dev[0, : n[0], :2], pcm)
