"""The GPU Rice+LPC decode kernel (ops/rice_lpc_kernel.py) on the Pallas
interpreter, against the XLA scans and the scalar oracle.

Two sets of inputs: the encoder-made feature matrix of
test_device_parity (every case decoded through ``decode_frames`` on the
"interpret" route vs the "scan" route, bit for bit, plus the oracle on
the partial last frame), and hand-crafted payloads for field domains the
encoder never emits (rice modifier 0/7, quant 0/15, orders 0/1/31,
escapes, zero runs, partial and odd-length frames).  The compiled
kernel on a GPU is checked by chip_smoke.py and tests marked ``gpu``.
"""

from __future__ import annotations

import dataclasses
import io

import jax.numpy as jnp
import numpy as np
import pytest

from alacnet_tpu.codec.cookie import default_cookie
from alacnet_tpu.codec.framemeta_vec import parse_frame_headers_vec
from alacnet_tpu.container import demux
from alacnet_tpu.ops.frame_decode import FrameMetaArrays, decode_frames
from alacnet_tpu.parallel.pipeline import span_max_order

from .corpus import encode_to_bytes, standard_cases
from .test_handcrafted import craft_frame, oracle_frame

CASES = [c for c in standard_cases() if c[0] != "stereo24_uncompressed"]


def _routes(payloads, params):
    """decode_frames on the interpreted kernel and on the scans."""
    fb = parse_frame_headers_vec(payloads, params)
    meta = FrameMetaArrays.from_batch(fb)
    words = jnp.asarray(fb.words)
    S = params.max_samples_per_frame
    k_out, k_n = decode_frames(
        words, meta, S, route="interpret", max_order=span_max_order(fb)
    )
    s_out, s_n = decode_frames(words, meta, S, route="scan")
    np.testing.assert_array_equal(np.asarray(k_n), np.asarray(s_n))
    np.testing.assert_array_equal(np.asarray(k_out), np.asarray(s_out))
    return np.asarray(k_out), np.asarray(k_n)


@pytest.mark.parametrize(
    "name,pcm,bits,cfg,mux_kwargs", CASES, ids=[c[0] for c in CASES]
)
def test_kernel_matches_scan_and_oracle(name, pcm, bits, cfg, mux_kwargs):
    data = encode_to_bytes(pcm, 44100, bits, cfg, **mux_kwargs)
    info = demux.parse(io.BytesIO(data))
    offs = info.tables.frame_file_offsets()
    sizes = info.tables.frame_byte_sizes
    payloads = [data[o : o + s] for o, s in zip(offs, sizes)]
    out, n = _routes(payloads, info.params)
    nch = info.num_channels_or_default()
    got = np.concatenate([out[f, : n[f], :nch] for f in range(len(payloads))])
    src = pcm if pcm.ndim == 2 else pcm[:, None]
    np.testing.assert_array_equal(got, src)
    ref = oracle_frame(info.params, payloads[-1], nch)
    np.testing.assert_array_equal(out[-1, : n[-1], :nch], ref)


S = 64


def _errs(rng, n, lo=-40, hi=40):
    return rng.integers(lo, hi, n).astype(np.int64)


def _zero_runs(rng, n):
    e = _errs(rng, n, -3, 4)
    e[5:40] = 0  # a long run: zero-run blocks with nonzero sizes
    return e


#: (id, channels, craft_frame kwargs, error generator) for field domains
#: the encoder never emits.
DOMAINS = [
    ("ricemodifier0", 2, dict(rice_modifier=0, order=2), None),
    ("ricemodifier7", 2, dict(rice_modifier=7, order=1, coefs=(31,)),
     lambda r, n: _errs(r, n, -3000, 3000)),
    ("quant0", 2, dict(order=3, quant=0, coefs=(40, -25, 10)), None),
    ("quant15_order12", 2,
     dict(order=12, quant=15, coefs=tuple(31 - i for i in range(12))),
     lambda r, n: _errs(r, n, -6, 6)),
    ("order0", 2, dict(order=0), None),
    ("order1", 1, dict(order=1, coefs=(500,)), None),
    ("order31", 2, dict(order=31), None),
    ("order30", 1, dict(order=30, coefs=tuple(range(1, 31))),
     lambda r, n: _errs(r, n, -4, 4)),
    ("escapes", 2, dict(order=4), lambda r, n: _errs(r, n, -30000, 30000)),
    ("zero_runs", 2, dict(order=2), _zero_runs),
    ("partial17", 2, dict(order=4, explicit_n=17), None),
    ("odd63_mono", 1, dict(order=6, explicit_n=63), None),
]


@pytest.mark.parametrize(
    "nch,kw,gen", [d[1:] for d in DOMAINS], ids=[d[0] for d in DOMAINS]
)
def test_kernel_handcrafted_domains(nch, kw, gen):
    rng = np.random.default_rng(0xD0)
    params = default_cookie(44100, 16, nch, max_samples_per_frame=S)
    if kw.get("rice_modifier") == 0:
        # history never grows: every sample runs the zero-run block
        # decode with k = clz(0) - 24 = 16 (the clz(0) = 40 quirk)
        params = dataclasses.replace(params, rice_initial_history=0)
    n = kw.get("explicit_n", S)
    gen = gen or _errs
    errs_b = gen(rng, n) if nch == 2 else None
    payload = craft_frame(params, gen(rng, n), errs_b, **kw)
    expect = oracle_frame(params, payload, nch)
    out, got_n = _routes([payload], params)
    assert got_n[0] == expect.shape[0]
    np.testing.assert_array_equal(out[0, : got_n[0], :nch], expect)


@pytest.mark.gpu
def test_compiled_kernel_matches_scan(gpu):
    """The compiled Triton kernel against the scans on the card."""
    from alacnet_tpu.bench_lib import make_corpus_frames

    for kind in ("music", "orders", "fat24"):
        frames, params = make_corpus_frames(num_distinct=64, kind=kind)
        fb = parse_frame_headers_vec(frames, params)
        meta = FrameMetaArrays.from_batch(fb)
        words = jnp.asarray(fb.words)
        S4 = params.max_samples_per_frame
        a = decode_frames(
            words, meta, S4, route="triton", max_order=span_max_order(fb)
        )
        b = decode_frames(words, meta, S4, route="scan")
        np.testing.assert_array_equal(np.asarray(a[0]), np.asarray(b[0]))
        np.testing.assert_array_equal(np.asarray(a[1]), np.asarray(b[1]))
