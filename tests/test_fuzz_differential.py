"""Decoder-first randomized differential fuzz (VERDICT r2 next #4).

Every e2e input elsewhere in the suite is encoder-produced or
hand-crafted, so a *shared* encoder/decoder misunderstanding could
survive.  This suite closes that loophole as far as the offline
environment allows: thousands of payloads with structurally valid
headers and ARBITRARY random entropy bodies must decode bit-identically
through all three decoder implementations —

    scalar oracle (codec/scalar.py, the AlacFile.cs transcription)
        == XLA scan path (ops/rice.py + ops/lpc.py via decode_frames)
        == fused Rice+LPC GPU kernel (ops/rice_lpc_kernel.py, on the
           Pallas interpreter; compiled parity is chip_smoke.py's).

Random bodies drive the decoder through every entropy shape the state
machine can reach — escapes, zero-runs with arbitrary block sizes,
k ladders, bit-reservoir overruns past the payload end (zero-fill
semantics, AlacFile.cs:101-105) — unconstrained by what our encoder
chooses to emit.
"""

from __future__ import annotations

import numpy as np
import pytest

import jax.numpy as jnp

from alacnet_tpu.codec.bitwriter import BitWriter
from alacnet_tpu.codec.cookie import default_cookie
from alacnet_tpu.codec.framemeta_vec import parse_frame_headers_vec
from alacnet_tpu.ops.frame_decode import FrameMetaArrays, decode_frames

from .test_handcrafted import oracle_frame

S = 64  # samples/frame: keeps the oracle (Python) fast at fuzz scale
ORDERS = (0, 1, 2, 4, 6, 8, 31)
QUANTS = (2, 9, 15)


def _random_payload(rng, params, bits: int):
    """Structurally valid compressed-frame header + random entropy body.

    Returns (payload bytes, nch).
    """
    stereo = rng.random() < 0.7
    nch = 2 if stereo else 1
    order = int(rng.choice(ORDERS))
    quant = int(rng.choice(QUANTS))
    hassize = rng.random() < 0.3
    n = int(rng.integers(1, S + 1)) if hassize else S
    ub = int(rng.integers(0, 2)) if bits == 24 else 0

    w = BitWriter()
    w.write(1 if stereo else 0, 3)
    w.write(0, 4)
    w.write(0, 12)
    w.write(1 if hassize else 0, 1)
    w.write(ub, 2)
    w.write(0, 1)  # compressed
    if hassize:
        w.write(n, 32)
    if stereo:
        w.write(int(rng.integers(0, 16)), 8)  # interlacing_shift
        w.write(int(rng.integers(0, 8)), 8)  # interlacing_leftweight
    else:
        w.write(0, 16)
    for _ in range(nch):
        w.write(0, 4)  # prediction type 0 (the only device-path type)
        w.write(quant, 4)
        w.write(int(rng.integers(0, 8)), 3)  # rice modifier
        w.write(order, 5)
        count = 31 if order == 31 else order
        for _ in range(count):
            w.write(int(rng.integers(0, 1 << 16)), 16)
    header = w.getvalue()
    # Arbitrary entropy body (covers the extra-bits section too when
    # ub > 0); lengths span from heavily truncated (reservoir overrun ->
    # zero-fill) to oversized.
    body_len = int(rng.integers(0, 3 * S))
    return header + rng.bytes(body_len), nch


@pytest.mark.parametrize("bits,count,seed", [(16, 1536, 101), (24, 768, 202)])
def test_randomized_differential_fuzz(bits, count, seed):
    rng = np.random.default_rng(seed)
    params = default_cookie(
        96000 if bits == 24 else 44100, bits, 2, max_samples_per_frame=S
    )
    payloads, nchs = [], []
    for _ in range(count):
        p, nch = _random_payload(rng, params, bits)
        payloads.append(p)
        nchs.append(nch)

    # ---- XLA batched decode vs the scalar oracle, per lane ----
    fb = parse_frame_headers_vec(payloads, params)
    assert not fb.status.any(), "fuzz headers must parse cleanly"
    meta = FrameMetaArrays.from_batch(fb)
    out_d, n_d = decode_frames(jnp.asarray(fb.words), meta, S)
    out = np.asarray(out_d)
    n_lanes = np.asarray(n_d)
    for i, (p, nch) in enumerate(zip(payloads, nchs)):
        expect = oracle_frame(params, p, nch)
        assert n_lanes[i] == expect.shape[0], f"lane {i}: n mismatch"
        np.testing.assert_array_equal(
            out[i, : expect.shape[0], :nch], expect, err_msg=f"lane {i}"
        )

    # ---- GPU kernel (interpreted) vs XLA scan, all lanes at once ----
    got, got_n = decode_frames(
        jnp.asarray(fb.words), meta, S, route="interpret", max_order=8
    )
    np.testing.assert_array_equal(np.asarray(got), out)
    np.testing.assert_array_equal(np.asarray(got_n), n_lanes)
