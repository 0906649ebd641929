"""The XLA bit gathers that stay on every platform: the affine extra-bits
and raw-PCM extractions (ops/frame_decode.py) against a NumPy bit
reader, and the scans' 4-word window fetch (ops/bitreader.py) against
the one-hot masked-reduction formulation it replaced."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from alacnet_tpu.ops.bitreader import WINDOW_WORDS, gather_window
from alacnet_tpu.ops.frame_decode import FrameMetaArrays, _extra_bits, _raw_pcm

B, W, S = 6, 96, 40


def _read_bits(words: np.ndarray, pos: int, n: int) -> int:
    """MSB-first read of ``n`` bits at bit ``pos`` of big-endian words."""
    v = 0
    for k in range(n):
        p = pos + k
        v = (v << 1) | ((int(words[p >> 5]) >> (31 - (p & 31))) & 1)
    return v


def _meta(**fields) -> FrameMetaArrays:
    z = np.zeros(B, np.int32)
    base = dict(
        is_stereo=np.zeros(B, bool), is_compressed=np.ones(B, bool),
        n_samples=np.full(B, S, np.int32), sample_size=np.full(B, 16, np.int32),
        ub=z, rss=z, interlacing_shift=z, interlacing_leftweight=z,
        payload_pos=z, entropy_pos=z, order=np.zeros((B, 2), np.int32),
        quant=np.zeros((B, 2), np.int32), rice_mult=np.zeros((B, 2), np.int32),
        rc=np.zeros((B, 2, 32), np.int32), kmod=z, init_history=z, kmask=z,
    )
    base.update(fields)
    return FrameMetaArrays(**{k: jnp.asarray(v) for k, v in base.items()})


@pytest.fixture
def words(rng):
    return rng.integers(0, 1 << 32, (B, W), dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("bits,nch", [(16, 1), (16, 2), (24, 1), (24, 2)])
def test_raw_pcm_matches_bit_reader(words, rng, bits, nch):
    pos0 = rng.integers(0, 64, B).astype(np.int32)
    m = _meta(
        is_stereo=np.full(B, nch == 2), is_compressed=np.zeros(B, bool),
        sample_size=np.full(B, bits, np.int32), payload_pos=pos0,
    )
    got_a, got_b = (np.asarray(x) for x in _raw_pcm(jnp.asarray(words), m, S))
    for b in range(B):
        for i in range(S):
            for c, got in ((0, got_a), (1, got_b)):
                v = _read_bits(words[b], int(pos0[b]) + (i * nch + c) * bits, bits)
                v -= (v >> (bits - 1)) << bits  # sign-extend
                assert got[b, i] == v, (b, i, c)


@pytest.mark.parametrize("ub,nch", [(1, 1), (1, 2), (2, 2)])
def test_extra_bits_match_bit_reader(words, rng, ub, nch):
    pos0 = rng.integers(0, 64, B).astype(np.int32)
    ubs = np.full(B, ub, np.int32)
    ubs[0] = 0  # a lane without the side channel reads zeros
    m = _meta(is_stereo=np.full(B, nch == 2), ub=ubs, payload_pos=pos0)
    got_a, got_b = (np.asarray(x) for x in _extra_bits(jnp.asarray(words), m, S))
    assert not got_a[0].any() and not got_b[0].any()
    nb = 8 * ub
    for b in range(1, B):
        for i in range(S):
            a = _read_bits(words[b], int(pos0[b]) + i * nb * nch, nb)
            assert got_a[b, i] == a, (b, i)
            if nch == 2:
                bb = _read_bits(words[b], int(pos0[b]) + (i * 2 + 1) * nb, nb)
                assert got_b[b, i] == bb, (b, i)
            else:
                assert got_b[b, i] == 0


def _onehot_window(words, bitpos):
    """The masked-reduction fetch: one sweep over the whole row per word."""
    w = jnp.clip(bitpos >> 5, 0, words.shape[1] - WINDOW_WORDS)
    iota = jax.lax.broadcasted_iota(jnp.int32, words.shape, 1)
    rel = iota - w[:, None]
    win = tuple(
        jnp.sum(jnp.where(rel == k, words, 0), axis=1).astype(jnp.uint32)
        for k in range(WINDOW_WORDS)
    )
    return win, bitpos & 31


@pytest.mark.parametrize("near_end", [False, True])
def test_gather_window_matches_onehot(words, rng, near_end):
    """take_along_axis fetch == one-hot sweep, including cursors past the
    last full window (both clamp to the row's last four words)."""
    hi = W * 32 + (200 if near_end else 0)
    lo = (W - 6) * 32 if near_end else 0
    for _ in range(4):
        pos = jnp.asarray(rng.integers(lo, hi, B).astype(np.int32))
        got, sh = gather_window(jnp.asarray(words), pos)
        want, sh_w = _onehot_window(jnp.asarray(words), pos)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
        np.testing.assert_array_equal(np.asarray(sh), np.asarray(sh_w))
