"""Device-side row assembly (ops/pack_rows.py) vs a direct NumPy
reference.

The packer replaces the host word packer (`_native/host.cpp:
alac_pack_frames`) on the single-device path: the host ships the raw
coded blob once and the (B, W) word-row table — each row the frame's
bytes as big-endian uint32 words, zero-padded past the frame end
(AlacFile.cs Readbits overrun contract: reads past the end yield zero
bits) — is gathered on-device.  These tests pin the gather to the
reference over randomized offsets/sizes, including the sub-word byte
shifts host_row_params folds into the lanes' start-bit positions.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from alacnet_tpu.ops.pack_rows import (  # noqa: E402
    PAD_WORDS,
    blob_words,
    host_row_params,
    pack_rows as pack_rows_xla,
)

TB = 8  # lanes per test batch


def _ref_rows(
    blob: np.ndarray, ow: np.ndarray, nbytes: np.ndarray, W: int, max_w: int = 0
):
    """NumPy reference: big-endian words from the padded blob, per-lane
    window at word offset ow, bytes at/after nbytes zeroed."""
    n = len(blob)
    nw = -(-n // 4)
    nq = nw + max_w + PAD_WORDS
    padded = np.zeros(nq * 4, np.uint8)
    padded[:n] = blob
    words = (
        (padded[0::4].astype(np.uint32) << 24)
        | (padded[1::4].astype(np.uint32) << 16)
        | (padded[2::4].astype(np.uint32) << 8)
        | padded[3::4].astype(np.uint32)
    )
    out = np.zeros((len(ow), W), np.uint32)
    for b in range(len(ow)):
        row_bytes = np.zeros(W * 4, np.uint8)
        lo = min(int(ow[b]) * 4, nq * 4)
        take = min(max(int(nbytes[b]), 0), W * 4, nq * 4 - lo)
        row_bytes[:take] = padded[lo : lo + take]
        out[b] = (
            (row_bytes[0::4].astype(np.uint32) << 24)
            | (row_bytes[1::4].astype(np.uint32) << 16)
            | (row_bytes[2::4].astype(np.uint32) << 8)
            | row_bytes[3::4].astype(np.uint32)
        )
    return out


def _rand_case(rng, B, W, blob_len):
    blob = rng.integers(0, 256, blob_len, dtype=np.uint8)
    # Word offsets anywhere in the blob, including near the tail (the
    # zero padding past the blob end must read back as zero bits).
    ow = rng.integers(0, max(1, blob_len // 4), B, dtype=np.int32)
    nbytes = rng.integers(0, W * 4 + 1, B, dtype=np.int32)
    return blob, ow, nbytes


class TestPackRowsXla:
    @pytest.mark.parametrize("W", [256, 512, 1536])
    def test_matches_numpy_reference(self, rng, W):
        blob, ow, nbytes = _rand_case(rng, 64, W, 200_000)
        bw = blob_words(np.asarray(blob), max_w=W)
        got = np.asarray(pack_rows_xla(bw, jnp.asarray(ow), jnp.asarray(nbytes), W))
        np.testing.assert_array_equal(got, _ref_rows(blob, ow, nbytes, W, max_w=W))

    def test_tail_frame_in_wide_span(self, rng):
        """Regression: a frame near the blob end gathered into a span
        wider than the blob's remaining bytes must read zero bits past
        the end — NOT a clipped (re-based) window."""
        W = 4096
        blob = rng.integers(0, 256, 40_000, dtype=np.uint8)
        nw = -(-len(blob) // 4)
        ow = np.array([nw - 100, nw - 1, nw - 2048], np.int32)
        nbytes = np.array([400, 4, 8192], np.int32)
        bw = blob_words(np.asarray(blob), max_w=W)
        got = np.asarray(pack_rows_xla(bw, jnp.asarray(ow), jnp.asarray(nbytes), W))
        np.testing.assert_array_equal(got, _ref_rows(blob, ow, nbytes, W, max_w=W))

    @pytest.mark.parametrize("extra", [1, 2, 3])
    def test_blob_tail_bytes_land_in_last_word(self, rng, extra):
        """Blob length % 4 != 0: the <=3 tail bytes must appear
        big-endian-aligned in the word past the uint32 view (the
        host_le_words tail scalar)."""
        blob = rng.integers(0, 256, 4096 + extra, dtype=np.uint8)
        ow = np.zeros(TB, np.int32)
        nbytes = np.full(TB, len(blob), np.int32)
        bw = blob_words(np.asarray(blob), max_w=2048)
        got = np.asarray(pack_rows_xla(bw, jnp.asarray(ow), jnp.asarray(nbytes), 2048))
        np.testing.assert_array_equal(
            got, _ref_rows(blob, ow, nbytes, 2048, max_w=2048)
        )

    def test_zero_nbytes_row_is_all_zero(self, rng):
        blob, ow, nbytes = _rand_case(rng, TB, 256, 8_192)
        nbytes[:] = 0
        bw = blob_words(np.asarray(blob))
        got = np.asarray(pack_rows_xla(bw, jnp.asarray(ow), jnp.asarray(nbytes), 256))
        assert not got.any()

    def test_partial_word_tail_masks_low_bytes(self):
        blob = np.arange(1, 65, dtype=np.uint8)
        bw = blob_words(np.asarray(blob))
        # 6 valid bytes -> word 0 full, word 1 keeps only its top 2 bytes.
        got = np.asarray(
            pack_rows_xla(
                bw, jnp.zeros(TB, jnp.int32), jnp.full(TB, 6, jnp.int32), 256
            )
        )
        assert got[0, 0] == 0x01020304
        assert got[0, 1] == 0x05060000
        assert not got[0, 2:].any()


class TestHostRowParams:
    def test_subword_offsets_bump_bits(self):
        offs = np.array([0, 1, 2, 3, 4, 7, 4097], np.int64)
        sizes = np.array([10, 10, 10, 10, 10, 10, 10], np.int64)
        ow, nbytes, bump = host_row_params(offs, sizes)
        np.testing.assert_array_equal(ow, [0, 0, 0, 0, 1, 1, 1024])
        np.testing.assert_array_equal(bump, [0, 8, 16, 24, 0, 24, 8])
        # nbytes covers the sub-word shift plus the frame's own bytes.
        np.testing.assert_array_equal(nbytes, [10, 11, 12, 13, 10, 13, 11])

    def test_roundtrip_through_packer_matches_host_packer(self, rng):
        """End-to-end: rows gathered at (ow, nbytes) hold exactly the
        frame's bytes at bit position bump, like the host packer's
        byte-aligned rows at bit 0."""
        blob = rng.integers(0, 256, 50_000, dtype=np.uint8)
        sizes = rng.integers(1, 900, 32, dtype=np.int64)
        offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]) + 3  # unaligned
        ow, nbytes, bump = host_row_params(offsets, sizes)
        W = 256
        bw = blob_words(np.asarray(blob))
        rows = np.asarray(
            pack_rows_xla(bw, jnp.asarray(ow), jnp.asarray(nbytes), W)
        )
        row_bytes = (
            rows[:, :, None] >> np.array([24, 16, 8, 0], np.uint32)
        ).astype(np.uint8).reshape(len(ow), -1)
        for b in range(len(ow)):
            sh = bump[b] // 8
            got = row_bytes[b, sh : sh + sizes[b]]
            np.testing.assert_array_equal(
                got, blob[offsets[b] : offsets[b] + sizes[b]]
            )
            # everything past the frame end is zero bits
            assert not row_bytes[b, sh + sizes[b] :].any()
