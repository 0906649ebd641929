"""Device-side row assembly: build the (B, W) word-row table from the raw
coded blob on the device.

The host word packer (`_native/host.cpp:alac_pack_frames`) ships a padded
(B, W) grid, about twice the coded bytes.  Here the host ships the raw
contiguous blob once and the rows are gathered on the device:

1. ``blob_words``: one pass turns the byte blob into big-endian uint32
   words, the bit reader's word domain (the reference reads an MSB-first
   byte stream, AlacFile.cs:101-129).
2. ``pack_rows``: per lane, the ``W`` words starting at word ``ow[b]``,
   with every byte at/after the frame's end (``nbytes[b]``) zeroed: the
   bit reader's overrun contract is "reads past the end return zero
   bits" (codec/scalar.py BitReader).

A frame's first byte may sit anywhere in a word: the caller keeps
``ow = byte_offset >> 2`` and adds ``8 * (byte_offset & 3)`` to the
lane's start bit position (``host_row_params``).  Bytes before the frame
inside word ``ow`` belong to the previous frame and are never read.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

I32 = jnp.int32
U32 = jnp.uint32

#: Zero words appended past the blob beyond the widest row: any row
#: starting at or before the blob's last word then reads zeros past the
#: end instead of a clipped (re-based) window.
PAD_WORDS = 2048


def host_le_words(
    blob_u8: np.ndarray, max_w: int = 0
) -> tuple[np.ndarray, int, int]:
    """Host half of ``blob_words``: a zero-copy little-endian uint32 view
    of the blob, the <=3 tail bytes folded into one big-endian word, and
    the padded word count (``max_w``: the widest row any caller gathers).
    """
    blob_u8 = np.asarray(blob_u8, dtype=np.uint8)
    n = blob_u8.shape[0]
    n4 = (n // 4) * 4
    head = blob_u8[:n4]
    if not (head.flags.c_contiguous and head.flags.aligned):
        head = np.ascontiguousarray(head)
    try:
        w32 = head.view(np.uint32)
    except ValueError:  # misaligned base (offset slice into a buffer)
        w32 = np.frombuffer(head.tobytes(), np.uint32)
    tail_be = 0
    for i, b in enumerate(blob_u8[n4:]):
        tail_be |= int(b) << (24 - 8 * i)
    return w32, tail_be, -(-n // 4) + max_w + PAD_WORDS


@functools.partial(jax.jit, static_argnames=("total",))
def _words_from_le(w32: jax.Array, tail_be: jax.Array, total: int) -> jax.Array:
    """Device half of ``blob_words``: byteswap LE->BE and zero-pad to
    ``total`` words.  The tail word (blob length % 4) lands at the first
    padding slot; without a tail the caller passes 0."""
    x = w32.astype(U32)
    be = (
        ((x & 0xFF) << 24)
        | ((x & 0xFF00) << 8)
        | ((x >> 8) & 0xFF00)
        | (x >> 24)
    )
    out = jnp.zeros((total,), U32).at[: x.shape[0]].set(be)
    return out.at[x.shape[0]].set(tail_be.astype(U32))


def blob_words(
    blob_u8: np.ndarray, max_w: int = 0, sharding=None
) -> jax.Array:
    """Byte blob -> 1-D big-endian uint32 words on the device, padded
    with zeros past any row of up to ``max_w`` words.  ``sharding``
    places the host words straight where they go (e.g. replicated over
    a mesh), so nothing lands on the default device first."""
    w32, tail_be, total = host_le_words(blob_u8, max_w)
    return _words_from_le(
        jax.device_put(w32, sharding), np.uint32(tail_be), total
    )


def _mask_tail(rows: jax.Array, nbytes: jax.Array) -> jax.Array:
    """Zero every byte of big-endian ``rows`` (B, W) at/after the
    per-lane byte count ``nbytes`` (B, 1)."""
    j = jax.lax.broadcasted_iota(I32, rows.shape, 1)
    nb = jnp.clip(nbytes - 4 * j, 0, 4)
    # nb == 4 keeps the word, nb == 0 zeroes it, else keep the top nb bytes.
    ones = jnp.full(rows.shape, 0xFFFFFFFF, U32)
    mask = jnp.where(
        nb >= 4, ones,
        jnp.where(nb <= 0, jnp.zeros_like(ones), ones << ((4 - nb) * 8).astype(U32)),
    )
    return rows & mask


@functools.partial(jax.jit, static_argnames=("W",))
def pack_rows(
    bwords: jax.Array, ow: jax.Array, nbytes: jax.Array, W: int
) -> jax.Array:
    """(B, W) uint32 rows: row b = ``bwords[ow[b] : ow[b] + W]`` with
    every byte at/after ``nbytes[b]`` zeroed (one gather)."""
    ow = jnp.clip(ow.astype(I32), 0, bwords.shape[0] - W)
    idx = ow[:, None] + jnp.arange(W, dtype=I32)[None, :]
    return _mask_tail(jnp.take(bwords, idx, axis=0), nbytes.astype(I32)[:, None])


def host_row_params(
    offsets: np.ndarray, sizes: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-lane (ow, nbytes, start_bit_bump) for device packing.

    ow = byte offset >> 2; nbytes = in-row valid bytes (sub-word shift +
    frame size); start_bit_bump = 8 * (byte offset & 3), to add to the
    parsed start bit position (which is relative to the frame's first
    byte).
    """
    off = offsets.astype(np.int64)
    sh = (off & 3).astype(np.int32)
    ow = (off >> 2).astype(np.int32)
    nbytes = (sh + sizes.astype(np.int64)).astype(np.int32)
    return ow, nbytes, (8 * sh).astype(np.int32)
