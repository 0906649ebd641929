"""Batched, functional bit-window reader for frame-parallel decode.

The reference reads bits through a mutable cursor one field at a time
(AlacFile.cs:101-152).  On the device that serialization is broken two
ways:

  * frames are independent batch lanes (bit cursors are (B,) vectors);
  * per Rice *event* we gather one aligned 4-word (128-bit) window and
    extract every field of the event from it with pure vector math — the
    worst-case event (9-bit unary + 32-bit escape + zero-run block of
    9+16 bits = 66 bits, starting at any intra-word offset <= 31) fits:
    31 + 66 < 128.

Frame payloads are packed into big-endian uint32 words, zero-padded with
>= WINDOW_PAD words of slack so clamped gathers never read out of bounds
(the analog of the reference's 80 KB slack buffer, AlacContext.cs:64).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .bitops import I32, U32, lsr

#: Words gathered per window.
WINDOW_WORDS = 4
#: Zero words of slack appended past the longest frame.
WINDOW_PAD = WINDOW_WORDS + 1


def pack_frames_to_words(frames: list[bytes], max_bytes: int | None = None) -> np.ndarray:
    """Pack variable-length frame payloads into a (B, W) uint32 matrix.

    Each row is one frame's bytes, big-endian packed, zero padded. ``W``
    includes WINDOW_PAD words of slack.
    """
    if max_bytes is None:
        max_bytes = max((len(f) for f in frames), default=0)
    nwords = -(-max_bytes // 4) + WINDOW_PAD
    B = len(frames)
    out = np.zeros((B, nwords * 4), dtype=np.uint8)
    if B:
        # Ragged-to-padded in two C passes (a per-row Python loop costs
        # ~50us/row): join once, then boolean-scatter into the padded grid.
        lens = np.fromiter((len(f) for f in frames), np.int64, B)
        src = np.frombuffer(b"".join(frames), np.uint8)
        mask = np.arange(nwords * 4, dtype=np.int64)[None, :] < lens[:, None]
        out[mask] = src
    # Big-endian word view, converted to native in one pass.
    return out.view(">u4").astype(np.uint32)


def gather_window(words, bitpos):
    """Fetch the 4 words covering ``bitpos`` for every lane.

    words: (B, W) uint32;  bitpos: (B,) int32.
    Returns (w0..w3) each (B,) uint32 plus the intra-word shift (B,) int32.
    One (B, 4) gather: each lane reads its own four consecutive words.
    """
    W = words.shape[1]
    w = jnp.clip(bitpos >> 5, 0, W - WINDOW_WORDS)
    idx = w[:, None] + jnp.arange(WINDOW_WORDS, dtype=I32)[None, :]
    cols = jnp.take_along_axis(words, idx, axis=1).astype(U32)
    win = tuple(cols[:, k] for k in range(WINDOW_WORDS))
    sh = (bitpos & 31).astype(I32)
    return win, sh


def window_bits(win, sh, off, n):
    """Extract ``n`` bits at bit offset ``sh + off`` inside a 4-word window.

    ``off`` (offset past the window's bit base) and ``n`` (field width,
    1..32) may be traced per-lane int32 arrays; ``sh + off`` must stay
    <= 96 so the straddle word exists.  Returns (B,) uint32, the field
    right-aligned — value-identical to the reference's Readbits
    (AlacFile.cs:101-129) for in-bounds reads.
    """
    w0, w1, w2, w3 = win
    p = (sh + off).astype(I32)
    wi = p >> 5  # 0..2
    s2 = (p & 31).astype(U32)
    hi = jnp.where(wi == 0, w0, jnp.where(wi == 1, w1, w2))
    lo = jnp.where(wi == 0, w1, jnp.where(wi == 1, w2, w3))
    straddle = jnp.where(s2 == 0, jnp.zeros_like(lo), lo >> ((32 - s2) & 31))
    x = (hi << s2) | straddle
    n = jnp.asarray(n, dtype=U32)
    return lsr(x, (32 - n) & 31)


def gather_bits(words, bitpos, nbits):
    """Arbitrary-position field read: one 2-word gather per element.

    words: (B, W) uint32; bitpos/nbits broadcastable int32 arrays (e.g.
    (B, S) sample grids for the extra-bits and raw-PCM paths, whose
    offsets are affine in the sample index — no scan needed).  nbits <= 25
    (field + 31-bit skew <= 64).  Returns uint32 of nbits fields.
    """
    w = jnp.clip(bitpos >> 5, 0, words.shape[1] - 2)
    hi = jnp.take_along_axis(words, w, axis=1)
    lo = jnp.take_along_axis(words, w + 1, axis=1)
    s2 = (bitpos & 31).astype(U32)
    straddle = jnp.where(s2 == 0, jnp.zeros_like(lo), lo >> ((32 - s2) & 31))
    x = (hi << s2) | straddle
    n = jnp.asarray(nbits, dtype=U32)
    return lsr(x, (32 - n) & 31)
