"""Frame-parallel Rice / adaptive-Golomb entropy decode as a lax.scan.

Vectorizes the reference's per-sample serial loop (EntropyRiceDecode,
AlacFile.cs:214-252 + EntropyDecodeValue :193-212) across a batch of
independent frame lanes.  The scan is over the output sample index; each
lane carries (bit cursor, history, sign modifier, zero-run remaining).
One 128-bit window gather per step covers the worst-case event (see
ops/bitreader.py), so the step body is pure vector math.

Bit-exactness notes (all mirrored from the reference):
  * per-sample k = min(31 - clz((h>>9)+3), kmod)      (:221-222)
  * main-loop multiplier mask is 0xFFFFFFFF; the zero-run block-size
    decode applies (1<<kmod)-1                         (:223-224,236)
  * unary run capped at 9 reads; escape reads rss raw bits (:196-202)
  * k == 1 returns the unary count with no extra bits  (:203)
  * extra <= 1 hands one bit back (Unreadbits)         (:209-210)
  * zig-zag via truncating (dv+1)/2                    (:225-226)
  * history clamp at 0xFFFF uses the *signed* compare  (:229)
  * zero-run: k = clz(h) + (h+16)/64 - 24, history reset, sign_modifier
    carried into the next sample                       (:231-249)
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..codec.cookie import RICE_THRESHOLD
from .bitops import I32, clz32, sra, trunc_div2_plus1, trunc_div_const
from .bitreader import gather_window, window_bits


class RiceParams(NamedTuple):
    """Per-lane entropy parameters (all (B,) int32)."""

    rss: jax.Array  # readsamplesize
    kmod: jax.Array  # rice_kmodifier
    init_history: jax.Array  # rice_initialhistory
    mult: jax.Array  # ricemodifier * (historymult / 4)
    kmask: jax.Array  # (1 << kmod) - 1


def _decode_event(win, sh, off, rss, k, mult_mask):
    """One entropy_decode_value: returns (value i32, consumed_bits i32).

    ``off`` is the event's bit offset inside the gathered window; all
    reads are extracted from the window without further gathers.
    """
    # Unary run of 1-bits, capped at RICE_THRESHOLD+1 reads (:196-197).
    u9 = window_bits(win, sh, off, 9).astype(I32)  # next 9 bits
    # Leading ones among the 9 = clz of the complement left-aligned to bit 31.
    inv = (~u9) & 0x1FF
    x = jnp.minimum(clz32((inv << 23).astype(I32)), RICE_THRESHOLD + 1)
    unary_consumed = jnp.where(x > RICE_THRESHOLD, 9, x + 1)

    field_off = off + unary_consumed
    esc = x > RICE_THRESHOLD
    # Escape: rss raw bits, masked (:199-202). window_bits already yields
    # exactly rss bits.
    esc_val = window_bits(win, sh, field_off, rss).astype(I32)
    # k-path (:203-211).
    k_safe = jnp.clip(k, 1, 31)
    extra = window_bits(win, sh, field_off, k_safe).astype(I32)
    # (1<<k)-1 with int32 wraparound (k=31 -> 0x7FFFFFFF), then the
    # caller's multiplier mask (AlacFile.cs:206).
    m = ((jnp.full_like(k_safe, 1) << k_safe) - 1) & mult_mask
    vk = x * m + jnp.where(extra > 1, extra - 1, 0)
    k_consumed = jnp.where(extra > 1, k_safe, k_safe - 1)

    is_k1 = k == 1
    value = jnp.where(esc, esc_val, jnp.where(is_k1, x, vk))
    consumed = unary_consumed + jnp.where(
        esc, rss, jnp.where(is_k1, 0, k_consumed)
    )
    return value.astype(I32), consumed.astype(I32)


def rice_sample(win, sh, i, n, state, rss, kmod, mult, kmask):
    """One output sample of EntropyRiceDecode for every lane.

    ``win``/``sh``: the 4-word window covering the lane's bit cursor
    (ops/bitreader.py); ``state`` = (pos, hist, signmod, zrun), each
    (B,) int32; ``i``: the sample index.  Lanes freeze at ``i >= n``.
    Returns (new state, residual).  Elementwise only, so the scan below
    and the GPU kernel (ops/rice_lpc_kernel.py) run the same step.
    """
    pos, hist, signmod, zrun = state
    active = i < n
    in_zero = zrun > 0
    nine = jnp.full((), 9, I32)
    # ---- main value (AlacFile.cs:221-226) ----
    k = jnp.minimum(31 - clz32(sra(hist, nine) + 3), kmod)
    raw, consumed = _decode_event(win, sh, jnp.zeros_like(pos), rss, k, -1)
    dv = raw + signmod
    almost = trunc_div2_plus1(dv)
    out_val = jnp.where((dv & 1) != 0, -almost, almost)
    # ---- history update (:229) ----
    hist2 = jnp.where(
        dv > 0xFFFF,
        jnp.full_like(hist, 0xFFFF),
        hist + dv * mult - sra(hist * mult, nine),
    )
    # ---- zero-run block (:231-249) ----
    zcond = (hist2 < 128) & (i + 1 < n)
    kz = clz32(hist2) + trunc_div_const(hist2 + 16, 64) - 24
    bsize, bconsumed = _decode_event(
        win, sh, consumed, jnp.full_like(rss, 16), kz, kmask
    )
    total_consumed = consumed + jnp.where(zcond, bconsumed, 0)
    new_signmod = jnp.where(
        zcond, jnp.where(bsize > 0xFFFF, 0, 1), jnp.zeros_like(signmod)
    )
    new_hist = jnp.where(zcond, jnp.zeros_like(hist2), hist2)
    new_zrun = jnp.where(zcond, bsize, jnp.zeros_like(bsize))

    # ---- select: zero-run emission vs decode vs frozen ----
    do = active & ~in_zero
    out = jnp.where(do, out_val, jnp.zeros_like(out_val))
    pos = jnp.where(do, pos + total_consumed, pos)
    hist = jnp.where(do, new_hist, hist)
    signmod = jnp.where(do, new_signmod, signmod)
    zrun = jnp.where(do, new_zrun, jnp.where(active & in_zero, zrun - 1, zrun))
    return (pos, hist, signmod, zrun), out


def rice_decode(words, start_bitpos, n, params: RiceParams, num_samples: int):
    """Decode ``num_samples`` residuals per lane.

    words: (B, W) uint32 packed frame payloads
    start_bitpos: (B,) int32 bit cursor at entropy-data start
    n: (B,) int32 valid output count per lane (lanes freeze past n)
    num_samples: static scan length (>= max(n))

    Returns (errors (B, num_samples) int32, end_bitpos (B,) int32).
    """
    B = words.shape[0]
    rss, kmod, init_hist, mult, kmask = (
        params.rss.astype(I32),
        params.kmod.astype(I32),
        params.init_history.astype(I32),
        params.mult.astype(I32),
        params.kmask.astype(I32),
    )

    def step(carry, i):
        win, sh = gather_window(words, carry[0])
        return rice_sample(win, sh, i, n, carry, rss, kmod, mult, kmask)

    init = (
        start_bitpos.astype(I32),
        init_hist,
        jnp.zeros((B,), I32),
        jnp.zeros((B,), I32),
    )
    (end_pos, _, _, _), outs = jax.lax.scan(
        step, init, jnp.arange(num_samples, dtype=I32)
    )
    return outs.T, end_pos
