"""Fused Rice + adaptive-LPC decode kernel for NVIDIA GPUs (Pallas, Triton).

The XLA path (ops/rice.py, ops/lpc.py) runs one ``lax.scan`` step per
output sample, and every step is several device kernels: on a GPU it is
bound by launches and loop overhead, not by arithmetic.  This kernel
keeps the whole per-sample loop inside one launch.

Layout, from what the codec is (frames are independent, the bit cursor
inside a frame is serial, all arithmetic is int32 with wraparound):

* **Lanes.** One lane per frame, ``BLOCK`` lanes per program.  A lane
  decodes channel A, then channel B from the bit position where A ended
  (AlacFile.cs:643,653): the channels are two loops of one launch.
* **Sample loop.** ``lax.fori_loop`` to the block's largest sample
  count; lanes past their own count freeze, as in the scans.
* **Word fetch.** Each lane gathers the four words covering its bit
  cursor straight from the (B, W) word table in global memory.  The
  planner sorts frames by coded size, so neighbouring lanes read
  neighbouring rows and the caches see the locality.
* **LPC state.** The base-aligned window and the reversed coefficients
  of ops/lpc.py are held as ``max_order + 1`` and ``max_order`` per-lane
  columns, i.e. registers: the per-lane variable order never becomes a
  dynamic index.
* **Output.** Stored (C, S, B): at each step a program writes one
  contiguous row of ``BLOCK`` lanes, so stores coalesce.  The wrapper
  transposes to the (B, S) layout of the scans.

Every variable shift count is masked to [0, 31]: Triton lowers shifts to
LLVM shifts, for which a count >= 32 is poison, while XLA (and so the
interpreter the CPU tests use) defines it.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .bitops import I32, U32, shl, sign_i32, signext, sra
from .bitreader import WINDOW_WORDS
from .lpc import MAX_ORDER
from .rice import rice_sample

#: Lanes per program (a power of two) and warps per program: one lane
#: per thread.  The kernel is latency-bound along each lane's serial
#: chain, so two lanes per thread cost twice the time; among one-lane-
#: per-thread shapes 128 x 4 warps measured fastest at 16384 lanes.
BLOCK = 128
NUM_WARPS = 4


def _lpc_sample(i, err, n, prev, D, rc, lane, max_order: int):
    """One PredictorDecompressFirAdapt step (AlacFile.cs:256-336) in
    column form: ``D[t]`` and ``rc[t - 1]`` are (BLOCK,) vectors, the
    recurrence is ops/lpc.py's.  Returns (out, prev, D, rc)."""
    order, quant, qround, rss = lane
    is_pass = order == 0
    is_int31 = order == MAX_ORDER
    use_int = is_int31 | (i <= order)
    out_int = signext(prev + err, rss)  # warm-up / order 31 (:276-292)
    out = out_int
    if max_order:
        base = D[0]
        fir = jnp.zeros_like(err)
        for t in range(1, max_order + 1):
            fir = fir + (D[t] - base) * rc[t - 1]
        out_fir = signext(sra(qround + fir, quant) + base + err, rss)
        out = jnp.where(use_int, out_int, out_fir)
    out = jnp.where(is_pass | (i == 0), err, out)  # sample 0 copies
    if max_order:
        # Adaptive coefficient walk (:312-332), FIR lanes only.
        do_adapt = ~(is_pass | use_int)
        pos_b = do_adapt & (err > 0)
        neg_b = do_adapt & (err < 0)
        ev = err
        rc = list(rc)
        for t in range(max_order):
            act_p = pos_b & (t < order) & (ev > 0)
            act_n = neg_b & (t < order) & (ev < 0)
            val = base - D[t + 1]
            sgn = sign_i32(val)
            sign_eff = jnp.where(act_p, sgn, jnp.where(act_n, -sgn, 0))
            rc[t] = rc[t] - sign_eff
            ev = jnp.where(
                act_p | act_n, ev - sra(val * sign_eff, quant) * (t + 1), ev
            )
        # Shift the window left by one and append at slot ``order``.
        D = tuple(
            jnp.where(order == t, out, D[t + 1] if t < max_order else D[0])
            for t in range(max_order + 1)
        )
        rc = tuple(rc)
    live = i < n
    out = jnp.where(live, out, 0)
    prev = jnp.where(live, out, prev)
    return out, prev, D, rc


def _kernel(
    words_ref, start_ref, lane_ref, chan_ref, rc_ref, out_ref, end_ref,
    *, n_lanes: int, width: int, channels: int, max_order: int, block: int,
):
    """One program: ``block`` lanes, every channel, every sample."""
    pid = pl.program_id(0)
    lane = pid * block + lax.broadcasted_iota(I32, (block,), 0)
    lane_c = jnp.minimum(lane, n_lanes - 1)  # the tail block re-reads
    rss = lane_ref[0, lane_c]
    kmod = lane_ref[1, lane_c]
    init_hist = lane_ref[2, lane_c]
    kmask = lane_ref[3, lane_c]
    pos = start_ref[lane_c]
    for c in range(channels):
        n = chan_ref[c, 0, lane_c]
        mult = chan_ref[c, 1, lane_c]
        order = chan_ref[c, 2, lane_c]
        quant = chan_ref[c, 3, lane_c]
        qround = shl(jnp.ones_like(quant), (quant - 1) & 31)
        rc = tuple(rc_ref[c, t, lane_c] for t in range(1, max_order + 1))
        D = tuple(jnp.zeros_like(n) for _ in range(max_order + 1))
        zero = jnp.zeros_like(n)
        nmax = jnp.max(jnp.where(lane < n_lanes, n, 0))

        def body(i, carry, c=c, n=n, mult=mult, lpc=(order, quant, qround, rss)):
            rice, prev, D, rc = carry
            p = rice[0]
            w = jnp.clip(p >> 5, 0, width - WINDOW_WORDS)
            win = tuple(
                words_ref[lane_c, w + k].astype(U32)
                for k in range(WINDOW_WORDS)
            )
            rice, err = rice_sample(
                win, p & 31, i, n, rice, rss, kmod, mult, kmask
            )
            out, prev, D, rc = _lpc_sample(i, err, n, prev, D, rc, lpc, max_order)
            out_ref[c, i, pl.ds(pid * block, block)] = out
            return rice, prev, D, rc

        rice0 = (pos, init_hist, zero, zero)
        (pos, _, _, _), _, _, _ = lax.fori_loop(
            0, nmax, body, (rice0, zero, D, rc)
        )
        end_ref[c, pl.ds(pid * block, block)] = pos


@functools.partial(
    jax.jit,
    static_argnames=("num_samples", "max_order", "interpret"),
)
def rice_lpc(
    words, start, n, rss, kmod, init_history, kmask, mult, order, quant, rc,
    num_samples: int, max_order: int = MAX_ORDER - 1, interpret: bool = False,
):
    """Rice + LPC decode of C channels per lane, channel c+1 starting
    where channel c ended.

    words (B, W) uint32; start, rss, kmod, init_history, kmask (B,);
    n, mult, order, quant (C, B); rc (C, B, 32) base-aligned reversed
    coefficients (ops/lpc.reverse_coefs).  ``max_order`` statically
    bounds the FIR window: every lane's order must be <= max_order or
    31 (pure integration).  ``interpret`` runs the kernel on the Pallas
    interpreter (CPU tests only; ops/route.py never picks it on a GPU).

    Returns (out (C, B, S) int32 with zeros at i >= n, end (C, B) int32
    bit positions after each channel).
    """
    if interpret and jax.default_backend() == "gpu":
        raise ValueError("the Pallas interpreter never runs on a GPU")
    B, W = words.shape
    C = n.shape[0]
    S = num_samples
    assert 0 <= max_order < MAX_ORDER, max_order
    Bp = -(-B // BLOCK) * BLOCK
    lane = jnp.stack([rss, kmod, init_history, kmask]).astype(I32)
    chan = jnp.stack([n, mult, order, quant], axis=1).astype(I32)  # (C,4,B)
    rc_t = jnp.swapaxes(rc.astype(I32), 1, 2)  # (C, 32, B)
    kernel = functools.partial(
        _kernel, n_lanes=B, width=W, channels=C, max_order=max_order,
        block=BLOCK,
    )
    out, end = pl.pallas_call(
        kernel,
        grid=(Bp // BLOCK,),
        out_shape=(
            jax.ShapeDtypeStruct((C, S, Bp), I32),
            jax.ShapeDtypeStruct((C, Bp), I32),
        ),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        interpret=interpret,
        name="alac_rice_lpc",
    )(words.astype(U32), start.astype(I32), lane, chan, rc_t)
    live = jnp.arange(S, dtype=I32)[None, None, :] < n[:, :, None]
    out = jnp.where(live, jnp.swapaxes(out[:, :, :B], 1, 2), 0)
    return out, end[:, :B]
