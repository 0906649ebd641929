"""Full batched ALAC frame decode: the device pipeline.

Composes the stages of DecodeFrame (AlacFile.cs:428-719) as batched,
jittable JAX ops over a lane-per-frame batch:

    extra-bits extraction  (:476-482,634-641)  — affine offsets, one gather
    Rice scan, channel A    (:483,643)          — ops/rice.py
    Rice scan, channel B    (:653)              — continues A's bit cursor
    LPC scan, both channels (:486,646,656)      — channels folded into lanes
    raw-PCM path            (:498-526,663-700)  — affine offsets, gathers
    decorrelation + output  (:338-421,527-566)  — pure vector epilogue

Everything is shape-static given (batch B, scan length S); lanes with
fewer samples freeze mid-scan.  The jitted entry is :func:`decode_frames`.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .bitops import I32, U32, shl, signext, sra
from .bitreader import gather_bits
from .lpc import LpcParams, lpc_decode
from .rice import RiceParams, rice_decode


class FrameMetaArrays(NamedTuple):
    """Device-side view of codec/framemeta.FrameBatch (order matters)."""

    is_stereo: jax.Array
    is_compressed: jax.Array
    n_samples: jax.Array
    sample_size: jax.Array
    ub: jax.Array
    rss: jax.Array
    interlacing_shift: jax.Array
    interlacing_leftweight: jax.Array
    payload_pos: jax.Array
    entropy_pos: jax.Array
    order: jax.Array  # (B, 2)
    quant: jax.Array  # (B, 2)
    rice_mult: jax.Array  # (B, 2)
    rc: jax.Array  # (B, 2, 32)
    kmod: jax.Array
    init_history: jax.Array
    kmask: jax.Array

    @classmethod
    def host_arrays(cls, fb) -> tuple:
        """Host-side (NumPy) field tuple in declaration order.

        Used by the sharding layer to ``device_put`` straight to target
        shards without committing anything to the default device first.
        """
        import numpy as np

        return (
            np.asarray(fb.is_stereo),
            np.asarray(fb.is_compressed),
            np.asarray(fb.n_samples, dtype=np.int32),
            np.asarray(fb.sample_size, dtype=np.int32),
            np.asarray(fb.ub, dtype=np.int32),
            np.asarray(fb.rss, dtype=np.int32),
            np.asarray(fb.interlacing_shift, dtype=np.int32),
            np.asarray(fb.interlacing_leftweight, dtype=np.int32),
            np.asarray(fb.payload_pos, dtype=np.int32),
            np.asarray(fb.entropy_pos, dtype=np.int32),
            np.asarray(fb.order, dtype=np.int32),
            np.asarray(fb.quant, dtype=np.int32),
            np.asarray(fb.rice_mult, dtype=np.int32),
            np.asarray(fb.rc, dtype=np.int32),
            np.asarray(fb.kmod, dtype=np.int32),
            np.asarray(fb.init_history, dtype=np.int32),
            np.asarray(fb.kmask, dtype=np.int32),
        )

    @classmethod
    def from_batch(cls, fb) -> "FrameMetaArrays":
        return cls(*(jnp.asarray(x) for x in cls.host_arrays(fb)))

    #: Columns of the packed (B, N_PACKED) int32 transfer layout:
    #: 10 scalar fields, kmod/init_history/kmask, order/quant/rice_mult
    #: (2 each), rc (2*32).  One matrix = ONE host->device transfer per
    #: batch instead of 17: per-array transfer setup is a fixed cost.
    N_PACKED = 13 + 6 + 64

    @classmethod
    def pack_host(cls, fb) -> "np.ndarray":
        """FrameBatch -> one (B, N_PACKED) int32 host matrix."""
        import numpy as np

        h = cls.host_arrays(fb)
        B = h[0].shape[0]
        out = np.empty((B, cls.N_PACKED), np.int32)
        for i in range(10):  # is_stereo .. entropy_pos
            out[:, i] = h[i]
        out[:, 10] = h[14]  # kmod
        out[:, 11] = h[15]  # init_history
        out[:, 12] = h[16]  # kmask
        out[:, 13:15] = h[10]  # order
        out[:, 15:17] = h[11]  # quant
        out[:, 17:19] = h[12]  # rice_mult
        out[:, 19:83] = h[13].reshape(B, 64)  # rc
        return out

    @classmethod
    def unpack(cls, packed) -> "FrameMetaArrays":
        """Device-side view of a packed matrix (free inside jit)."""
        B = packed.shape[0]
        return cls(
            is_stereo=packed[:, 0].astype(bool),
            is_compressed=packed[:, 1].astype(bool),
            n_samples=packed[:, 2],
            sample_size=packed[:, 3],
            ub=packed[:, 4],
            rss=packed[:, 5],
            interlacing_shift=packed[:, 6],
            interlacing_leftweight=packed[:, 7],
            payload_pos=packed[:, 8],
            entropy_pos=packed[:, 9],
            order=packed[:, 13:15],
            quant=packed[:, 15:17],
            rice_mult=packed[:, 17:19],
            rc=packed[:, 19:83].reshape(B, 2, 32),
            kmod=packed[:, 10],
            init_history=packed[:, 11],
            kmask=packed[:, 12],
        )


def _extra_bits(words, m: FrameMetaArrays, S: int):
    """Extra-bits side channel, interleaved A,B per sample (:634-641)."""
    B = words.shape[0]
    ub8 = (m.ub * 8).astype(I32)
    nch = 1 + m.is_stereo.astype(I32)
    stride = (ub8 * nch)[:, None]
    idx = jnp.arange(S, dtype=I32)[None, :]
    pos_a = m.payload_pos[:, None] + idx * stride
    nb = jnp.maximum(ub8, 8)[:, None]
    extra_a = gather_bits(words, pos_a, nb).astype(I32)
    extra_b = gather_bits(words, pos_a + ub8[:, None], nb).astype(I32)
    valid = (m.ub > 0)[:, None]
    zero = jnp.zeros((B, S), I32)
    return (
        jnp.where(valid, extra_a, zero),
        jnp.where(valid & m.is_stereo[:, None], extra_b, zero),
    )


def _extend_raw(v, m: FrameMetaArrays):
    """Raw-sample sign extension: plain for ss<=16, the reference's
    hard-coded 24-bit (x ^ m) - m form for ss>16 (:512-521)."""
    ss = m.sample_size
    le16 = signext(v, ss[:, None])
    mbit = 1 << 23
    gt16 = ((v & 0xFFFFFF) ^ mbit) - mbit
    return jnp.where((ss <= 16)[:, None], le16, gt16)


def _raw_pcm(words, m: FrameMetaArrays, S: int):
    """Uncompressed frame bodies (:500-524,665-696)."""
    ss = m.sample_size
    nch = 1 + m.is_stereo.astype(I32)
    stride = (ss * nch)[:, None]
    idx = jnp.arange(S, dtype=I32)[None, :]
    pos_a = m.payload_pos[:, None] + idx * stride
    raw_a = gather_bits(words, pos_a, ss[:, None]).astype(I32)
    raw_b = gather_bits(words, pos_a + ss[:, None], ss[:, None]).astype(I32)
    return _extend_raw(raw_a, m), _extend_raw(raw_b, m)


def _rice_params(m: FrameMetaArrays, chan: int) -> RiceParams:
    return RiceParams(
        rss=m.rss,
        kmod=m.kmod,
        init_history=m.init_history,
        mult=m.rice_mult[:, chan],
        kmask=m.kmask,
    )


_STATIC = ("num_samples", "route", "max_order", "emit16")


@functools.partial(jax.jit, static_argnames=_STATIC)
def decode_frames_packed(
    words,
    packed_meta,
    num_samples: int,
    route: str = "scan",
    max_order: int = 30,
    emit16: bool = False,
):
    """decode_frames with metadata as one packed (B, N_PACKED) matrix.

    The production transfer path: the caller ships ``words`` plus ONE
    int32 matrix (FrameMetaArrays.pack_host) and the unpack happens
    inside the executable — one H2D per batch instead of 17 small ones.
    """
    return _decode_frames_impl(
        words, FrameMetaArrays.unpack(packed_meta), num_samples,
        route=route, max_order=max_order, emit16=emit16,
    )


@functools.partial(jax.jit, static_argnames=_STATIC)
def decode_frames(
    words,
    meta: FrameMetaArrays,
    num_samples: int,
    route: str = "scan",
    max_order: int = 30,
    emit16: bool = False,
):
    """Decode a frame batch -> (samples (B, S, 2) int32, n (B,) int32).

    Output samples are final PCM integers (decorrelated, extra-bits
    merged, sign-extended); channel 1 is zero for mono lanes (the
    reference's mono-in-stereo silence, AlacFile.cs:536-540) and samples
    at i >= n are zero.

    ``emit16`` returns int16 samples (valid only when every lane is a
    16-bit stream) — halves the device->host transfer.

    ``route`` (ops/route.py): "scan" runs the XLA scans; "triton" the
    fused Rice+LPC GPU kernel (ops/rice_lpc_kernel.py); "interpret" that
    kernel on the Pallas interpreter.  ``max_order`` statically bounds
    the kernel's FIR window: every lane's order must be <= max_order or
    31.  The scans ignore it.
    """
    return _decode_frames_impl(
        words, meta, num_samples,
        route=route, max_order=max_order, emit16=emit16,
    )


def _decode_frames_impl(
    words,
    meta: FrameMetaArrays,
    num_samples: int,
    route: str = "scan",
    max_order: int = 30,
    emit16: bool = False,
):
    S = num_samples
    B = words.shape[0]
    words = words.astype(U32)
    m = meta

    # Clamp to [0, S]: a malformed explicit sample count (hassize path,
    # AlacFile.cs:447-453) must not leak negative/oversized n downstream.
    n = jnp.clip(m.n_samples, 0, S)
    n_comp = jnp.where(m.is_compressed, n, 0)
    n_b = jnp.where(m.is_stereo, n_comp, 0)

    # ---- compressed path ----
    zeros_bs = lambda: (jnp.zeros((B, S), I32), jnp.zeros((B, S), I32))  # noqa: E731
    extra_a, extra_b = jax.lax.cond(
        jnp.any(m.ub > 0), lambda: _extra_bits(words, m, S), zeros_bs
    )
    if route == "scan":
        err_a, pos_after_a = rice_decode(
            words, m.entropy_pos, n_comp, _rice_params(m, 0), S
        )
        err_b, _ = rice_decode(words, pos_after_a, n_b, _rice_params(m, 1), S)

        # LPC over both channels as one 2B-lane scan.
        errs = jnp.concatenate([err_a, err_b], axis=0)
        lpc_p = LpcParams(
            order=jnp.concatenate([m.order[:, 0], m.order[:, 1]]),
            quant=jnp.concatenate([m.quant[:, 0], m.quant[:, 1]]),
            rc=jnp.concatenate([m.rc[:, 0], m.rc[:, 1]], axis=0),
            rss=jnp.concatenate([m.rss, m.rss]),
        )
        lpc_out = lpc_decode(errs, jnp.concatenate([n_comp, n_b]), lpc_p, S)
        out_a, out_b = lpc_out[:B], lpc_out[B:]
    else:
        from .rice_lpc_kernel import rice_lpc

        (out_a, out_b), _ = rice_lpc(
            words, m.entropy_pos, jnp.stack([n_comp, n_b]),
            m.rss, m.kmod, m.init_history, m.kmask,
            m.rice_mult.T, m.order.T, m.quant.T, jnp.swapaxes(m.rc, 0, 1),
            S, max_order=max_order, interpret=route == "interpret",
        )

    # ---- raw path (cond'd out when every lane is compressed) ----
    raw_a, raw_b = jax.lax.cond(
        jnp.any(~m.is_compressed), lambda: _raw_pcm(words, m, S), zeros_bs
    )
    comp = m.is_compressed[:, None]
    a = jnp.where(comp, out_a, raw_a)
    b = jnp.where(comp, out_b, raw_b)

    # ---- decorrelation (:338-421) ----
    lw = jnp.where(m.is_compressed, m.interlacing_leftweight, 0)[:, None]
    # C# shift counts are masked & 31 (an 8-bit field feeds a >> at :349).
    sh = jnp.where(m.is_compressed, m.interlacing_shift, 0)[:, None] & 31
    right_w = a - sra(b * lw, sh)
    left_w = right_w + b
    use_w = (lw != 0) & m.is_stereo[:, None]
    left = jnp.where(use_w, left_w, a)
    right = jnp.where(use_w, right_w, b)

    # ---- extra-bits merge (:381-395,549-554) ----
    # The reference merges the side channel only in the 24-bit output
    # paths; 16-bit output ignores parsed extra bits (AlacFile.cs:529-543
    # vs :544-566).
    ub8 = jnp.where(m.is_compressed, m.ub * 8, 0)[:, None]
    mask = shl(jnp.full_like(ub8, -1), ub8) ^ jnp.full_like(ub8, -1)
    has_extra = (ub8 > 0) & (m.sample_size > 16)[:, None]
    left = jnp.where(has_extra, shl(left, ub8) | (extra_a & mask), left)
    right = jnp.where(
        has_extra & m.is_stereo[:, None],
        shl(right, ub8) | (extra_b & mask),
        right,
    )

    # 24-bit output is a 3-byte layout: Deinterlace24 truncates each value
    # to its low 24 bits when writing bytes (AlacFile.cs:390-395,558-562).
    # Reproduce that value domain (sign-extended from bit 23) — reachable
    # only when ub >= 2 or extreme decorrelation pushes past 24 bits.
    is24 = (m.sample_size > 16)[:, None]
    eight = jnp.full_like(ub8, 8)
    left = jnp.where(is24, sra(shl(left, eight), eight), left)
    right = jnp.where(is24, sra(shl(right, eight), eight), right)

    # mono lanes: silent channel 1 (:536-540,563-565); mask the tail.
    live = jnp.arange(S, dtype=I32)[None, :] < n[:, None]
    left = jnp.where(live, left, 0)
    right = jnp.where(live & m.is_stereo[:, None], right, 0)
    out = jnp.stack([left, right], axis=-1)
    if emit16:
        out = out.astype(jnp.int16)
    return out, n
