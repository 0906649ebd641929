"""Integer/bit primitives with C#-exact semantics, vectorized for JAX.

Every helper mirrors a construct in the reference codec core
(/root/reference/ALACDecoder/AlacFile.cs) and is shared by the Rice and
LPC scans.  All are shape-polymorphic elementwise ops on int32/uint32.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

I32 = jnp.int32
U32 = jnp.uint32


def clz32(x):
    """Count leading zeros per the reference ladder (AlacFile.cs:154-191).

    Negative int32 inputs (top bit set) give 0; **zero gives 40** (the
    ladder's fall-through ``output + 8``) — reachable at the zero-run k
    when the Rice history is exactly 0 (e.g. ricemodifier 0 or a zero
    initial history).
    """
    # clz of the int32 bit pattern: Triton lowers clz for int32 only.
    c = jax.lax.clz(x.astype(I32))
    return jnp.where(x == 0, jnp.full_like(c, 40), c)


def lsr(x, n):
    """Logical right shift of the 32-bit pattern; n in [0, 31]."""
    return (x.astype(U32) >> n.astype(U32)).astype(x.dtype)


def sra(x, n):
    """Arithmetic right shift (C# >> on int); n in [0, 31]."""
    return jax.lax.shift_right_arithmetic(
        x.astype(I32), n.astype(I32)
    )


def shl(x, n):
    """Left shift with int32 wraparound (C# unchecked <<)."""
    return jax.lax.shift_left(x.astype(I32), n.astype(I32))


def signext(x, bits):
    """Sign-extend the low ``bits`` bits: (x << (32-b)) >> (32-b).

    The reference's readsamplesize clamp (AlacFile.cs:278-279,309-310).
    ``bits`` may be a traced per-lane array in [1, 32].
    """
    shift = (32 - bits.astype(I32)) & 31 if hasattr(bits, "astype") else (32 - bits) & 31
    return sra(shl(x, shift), shift)


def trunc_div2_plus1(dv):
    """C#-exact (dv + 1) / 2 with truncation toward zero (AlacFile.cs:225)."""
    t = dv.astype(I32) + 1
    # trunc(t/2): arithmetic shift is floor; correct negatives odd case.
    q = sra(t, jnp.ones((), I32))
    return jnp.where((t < 0) & ((t & 1) != 0), q + 1, q)


def trunc_div_const(x, d: int):
    """C#-exact x / d (truncating) for a power-of-two Python-int divisor.

    Shifts only: an arithmetic shift floors, so negatives with a nonzero
    remainder round up by one."""
    assert d > 0 and d & (d - 1) == 0, d
    x = x.astype(I32)
    s = d.bit_length() - 1
    q = sra(x, jnp.full((), s, I32))
    return jnp.where((x < 0) & ((x & (d - 1)) != 0), q + 1, q)


def sign_i32(x):
    """-1/0/+1 of an int32 (the predictor's sign probe, AlacFile.cs:325)."""
    x = x.astype(I32)
    return (x > 0).astype(I32) - (x < 0).astype(I32)
