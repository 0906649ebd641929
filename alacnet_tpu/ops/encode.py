"""Device batch ALAC *encoding* stages (beyond-reference capability).

The reference has no encoder; the host tier grew one in round 1
(codec/encoder.py + _native/host.cpp).  This module moves the two
sequential per-sample automatons onto the device, frame-per-lane like
the decoder:

  * :func:`predictor_errors` — the forward adaptive FIR: runs the
    decoder's reconstruction (AlacFile.cs:256-336) in lockstep over the
    *known* signal and solves for each residual, mutating the
    coefficient table exactly as the decoder will.  Same base-aligned
    window/coef layout as ops/lpc.py, but the window carries inputs.
  * :func:`rice_symbols` — the Rice/adaptive-Golomb emitter
    (EntropyRiceDecode's state machine run forward, AlacFile.cs:214-252):
    per sample it produces up to four (value, width) bit fields — unary
    or escape marker, remainder field, and the optional zero-run
    block-size symbol pair.  Bit *packing* (concatenating the variable-
    width fields) is embarrassingly parallel per frame and stays in the
    native host tier (alac_pack_bits), so the device never needs a
    bit-scatter.

Quotient computation is division-free: q = raw / m only matters while
q <= 8 (RICE_THRESHOLD; larger escapes, AlacFile.cs:196-202), so nine
conditional subtractions bound it — the VPU has no integer divide.

Both stages fold stereo channels into extra lanes (channel histories are
independent, unlike the bitstream itself, which is only concatenated at
pack time — encoding has no decode-side cursor dependency, so channels
A and B parallelize perfectly here).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..codec.cookie import RICE_THRESHOLD
from .bitops import I32, U32, shl, sign_i32, signext, sra
from .lpc import MAX_ORDER, LpcParams


def _clz32(x):
    # clz(0) = 40 ladder semantics (AlacFile.cs:190).
    c = jax.lax.clz(x.astype(jnp.uint32)).astype(I32)
    return jnp.where(x == 0, jnp.full_like(c, 40), c)


def predictor_errors(
    sig, n, params: LpcParams, num_samples: int, max_order: int = MAX_ORDER
):
    """Residuals whose decode reproduces ``sig`` bit-exactly.

    sig: (B, S) int32 channel values (decorrelated, extra-bits split
    off); n: (B,) valid counts; params as for ops/lpc.lpc_decode (rc in
    the base-aligned reversed layout, mutated in-scan like the decoder's
    table).  ``max_order`` statically bounds the FIR width and adaptive
    walk (orders 1..max_order; order 31 = pure integration needs no
    window) — the default 31 costs ~3x on typical order-6 content.
    Returns errs (B, S) int32.
    """
    order = params.order.astype(I32)
    quant = params.quant.astype(I32)
    rss = params.rss.astype(I32)
    B = sig.shape[0]
    tmax = max_order

    is_pass = order == 0
    is_int31 = order == MAX_ORDER
    append_hot = (
        jnp.arange(tmax + 1, dtype=I32)[None, :] == order[:, None]
    )
    qshift = (quant - 1) & 31
    one = jnp.ones((), I32)

    sig_t = sig.T  # (S, B)

    def step(carry, inp):
        i, x = inp
        prev, D, rc = carry

        # integration/warm-up residual (AlacFile.cs:276-292 inverted)
        err_int = signext(x - prev, rss)
        base = D[:, 0]
        fir = jnp.sum(
            (D[:, 1:] - base[:, None]) * rc[:, 1:], axis=1, dtype=jnp.int32
        )
        outval = sra(shl(one, qshift) + fir, quant)
        err_fir = signext(x - outval - base, rss)

        use_int = is_int31 | (i <= order)
        err = jnp.where(is_pass, x, jnp.where(use_int, err_int, err_fir))

        # adaptive coefficient walk — identical to the decoder's
        # (ops/lpc.py step), with window values = inputs
        do_adapt = ~(is_pass | is_int31 | use_int)
        pos_b = do_adapt & (err > 0)
        neg_b = do_adapt & (err < 0)
        ev = err
        rc_cols = [rc[:, t] for t in range(tmax + 1)]
        for t in range(tmax):
            act_p = pos_b & (t < order) & (ev > 0)
            act_n = neg_b & (t < order) & (ev < 0)
            act = act_p | act_n
            val = base - D[:, t + 1]
            sgn = sign_i32(val)
            sign_eff = jnp.where(act_p, sgn, jnp.where(act_n, -sgn, 0))
            rc_cols[t + 1] = rc_cols[t + 1] - sign_eff
            ev = jnp.where(act, ev - sra(val * sign_eff, quant) * (t + 1), ev)
        rc_new = jnp.stack(rc_cols, axis=1)
        rc = jnp.where(do_adapt[:, None], rc_new, rc)

        # advance window with the INPUT sample (== decoder's output)
        shifted = jnp.concatenate([D[:, 1:], D[:, :1]], axis=1)
        D = jnp.where(append_hot, x[:, None], shifted)

        live = i < n
        err = jnp.where(live, err, jnp.zeros_like(err))
        prev = jnp.where(live, x, prev)
        return (prev, D, rc), err

    # i = 0: err[0] = sig[0] verbatim (AlacFile.cs first-sample copy).
    x0 = sig_t[0]
    D0 = jnp.where(append_hot, x0[:, None], jnp.zeros((B, tmax + 1), I32))
    init = (x0, D0, params.rc.astype(I32)[:, : tmax + 1])
    xs = (jnp.arange(1, num_samples, dtype=I32), sig_t[1:])
    # unroll=2: amortizes per-step scan overhead (not re-measured on a
    # GPU; ROADMAP S4).
    (_, _, _), errs = jax.lax.scan(step, init, xs, unroll=2)
    err0 = jnp.where(n > 0, x0, jnp.zeros_like(x0))
    return jnp.concatenate([err0[None, :], errs], axis=0).T


def zero_run_lengths(errs, n, num_samples: int):
    """(B, S) runs of zero residuals starting at i+1 (capped at n).

    Vectorized lookahead for the encoder's zero-run symbol
    (AlacFile.cs:231-249): run[i] = #{j > i : errs[i+1..j] all zero},
    stopping at the lane's n (the reference's ``i + 1 + run < n`` walk).
    """
    S = num_samples
    idx = jnp.arange(S, dtype=I32)[None, :]
    # positions that BREAK a zero run: nonzero residual or past-n
    brk = (errs != 0) | (idx >= n[:, None])
    nz_idx = jnp.where(brk, idx, S)
    # suffix minimum: index of the next break at or after i
    next_brk = jax.lax.cummin(nz_idx[:, ::-1], axis=1)[:, ::-1]
    run_from = next_brk - idx  # zeros starting at i
    run_after = jnp.concatenate(
        [run_from[:, 1:], jnp.zeros((errs.shape[0], 1), I32)], axis=1
    )
    return jnp.minimum(run_after, 0xFFFF)


class RiceEncParams(NamedTuple):
    rss: jax.Array  # (B,) int32
    kmod: jax.Array
    init_history: jax.Array
    mult: jax.Array
    kmask: jax.Array


def _emit_sym(raw, rss, k, mask):
    """(v0,w0,v1,w1) bit fields for one entropy symbol (AlacFile.cs:193-212
    run forward).  Division-free: quotients above RICE_THRESHOLD escape."""
    k_safe = jnp.clip(k, 1, 31)
    m = (shl(jnp.ones_like(k_safe), k_safe) - 1) & mask
    rem = raw
    q = jnp.zeros_like(raw)
    for _ in range(RICE_THRESHOLD + 1):
        c = (m > 0) & (rem >= m)
        rem = rem - jnp.where(c, m, 0)
        q = q + c.astype(I32)
    esc_q = (m <= 0) | (q > RICE_THRESHOLD)
    is_k1 = k == 1
    esc = jnp.where(is_k1, raw > RICE_THRESHOLD, esc_q)
    uq = jnp.where(is_k1, jnp.minimum(raw, RICE_THRESHOLD), q)
    # unary: uq one-bits then a zero = (2^(uq+1) - 2), width uq+1
    v0 = jnp.where(esc, 0x1FF, shl(jnp.ones_like(uq), uq + 1) - 2)
    w0 = jnp.where(esc, 9, uq + 1)
    r = rem
    v1 = jnp.where(esc, raw, jnp.where(is_k1, 0, jnp.where(r == 0, 0, r + 1)))
    w1 = jnp.where(
        esc, rss, jnp.where(is_k1, 0, jnp.where(r == 0, k_safe - 1, k_safe))
    )
    return v0, w0, v1, w1


@functools.partial(jax.jit, static_argnames=("num_samples",))
def rice_symbols(errs, zruns, n, params: RiceEncParams, num_samples: int):
    """Run the Rice emitter automaton -> fixed-arity bit-field planes.

    Returns (vals16 (B, S, 2) int16 — the unary/marker fields [v0, v2],
    vals32 (B, S, 2) int32 — the remainder/escape fields [v1, v3],
    widths (B, S, 4) int8 in field order v0,v1,v2,v3, bad (B,) bool).
    Fields with width 0 are no-ops for the packer; ``bad`` flags the
    (construction-impossible) encoder desync raw < 0 — the host raises,
    mirroring codec/encoder.py's RuntimeError.
    """
    rss = params.rss.astype(I32)
    kmod = params.kmod.astype(I32)
    mult = params.mult.astype(I32)
    kmask = params.kmask.astype(I32)
    neg1 = jnp.full_like(rss, -1)

    errs_t = errs.T
    zr_t = zruns.T

    def step(carry, inp):
        i, err, zr = inp
        h, sgnmod, skip, bad = carry
        in_skip = skip > 0
        active = (i < n) & ~in_skip

        dv = jnp.where(err > 0, 2 * err, jnp.where(err < 0, -2 * err - 1, 0))
        raw = dv - sgnmod
        bad = bad | (active & (raw < 0))
        ik = 31 - kmod - _clz32(sra(h, jnp.full_like(h, 9)) + 3)
        k = jnp.where(ik < 0, ik + kmod, kmod)
        v0, w0, v1, w1 = _emit_sym(raw, rss, k, neg1)

        h2 = jnp.where(
            dv > 0xFFFF,
            jnp.full_like(h, 0xFFFF),
            h + dv * mult - sra(h * mult, jnp.full_like(h, 9)),
        )
        zcond = (h2 < 128) & (i + 1 < n)
        kz = jnp.minimum(
            _clz32(h2) + sra(h2 + 16, jnp.full_like(h2, 6)) - 24, 31
        )
        v2, w2, v3, w3 = _emit_sym(zr, jnp.full_like(rss, 16), kz, kmask)

        emit_v = active
        emit_z = active & zcond
        # Unary/marker fields fit 16 bits (<= 0x3FE); widths fit 8.
        # Halves the device->host transfer of the symbol planes.
        vals16 = jnp.stack([v0, v2], axis=-1).astype(jnp.int16)
        vals32 = jnp.stack([v1, v3], axis=-1)
        widths = jnp.stack(
            [
                jnp.where(emit_v, w0, 0),
                jnp.where(emit_v, w1, 0),
                jnp.where(emit_z, w2, 0),
                jnp.where(emit_z, w3, 0),
            ],
            axis=-1,
        ).astype(jnp.int8)

        h_n = jnp.where(active, jnp.where(zcond, 0, h2), h)
        sgn_n = jnp.where(active, jnp.where(zcond, 1, 0), sgnmod)
        skip_n = jnp.where(
            active, jnp.where(zcond, zr, 0),
            jnp.where(in_skip & (i < n), skip - 1, skip),
        )
        return (h_n, sgn_n, skip_n, bad), (vals16, vals32, widths)

    B = errs.shape[0]
    z = jnp.zeros((B,), I32)
    init = (params.init_history.astype(I32), z, z, jnp.zeros((B,), bool))
    xs = (jnp.arange(num_samples, dtype=I32), errs_t, zr_t)
    # unroll=2: same per-step-overhead amortization as predictor_errors.
    (h, s, sk, bad), (vals16, vals32, widths) = jax.lax.scan(
        step, init, xs, unroll=2
    )
    return (
        vals16.transpose(1, 0, 2),
        vals32.transpose(1, 0, 2),
        widths.transpose(1, 0, 2),
        bad,
    )


def _shl_s(x, c):
    """u32 << c with c in [0, 32] (c >= 32 -> 0; XLA shifts past the
    width are undefined)."""
    return jnp.where(c >= 32, jnp.zeros_like(x), x << (c.astype(U32) & 31))


def _shr_s(x, c):
    """u32 >> c with c in [0, 32]."""
    return jnp.where(c >= 32, jnp.zeros_like(x), x >> (c.astype(U32) & 31))


def merge_symbol_chunks(vals16, vals32, widths):
    """Fold each sample's four bit fields into one right-aligned 96-bit
    chunk — elementwise, so the host packer writes ONE multi-word field
    per channel-sample instead of four (the pack stage is the encode
    pipeline's serial bottleneck on a 1-core host; VERDICT r2 next #1).

    Returns (c0, c1, c2 (B, S) uint32 — c0 holds the high bits, value
    right-aligned in the low ``ws`` bits of c0:c1:c2 — and ws (B, S)
    int8 total widths, <= 9+32+9+31 = 81).  Width-0 fields are no-ops,
    matching the packer's convention.
    """
    h = jnp.zeros(vals16.shape[:2], U32)
    m = jnp.zeros_like(h)
    l = jnp.zeros_like(h)
    one = jnp.ones_like(h)
    fields = (
        (vals16[:, :, 0], widths[:, :, 0]),
        (vals32[:, :, 0], widths[:, :, 1]),
        (vals16[:, :, 1], widths[:, :, 2]),
        (vals32[:, :, 1], widths[:, :, 3]),
    )
    for val, w in fields:
        w = w.astype(I32)
        mask = _shl_s(one, w) - 1  # w=32 -> 0-1 = all ones
        v = val.astype(I32).astype(U32) & mask
        inv = 32 - w
        h = _shl_s(h, w) | _shr_s(m, inv)
        m = _shl_s(m, w) | _shr_s(l, inv)
        l = _shl_s(l, w) | v
    ws = (
        widths[:, :, 0].astype(I32) + widths[:, :, 1]
        + widths[:, :, 2] + widths[:, :, 3]
    )
    return h, m, l, ws.astype(jnp.int8)


def merge_pair_chunks(c0, c1, c2, ws):
    """Fold ADJACENT SAMPLES' 96-bit chunks into one 96-bit pair field —
    elementwise, so the host packer writes one multi-word field per TWO
    channel-samples (and the planes D2H halves: 13 B/pair vs 13 B/
    sample).  The host pack stage is the encode pipeline's bottleneck
    on a small-core host; with the two-frame interleaved native pair
    packer this roughly doubles it.

    Pair j covers samples (2j, 2j+1); sample widths beyond the lane's
    live count are 0 (rice_symbols masks them), so an odd live count
    just merges a zero-width tail.  A pair FITS when its combined width
    is <= 96 bits (each sample alone is <= 81: 9+32+9+31, see
    merge_symbol_chunks).  Non-fitting pairs — two adjacent near-
    maximal escape+zero-run samples, unreachable for real content but
    not provably impossible — poison the whole batch via ``fat``: the
    caller re-dispatches the classic per-sample planes for that batch
    (codec/encoder_tpu._pack), keeping correctness unconditional.

    Returns (ph, pm, pl (B, ceil(S/2)) uint32 — pair value right-
    aligned in the low ``pws`` bits of ph:pm:pl — pws (B, ceil(S/2))
    int8 combined widths (-1 for non-fitting pairs), fat (B,) bool).
    """
    if ws.shape[1] % 2:
        pad = [(0, 0), (0, 1)]
        c0, c1, c2 = (jnp.pad(x, pad) for x in (c0, c1, c2))
        ws = jnp.pad(ws, pad)
    wa = ws[:, 0::2].astype(I32)
    wb = ws[:, 1::2].astype(I32)
    wp = wa + wb
    fits = wp <= 96
    # A's 96-bit chunk shifted left by wb (0..96): sub-word shift by
    # r = wb & 31 on the 3-word ladder, then a word roll by wb >> 5.
    r = wb & 31
    inv = 32 - r  # in [1, 32]; _shr_s handles 32
    ah, am, al = c0[:, 0::2], c1[:, 0::2], c2[:, 0::2]
    h = _shl_s(ah, r) | _shr_s(am, inv)
    m = _shl_s(am, r) | _shr_s(al, inv)
    l = _shl_s(al, r)
    q = wb >> 5  # 0..2 for fitting pairs (wb <= 81)
    zero = jnp.zeros_like(h)
    h2 = jnp.where(q == 0, h, jnp.where(q == 1, m, l))
    m2 = jnp.where(q == 0, m, jnp.where(q == 1, l, zero))
    l2 = jnp.where(q == 0, l, zero)
    # B sits in the low wb bits; disjoint from A << wb when the pair
    # fits (wa <= 96 - wb), so plain ORs compose the pair.
    ph = h2 | c0[:, 1::2]
    pm = m2 | c1[:, 1::2]
    pl = l2 | c2[:, 1::2]
    pws = jnp.where(fits, wp, -1).astype(jnp.int8)
    fat = jnp.any(~fits, axis=1)
    return ph, pm, pl, pws, fat


def merge_quad_chunks(ph, pm, pl, pws):
    """Fold ADJACENT PAIRS' <=96-bit fields into one <=96-bit QUAD
    field — :func:`merge_pair_chunks` applied to its own output, so the
    host packer writes one field per FOUR samples and its per-field
    bookkeeping (the encode pipeline's host bottleneck) halves again.
    The native pair packer consumes the quad planes UNCHANGED — it only
    derives its field count from the per-frame ``n`` it is handed, so
    the caller passes ceil(n/2) (codec/encoder_tpu._pack_host_pairs)
    and everything else is identical.

    A quad FITS when its combined width is <= 96 bits, i.e. the four
    samples average <= 24 bits — always true for 16-bit content without
    adjacent escapes, typically false for 24-bit residuals (which stay
    on the pair path; the caller gates per batch via ``qfat``).  A
    non-fitting PAIR input (-1 width) also poisons: its batch is
    already routed to the classic chunk path by the pair-level ``fat``,
    but the quad fold must not shift by negative amounts, so widths are
    clamped for the math and the lane is marked fat here too.

    Returns (qh, qm, ql (B, ceil(S/4)) uint32, qws (B, ceil(S/4)) int8,
    qfat (B,) bool).
    """
    bad_pair = jnp.any(pws < 0, axis=1)
    wsc = jnp.maximum(pws, 0).astype(jnp.int8)
    qh, qm, ql, qws, qfat = merge_pair_chunks(ph, pm, pl, wsc)
    return qh, qm, ql, qws, qfat | bad_pair


@functools.partial(
    jax.jit,
    static_argnames=("num_samples", "max_order", "pairs", "quads"),
)
def encode_stages(sig, n, lp: LpcParams, rp: RiceEncParams, num_samples: int,
                  max_order: int = MAX_ORDER, pairs: bool = False,
                  quads: bool = False):
    """One-dispatch device encode: residuals -> zero-run lookahead ->
    rice symbols -> merged chunk planes.

    Returns (c0, c1, c2 (B, S) uint32, ws (B, S) int8, bits (B,) int32
    per-lane entropy-section bit totals, bad (B,) bool).  13 bytes per
    sample of D2H vs 16 for the raw symbol planes, and the per-lane bit
    totals come back as one (B,) vector instead of a host-side
    reduction over the width planes.

    ``pairs``: additionally fold adjacent samples via
    :func:`merge_pair_chunks` and return
    (ph, pm, pl (B, ceil(S/2)) uint32, pws (B, ceil(S/2)) int8, bits,
    bad, fat (B,) bool) — the native pair packer's input layout.

    ``quads`` (requires ``pairs``): ALSO fold adjacent pairs via
    :func:`merge_quad_chunks`, appending (qh, qm, ql, qws
    (B, ceil(S/4)), qfat (B,)) to the pair tuple.  Both plane sets come
    back as lazy device arrays; the host fetches the flags first and
    transfers only the set it will pack (codec/encoder_tpu), so the
    extra fold costs elementwise FLOPs but no extra D2H.
    """
    errs = predictor_errors(sig, n, lp, num_samples, max_order=max_order)
    zr = zero_run_lengths(errs, n, num_samples)
    v16, v32, widths, bad = rice_symbols(errs, zr, n, rp, num_samples)
    c0, c1, c2, ws = merge_symbol_chunks(v16, v32, widths)
    bits = jnp.sum(ws.astype(I32), axis=1)
    if pairs:
        ph, pm, pl, pws, fat = merge_pair_chunks(c0, c1, c2, ws)
        if quads:
            qh, qm, ql, qws, qfat = merge_quad_chunks(ph, pm, pl, pws)
            return ph, pm, pl, pws, bits, bad, fat, qh, qm, ql, qws, qfat
        return ph, pm, pl, pws, bits, bad, fat
    assert not quads, "quads requires pairs"
    return c0, c1, c2, ws, bits, bad


@functools.partial(
    jax.jit,
    static_argnames=(
        "num_samples", "max_order", "lw", "sh", "ub8", "wide",
        "pairs", "quads",
    ),
)
def encode_stages_pcm(
    pcm, stereo, n, lp: LpcParams, rp: RiceEncParams, num_samples: int,
    max_order: int = MAX_ORDER, lw: int = 0, sh: int = 0, ub8: int = 0,
    wide: bool = False, pairs: bool = False, quads: bool = False,
):
    """:func:`encode_stages` fed raw interleaved PCM.

    ``pcm``: (F, S, 2) int32 (channel 1 zeroed for mono lanes);
    ``stereo``: (F,) bool.  The extra-bits strip (``>> ub8``), stereo
    decorrelation (AlacFile.cs mid/side inverse run forward:
    cb = L - R, ca = R + ((cb*lw) >> sh)) and the channel fold into
    2F lanes all run on device — they are elementwise, so XLA fuses
    them into the automaton prologue and the host sheds two full
    passes over the chunk.  ``wide`` marks post-strip sample
    widths over 16 bits (24-bit no-extra-bits content), where
    |cb| * leftweight can pass 2^31; the host encoder computes those in
    int64 and truncates to int32.  JAX here runs without x64, so the
    wide product is emulated exactly in two int32 registers:
    cb*lw = (cb>>16)*lw * 2^16 + (cb&0xFFFF)*lw with both partials
    in-range, and the static ``>> sh`` distributes exactly over the
    split (sh <= 16: the high partial is 2^sh-divisible; sh > 16: the
    low partial can never carry past 2^sh).  int32 wrap-around equals
    the host's int64-then-truncate mod 2^32, + and << being modular.
    Narrow content multiplies directly — no product overflows.
    """
    hi = (pcm >> ub8) if ub8 else pcm
    l_ch, r_ch = hi[:, :, 0], hi[:, :, 1]
    if lw != 0:
        cb = l_ch - r_ch
        if wide:
            p_hi = (cb >> 16) * lw
            p_lo = (cb & 0xFFFF) * lw
            if sh <= 16:
                adj = (p_hi << (16 - sh)) + (p_lo >> sh)
            else:
                adj = p_hi >> (sh - 16)
        else:
            adj = (cb * lw) >> sh
        ca = r_ch + adj
    else:
        ca, cb = l_ch, r_ch
    st = stereo[:, None]
    sig = jnp.concatenate(
        [
            jnp.where(st, ca, l_ch).astype(I32),
            jnp.where(st, cb, 0).astype(I32),
        ]
    )
    return encode_stages(
        sig, n, lp, rp, num_samples, max_order=max_order,
        pairs=pairs, quads=quads,
    )

# ---------------------------------------------------------------------------
# Device-side frame packing (round 3): the coded BYTES leave the chip.
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("stride_words", "K"))
def pack_frames_device(
    c0, c1, c2, ws, n, stereo, hbits, stride_words: int, K: int = 34
):
    """Assemble whole coded frame BODIES on device from the merged
    96-bit sample chunks — the encode mirror of decode's device-side
    row assembly (ops/pack_rows.py): the host packer leaves the
    pipeline and the D2H drops from ~13 B/sample of chunk planes to the
    coded bytes themselves.

    Bit packing is a prefix-sum problem, not a serial one: each output
    32-bit word's content depends only on which symbols overlap its bit
    range.  Three vector phases, no scan:

      1. fold the chunk planes frame-major (channel A's symbols then
         B's — the bitstream concatenation order, AlacFile.cs:643,653)
         and COMPACT away zero-width slots (zero-run-compressed samples
         emit nothing; without compaction a silence run would starve
         the bounded gather window below);
      2. ``ends = hbits + cumsum(widths)`` — every symbol's absolute
         bit range, with the whole body pre-offset by the frame's
         header bit count so the host can OR the ragged header fields
         into the zeroed prefix without shifting the body;
      3. for every output word j: ``searchsorted(ends, 32j)`` finds the
         first overlapping symbol; OR together the next ``K``
         candidates' in-window bits (a 32-bit window intersects at most
         32/min_width+2 <= 34 post-compaction symbols, each >= 1 bit).

    Inputs: ``c0,c1,c2`` (B, S) uint32 right-aligned pre-masked chunks,
    ``ws`` (B, S) int8 widths (lane f = channel A of frame f, lane F+f
    = channel B); ``n`` (F,) valid samples; ``stereo`` (F,) bool;
    ``hbits`` (F,) int32 header bit counts.  Returns
    (rows (F, stride_words*4) uint8 — big-endian bit stream, header
    region zeroed — and end_bits (F,) int32).

    The extra-bits plane (ub != 0) is NOT packed here; callers keep
    those frames on the host packer.
    """
    a0, a1, a2, starts, ends, end_bits, NS = _pack_fold_compact(
        c0, c1, c2, ws, n, stereo, hbits
    )
    F = ws.shape[0] // 2

    lo_row = jnp.arange(stride_words, dtype=I32) * 32
    first = jax.vmap(
        lambda e: jnp.searchsorted(e, lo_row, side="right")
    )(ends).astype(I32)
    lo = lo_row[None, :]
    hi = lo + 32

    acc = jnp.zeros((F, stride_words), U32)
    for t in range(K):
        k = first + t
        kc = jnp.minimum(k, NS - 1)
        st = jnp.take_along_axis(starts, kc, axis=1)
        en = jnp.take_along_axis(ends, kc, axis=1)
        v0 = jnp.take_along_axis(a0, kc, axis=1)
        v1 = jnp.take_along_axis(a1, kc, axis=1)
        v2 = jnp.take_along_axis(a2, kc, axis=1)
        live = (k < NS) & (st < hi) & (en > lo) & (en > st)
        win = _win32(v0, v1, v2, en - hi)
        acc = acc | jnp.where(live, win, jnp.zeros_like(win))

    return _rows_be(acc, F, stride_words), end_bits


def _pack_fold_compact(c0, c1, c2, ws, n, stereo, hbits):
    """Phases 1-2 shared by the pack variants: frame-major channel fold,
    zero-width compaction, absolute bit ranges."""
    F, S = ws.shape[0] // 2, ws.shape[1]
    NS = 2 * S
    samp = jnp.arange(S, dtype=I32)[None, :]
    mA = samp < n[:, None]
    mB = mA & stereo[:, None]

    def fold(plane, dtype):
        a = jnp.where(mA, plane[:F], 0).astype(dtype)
        b = jnp.where(mB, plane[F:], 0).astype(dtype)
        return jnp.concatenate([a, b], axis=1)

    ws_f = fold(ws.astype(I32), I32)
    mask = ws_f > 0
    # Compact real symbols to the front; dropped slots scatter past the
    # row end (mode='drop').
    dest = jnp.where(mask, jnp.cumsum(mask, axis=1) - 1, NS)
    fidx = jnp.broadcast_to(jnp.arange(F, dtype=I32)[:, None], (F, NS))

    def compact(plane):
        # NOT unique_indices: every dropped slot shares dest == NS, and
        # XLA's uniqueness promise is undefined for duplicates even
        # when they fall out of bounds — a backend may exploit it before
        # bounds-dropping.
        return (
            jnp.zeros((F, NS), plane.dtype)
            .at[fidx, dest]
            .set(plane, mode="drop")
        )

    cw = compact(ws_f)
    a0 = compact(fold(c0, U32))
    a1 = compact(fold(c1, U32))
    a2 = compact(fold(c2, U32))

    ends = hbits[:, None] + jnp.cumsum(cw, axis=1)
    starts = ends - cw
    return a0, a1, a2, starts, ends, ends[:, -1], NS


def _win32(v0, v1, v2, s):
    """The 32-bit window of the 96-bit value v0:v1:v2 whose LSB sits
    ``s`` bits above the value's LSB (s >= 0: field extends past the
    window; s < 0: field ends -s bits inside it)."""
    sr = jnp.maximum(s, 0)
    right = jnp.where(
        sr < 32,
        _shr_s(v2, sr) | _shl_s(v1, 32 - sr),
        jnp.where(
            sr < 64,
            _shr_s(v1, sr - 32) | _shl_s(v0, 64 - sr),
            _shr_s(v0, jnp.minimum(sr - 64, 32)),
        ),
    )
    left = _shl_s(v2, jnp.maximum(-s, 0))
    return jnp.where(s >= 0, right, left)


def _rows_be(acc, F: int, stride_words: int):
    """(F, W) u32 accumulators -> (F, W*4) big-endian stream bytes."""
    be = (
        (acc >> 24)
        | ((acc >> 8) & 0xFF00)
        | ((acc << 8) & 0xFF0000)
        | (acc << 24)
    )
    return jax.lax.bitcast_convert_type(be, jnp.uint8).reshape(
        F, stride_words * 4
    )


@functools.partial(jax.jit, static_argnames=("stride_words",))
def pack_frames_device_scatter(
    c0, c1, c2, ws, n, stereo, hbits, stride_words: int
):
    """Scatter-add formulation of :func:`pack_frames_device` — the
    symmetric alternative: instead of each output word GATHERING its
    <= K overlapping symbols, each symbol SCATTERS its <= 4 word
    contributions (a <= 81-bit chunk spans at most ceil((81+31)/32) = 4
    output words).  Contributions to a shared word occupy disjoint bit
    ranges, so an integer scatter-ADD is exactly bitwise OR and
    duplicate indices are well-defined.  ~4*NS scattered elements vs
    the gather's K*W*6 gathered ones; which wins is a lowering
    question for the device at hand.
    """
    a0, a1, a2, starts, ends, end_bits, NS = _pack_fold_compact(
        c0, c1, c2, ws, n, stereo, hbits
    )
    F = ws.shape[0] // 2
    fidx = jnp.broadcast_to(jnp.arange(F, dtype=I32)[:, None], (F, NS))
    j0 = starts >> 5
    acc = jnp.zeros((F, stride_words), U32)
    for t in range(4):
        j = j0 + t
        live = (ends > starts) & (j * 32 < ends)
        val = _win32(a0, a1, a2, ends - (j * 32 + 32))
        val = jnp.where(live, val, jnp.zeros_like(val))
        jc = jnp.where(live, j, stride_words)  # drop dead updates
        acc = acc.at[fidx, jc].add(val, mode="drop")
    return _rows_be(acc, F, stride_words), end_bits
