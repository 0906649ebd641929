"""Multi-device sharding: frame-batch data parallelism over a device mesh.

ALAC frames are fully independent (all decoder state is re-read from the
bitstream per frame, AlacFile.cs:432-434), so the primary axis is DP over
frames (SURVEY.md §2.5): `jax.sharding` partitions the lane axis of every
batch array across the mesh and XLA runs the identical fused decode on
each device's shard with zero cross-device traffic in the decode math.
The only collectives are reductions/gathers over *results* (throughput
accounting, checksum).  The mesh is 1-D: frames need no topology.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.frame_decode import FrameMetaArrays, decode_frames

FRAME_AXIS = "frames"


def make_mesh(devices=None) -> Mesh:
    """1-D mesh over all (or the given) devices, frame-parallel."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (FRAME_AXIS,))


def shard_frame_batch(fb, mesh: Mesh):
    """Place a padded FrameBatch onto the mesh, lane axis sharded.

    Returns (words, packed_meta) — metadata travels as ONE packed int32
    matrix (FrameMetaArrays.pack_host): two transfers per batch instead
    of 18, and each goes straight to its target shards
    (``device_put(np_array, sharding)``) — no ``jnp.asarray`` detour,
    which would first commit every array to the *default* device (a
    wasted full-batch H2D + reshard on a real mesh).
    """
    sh = NamedSharding(mesh, P(FRAME_AXIS))
    words = jax.device_put(np.ascontiguousarray(fb.words), sh)
    meta = jax.device_put(FrameMetaArrays.pack_host(fb), sh)
    return words, meta


@functools.partial(jax.jit, static_argnames=("num_samples",))
def _decode_and_account(words, packed_meta, num_samples: int):
    """Sharded decode + the cross-chip accounting collectives.

    The decode itself is embarrassingly parallel; the sample count and a
    PCM checksum are global reductions (XLA inserts the psums).
    """
    out, n = decode_frames(
        words, FrameMetaArrays.unpack(packed_meta), num_samples
    )
    total_samples = jnp.sum(n.astype(jnp.int32))
    checksum = jnp.sum(out.astype(jnp.int32))  # wraps mod 2^32 (x64 disabled)
    return out, n, total_samples, checksum


def decode_frames_spmd(
    words, packed_meta, mesh: Mesh, num_samples: int, **kw,
):
    """decode_frames over mesh-sharded inputs via shard_map.

    ``packed_meta`` is the (B, N_PACKED) matrix from shard_frame_batch;
    ``kw`` are decode_frames' static options (route, max_order, emit16).
    Each device decodes its lane shard independently (zero collectives in
    the decode math); shard_map — rather than bare jit-SPMD — so the
    Pallas kernel runs per shard without custom-call partitioning rules.
    """
    spec = P(FRAME_AXIS)

    def fn(w, m):
        return decode_frames(w, FrameMetaArrays.unpack(m), num_samples, **kw)

    # check_vma=False: decode_frames' lax.cond fast-skips pair a varying
    # compute branch with replicated zeros — sound here (the zeros are
    # per-shard constants), but the vma type checker can't see that.
    return jax.shard_map(
        fn, mesh=mesh, in_specs=(spec, spec), out_specs=(spec, spec),
        check_vma=False,
    )(words, packed_meta)


def decode_frames_spmd_rows(
    bwords,
    ow: np.ndarray,
    nbytes: np.ndarray,
    W: int,
    packed_meta: np.ndarray,
    mesh: Mesh,
    num_samples: int,
    **kw,
):
    """Sharded decode with device-side row assembly (config.device_pack).

    The word blob (ops/pack_rows.blob_words) is replicated across the
    mesh — one broadcast per corpus, about half the bytes of the padded
    row grid — and each shard gathers only its own lanes' rows before
    decoding them: the host never packs word rows, so multi-device
    scaling isn't re-bottlenecked on the host packer.
    ``ow``/``nbytes``/``packed_meta`` are host arrays padded to the
    global lane count; they shard on the frame axis.
    """
    from ..ops.pack_rows import pack_rows

    spec = P(FRAME_AXIS)
    sh = NamedSharding(mesh, spec)

    def fn(bw, o, nb, m):
        words = pack_rows(bw, o, nb, W)
        return decode_frames(words, FrameMetaArrays.unpack(m), num_samples, **kw)

    bwords_r = jax.device_put(bwords, NamedSharding(mesh, P()))
    ow_d = jax.device_put(np.ascontiguousarray(ow.astype(np.int32)), sh)
    nb_d = jax.device_put(np.ascontiguousarray(nbytes.astype(np.int32)), sh)
    meta_d = jax.device_put(packed_meta, sh)
    return jax.shard_map(
        fn,
        mesh=mesh,
        in_specs=(P(), spec, spec, spec),
        out_specs=(spec, spec),
        check_vma=False,
    )(bwords_r, ow_d, nb_d, meta_d)


def decode_frames_sharded(fb, mesh: Mesh, num_samples: int):
    """Decode a FrameBatch across every device in the mesh.

    Returns (samples (B, S, 2) — sharded on the frame axis, n (B,),
    total_samples, checksum).  ``fb.batch`` must be divisible by the mesh
    size (use parallel.pipeline.pad_frame_batch).
    """
    words, meta = shard_frame_batch(fb, mesh)
    with mesh:
        return _decode_and_account(words, meta, num_samples)


def encode_stages_pcm_spmd(
    pcm, stereo, n, lp, rp, mesh: Mesh, num_samples: int,
    max_order: int, lw: int, sh: int, ub8: int, wide: bool,
    pairs: bool = False, quads: bool = False,
):
    """ops/encode.encode_stages_pcm over a frame-sharded mesh — the
    encode mirror of :func:`decode_frames_spmd` (DP over frames, zero
    collectives in the math; the two sequential automatons run
    per-shard).

    The channel fold makes lane order the one subtlety: globally the
    planes are [all channel-A lanes, all channel-B lanes], but each
    shard folds only its own frames.  All (2F,)-shaped lane params and
    all outputs therefore travel as (2, F, ...) — channel-major with
    the FRAME axis sharded — so the global order is preserved exactly;
    hosts reshape back to (2F, ...) for the packer (a free view).

    ``pcm`` (F, S, 2) int32, ``n``/``lp``/``rp`` in the flat (2F,) lane
    layout.  Returns (c0, c1, c2, ws, bits, bad) each (2, F, ...), or
    the 7-tuple pair-plane layout under ``pairs`` (the fold is
    elementwise, so it shards with the frames for free), or the
    12-tuple pair+quad layout under ``quads`` (ops/encode.encode_stages).
    """
    from ..ops.encode import RiceEncParams, encode_stages_pcm
    from ..ops.lpc import LpcParams

    F = pcm.shape[0]
    fsh = NamedSharding(mesh, P(FRAME_AXIS))
    csh = NamedSharding(mesh, P(None, FRAME_AXIS))

    def to2(x):
        a = np.asarray(x)
        return jax.device_put(
            np.ascontiguousarray(a.reshape(2, F, *a.shape[1:])), csh
        )

    pcm_d = jax.device_put(np.ascontiguousarray(pcm), fsh)
    st_d = jax.device_put(np.ascontiguousarray(stereo), fsh)
    n2 = to2(n)
    lp2 = LpcParams(*(to2(x) for x in lp))
    rp2 = RiceEncParams(*(to2(x) for x in rp))

    def fn(pcm_l, st_l, n_l, lp_l, rp_l):
        f = pcm_l.shape[0]

        def flat(x):
            return x.reshape(2 * f, *x.shape[2:])

        def two(x):
            return x.reshape(2, f, *x.shape[1:])

        out = encode_stages_pcm(
            pcm_l, st_l, flat(n_l),
            LpcParams(*(flat(x) for x in lp_l)),
            RiceEncParams(*(flat(x) for x in rp_l)),
            num_samples, max_order=max_order, lw=lw, sh=sh, ub8=ub8,
            wide=wide, pairs=pairs, quads=quads,
        )
        return tuple(two(x) for x in out)

    cspec = P(None, FRAME_AXIS)
    n_out = 12 if (pairs and quads) else 7 if pairs else 6
    return jax.shard_map(
        fn,
        mesh=mesh,
        in_specs=(P(FRAME_AXIS), P(FRAME_AXIS), cspec, cspec, cspec),
        out_specs=(cspec,) * n_out,
        check_vma=False,
    )(pcm_d, st_d, n2, lp2, rp2)
