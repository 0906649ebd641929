"""Multi-process / multi-host decode: jax.distributed.

The reference has no networking of any kind (SURVEY.md §2.5 — the whole
repo is one in-proc library); this is the comm-backend tier the device
build promises there.  Design:

  * **Corpus sharding (across processes):** ALAC frames are independent, so a
    corpus shards by *global frame index* — process p takes frames
    [p*F/P, (p+1)*F/P).  No frame data ever crosses a process boundary.
  * **Device sharding (within a process):** the frame axis
    shards further over local devices via the same 1-D mesh as the
    single-process path (parallel/mesh.py).
  * **Collectives:** the decode math needs none; only accounting scalars
    (total samples, PCM checksum) reduce over the global mesh — XLA
    inserts the psums.

Recipe (each process):

    import alacnet_tpu.parallel.distributed as dist
    dist.initialize(coordinator, num_processes, process_id)   # once
    mesh = dist.global_mesh()
    fb_local = parse(local frame shard)                        # host
    out, n, total, checksum = dist.decode_frames_global(
        fb_local, mesh, num_samples)
    # out/n are globally sharded; each process materializes only its
    # addressable shards: dist.local_samples(out, n, ...)

Tested without a cluster by launching N CPU processes, each with K
virtual devices (tests/test_distributed.py), matching SURVEY.md §4
"multi-node without a cluster".
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.frame_decode import FrameMetaArrays
from .mesh import FRAME_AXIS, _decode_and_account


def initialize(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    initialization_timeout: int | None = None,
) -> None:
    """Join the distributed runtime (jax.distributed.initialize).

    Call once per process before any device computation.  Where no
    cluster environment tells JAX the layout, all three arguments are
    required (the coordinator at ``localhost:<port>`` on one host).

    ``initialization_timeout`` (seconds) bounds the wait for peers: a
    worker that never arrives fails the job cleanly instead of hanging
    it (SURVEY.md §5 failure detection; default is JAX's 300 s).
    """
    kw = {}
    if initialization_timeout is not None:
        kw["initialization_timeout"] = initialization_timeout
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        **kw,
    )


def global_mesh() -> Mesh:
    """1-D frame-parallel mesh over every device in every process."""
    return Mesh(np.asarray(jax.devices()), (FRAME_AXIS,))


def shard_frame_batch_global(fb_local, mesh: Mesh):
    """Assemble the global sharded batch from per-process local shards.

    ``fb_local`` is this process's slice of the global frame batch; all
    processes must pass the same per-process batch size (pad with
    n_samples=0 lanes via parallel.pipeline.pad_frame_batch).  Only the
    local shard is transferred on each host — no cross-process data
    movement (frames are decoded where they were ingested).
    """
    sh = NamedSharding(mesh, P(FRAME_AXIS))
    words = jax.make_array_from_process_local_data(
        sh, np.ascontiguousarray(fb_local.words)
    )
    # Metadata travels as ONE packed matrix per process (two local
    # transfers per batch total; see FrameMetaArrays.pack_host).
    meta = jax.make_array_from_process_local_data(
        sh, FrameMetaArrays.pack_host(fb_local)
    )
    return words, meta


def decode_frames_global(fb_local, mesh: Mesh, num_samples: int):
    """Decode the global frame batch; returns sharded results.

    Returns (out (B_global, S, 2) sharded, n (B_global,) sharded,
    total_samples, checksum) — the scalars are identical on every
    process (global psum).
    """
    words, meta = shard_frame_batch_global(fb_local, mesh)
    with mesh:
        return _decode_and_account(words, meta, num_samples)


def local_samples(out, n) -> tuple[np.ndarray, np.ndarray]:
    """Materialize this process's addressable shard of (out, n).

    Shards come back in global-index order of this process's lanes, so
    concatenating per-process results in process order reassembles the
    full corpus.
    """
    out_shards = sorted(
        out.addressable_shards, key=lambda s: s.index[0].start or 0
    )
    n_shards = sorted(
        n.addressable_shards, key=lambda s: s.index[0].start or 0
    )
    return (
        np.concatenate([np.asarray(s.data) for s in out_shards]),
        np.concatenate([np.asarray(s.data) for s in n_shards]),
    )
