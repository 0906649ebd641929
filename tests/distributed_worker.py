"""Worker process for the multi-process distributed decode test.

Invoked by tests/test_distributed.py as:
    python tests/distributed_worker.py <coordinator> <nprocs> <pid> [mode]
with JAX_PLATFORMS=cpu and xla_force_host_platform_device_count set, so
N processes x K virtual CPU devices emulate an N-host pod slice
(SURVEY.md §4 "multi-node without a cluster").

Modes: ``even`` (default) — every process ingests FRAMES_PER_PROC
frames; ``uneven`` — process p ingests FRAMES_PER_PROC + (P-1-p) frames
and pads its shard to the common per-process batch with n_samples=0
lanes (the real-corpus case: file counts never divide evenly).
ALAC_DIST_INIT_TIMEOUT bounds jax.distributed.initialize so a dead peer
fails the job instead of hanging it (tests the failure-detection row).
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=4"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import alacnet_tpu.parallel.distributed as dist  # noqa: E402
from alacnet_tpu.codec.cookie import default_cookie  # noqa: E402
from alacnet_tpu.codec.encoder import AlacEncoder, EncoderConfig  # noqa: E402
from alacnet_tpu.codec.framemeta_vec import parse_frame_headers_vec  # noqa: E402
from alacnet_tpu.parallel.pipeline import pad_frame_batch  # noqa: E402

FRAME_SAMPLES = 64
FRAMES_PER_PROC = 8


def corpus(total_frames: int):
    """Deterministic corpus — identical in every process."""
    params = default_cookie(44100, 16, 2, max_samples_per_frame=FRAME_SAMPLES)
    enc = AlacEncoder(params, EncoderConfig(order=4))
    rng = np.random.default_rng(0xD15C)
    t = np.arange(total_frames * FRAME_SAMPLES)
    pcm = np.stack(
        [
            np.clip(2500 * np.sin(t * 0.06) + rng.normal(0, 30, t.size), -32768, 32767),
            np.clip(2000 * np.sin(t * 0.05 + 1) + rng.normal(0, 30, t.size), -32768, 32767),
        ],
        axis=1,
    ).astype(np.int32)
    payloads = [
        enc.encode_frame(pcm[i * FRAME_SAMPLES : (i + 1) * FRAME_SAMPLES])
        for i in range(total_frames)
    ]
    return payloads, params, pcm


def main() -> int:
    coordinator, nprocs, pid = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    mode = sys.argv[4] if len(sys.argv) > 4 else "even"
    timeout = int(os.environ.get("ALAC_DIST_INIT_TIMEOUT", "0")) or None
    dist.initialize(coordinator, nprocs, pid, initialization_timeout=timeout)
    assert jax.process_count() == nprocs
    mesh = dist.global_mesh()
    if mode == "uneven":
        counts = [FRAMES_PER_PROC + (nprocs - 1 - p) for p in range(nprocs)]
    else:
        counts = [FRAMES_PER_PROC] * nprocs
    # Common per-process batch: max shard, rounded up to the local
    # device count (every process must present the same local shape).
    ndev_local = 4
    pad_to = -(-max(counts) // ndev_local) * ndev_local
    total_frames = sum(counts)
    payloads, params, pcm = corpus(total_frames)
    # Process-local shard: no frame data crosses a process boundary.
    lo = sum(counts[:pid])
    local = payloads[lo : lo + counts[pid]]
    fb = pad_frame_batch(parse_frame_headers_vec(local, params), pad_to)
    out, n, total, checksum = dist.decode_frames_global(fb, mesh, FRAME_SAMPLES)

    # Global accounting scalars: identical on every process (padded
    # lanes decode as n=0 and contribute nothing).
    assert int(total) == total_frames * FRAME_SAMPLES, int(total)
    expect_ck = int(pcm.astype(np.int64).sum()) & 0xFFFFFFFF
    assert int(checksum) & 0xFFFFFFFF == expect_ck, (int(checksum), expect_ck)

    # Local shards: bit-exact against this process's slice of the PCM.
    out_l, n_l = dist.local_samples(out, n)
    k = counts[pid]
    assert (n_l[:k] == FRAME_SAMPLES).all()
    assert (n_l[k:] == 0).all()  # padded lanes
    got = out_l[:k, :, :2].reshape(-1, 2)
    want = pcm[lo * FRAME_SAMPLES : (lo + k) * FRAME_SAMPLES]
    np.testing.assert_array_equal(got, want)
    print(f"proc {pid}/{nprocs}: OK total={int(total)} ck={int(checksum)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
