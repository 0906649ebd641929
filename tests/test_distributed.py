"""Multi-process distributed decode: N CPU processes, one global mesh.

SURVEY.md §2.5 comm-backend row / VERDICT r1 missing #2: the
jax.distributed path, exercised without a cluster by launching worker
subprocesses each owning 4 virtual CPU devices.  Workers shard the
corpus by global frame index (process-local ingestion), decode over the
global mesh, and verify (a) globally-psummed accounting scalars and
(b) bit-exact local PCM shards.
"""

import os
import socket
import subprocess
import sys

import pytest

WORKER = os.path.join(os.path.dirname(__file__), "distributed_worker.py")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(nprocs, mode="even", skip=(), extra_env=None):
    port = _free_port()
    coordinator = f"127.0.0.1:{port}"
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env.update(extra_env or {})
    # Workers run on the CPU backend (forced in the worker too).
    return [
        subprocess.Popen(
            [sys.executable, WORKER, coordinator, str(nprocs), str(pid), mode],
            env=env,
            cwd=REPO,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for pid in range(nprocs)
        if pid not in skip
    ]


def _communicate(procs, timeout=420):
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("distributed workers timed out:\n" + "\n".join(outs))
    return outs


@pytest.mark.parametrize(
    "nprocs,mode", [(2, "even"), (2, "uneven"), (4, "uneven")]
)
def test_multiprocess_decode_bit_exact(nprocs, mode):
    procs = _launch(nprocs, mode)
    outs = _communicate(procs)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
        assert f"proc {pid}/{nprocs}: OK" in out


def test_missing_worker_fails_cleanly_without_hang():
    """A worker that never joins must FAIL the job within the bounded
    initialization timeout — never hang it (SURVEY.md §5 failure
    detection; VERDICT r2 next #6)."""
    procs = _launch(
        2, skip={1}, extra_env={"ALAC_DIST_INIT_TIMEOUT": "15"}
    )
    outs = _communicate(procs, timeout=120)
    (p,) = procs
    assert p.returncode != 0, "lone worker should fail, not succeed"
    assert "proc 0/2: OK" not in outs[0]
