"""chip_smoke.py on the CPU: it refuses to run without a GPU or outside a
checkout, and its phase functions hold at tiny sizes."""

from __future__ import annotations

import os
import pathlib
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def _run(cwd, script):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run(
        [sys.executable, str(script)], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_exits_nonzero_without_gpu():
    r = _run(ROOT, ROOT / "chip_smoke.py")
    assert r.returncode != 0
    assert r.stdout == ""
    assert "no GPU" in r.stderr


def test_exits_nonzero_outside_checkout(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run(tmp_path, tmp_path / "chip_smoke.py")
    assert r.returncode != 0
    assert r.stdout == ""


def test_catalog_encode_decode_reader_phases(tmp_path):
    tracks = chip_smoke.build_catalog(seed=3, scale=0.002)
    assert [t.fmt for t in tracks].count("cd16") == 12
    paths = chip_smoke.encode_catalog(tracks, str(tmp_path), seed=3, sample=4)
    chip_smoke.decode_catalog(tracks, paths, seed=3, oracle_frames=1)
    i = next(i for i, t in enumerate(tracks) if t.fmt == "hires24")
    chip_smoke.check_reader(tracks[i], paths[i], count=200)


def test_kernel_parity_phase():
    chip_smoke.kernel_parity(
        8, "interpret", kinds=["orders", "hires24"], frame=64, distinct=8
    )


def test_encode_phase_catches_a_wrong_frame(tmp_path, monkeypatch):
    """The byte check fails when the host encoder disagrees."""
    import alacnet_tpu

    tracks = chip_smoke.build_catalog(seed=4, scale=0.001)[:1]

    class Wrong(alacnet_tpu.AlacEncoder):
        def encode_frame(self, pcm):
            return b"\x00" + super().encode_frame(pcm)

    monkeypatch.setattr(alacnet_tpu, "AlacEncoder", Wrong)
    with pytest.raises(AssertionError, match="differs from the host encoder"):
        chip_smoke.encode_catalog(tracks, str(tmp_path), seed=4, sample=2)


def test_four_device_phase(tmp_path):
    """The --four phase on four virtual CPU devices: mesh encode and mesh
    decode (device row assembly) against one device."""
    tracks = chip_smoke.build_catalog(seed=5, scale=0.001)
    chip_smoke.four_gpu(tracks, str(tmp_path), seed=5)
