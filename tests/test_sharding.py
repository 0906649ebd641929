"""Multi-chip sharded decode on the 8-device virtual CPU mesh.

SURVEY.md §4: "multi-node without a cluster" — conftest.py forces
xla_force_host_platform_device_count=8, matching the driver's
dryrun_multichip environment.
"""

import io

import jax
import numpy as np
import pytest

from alacnet_tpu.codec.framemeta_vec import parse_frame_headers_vec
from alacnet_tpu.container import demux
from alacnet_tpu.parallel.mesh import decode_frames_sharded, make_mesh
from alacnet_tpu.parallel.pipeline import pad_frame_batch

from .corpus import encode_to_bytes, tone

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs the 8-device virtual CPU mesh"
)


def test_sharded_decode_bit_exact():
    pcm = tone(4096 * 8, 2, 16)
    data = encode_to_bytes(pcm, 44100, 16)
    info = demux.parse(io.BytesIO(data))
    offs = info.tables.frame_file_offsets()
    sizes = info.tables.frame_byte_sizes
    payloads = [data[o : o + s] for o, s in zip(offs, sizes)]
    fb = pad_frame_batch(parse_frame_headers_vec(payloads, info.params), 8)

    mesh = make_mesh(jax.devices()[:8])
    out, n, total, checksum = decode_frames_sharded(fb, mesh, 4096)
    # Output is sharded across chips on the frame axis.
    assert len(out.sharding.device_set) == 8
    got = np.asarray(out).reshape(-1, 2)[: pcm.shape[0]]
    np.testing.assert_array_equal(got, pcm)
    assert int(total) == pcm.shape[0]
    expect_ck = int(pcm.astype(np.int64).sum()) & 0xFFFFFFFF
    assert int(checksum) & 0xFFFFFFFF == expect_ck


def test_graft_entry_single_chip():
    import __graft_entry__ as g

    fn, args = g.entry()
    out, n = jax.jit(fn, static_argnums=()).lower(*args).compile()(*args)
    assert out.shape[0] == args[0].shape[0]
    assert int(np.asarray(n).sum()) == 8 * 256


def test_graft_dryrun_multichip():
    import __graft_entry__ as g

    g.dryrun_multichip(8)


@pytest.mark.parametrize("devpack", [True, False])
def test_decode_blob_over_mesh(devpack, monkeypatch):
    """The production blob pipeline sharded over the 8-device CPU mesh
    equals the single-device decode bit-for-bit (round 2) — both with
    device-side row assembly (the blob replicated, per-shard gathers;
    round 3) and with host-packed rows."""
    import numpy as np

    from alacnet_tpu import config as cfg
    from alacnet_tpu.codec.cookie import default_cookie
    from alacnet_tpu.codec.encoder import AlacEncoder, EncoderConfig
    from alacnet_tpu.parallel.mesh import make_mesh
    from alacnet_tpu.parallel.pipeline import decode_blob

    monkeypatch.setattr(cfg.DEFAULT, "device_pack", devpack)

    params = default_cookie(44100, 16, 2, max_samples_per_frame=128)
    enc = AlacEncoder(params, EncoderConfig(order=4))
    rng = np.random.default_rng(17)
    payloads = [
        enc.encode_frame(rng.integers(-3000, 3000, (128, 2)).astype(np.int32))
        for _ in range(24)
    ]
    sizes = np.array([len(p) for p in payloads], np.int64)
    offsets = np.concatenate(([0], np.cumsum(sizes)))[:-1]
    blob = np.frombuffer(b"".join(payloads), np.uint8)
    ref_out, ref_n, ref_st = decode_blob(blob, offsets, sizes, params, 128)
    mesh = make_mesh()
    out, n, st = decode_blob(blob, offsets, sizes, params, 128, mesh=mesh)
    np.testing.assert_array_equal(out, ref_out)
    np.testing.assert_array_equal(n, ref_n)
    np.testing.assert_array_equal(st, ref_st)


def test_decode_blob_cpu_mesh_under_gpu_default_backend(monkeypatch):
    """Platform-mismatch regression: a CPU mesh in a process whose
    DEFAULT backend is the GPU (a virtual CPU mesh on a GPU machine)
    must not route the compiled Triton kernel onto the CPU shards: the
    route follows the mesh devices' platform, not jax.default_backend()
    (parallel/pipeline.dispatch_frame_batch, ops/route.py)."""
    import numpy as np

    import jax as jax_mod

    from alacnet_tpu import config as cfg
    from alacnet_tpu.codec.cookie import default_cookie
    from alacnet_tpu.codec.encoder import AlacEncoder, EncoderConfig
    from alacnet_tpu.parallel.mesh import make_mesh
    from alacnet_tpu.parallel.pipeline import decode_blob

    monkeypatch.setattr(cfg.DEFAULT, "device_pack", True)
    params = default_cookie(44100, 16, 2, max_samples_per_frame=128)
    enc = AlacEncoder(params, EncoderConfig(order=4))
    rng = np.random.default_rng(23)
    payloads = [
        enc.encode_frame(rng.integers(-3000, 3000, (128, 2)).astype(np.int32))
        for _ in range(16)
    ]
    sizes = np.array([len(p) for p in payloads], np.int64)
    offsets = np.concatenate(([0], np.cumsum(sizes)))[:-1]
    blob = np.frombuffer(b"".join(payloads), np.uint8)
    ref_out, ref_n, ref_st = decode_blob(blob, offsets, sizes, params, 128)
    mesh = make_mesh()
    # Simulate a GPU process default without needing real hardware.
    monkeypatch.setattr(jax_mod, "default_backend", lambda: "gpu")
    out, n, st = decode_blob(blob, offsets, sizes, params, 128, mesh=mesh)
    np.testing.assert_array_equal(out, ref_out)
    np.testing.assert_array_equal(n, ref_n)
    np.testing.assert_array_equal(st, ref_st)


def test_sharded_encode_byte_identical():
    """encode_frames_tpu(mesh=): DP-sharded encode over the 8-device
    mesh, byte-identical to the single-device device encoder — incl. a
    ragged chunk (F not divisible by the mesh) via silent-frame padding
    and mixed mono/partial frames."""
    from alacnet_tpu.codec.cookie import default_cookie
    from alacnet_tpu.codec.encoder import EncoderConfig
    from alacnet_tpu.codec.encoder_tpu import encode_frames_tpu
    from alacnet_tpu.parallel.mesh import make_mesh

    S = 256
    params = default_cookie(44100, 16, 2, max_samples_per_frame=S)
    cfg = EncoderConfig(order=4)
    frames = [tone(S, 2, 16, seed=i) for i in range(17)]  # 17 % 8 != 0
    frames[3] = np.zeros((S, 2), np.int32)  # zero-run content
    frames[5] = tone(S, 1, 16, seed=99)  # mono lane
    frames[11] = tone(S // 2 + 3, 2, 16, seed=7)  # partial (hassize)
    want = encode_frames_tpu(frames, params, cfg)
    mesh = make_mesh(jax.devices()[:8])
    got = encode_frames_tpu(frames, params, cfg, mesh=mesh)
    assert got == want
