"""Route choice (ops/route.py) and the entry points' compile cache
(utils/compile_cache.py), with the platform monkeypatched."""

from __future__ import annotations

import jax
import pytest

from alacnet_tpu.config import DEFAULT
from alacnet_tpu.ops.route import decode_route
from alacnet_tpu.utils import compile_cache


@pytest.mark.parametrize(
    "platform,mode,route",
    [
        ("gpu", "auto", "triton"),
        ("gpu", "fused", "triton"),  # never the interpreter on a GPU
        ("gpu", "xla", "scan"),
        ("cpu", "auto", "scan"),
        ("cpu", "xla", "scan"),
        ("cpu", "fused", "interpret"),
    ],
)
def test_decode_route(monkeypatch, platform, mode, route):
    monkeypatch.setattr(DEFAULT, "kernel", mode)
    assert decode_route(platform) == route
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    assert decode_route() == route


@pytest.mark.parametrize("platform", ["rocm", "metal", "sycl"])
def test_unknown_platform_raises(platform):
    with pytest.raises(ValueError, match="no decode route"):
        decode_route(platform)


def test_interpreter_refused_on_gpu(monkeypatch):
    """A forced interpret route cannot reach a GPU backend."""
    import jax.numpy as jnp

    from alacnet_tpu.ops.rice_lpc_kernel import rice_lpc

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    lane = jnp.zeros((3,), jnp.int32)
    chan = jnp.zeros((2, 3), jnp.int32)
    with pytest.raises(ValueError, match="never runs on a GPU"):
        rice_lpc(
            jnp.zeros((3, 7), jnp.uint32), lane, chan, lane, lane, lane,
            lane, chan, chan, chan, jnp.zeros((2, 3, 32), jnp.int32),
            num_samples=5, max_order=0, interpret=True,
        )


def test_pipeline_follows_route(monkeypatch):
    """dispatch_frame_batch hands decode_frames the route of the platform
    it runs on: a GPU default backend gets the compiled kernel."""
    import numpy as np

    import alacnet_tpu.parallel.pipeline as pl
    from alacnet_tpu.codec.cookie import default_cookie
    from alacnet_tpu.codec.encoder import AlacEncoder
    from alacnet_tpu.codec.framemeta_vec import parse_frame_headers_vec

    params = default_cookie(44100, 16, 2, max_samples_per_frame=64)
    pcm = np.arange(128, dtype=np.int32).reshape(64, 2)
    fb = parse_frame_headers_vec([AlacEncoder(params).encode_frame(pcm)], params)
    seen = {}

    def fake(words, meta, S, **kw):
        seen.update(kw)
        return None, None

    monkeypatch.setattr(pl, "decode_frames_packed", fake)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    pl.dispatch_frame_batch(fb, 64)
    assert seen["route"] == "triton"
    assert seen["max_order"] == pl.span_max_order(fb)


def test_compile_cache_follows_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # nothing set


def test_compile_cache_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        d = compile_cache.enable_compile_cache()
        assert d.endswith(".jax_cache")
        assert compile_cache.DEFAULT_DIR.parent.joinpath("alacnet_tpu").is_dir()
        assert jax.config.jax_compilation_cache_dir == d
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
