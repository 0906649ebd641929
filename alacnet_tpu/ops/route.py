"""The one place that picks the decode route for a platform.

* ``"triton"``: the fused Rice+LPC kernel (ops/rice_lpc_kernel.py),
  compiled for the GPU.
* ``"scan"``: the plain XLA scans (ops/rice.py, ops/lpc.py) — the CPU
  route and the reference the kernel is checked against.
* ``"interpret"``: the kernel on the Pallas interpreter.  Only a CPU run
  that forces the kernel (``ALAC_KERNEL=fused``, tests) gets it; a GPU
  never does.

``config.DEFAULT.kernel``: "auto" (the platform's route), "fused"
(the kernel everywhere) or "xla" (the scans everywhere).  Encode has a
single route, the XLA scans of ops/encode.py, on every platform.
"""

from __future__ import annotations


def decode_route(platform: str | None = None) -> str:
    """Route for a decode on ``platform`` (default: JAX's default backend;
    under a mesh, the mesh devices' platform)."""
    import jax

    from ..config import DEFAULT

    plat = platform or jax.default_backend()
    mode = DEFAULT.kernel
    if plat == "gpu":
        return "scan" if mode == "xla" else "triton"
    if plat == "cpu":
        return "interpret" if mode == "fused" else "scan"
    raise ValueError(f"no decode route for platform {plat!r} (gpu or cpu)")
