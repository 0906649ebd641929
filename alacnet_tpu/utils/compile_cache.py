"""JAX's persistent compilation cache for the entry points.

Called by ``alac-tpu`` (cli.main), ``bench.py`` and ``chip_smoke.py``;
never on library import.  Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX
reads it itself and nothing else is set.  Otherwise the cache lives at
the fixed path ``<checkout>/.jax_cache`` (listed in .gitignore): the path
is part of the cache's key, so a directory that moves never hits.
"""

from __future__ import annotations

import os
from pathlib import Path

#: The checkout's own cache directory (the package's parent directory).
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn the persistent cache on; returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
