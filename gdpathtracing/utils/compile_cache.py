"""Persistent XLA compile cache for the entry points (CLI, bench, smoke).

JAX reads ``JAX_COMPILATION_CACHE_DIR`` itself; where it is set, that
directory is used and no other is configured. Otherwise the cache lives at
a fixed ``.jax_cache/`` in the checkout (listed in ``.gitignore``): the
path is part of the cache key, so a directory that moved would never hit.
"""

from __future__ import annotations

import os
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[2]


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at its directory; returns it."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if path:
        return path
    import jax

    path = str(CHECKOUT / ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
