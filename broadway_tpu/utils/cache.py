"""Persistent XLA compile cache setup.

1080p pipeline compiles are slow, so every device entry point enables
the on-disk cache: in JAX_COMPILATION_CACHE_DIR when that is set, else
at the fixed path build/jaxcache inside the checkout (a fixed path
keeps cache keys stable from run to run). The setting is applied with
an explicit `jax.config.update`, which takes effect even when jax was
imported before the environment variable was read.
"""

from __future__ import annotations

import os

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def ensure_compile_cache(path: str = None) -> str:
    """Point jax at the on-disk compile cache (idempotent; call before
    the first compile — importing jax is fine)."""
    import jax

    path = path or os.environ.get(
        "JAX_COMPILATION_CACHE_DIR",
        os.path.join(_REPO, "build", "jaxcache"))
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
