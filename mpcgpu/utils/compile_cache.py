"""Persistent compilation cache for the command-line entry points.

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX uses that directory and this
module sets nothing.  Otherwise the cache goes to ``<checkout>/.jax_cache``:
a fixed path, so that each run finds what the last one stored, listed in
``.gitignore``.
"""

from __future__ import annotations

import os
from pathlib import Path

ENV = "JAX_COMPILATION_CACHE_DIR"


def default_cache_dir() -> Path:
    return Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Point JAX at the persistent cache; returns the directory in use."""
    if os.environ.get(ENV):
        return os.environ[ENV]
    import jax

    path = str(default_cache_dir())
    jax.config.update("jax_compilation_cache_dir", path)
    return path
