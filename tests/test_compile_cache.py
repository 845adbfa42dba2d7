"""The persistent compilation cache helper used by every entry point."""

import tempfile

import jax

from mpcgpu.utils import compile_cache
from mpcgpu.utils.compile_cache import ENV, default_cache_dir, enable_compile_cache


def test_env_var_set_is_left_to_jax(monkeypatch):
    monkeypatch.setenv(ENV, "/some/cache/dir")
    before = jax.config.jax_compilation_cache_dir
    assert enable_compile_cache() == "/some/cache/dir"
    assert jax.config.jax_compilation_cache_dir == before


def test_env_var_unset_uses_the_checkout(monkeypatch):
    monkeypatch.delenv(ENV, raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = enable_compile_cache()
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    root = default_cache_dir().parent
    assert path == str(root / ".jax_cache")
    assert (root / "mpcgpu" / "utils" / "compile_cache.py").exists()


def test_cache_path_is_fixed_not_temporary_or_per_process():
    """A path that moved between runs would never find an earlier run's
    programs."""
    import os

    path = str(default_cache_dir())
    assert not path.startswith(tempfile.gettempdir())
    assert str(os.getpid()) not in path
    assert path == str(default_cache_dir())
    assert compile_cache.default_cache_dir().name == ".jax_cache"
    gitignore = (default_cache_dir().parent / ".gitignore").read_text()
    assert ".jax_cache/" in gitignore.split()
