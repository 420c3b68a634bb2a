"""Compile-cache placement for the entry points (oavif_jax.runtime)."""

import jax
import pytest

from oavif_jax import runtime


@pytest.mark.parametrize("env", [None, "/tmp/oavif-jax-cache-test"])
def test_compile_cache_dir(monkeypatch, env):
    if env is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = str(runtime.DEFAULT_CACHE_DIR)
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env)
        want = env
    before = jax.config.jax_compilation_cache_dir
    try:
        assert runtime.enable_compile_cache() == want
        assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_default_cache_dir_is_ignored_by_git():
    root = runtime.DEFAULT_CACHE_DIR.parent
    assert (root / "oavif_jax").is_dir()
    ignored = (root / ".gitignore").read_text().split()
    assert runtime.DEFAULT_CACHE_DIR.name + "/" in ignored


def test_require_gpu_refuses_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        runtime.require_gpu()
