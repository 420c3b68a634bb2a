"""Process set-up shared by the entry points (CLI, bench, chip smoke).

Nothing here runs at import: each entry point calls what it needs before
its first compile.
"""

from __future__ import annotations

import os
from pathlib import Path

# Fixed so that one checkout finds its own cache again: the directory is
# part of the cache key. Listed in .gitignore.
DEFAULT_CACHE_DIR = Path(__file__).resolve().parent.parent / ".jax_cache"


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at
    ``JAX_COMPILATION_CACHE_DIR`` when it is set, else at
    ``DEFAULT_CACHE_DIR``. JAX settles on its cache at the first compile,
    so call this before any. Returns the directory."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(
        DEFAULT_CACHE_DIR)
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def require_gpu():
    """The first JAX device, which must be a GPU. Raises RuntimeError
    otherwise: a measurement that ran on the CPU must not pass for one
    taken on the card."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's first device is {dev.platform} "
            f"({dev.device_kind})")
    return dev
