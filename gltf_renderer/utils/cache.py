"""Persistent XLA compilation cache.

Called from every entry point (CLI, bench, chip smoke, driver entry, tools)
before the first jit. Where JAX_COMPILATION_CACHE_DIR is set, JAX already
keeps its cache there and this module sets no other directory. Otherwise the
cache lives at a fixed path inside the checkout, `.jax_cache/` (listed in
.gitignore): the path is part of the cache key, so a directory that moved
would never hit.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)
_enabled = False


def cache_dir(subdir: str = "") -> str:
    """The compile-cache directory: $JAX_COMPILATION_CACHE_DIR when set,
    else `.jax_cache/<subdir>` in the checkout."""
    if os.environ.get(ENV_VAR):
        return os.environ[ENV_VAR]
    return os.path.join(CHECKOUT_DIR, subdir) if subdir else CHECKOUT_DIR


def enable_compilation_cache(subdir: str = "") -> None:
    """Idempotently enable the on-disk compilation cache (see cache_dir)."""
    global _enabled
    if _enabled:
        return
    import jax

    path = cache_dir(subdir)
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    _enabled = True
