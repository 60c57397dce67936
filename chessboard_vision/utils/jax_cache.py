"""Placement of JAX's persistent compilation cache, shared by every entry
point (bench.py, chip_smoke.py, the tools and the tests).

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and no
other directory is set here. Otherwise the cache lives at one fixed path
inside the checkout: the path is part of the cache key, so a directory
that moves never hits.
"""

from __future__ import annotations

import os

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache(min_compile_secs: float = 1.0, min_entry_bytes: int = 0) -> None:
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", min_compile_secs)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", min_entry_bytes)
