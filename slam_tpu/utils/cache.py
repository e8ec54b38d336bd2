"""Persistent XLA compilation cache.

The partitioned-Schur LM programs take tens of seconds to compile; JAX's
persistent compilation cache amortises that across processes.  Entry points
(CLI, ``bench.py``, ``chip_smoke.py``) call :func:`enable_persistent_cache`
before building programs.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
module sets nothing.  Otherwise the cache lives at one fixed path inside the
checkout (:data:`DEFAULT_CACHE_DIR`, listed in ``.gitignore``): the path is
part of the cache key, so a directory that moves never hits.
"""

from __future__ import annotations

import os
import pathlib

DEFAULT_CACHE_DIR = str(pathlib.Path(__file__).resolve().parents[2]
                        / ".jax_cache")


def enable_persistent_cache() -> str | None:
    """Point JAX at :data:`DEFAULT_CACHE_DIR` unless the environment already
    names a cache.  Returns the directory this call set, or ``None``."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR
