"""Persistent XLA compilation cache for the repository's entry points.

Compiling the full-size train step (the device preprocessing sorts in
particular) takes minutes; the cache lets a second run of the same
program on the same machine skip it. The cache key includes the
directory, so the directory is fixed: `JAX_COMPILATION_CACHE_DIR` when
set (JAX reads that itself), else `<repo root>/.jax_cache`, which
`.gitignore` lists.

Entry points (`chip_smoke.py`, `bench.py`, `examples/ml_perf/main.py`)
call `enable_compile_cache()` before their first compile; the library
never does so on import.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Turns the persistent compilation cache on; returns its directory.

    With `JAX_COMPILATION_CACHE_DIR` set, JAX already uses that directory
    and nothing is changed here.
    """
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
