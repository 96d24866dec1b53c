"""JAX's persistent compilation cache, at one fixed place per checkout.

A sweep program takes tens of seconds to compile on the GPU at full size
(GEMM autotuning included), so every entry point turns the cache on before
its first compile.  ``JAX_COMPILATION_CACHE_DIR``, when set, wins and
nothing is set in code; otherwise the cache lives in ``<checkout>/.cache/
jax_compile``.  The path is part of the cache's key, so it never depends
on a temporary name, a process id or the time.  On the CPU backend the
helper sets nothing: CPU compiles take seconds, and XLA:CPU cache entries
are tied to the compiling host's CPU features.
"""
from __future__ import annotations

import os
from typing import Optional

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".cache", "jax_compile")


def enable_compile_cache(backend: Optional[str] = None) -> Optional[str]:
    """Turn the persistent compile cache on; returns its directory (None
    on the CPU backend).  ``backend`` defaults to JAX's default backend."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env              # JAX reads the variable itself
    if (backend or jax.default_backend()) == "cpu":
        return None
    if jax.config.jax_compilation_cache_dir != DEFAULT_DIR:
        os.makedirs(DEFAULT_DIR, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
