"""Platform helpers: alignment math and the compile cache.

The reference asserts M, N are multiples of 32 (tester.cpp:8-10); the packed
formats here work in 128-lane windows and column groups, so all converters
pad to multiples of 128 (and 8-slot chunks) instead of asserting.
"""

from __future__ import annotations

import functools
import os

import jax


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return cdiv(x, m) * m


# repo root: the fallback cache sits inside the checkout (listed in
# .gitignore), at a fixed path — the path is part of the cache key
_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_CACHE_DIR = os.path.join(_CHECKOUT, ".jax_cache")


@functools.cache
def enable_compile_cache() -> str:
    """Idempotently turn on JAX's persistent compilation cache (the CLI,
    AMG setup and the test conftest share it): heavy multi-program work —
    an AMG hierarchy compiles one program per level structure — then
    compiles once per machine. A cache directory set through
    ``JAX_COMPILATION_CACHE_DIR`` (JAX loads it into
    ``jax_compilation_cache_dir``) is respected and no other is set;
    otherwise the cache lives in ``.jax_cache/`` inside the checkout.
    Returns the cache dir in effect."""
    existing = jax.config.jax_compilation_cache_dir
    if existing:
        return existing
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.3)
    return DEFAULT_CACHE_DIR
