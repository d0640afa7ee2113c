"""Where the program keeps its caches: JAX's persistent compile cache and
the sized-caps cache of the tiled renderer.

If JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing here
overrides it. Otherwise the compile cache lives at a fixed directory inside
the checkout, `<repo>/.cache/jax` (git-ignored): the path is part of the
cache key, so a directory that moves would never hit. The sized-caps cache
sits beside it at `<repo>/.cache/tracer_caps.json` unless TRACER_CAPS_CACHE
names another file.
"""
from __future__ import annotations

import os

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CACHE_DIR = os.path.join(REPO_ROOT, ".cache")


def compile_cache_dir() -> str:
    """The compile-cache directory this process uses."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(CACHE_DIR, "jax"))


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at compile_cache_dir() and
    return it. Entry points (bench.py, bin/trace, bin/fit, chip_smoke.py)
    call this once before compiling anything."""
    import jax

    path = compile_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", path)
    return path


def caps_cache_path() -> str:
    return (os.environ.get("TRACER_CAPS_CACHE")
            or os.path.join(CACHE_DIR, "tracer_caps.json"))
