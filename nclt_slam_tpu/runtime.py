"""Process set-up shared by every entry point that drives the device.

``init_runtime`` is the first call of each CLI main, ``bench.py``,
``chip_smoke.py`` and the tools under ``tools/``.  It pins the platform
when one is asked for and keeps JAX's persistent compilation cache, so a
second run of the same campaign program loads it instead of compiling it.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
# a fixed path in the checkout (listed in .gitignore): the cache key does
# not depend on it, but a directory that moved would never be found again
DEFAULT_CACHE_DIR = Path(__file__).resolve().parent.parent / ".jax_cache"


def compile_cache_dir(environ=os.environ) -> Path:
    """Where the compile cache lives: ``$JAX_COMPILATION_CACHE_DIR`` when
    set, else ``<checkout>/.jax_cache``."""
    env = environ.get(CACHE_ENV)
    return Path(env) if env else DEFAULT_CACHE_DIR


def init_runtime(platform: str | None = None) -> Path:
    """Pin ``platform`` (e.g. ``"cpu"``) when given, else leave JAX's own
    choice (the GPU where there is one), and turn on the persistent
    compile cache.  JAX reads ``$JAX_COMPILATION_CACHE_DIR`` itself; only
    its absence makes us set a directory.  Returns the cache directory."""
    if platform:
        jax.config.update("jax_platforms", platform)
    if not os.environ.get(CACHE_ENV):
        jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    return compile_cache_dir()
