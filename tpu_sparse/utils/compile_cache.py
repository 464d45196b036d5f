"""One place that decides where JAX keeps its persistent compilation cache.

Every entry point (tests, benchmarks, examples, ``chip_smoke.py``) calls
`setup_compile_cache()` before its first compile:

* ``JAX_COMPILATION_CACHE_DIR`` set: JAX reads the variable itself, and
  nothing is set in code;
* otherwise the cache lives at the fixed path ``<checkout>/.jax_cache``
  (git-ignored). A fixed path matters: a directory that moves between
  runs starts empty every time, so it never hits.
"""

from __future__ import annotations

import os

import jax

# the directory that holds the `tpu_sparse` package
CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(CHECKOUT, ".jax_cache")


def setup_compile_cache() -> str:
    """Configure the persistent compilation cache; returns its directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
