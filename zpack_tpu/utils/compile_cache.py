"""Where JAX keeps its persistent compile cache.

Every JAX entry point (the CLI's device engine, bench.py, chip_smoke.py,
scripts/scaling.py) calls :func:`enable_compile_cache` once before its
first compile, so all of them share one cache per checkout.
"""

from __future__ import annotations

import os
import pathlib

#: the checkout root: this file is <checkout>/zpack_tpu/utils/compile_cache.py
_CHECKOUT = pathlib.Path(__file__).resolve().parents[2]


def enable_compile_cache() -> str:
    """Return the compile cache directory in use: ``JAX_COMPILATION_CACHE_DIR``
    when set (JAX reads it itself, so nothing is set here), else
    ``<checkout>/.jax_cache``, which this points JAX at."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    path = str(_CHECKOUT / ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
