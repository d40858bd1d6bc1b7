"""Shared JAX runtime configuration: platform pin and compile cache.

Deliberately dependency-free (no cfd_julia_tpu imports) so entry scripts
can call it before anything heavy loads.

Compile cache, one rule for every entry point (the CLI, bench.py,
chip_smoke.py, __graft_entry__.py):
* `JAX_COMPILATION_CACHE_DIR` set: JAX reads that directory itself, and
  nothing here sets another;
* otherwise the fixed `<checkout>/.jax_cache` (listed in .gitignore).
A process that has already placed its cache (the CPU test suite) keeps it.
"""
from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_CACHE_DIR = os.path.join(CHECKOUT, ".jax_cache")


def configure_cache() -> str | None:
    """Place the persistent compile cache (see the module note); returns
    the directory in use."""
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR") \
            and not jax.config.jax_compilation_cache_dir:
        jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return jax.config.jax_compilation_cache_dir


def pin_platform(platform: str | None = None) -> None:
    """Pin the JAX backend before it initializes: `platform`, or else a
    user-set JAX_PLATFORMS.  Once the backend is up, a pin that names the
    platform already running is a no-op; any other pin raises."""
    import jax

    want = platform or os.environ.get("JAX_PLATFORMS")
    if not want:
        return
    try:
        jax.config.update("jax_platforms", want)
    except RuntimeError:
        running = jax.devices()[0].platform
        names = {"cuda": "gpu", "rocm": "gpu"}
        if running not in {names.get(p, p) for p in want.split(",")}:
            raise RuntimeError(
                f"JAX backend already initialized on {running!r}; "
                f"cannot switch to {want!r}") from None
