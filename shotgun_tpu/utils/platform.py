"""Backend selection + persistent compilation cache.

``SHOTGUN_TPU_PLATFORM`` (e.g. ``cpu``, ``cuda``) overrides the JAX
platform for this process -- applied right after the first jax import,
before any backend is initialized.  Used by tests/CI to force the host CPU
backend on machines that also have an accelerator.

The persistent compilation cache amortizes the cold-compile cost of the
align pipeline across CLI invocations (the reference's build-once
align-many ``.kdb`` workflow, reference kmer.py:265-282, has the same
goal): a warm ``dumpalign`` reuses the serialized executable instead of
repaying the full XLA compile.  Where ``JAX_COMPILATION_CACHE_DIR`` is set,
JAX keeps the cache there and this module sets no directory of its own;
otherwise the cache lives at the fixed path ``<repo>/.xla_cache`` (a fixed
path, because the directory is part of every cache key's lookup).
"""

from __future__ import annotations

import os
from typing import Mapping, Optional

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

_configured = False

#: live compile counters (enable_compile_stats); keys:
#: backend_compiles, backend_compile_secs, cache_hits, cache_misses
COMPILE_STATS: dict = {}


def enable_compile_stats() -> dict:
    """Count XLA compilations and persistent-cache hits/misses process-wide
    via jax.monitoring events; returns the live counter dict.

    Used by the CLI (SHOTGUN_TPU_COMPILE_STATS=1 prints a summary line to
    stderr at exit) and bench.py's warm-compile probe, so a warm run can
    PROVE it performed zero XLA compilations."""
    if COMPILE_STATS:
        return COMPILE_STATS
    COMPILE_STATS.update(backend_compiles=0, backend_compile_secs=0.0,
                         cache_hits=0, cache_misses=0)
    from jax._src import monitoring

    def on_event(name: str, **kw) -> None:
        if name.endswith("/cache_hits"):
            COMPILE_STATS["cache_hits"] += 1
        elif name.endswith("/cache_misses"):
            COMPILE_STATS["cache_misses"] += 1

    def on_duration(name: str, secs: float, **kw) -> None:
        if name.endswith("/backend_compile_duration"):
            COMPILE_STATS["backend_compiles"] += 1
            COMPILE_STATS["backend_compile_secs"] += secs

    monitoring.register_event_listener(on_event)
    monitoring.register_event_duration_secs_listener(on_duration)
    return COMPILE_STATS


def configure_platform() -> None:
    global _configured
    if _configured:
        return
    _configured = True
    if os.environ.get("SHOTGUN_TPU_COMPILE_STATS") == "1":
        enable_compile_stats()
    plat = os.environ.get("SHOTGUN_TPU_PLATFORM")
    import jax

    if plat:
        jax.config.update("jax_platforms", plat)

    cache_dir = cache_dir_for(os.environ, plat)
    if cache_dir is None:
        return
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(cache_dir, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    # the align executables compile in 1-80s; cache all of them, and
    # anything else that takes more than a trivial trace
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.2)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)


def cache_dir_for(env: Mapping[str, str],
                  plat: Optional[str] = None) -> Optional[str]:
    """Persistent compile-cache directory for a process with environment
    ``env`` (None: no cache).  ``JAX_COMPILATION_CACHE_DIR`` wins; CPU
    runs keep no cache (CPU compiles are fast and the CPU executable
    cache is brittle across machine-feature fingerprints); otherwise the
    fixed ``<repo>/.xla_cache``."""
    if env.get("JAX_COMPILATION_CACHE_DIR"):
        return env["JAX_COMPILATION_CACHE_DIR"]
    if (plat or env.get("JAX_PLATFORMS", "")).startswith("cpu"):
        return None
    return os.path.join(_REPO, ".xla_cache")
