"""Persistent XLA compilation cache (opt-in).

The flagship pipeline executes in seconds but compiles for much longer on a
cold process, so the one-time compile is a large part of a short run's
wall. JAX's persistent on-disk compilation cache removes repeat compiles
across processes. Call :func:`enable` before the first ``jit`` compilation
in any process that wants that reuse.

Where the cache lives: if ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already
reads it and this module sets no directory; otherwise the cache is the fixed
``<checkout>/.xla_cache`` (a fixed path, since the path is part of what makes
a later process find the entries).

Reference correspondence: the reference has no compile step at all (eager
numpy); this subsystem exists because the design trades a one-time compile
for fast execution, and the cache amortizes that trade across processes.
"""

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".xla_cache",
)


def cache_dir() -> str:
    """The directory `enable` uses."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def enable(min_compile_secs=1.0) -> str:
    """Enable the persistent compilation cache for this process and return
    its directory.

    Must run before the first compilation to affect it (programs compiled
    earlier are simply not cached). ``min_compile_secs``: only programs
    whose compile took at least this long are persisted, which keeps the
    cache to the expensive programs (the evidence vjp, sampler chunks, SMC
    rounds).
    """
    import jax

    path = cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update(
        "jax_persistent_cache_min_compile_time_secs", float(min_compile_secs)
    )
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
