"""Process-level JAX configuration: the persistent compilation cache.

The solver's scan bodies are large (a few thousand HLO ops across the
unrolled multi-level schedule), so caching compiled executables across
processes matters for every entry point (runner, bench, chip_smoke).

The cache lives where `JAX_COMPILATION_CACHE_DIR` says when it is set (JAX
reads that variable itself; nothing here overrides it).  Otherwise it is the
fixed directory `.jax_cache` at the root of the checkout, which `.gitignore`
lists: a fixed path keeps the cache's keys stable from run to run.
"""

import os

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def cache_dir() -> str:
    """The directory the compilation cache uses in this process."""
    return os.environ.get(CACHE_ENV) or DEFAULT_CACHE_DIR


def setup_jax_cache() -> str:
    import jax

    path = cache_dir()
    if not os.environ.get(CACHE_ENV):
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
