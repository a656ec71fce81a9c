"""Persistent XLA compilation cache setup.

Every shape bucket of the banded-DP, mutation-scoring and Viterbi programs is
a separate compiled program, and the reference-scale workload re-runs the
same buckets in every process (the reference's cluster model is one process
per region file, /root/reference/README.md:48-62).  JAX's persistent
compilation cache makes each bucket a one-time cost per cache directory
instead of per process.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
module sets no directory.  Otherwise the cache lives at one fixed path inside
the checkout (``CACHE_DIR``, listed in .gitignore), so every process started
from the same checkout finds the programs the earlier ones compiled.
``PSQ_COMPILATION_CACHE=0`` disables the cache.
"""

from __future__ import annotations

import os

#: the in-checkout cache used when JAX_COMPILATION_CACHE_DIR is not set
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")

_done = False


def enable_compilation_cache() -> None:
    """Idempotently point JAX at the on-disk executable cache."""
    global _done
    if _done or os.environ.get("PSQ_COMPILATION_CACHE", "1") == "0":
        _done = True
        return
    _done = True
    import jax

    try:
        if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
            os.makedirs(CACHE_DIR, exist_ok=True)
            jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
        # cache every program: a consensus run compiles many shape buckets,
        # many of them in under a second, which JAX's default one-second
        # floor would recompile in every process; entries are small
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
        jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    except OSError:
        pass  # an unwritable checkout only loses the cache, not the run
