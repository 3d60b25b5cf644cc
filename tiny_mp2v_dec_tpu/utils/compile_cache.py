"""Where JAX keeps its persistent compilation cache."""
from __future__ import annotations

import os

# A fixed path (listed in .gitignore): a cache directory that moves between
# runs never hits.
REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache and return its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it by itself and
    this sets nothing.  Otherwise the cache goes to ``<repo>/.jax_cache``.
    Works after ``jax`` has been imported, unlike setting the variable."""
    import jax
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    return jax.config.jax_compilation_cache_dir
