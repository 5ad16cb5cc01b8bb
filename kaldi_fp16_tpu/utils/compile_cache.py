"""Where JAX keeps its persistent compilation cache.

A cold compile of the flagship train step takes tens of seconds or more,
and every CLI run is a fresh process.  A cache entry is found again only
under the same directory, so the directory is fixed: never a temporary
name, a process id or a time.
"""

import os

REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its one directory and
    return it: `JAX_COMPILATION_CACHE_DIR` when that is set, else
    `<checkout>/.jax_cache`.  Config only, so it is safe to call before
    any backend is initialised."""
    import jax
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = REPO_CACHE_DIR
        os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    return path
