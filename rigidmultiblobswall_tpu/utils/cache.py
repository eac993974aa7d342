"""JAX's persistent compilation cache, in one place.

Where `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it itself and no
code here names a directory. Otherwise the cache lives at
`<repo>/.jax_cache` (listed in .gitignore): a fixed path, so reruns from
the same checkout find their compiled programs again.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def default_cache_dir():
    """The directory code should set, or None when the environment
    variable already chooses one."""
    if os.environ.get(ENV_VAR):
        return None
    return os.path.join(REPO_ROOT, ".jax_cache")


def enable_compilation_cache(min_compile_secs=0.5):
    """Turn the persistent cache on; returns the directory in use."""
    import jax

    path = default_cache_dir()
    if path is not None:
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_secs)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path or os.environ[ENV_VAR]
