"""Persistent XLA compilation cache for the CLI drivers and benchmarks.

A full-size training step takes tens of seconds to compile; without a
persistent cache every fresh ``fwi-train``/``fwi-test``/benchmark
process pays that again.  The reference never had this problem only
because PyTorch eager has no compile step — its "just relaunch the
script" workflow (trainVelAutoElMar22ModelPhy.sh reruns with
--continue_train) needs the cache on by default.  The directory is
part of the cache's key, so it is fixed: ``JAX_COMPILATION_CACHE_DIR``
when set, else ``<repo root>/.cache/jax`` whatever the working
directory.
"""

from __future__ import annotations

import os

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable_persistent_cache() -> str:
    """Turn on JAX's on-disk compilation cache and return its path.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it natively
    and nothing is changed; otherwise the cache goes to
    ``<repo root>/.cache/jax``.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    target = os.path.join(_REPO_ROOT, ".cache", "jax")
    os.makedirs(target, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", target)
    return target
