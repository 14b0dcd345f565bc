"""Full train-state checkpointing as numpy ``.npz`` files.

The reference checkpoints only network weights (base_model.py:154-170)
— optimizer/scheduler state is lost on resume (SURVEY.md §5).  Here
the full state (params + optimizer + epoch) round-trips.  A pytree is
stored as one array per leaf, keyed by its ``jax.tree_util.keystr``
path, and restored into a template of the same structure: no pickle,
so loading a file runs no code from it.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save_tree(path: str, tree) -> str:
    """Write every leaf of ``tree`` to ``path`` (.npz); returns the
    file name."""
    path = _npz_path(os.path.abspath(path))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez(path, **{jax.tree_util.keystr(k): np.asarray(v)
                      for k, v in jax.tree_util.tree_leaves_with_path(tree)})
    return path


def restore_tree(path: str, template):
    """Read a tree written by :func:`save_tree` into ``template``'s
    structure; raises ValueError on a leaf whose shape differs."""
    with np.load(_npz_path(path)) as z:
        flat = {k: z[k] for k in z.files}

    def fill(kp, leaf):
        key = jax.tree_util.keystr(kp)
        arr = flat[key]
        if arr.shape != np.shape(leaf):
            raise ValueError(f"checkpoint leaf {key} has shape {arr.shape}, "
                             f"expected {np.shape(leaf)}")
        return jnp.asarray(arr)

    return jax.tree_util.tree_map_with_path(fill, template)


def save_engine(engine, path: str, *, epoch: int = 0) -> str:
    """Checkpoint ``{params, opt_state, epoch}`` of an engine."""
    return save_tree(path, {"params": engine.params,
                            "opt_state": engine.opt_state,
                            "epoch": np.asarray(epoch)})


def restore_engine(engine, path: str) -> int:
    """Restore a :func:`save_engine` checkpoint; returns its epoch."""
    state = restore_tree(path, {"params": engine.params,
                                "opt_state": engine.opt_state,
                                "epoch": np.asarray(0)})
    engine.params = state["params"]
    engine.opt_state = state["opt_state"]
    return int(state["epoch"])
