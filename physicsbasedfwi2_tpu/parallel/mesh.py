"""Mesh construction helpers."""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(n_devices: int | None = None,
              axis_name: str = "shot") -> Mesh:
    """1D device mesh over the FWI shot axis.

    Shots are FWI's embarrassingly parallel axis (the reference fans
    them out over Ray GPUs / DENISE MPI ranks); here they shard over
    the devices with a single psum for the gradient reduction.
    """
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis_name,))


def make_mesh2d(n_sample: int, n_shot: int,
                axis_names=("sample", "shot")) -> Mesh:
    """2D {sample, shot} mesh: per-sample FWI fan-out (the
    reference's Ray remote-GPU pattern, Auto_model.py:185-199)
    composed with shot parallelism on the inner axis.  Every GPU of
    an NVLink host reaches every other at the same rate, so the
    layout follows the algorithm alone."""
    devs = jax.devices()
    need = n_sample * n_shot
    if len(devs) < need:
        raise ValueError(f"need {need} devices, have {len(devs)}")
    return Mesh(np.array(devs[:need]).reshape(n_sample, n_shot),
                axis_names)


def shot_axis_size(mesh: Mesh, axis_name: str = "shot") -> int:
    return mesh.shape[axis_name]
