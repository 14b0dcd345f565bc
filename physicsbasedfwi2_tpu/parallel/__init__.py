"""Device-mesh parallelism: the replacement for the
reference's Ray per-shot GPU fan-out (Auto_model.py:69-199), DENISE's
MPI domain decomposition (networks.py:7709-7710), and the
loss_landscape mpi4py grid sweep."""

from physicsbasedfwi2_tpu.parallel.mesh import (
    make_mesh, make_mesh2d, shot_axis_size,
)
from physicsbasedfwi2_tpu.parallel.shard import (
    shot_sharded_acoustic_gradient,
    shot_sharded_elastic_gradient,
    sample_shot_sharded_acoustic_gradient,
    pad_shots_to_multiple,
)
from physicsbasedfwi2_tpu.parallel.halo import simulate_acoustic_dd

__all__ = [
    "make_mesh",
    "make_mesh2d",
    "shot_axis_size",
    "shot_sharded_acoustic_gradient",
    "shot_sharded_elastic_gradient",
    "sample_shot_sharded_acoustic_gradient",
    "pad_shots_to_multiple",
    "simulate_acoustic_dd",
]
