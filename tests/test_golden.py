"""Golden-file regression tests.

SURVEY.md §4 calls for "golden-file tests against small reference
runs": fixed tiny workloads whose receiver traces and gradients are
committed, so numerical regressions in the propagators are caught
across refactors.  Goldens live in tests/golden/*.npz; regenerate
deliberately with REGEN_GOLDEN=1 python -m pytest tests/test_golden.py.
"""

import os

import jax.numpy as jnp
import numpy as np

from physicsbasedfwi2_tpu.geo import Grid2D, ricker
from physicsbasedfwi2_tpu.ops import (
    AcousticConfig, ElasticConfig, simulate_acoustic, simulate_elastic,
    acoustic_gradient, l2_misfit,
)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
REGEN = os.environ.get("REGEN_GOLDEN") == "1"


def _check(name: str, arrays: dict, rtol=2e-4, atol=1e-8):
    path = os.path.join(GOLDEN_DIR, f"{name}.npz")
    if REGEN or not os.path.exists(path):
        os.makedirs(GOLDEN_DIR, exist_ok=True)
        np.savez_compressed(path, **{k: np.asarray(v)
                                     for k, v in arrays.items()})
        return
    ref = np.load(path)
    for k, v in arrays.items():
        got = np.asarray(v)
        scale = np.abs(ref[k]).max() + 1e-30
        np.testing.assert_allclose(
            got, ref[k], rtol=rtol, atol=atol + rtol * scale,
            err_msg=f"golden mismatch: {name}/{k}")


def _acoustic_case():
    grid = Grid2D(nz=36, nx=44, dx=10.0, nt=180, dt=0.002, pml_width=12)
    cfg = AcousticConfig(grid=grid, chunk=20, vmax_pml=2500.0)
    wav = ricker(10.0, grid.nt, grid.dt)
    geom = (jnp.array([3, 3], jnp.int32), jnp.array([10, 30], jnp.int32),
            jnp.full((2, 8), 3, jnp.int32),
            jnp.tile(jnp.arange(8, dtype=jnp.int32) * 5 + 2, (2, 1)))
    vp = jnp.full((36, 44), 1700.0, jnp.float32).at[18:, :].set(2100.0)
    return cfg, wav, vp, geom


def acoustic_golden_arrays() -> dict:
    """Receiver traces and the L2 gradient of the small acoustic case
    (also recomputed on the GPU by chip_smoke.py)."""
    cfg, wav, vp, geom = _acoustic_case()
    recs = simulate_acoustic(vp, wav, *geom, cfg)
    vpt = vp.at[20:28, 15:30].add(150.0)
    obs = simulate_acoustic(vpt, wav, *geom, cfg)
    _, grad = acoustic_gradient(vp, lambda p: l2_misfit(p, obs), wav,
                                *geom, cfg)
    return {"recs": recs, "grad": grad}


def elastic_golden_arrays() -> dict:
    """Receiver traces of the small split-PML elastic case."""
    grid = Grid2D(nz=32, nx=40, dx=10.0, nt=140, dt=0.0015, pml_width=10)
    cfg = ElasticConfig(grid=grid, chunk=20, vmax_pml=2800.0)
    wav = ricker(12.0, grid.nt, grid.dt)
    geom = (jnp.array([16], jnp.int32), jnp.array([12], jnp.int32),
            jnp.full((1, 6), 4, jnp.int32),
            (jnp.arange(6, dtype=jnp.int32) * 5 + 8)[None, :])
    vp = jnp.full((32, 40), 2000.0, jnp.float32)
    vs = jnp.full((32, 40), 1150.0, jnp.float32)
    rho = jnp.full((32, 40), 2100.0, jnp.float32)
    rvx, rvz = simulate_elastic(vp, vs, rho, wav, *geom, cfg)
    return {"rvx": rvx, "rvz": rvz}


def test_golden_acoustic_traces_and_gradient():
    _check("acoustic_small", acoustic_golden_arrays())


def test_golden_elastic_traces():
    _check("elastic_small", elastic_golden_arrays())
