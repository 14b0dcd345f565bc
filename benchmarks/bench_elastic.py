"""Elastic FWI iteration benchmark — the DENISE workload.

Reference workload (BASELINE.md): 5 shots/iter x 5.0 s record x grid
~100x300 (dx=20 m), forward + adjoint per gradient, DENISE-Black-
Edition on 30 CPU MPI ranks (NPROCX=6 x NPROCY=5) with file-based
coupling.  The reference repo preserves no DENISE wall-clock numbers;
a 2D P-SV staggered-grid code of this size on ~30 2010s-class CPU
cores typically needs tens of seconds per 5-shot gradient (fwd +
adjoint + SU file IO).  We report absolute numbers: iteration
wall-clock and FD cell-steps/s, with the device they ran on.

Usage: python benchmarks/bench_elastic.py
"""

import json
import os
import time

import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from physicsbasedfwi2_tpu.geo import Grid2D, ricker
from physicsbasedfwi2_tpu.geo.acquisition import Acquisition
from physicsbasedfwi2_tpu.ops import ElasticConfig, simulate_elastic
import numpy as np


def main():
    from physicsbasedfwi2_tpu.utils.cache import enable_persistent_cache
    enable_persistent_cache()
    nz, nx, dx = 100, 300, 20.0
    nt, dt = 3334, 0.0015  # 5.0 s record
    ns, nr = 5, 298
    grid = Grid2D(nz=nz, nx=nx, dx=dx, nt=nt, dt=dt, pml_width=20,
                  free_surface=True)
    cfg = ElasticConfig(grid=grid, chunk=64, vmax_pml=5000.0)
    wav = ricker(10.0, nt, dt)
    src_x = np.round(np.linspace(5, nx - 6, ns)).astype(np.int32)
    acq = Acquisition(np.full(ns, 2, np.int32), src_x,
                      np.full((ns, nr), 2, np.int32),
                      np.tile(np.round(np.linspace(1, nx - 2, nr))
                              .astype(np.int32), (ns, 1)))
    geom = tuple(jnp.asarray(a) for a in
                 (acq.src_z, acq.src_x, acq.rcv_z, acq.rcv_x))

    z = jnp.arange(nz, dtype=jnp.float32)[:, None]
    vp = jnp.broadcast_to(1500.0 + jnp.where(z < 10, 0.0, (z - 10) * 25.0),
                          (nz, nx)).astype(jnp.float32)
    vs = jnp.where(vp > 1500.0, vp / 1.8, 0.0)
    rho = 310.0 * vp ** 0.25
    vp_t = vp.at[40:60, 100:200].add(200.0)
    ovx, ovz = simulate_elastic(vp_t, vs, rho, wav, *geom, cfg)

    def loss_fn(vp_, vs_):
        pvx, pvz = simulate_elastic(vp_, vs_, rho, wav, *geom, cfg)
        return jnp.mean((pvx - ovx) ** 2) + jnp.mean((pvz - ovz) ** 2)

    @jax.jit
    def chain(vp_, vs_, n):
        def body(i, carry):
            vp_, vs_, acc = carry
            loss, (gvp, gvs) = jax.value_and_grad(
                loss_fn, argnums=(0, 1))(vp_, vs_)
            return (vp_ - 1e-3 * gvp, vs_ - 1e-3 * gvs, acc + loss)

        vp_, vs_, acc = jax.lax.fori_loop(0, n, body, (vp_, vs_, 0.0))
        return acc

    float(chain(vp, vs, 1))  # compile
    n = 5
    t0 = time.perf_counter()
    total = float(chain(vp, vs, n))
    dt_iter = (time.perf_counter() - t0) / n
    assert jnp.isfinite(total)

    # effective FD throughput: fwd+adjoint ~ 3 passes over the grid
    pad = grid.padded_shape
    cell_steps = ns * nt * pad[0] * pad[1] * 3 / dt_iter
    print(json.dumps({
        "metric": "marmousi_elastic_fwi_iteration_wallclock",
        "value": round(dt_iter, 4),
        "unit": "s",
        "cell_steps_per_sec": f"{cell_steps:.3e}",
        "workload": "5 shots x 5.0s x 100x300 P-SV fwd+adjoint",
    }))


if __name__ == "__main__":
    main()
