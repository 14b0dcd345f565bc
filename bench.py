"""Benchmark: FWI iteration wall-clock on the reference's workloads.

Runs on the GPU and refuses to run anywhere else.  Every line is one
JSON object naming its device (platform, kind, count) and the physics
path it measured:

1. ``marmousi_acoustic_fwi_iteration_wallclock``: the acoustic
   physics gradient of BASELINE.md's "Acoustic gradient workload" —
   18 shots x nt=4001 (dt=1 ms) x grid 151x200, forward + adjoint per
   iteration (direct-wave simulation hoisted out of the loop — it is
   model-independent; the reference recomputed it every iteration,
   networks.py:5396-5411).  Reference: deepwave CUDA on the
   reference's GPU, it_lap ~= 0.35 s/iteration (marmsm_Mod8_log.txt
   col 5).
2. ``marmousi_elastic_fwi_iteration_wallclock``: the elastic
   DENISE-replacement gradient (5 shots x 5.0 s x 100x300 P-SV
   fwd+adjoint, networks.py:7554-7878 geometry) on the inversion
   operator.
3. and 4. the end-to-end engine iteration of ``marmousi_acoustic``
   and ``marmousi_elastic`` (benchmarks/bench_configs.py).

A failed path fails the process.
"""

from __future__ import annotations

import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from physicsbasedfwi2_tpu.geo import Grid2D, ricker, marmousi_acoustic_acquisition
from physicsbasedfwi2_tpu.geo.acquisition import Acquisition
from physicsbasedfwi2_tpu.ops import (
    AcousticConfig, ElasticConfig, select_operator, trace_normalize,
)

BASELINE_IT_LAP = 0.35  # s, reference GPU (marmsm_Mod8_log.txt)


def device_info() -> dict:
    d = jax.devices()
    return {"platform": d[0].platform, "kind": d[0].device_kind,
            "count": len(d)}


def acoustic_problem():
    """(path, simulate, loss, vp0, data) of the acoustic gradient at
    the reference's shapes.  ``loss(vp, data)`` is the trace-normalised
    L1 misfit with the direct wave removed; every array rides in
    ``data`` so the same jitted code runs on any device its inputs are
    on."""
    grid = Grid2D(nz=151, nx=200, dx=10.0, nt=4001, dt=0.001, pml_width=20)
    cfg = AcousticConfig(grid=grid, order=4, chunk=64, vmax_pml=5000.0)
    path, sim = select_operator("acoustic")
    acq = marmousi_acoustic_acquisition(nx=200)
    geom = tuple(jnp.asarray(a) for a in
                 (acq.src_z, acq.src_x, acq.rcv_z, acq.rcv_x))
    wav = ricker(8.0, grid.nt, grid.dt)
    z = jnp.arange(151, dtype=jnp.float32)[:, None]
    vp_true = 1500.0 + jnp.where(z < 26, 0.0, (z - 26) * 14.0)
    vp_true = jnp.broadcast_to(vp_true, (151, 200)).at[60:90, 80:140].add(
        300.0).astype(jnp.float32)
    vp0 = jnp.broadcast_to(
        1500.0 + jnp.where(z < 26, 0.0, (z - 26) * 12.0),
        (151, 200)).astype(jnp.float32)

    def simulate(vp, data):
        return sim(vp, data["wav"], *data["geom"], cfg)

    data = {"wav": wav, "geom": geom}
    data["obs_norm"] = trace_normalize(simulate(vp_true, data))
    data["direct"] = simulate(jnp.full_like(vp_true, 1500.0), data)

    def loss(vp, data):
        pred = simulate(vp, data) - data["direct"]
        m = jnp.max(jnp.abs(pred), axis=1, keepdims=True)
        return jnp.mean(jnp.abs(pred / (m + 1e-10) - data["obs_norm"]))

    return path, simulate, loss, vp0, data


def elastic_problem():
    """(path, simulate, loss, (vp0, vs0), data) of the elastic
    gradient (5 shots x 5.0 s x 100x300) on the inversion operator;
    ``loss((vp, vs), data)`` is the raw L2 misfit."""
    nz, nx, nt, dt = 100, 300, 3334, 0.0015
    ns, nr = 5, 298
    grid = Grid2D(nz=nz, nx=nx, dx=20.0, nt=nt, dt=dt, pml_width=20,
                  free_surface=True)
    cfg = ElasticConfig(grid=grid, chunk=64, vmax_pml=5000.0)
    path, sim = select_operator("elastic")
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

    def simulate(m, data):
        return sim(m[0], m[1], data["rho"], data["wav"], *data["geom"],
                   cfg)

    data = {"wav": ricker(10.0, nt, dt), "geom": geom,
            "rho": 310.0 * vp ** 0.25}
    data["obs"] = simulate((vp.at[40:60, 100:200].add(200.0), vs), data)

    def loss(m, data):
        pvx, pvz = simulate(m, data)
        ovx, ovz = data["obs"]
        return jnp.mean((pvx - ovx) ** 2) + jnp.mean((pvz - ovz) ** 2)

    return path, simulate, loss, (vp, vs), data


def seconds_per_gradient(loss, m0, data, n_iter: int = 10) -> float:
    """Mean wall-clock of one value-and-gradient call, chained inside
    one jitted loop (a gradient step links the iterations, one scalar
    reaches the host at the end)."""

    @jax.jit
    def chain(m, data, n):
        def body(i, carry):
            m, acc = carry
            val, g = jax.value_and_grad(loss)(m, data)
            m = jax.tree_util.tree_map(lambda a, b: a - 1e-6 * b, m, g)
            return m, acc + val

        return jax.lax.fori_loop(0, n, body, (m, 0.0))[1]

    if not np.isfinite(float(chain(m0, data, 1))):  # compile + warm
        raise FloatingPointError("non-finite loss")
    t0 = time.perf_counter()
    total = float(chain(m0, data, n_iter))
    dt = (time.perf_counter() - t0) / n_iter
    if not np.isfinite(total):
        raise FloatingPointError("non-finite loss")
    return dt


def main():
    from physicsbasedfwi2_tpu.utils.cache import enable_persistent_cache
    from benchmarks.bench_configs import bench_one

    enable_persistent_cache()
    device = device_info()
    if device["platform"] != "gpu":
        sys.exit(f"bench.py measures the GPU; found {device}")

    path, _, loss, vp0, data = acoustic_problem()
    dt_iter = seconds_per_gradient(loss, vp0, data)
    print(json.dumps({
        "metric": "marmousi_acoustic_fwi_iteration_wallclock",
        "value": dt_iter, "unit": "s",
        "vs_baseline": BASELINE_IT_LAP / dt_iter,
        "baseline": "reference deepwave it_lap 0.35 s on its own GPU",
        "path": path, "device": device,
    }), flush=True)

    path, _, loss, m0, data = elastic_problem()
    dt_el = seconds_per_gradient(loss, m0, data)
    print(json.dumps({
        "metric": "marmousi_elastic_fwi_iteration_wallclock",
        "value": dt_el, "unit": "s", "path": path, "device": device,
        "workload": "5 shots x 5.0s x 100x300 P-SV fwd+adjoint",
    }), flush=True)

    # end-to-end engine iterations (net fwd/bwd + physics gradient +
    # conditioning + optimizer + logged scalars — the scope of the
    # reference's it_lap column, marmsm_Mod8_log.txt col 5)
    for workload in ("marmousi_acoustic", "marmousi_elastic"):
        r = bench_one(workload, iters=5)
        print(json.dumps({
            "metric": f"{workload}_engine_iteration_end_to_end",
            "value": r["seconds_per_iteration"], "unit": "s",
            "path": r["path"], "device": r["device"],
        }), flush=True)


if __name__ == "__main__":
    main()
