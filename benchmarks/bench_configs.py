"""End-to-end iteration wall-clock for every BASELINE.json config.

SURVEY.md §6 asks the rebuild to ship a harness that reports, per
BASELINE config, the end-to-end FWI iteration wall-clock plus FD
throughput (cell-steps/s and shots/s) at the reference geometries.
``bench.py`` at the repo root reports the two headline kernel
numbers; this harness drives the *engines* (net forward + physics
gradient + optimizer update + host logging), i.e. the number a user
of the reference actually experiences per `optimize_parameters` call
(trainValLatent4dVel2.py:51-75 `iter_start_time` timing).

Each line: {"config": ..., "workload": ..., "seconds_per_iteration":
N, "shots_per_sec": N, "mcell_steps_per_sec": N} where
mcell_steps_per_sec counts ONE forward-equivalent pass (nz*nx*nt*
shots/iter / wall-clock) — gradient iterations sweep the grid ~3x, so
the hardware does ~3x this; the single-pass convention keeps the
number comparable across schemes with different checkpointing.

Usage: python benchmarks/bench_configs.py [--iters N] [--only NAME]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

# (BASELINE.json config name, workload registry name)
CONFIGS = [
    ("1_marmousi_acoustic_cnn_prior", "marmousi_acoustic"),
    ("2_acoustic_unet22", "marmousi_acoustic_unet"),
    ("3_marmousi_elastic_lbfgs", "marmousi_elastic_lbfgs"),
    ("4_vae_latent_inversion", "latent_inversion"),
    ("5_seam_elastic_mcdip", "mcdip_uq"),
]


def bench_one(workload: str, iters: int) -> dict:
    from physicsbasedfwi2_tpu.engine import get_workload, create_engine

    cfg = get_workload(workload).replace(
        name=f"bench_{workload}", save_dir="/tmp/fwi_bench_ck")
    eng = create_engine(cfg)
    # bench the PHYSICS-phase iteration: epochs must sit past any
    # lstart warmup (which trains the cheap anchor regression only)
    e0 = cfg.lstart + 1
    # first call compiles; second warms any lazily-built step caches
    for _ in range(2):
        eng.optimize_parameters(epoch=e0)
    t0 = time.perf_counter()
    for i in range(iters):
        eng.optimize_parameters(epoch=e0 + 1 + i)
    dt = (time.perf_counter() - t0) / iters
    shots = cfg.shots_per_iter or cfg.num_shots
    cells = cfg.nz * cfg.nx
    return {
        "seconds_per_iteration": dt,
        "shots_per_sec": shots / dt,
        "mcell_steps_per_sec": cells * cfg.nt * shots / dt / 1e6,
        "path": getattr(eng, "physics_path", "n/a"),
        "device": {"platform": jax.devices()[0].platform,
                   "kind": jax.devices()[0].device_kind,
                   "count": len(jax.devices())},
    }


def main(argv=None):
    from physicsbasedfwi2_tpu.utils.cache import enable_persistent_cache
    enable_persistent_cache()
    p = argparse.ArgumentParser()
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--only", default=None,
                   help="bench a single workload registry name")
    args = p.parse_args(argv)

    rows = ([(f"only_{args.only}", args.only)] if args.only
            else CONFIGS)
    failed = []
    for config_name, workload in rows:
        try:
            r = bench_one(workload, args.iters)
        except Exception as e:  # keep the sweep alive per-config
            traceback.print_exc()
            print(json.dumps({"config": config_name,
                              "workload": workload,
                              "error": f"{type(e).__name__}: {e}"}),
                  flush=True)
            failed.append(config_name)
            continue
        print(json.dumps({"config": config_name, "workload": workload,
                          **r}), flush=True)
    if failed:
        sys.exit(f"failed configs: {', '.join(failed)}")


if __name__ == "__main__":
    main()
