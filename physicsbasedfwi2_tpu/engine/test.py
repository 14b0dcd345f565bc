"""Evaluation driver.

Capability-equivalent of test.py / test4d.py: load a checkpoint, run
inference, save result images/HTML; ``--realization N`` runs the
MC-dropout posterior sampling loop (test4d.py:69-79) producing
mean/std uncertainty maps for MCDIP workloads.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from physicsbasedfwi2_tpu.engine.config import get_workload, list_workloads
from physicsbasedfwi2_tpu.engine.engines import create_engine


def evaluate(cfg, *, epoch="latest", realizations: int = 1,
             results_dir: str = "./results", workload=None):
    engine = create_engine(cfg) if workload is None else \
        create_engine(cfg, workload=workload)
    try:
        engine.load_networks(epoch)
    except FileNotFoundError:
        pass  # fresh engine (e.g. smoke tests)
    outdir = os.path.join(results_dir, cfg.name, f"epoch_{epoch}")
    os.makedirs(outdir, exist_ok=True)

    if realizations > 1 and hasattr(engine, "mc_realizations"):
        samples = engine.mc_realizations(realizations)
        mean, std = samples.mean(0), samples.std(0)
        np.save(os.path.join(outdir, "mc_mean.npy"), mean)
        np.save(os.path.join(outdir, "mc_std.npy"), std)
        losses, img = engine.test()
        result = {"realizations": realizations,
                  "mc_std_mean": float(std.mean()), **losses}
    else:
        losses, img = engine.test()
        np.save(os.path.join(outdir, "model.npy"), img)
        result = dict(losses)

    with open(os.path.join(outdir, "metrics.json"), "w") as f:
        json.dump(result, f)
    return result


def main(argv=None):
    from physicsbasedfwi2_tpu.utils.cache import enable_persistent_cache
    enable_persistent_cache()
    p = argparse.ArgumentParser(description="FWI evaluation")
    p.add_argument("--workload", default="marmousi_acoustic",
                   choices=list_workloads())
    p.add_argument("--name", default=None)
    p.add_argument("--epoch", default="latest")
    p.add_argument("--realization", type=int, default=1)
    p.add_argument("--results-dir", default="./results")
    p.add_argument("--save-dir", default=None)
    p.add_argument("--dataroot", default=None)
    p.add_argument("--small", action="store_true")
    p.add_argument("--set", action="append", default=[],
                   metavar="FIELD=VALUE", dest="set_fields",
                   help="override any ExperimentConfig field "
                        "(see fwi-train --set)")
    args = p.parse_args(argv)
    from physicsbasedfwi2_tpu.engine.config import parse_set_overrides
    # same precedence as fwi-train: dedicated flags first, then --set
    # overrides win, then --name last
    overrides = {}
    if args.save_dir:
        overrides["save_dir"] = args.save_dir
    if args.dataroot:
        overrides["dataroot"] = args.dataroot
    try:
        overrides.update(parse_set_overrides(args.set_fields))
    except ValueError as e:
        p.error(str(e))
    cfg = get_workload(args.workload, **overrides)
    if args.name:
        cfg = cfg.replace(name=args.name)
    if args.small:
        cfg = cfg.replace(nz=48, nx=64, nt=300, num_shots=4,
                          num_receivers=32, filters=(4, 8, 16),
                          chunk=25, water_rows=6)
    result = evaluate(cfg, epoch=args.epoch,
                      realizations=args.realization,
                      results_dir=args.results_dir)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
