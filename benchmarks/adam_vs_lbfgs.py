"""Adam vs L-BFGS at equal propagator-call budget.

The reference's L-BFGS workload was a deliberate optimizer choice
(AutoElMar22LBFGS_model.py:128-137 with the vendored
functions/LBFGS.py Powell-damped Wolfe implementation); this harness
answers whether that choice pays off HERE, where every line-search
probe is a compiled gradient call instead of a DENISE subprocess.

Budget accounting: the unit is one SHOT-GRADIENT (fwd+adjoint of one
shot).  Adam spends `shots_per_iter` per step; L-BFGS spends
`num_shots x num_linesearch_steps` per step — optax's zoom linesearch
reports its probe count in the state (ZoomLinesearchInfo), and the
accepted probe's value/grad pair is REUSED for the next iteration's
gradient (optax.value_and_grad_from_state), so probes are the only
propagator cost.  Line-search probes evaluate value+grad in one
autodiff pass, so a probe and an Adam gradient cost the same.

Usage:
    python benchmarks/adam_vs_lbfgs.py --budget 7000 \
        --dataroot dataroots/marm_elastic [--acoustic] [--png out.png]

Prints one JSON line per arm with the (budget, misfit, model-MSE)
curve and a final summary.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import jax



def _linesearch_steps(opt_state) -> int:
    """Pull num_linesearch_steps out of an optax lbfgs state pytree."""
    for leaf in jax.tree_util.tree_leaves(
            opt_state, is_leaf=lambda x: hasattr(
                x, "num_linesearch_steps")):
        if hasattr(leaf, "num_linesearch_steps"):
            return int(leaf.num_linesearch_steps)
    return 1


def run_arm(workload: str, budget: int, dataroot: str | None,
            overrides: dict, label: str) -> dict:
    from physicsbasedfwi2_tpu.engine import get_workload, create_engine

    cfg = get_workload(workload, name=f"avl_{label}",
                       save_dir="/tmp/avl_ck", **overrides)
    if dataroot:
        cfg = cfg.replace(dataroot=dataroot)
    eng = create_engine(cfg)
    shots_full = getattr(eng, "n_shots", cfg.num_shots)
    per_iter = (cfg.shots_per_iter or shots_full)
    is_lbfgs = cfg.optimizer == "lbfgs"
    spent = 0
    epoch = cfg.lstart  # anchor warmup epochs are free (no physics)
    curve = []
    # run any anchor warmup first (not counted: no propagator calls)
    for e in range(1, cfg.lstart + 1):
        eng.optimize_parameters(epoch=e)
    while spent < budget:
        epoch += 1
        out = eng.optimize_parameters(epoch=epoch)
        if is_lbfgs:
            spent += shots_full * _linesearch_steps(eng.opt_state)
        else:
            spent += per_iter
        # elastic engines report "loss_D_MSE"; the acoustic DIP engine
        # reports "loss_D" (or "loss_M" for anchor-only epochs,
        # engines.py:666)
        misfit = next(out[k] for k in ("loss_D_MSE", "loss_D", "loss_M")
                      if k in out)
        curve.append((spent, misfit, out["loss_M_MSE"]))
    val, _ = eng.test()
    best_mse = min(c[2] for c in curve)
    return {"arm": label, "workload": workload,
            "optimizer": cfg.optimizer, "misfit": cfg.misfit,
            "budget_spent": spent, "iterations": len(curve),
            "final_misfit": curve[-1][1], "final_model_mse": curve[-1][2],
            "best_model_mse": best_mse,
            "val_model_mse": val.get("loss_V_MSE"),
            "curve": [(s, round(d, 6), round(m, 1))
                      for s, d, m in curve[:: max(1, len(curve) // 60)]]}


def main(argv=None):
    from physicsbasedfwi2_tpu.utils.cache import enable_persistent_cache
    enable_persistent_cache()
    p = argparse.ArgumentParser()
    p.add_argument("--budget", type=int, default=7000,
                   help="shot-gradient budget per arm")
    p.add_argument("--dataroot", default=None)
    p.add_argument("--acoustic", action="store_true",
                   help="also run the acoustic pair (l2 misfit both "
                        "arms: L-BFGS needs a smooth objective)")
    p.add_argument("--lbfgs-memory", type=int, default=10)
    p.add_argument("--png", default=None)
    p.add_argument("--only", default=None,
                   help="substring filter on arm labels (e.g. "
                        "'acoustic' re-runs just the acoustic pair)")
    args = p.parse_args(argv)

    arms = [
        ("marmousi_elastic", {}, "elastic_adam"),
        ("marmousi_elastic_lbfgs",
         {"extras": {"lbfgs_memory": args.lbfgs_memory}},
         "elastic_lbfgs"),
    ]
    if args.acoustic:
        arms += [
            ("marmousi_acoustic", {"misfit": "l2"}, "acoustic_adam"),
            ("marmousi_acoustic",
             {"misfit": "l2", "optimizer": "lbfgs"}, "acoustic_lbfgs"),
        ]
    if args.only:
        arms = [a for a in arms if args.only in a[2]]
    results = []
    for workload, ov, label in arms:
        r = run_arm(workload, args.budget,
                    args.dataroot if label.startswith("elastic") else
                    None, ov, label)
        results.append(r)
        print(json.dumps(r), flush=True)
    print(json.dumps({
        "summary": {r["arm"]: {"final_model_mse": r["final_model_mse"],
                               "best_model_mse": r["best_model_mse"],
                               "iterations": r["iterations"]}
                    for r in results},
        "budget": args.budget}), flush=True)

    if args.png:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, axes = plt.subplots(1, 2, figsize=(10, 4))
        for r in results:
            s = [c[0] for c in r["curve"]]
            axes[0].plot(s, [c[1] for c in r["curve"]], label=r["arm"])
            axes[1].plot(s, [c[2] for c in r["curve"]], label=r["arm"])
        axes[0].set_ylabel("data misfit")
        axes[1].set_ylabel("model MSE")
        for ax in axes:
            ax.set_xlabel("shot-gradients spent")
            ax.legend()
        fig.tight_layout()
        fig.savefig(args.png, dpi=110)
        print(f"wrote {args.png}")


if __name__ == "__main__":
    main()
