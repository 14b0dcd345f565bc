"""Misfit-informativeness line-scan for an elastic dataroot.

The diagnostic that drove the round-4 elastic recipe (docs/RESULTS.md):
evaluate each candidate misfit with ALL shots along two 1-D model
paths

    T: m(a) = lowf + a (truth - lowf)        a in [0, 1]
    D: m(a) = lowf + a (drift - lowf)        drift = a trained
                                             checkpoint's decoded model

and report whether the misfit (1) decreases monotonically along T,
(2) ranks J(truth) well below the drift direction, (3) is ~0 at the
truth (it cannot be when the inversion simulates with a different rho
than the one that generated the gathers — the fixed-rho floor this
tool measured at 2/3 of the landscape's dynamic range, which motivated
the --rho-start true known-density prep mode).

Usage:
    python benchmarks/misfit_linescan.py --dataroot dataroots/marm_elastic_kd \
        [--drift-run runs_r4/probe_b_decay] [--fc 20] [--workload marmousi_elastic]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import jax.numpy as jnp

from physicsbasedfwi2_tpu.engine import get_workload
from physicsbasedfwi2_tpu.engine.engines import create_engine
from physicsbasedfwi2_tpu.models import apply_elastic_output
from physicsbasedfwi2_tpu.ops import trace_normalize


def main(argv=None):
    from physicsbasedfwi2_tpu.utils.cache import enable_persistent_cache
    enable_persistent_cache()
    p = argparse.ArgumentParser()
    p.add_argument("--dataroot", required=True)
    p.add_argument("--workload", default="marmousi_elastic")
    p.add_argument("--drift-run", default=None,
                   help="run dir with <tag>_net_G.npz checkpoints; "
                        "its decoded model defines path D")
    p.add_argument("--drift-tag", default="latest")
    p.add_argument("--fc", type=float, default=20.0)
    p.add_argument("--alphas", default="0,0.25,0.5,0.75,1.0")
    args = p.parse_args(argv)

    cfg = get_workload(args.workload, dataroot=args.dataroot)
    if args.drift_run:
        cfg = cfg.replace(name=os.path.basename(args.drift_run),
                          save_dir=os.path.dirname(args.drift_run) or ".")
    eng = create_engine(cfg)
    wl = eng.wl
    names = eng.field_names
    lowf = jnp.stack([wl.start[k] for k in names], -1)
    truth = jnp.stack([wl.true[k] for k in names], -1)

    paths = [("T(truth)", truth)]
    if args.drift_run:
        eng.load_networks(args.drift_tag)
        deltas, _ = eng.net.apply(eng.params, eng.in_vx, eng.in_vz,
                                  deterministic=True)
        drift = apply_elastic_output(
            deltas, eng.lowf, eng.true_m, delta_scale=eng.delta_scale,
            clip_min=eng.clip_min, clip_max=eng.clip_max,
            pin_rows=cfg.water_rows, clip_mode=cfg.clip_mode)[0]
        print(json.dumps({
            "drift_mse": float(jnp.mean((drift - truth) ** 2)),
            "lowf_mse": float(jnp.mean((lowf - truth) ** 2))}),
            flush=True)
        paths.append(("D(drift)", drift))

    # Band-limit the raw gathers directly rather than via
    # eng._stage_data: for snl2-configured workloads _stage_data
    # returns gathers ALREADY divided by the per-shot RMS, so a scan
    # scaling recomputed from them is ~1 and the reported snl2 would
    # silently equal l2.  The scan must stay independent of
    # cfg.misfit — it is the tool that ranks the candidates.
    from physicsbasedfwi2_tpu.geo.filters import lowpass_filter_time
    fc = float(args.fc or 0.0)
    if fc > 0:
        wav = lowpass_filter_time(wl.wavelet, fc, cfg.dt, axis=-1)
        ovx = lowpass_filter_time(wl.obs_vx, fc, cfg.dt, axis=1)
        ovz = lowpass_filter_time(wl.obs_vz, fc, cfg.dt, axis=1)
    else:
        wav, ovx, ovz = wl.wavelet, wl.obs_vx, wl.obs_vz
    s = jnp.maximum(jnp.sqrt(jnp.mean(ovx ** 2 + ovz ** 2,
                                      axis=(1, 2), keepdims=True)),
                    1e-30)

    def misfits(m):
        vp, vs = m[..., 0], m[..., 1]
        rho = (m[..., 2] if len(names) == 3 else wl.start["rho"])
        pvx, pvz = eng._sim(vp, vs, rho, wav, *wl.geom, wl.cfg)
        out = {"l2": float(jnp.mean((pvx - ovx) ** 2)
                           + jnp.mean((pvz - ovz) ** 2)),
               "snl2": float(jnp.mean((pvx / s - ovx / s) ** 2)
                             + jnp.mean((pvz / s - ovz / s) ** 2))}
        tpx, tpz = trace_normalize(pvx), trace_normalize(pvz)
        tox, toz = trace_normalize(ovx), trace_normalize(ovz)
        out["tnl1"] = float(jnp.mean(jnp.abs(tpx - tox))
                            + jnp.mean(jnp.abs(tpz - toz)))
        out["tnl2"] = float(jnp.mean((tpx - tox) ** 2)
                            + jnp.mean((tpz - toz) ** 2))
        return out

    alphas = [float(a) for a in args.alphas.split(",")]
    for tag, target in paths:
        for a in alphas:
            m = lowf + a * (target - lowf)
            m = m.at[: cfg.water_rows].set(lowf[: cfg.water_rows])
            print(json.dumps(
                {"path": tag, "a": a,
                 "mse": round(float(jnp.mean((m - truth) ** 2)), 1),
                 **{k: round(v, 8) for k, v in misfits(m).items()}}),
                flush=True)


if __name__ == "__main__":
    main()
