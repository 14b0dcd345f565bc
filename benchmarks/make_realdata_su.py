"""Build a field-marine SU dataset for the `real_data` workload.

The reference's AutoRealData workload (networks.py:9937-10580) ingests
field marine shot gathers as DENISE SU files (su/seis_x.su.shot1..N)
with vs and rho pinned by the DENISE bounds (VSUPPERLIM = VSLOWERLIM =
881, RHOUPPERLIM = RHOLOWERLIM = 1010, networks.py:10448-10460).  No
field data ships in this environment, so this script manufactures the
same artifact honestly: a canonical SEAM-structured marine vp slice,
gathers simulated with the split-PML reference scheme
(ops/elastic.py) — NOT the 5-field sponge scheme the inversion runs, so
the ingest-and-invert path faces a real scheme mismatch — written as
little-endian SU shot files and ingested through the same
``fwi-prep --su-obs`` path a user would feed field tapes through.

Usage:
    python benchmarks/make_realdata_su.py --out dataroots/real_marine
Then:
    fwi-train --workload real_data --dataroot dataroots/real_marine
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np


def write_su_gather(path, traces_tr_ns, dt_us):
    """[ntr, ns] float32 -> minimal little-endian SU file (240-byte
    headers carrying ns @ bytes 114-115 and dt @ 116-117, the fields
    native/su_reader.cpp probes)."""
    nt = traces_tr_ns.shape[1]
    with open(path, "wb") as f:
        for tr in traces_tr_ns:
            hdr = np.zeros(240, np.uint8)
            hdr[114:116] = np.frombuffer(
                np.array([nt], "<u2").tobytes(), np.uint8)
            hdr[116:118] = np.frombuffer(
                np.array([dt_us], "<u2").tobytes(), np.uint8)
            f.write(hdr.tobytes())
            f.write(np.asarray(tr, "<f4").tobytes())


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True)
    p.add_argument("--su-dir", default=None,
                   help="where to write the SU shot files "
                        "(default <out>_su)")
    args = p.parse_args(argv)

    import jax.numpy as jnp
    from physicsbasedfwi2_tpu.data.marmousi import canonical_seam_vp
    from physicsbasedfwi2_tpu.data.prep import (prepare_su_observed,
                                                resample_grid)
    from physicsbasedfwi2_tpu.data.synthetic import smooth_model
    from physicsbasedfwi2_tpu.engine.config import get_workload
    from physicsbasedfwi2_tpu.geo import Grid2D, check_cfl, ricker
    from physicsbasedfwi2_tpu.geo.acquisition import elastic_line
    from physicsbasedfwi2_tpu.ops import ElasticConfig, simulate_elastic

    cfg = get_workload("real_data")
    nz, nx = cfg.nz, cfg.nx
    vp = resample_grid(canonical_seam_vp(), nz, nx).astype(np.float32)
    vp = np.clip(vp, 1500.0, float(cfg.clip_max[0]))
    # the marine workload's pinned elastic parameters
    # (networks.py:10448-10460)
    vs = np.full((nz, nx), 881.0, np.float32)
    rho = np.full((nz, nx), 1010.0, np.float32)

    grid = Grid2D(nz=nz, nx=nx, dx=cfg.dx, nt=cfg.nt, dt=cfg.dt,
                  pml_width=cfg.pml_width,
                  free_surface=cfg.free_surface)
    check_cfl(float(vp.max()), grid)
    ecfg = ElasticConfig(grid=grid, chunk=cfg.chunk, vmax_pml=6000.0)
    wav = ricker(cfg.freq, cfg.nt, cfg.dt)
    acq = elastic_line(cfg.num_shots, cfg.num_receivers, nx, nz,
                       src_row=cfg.extras["src_depth_row"],
                       rcv_row=cfg.extras["rcv_depth_row"])
    geom = tuple(jnp.asarray(a) for a in
                 (acq.src_z, acq.src_x, acq.rcv_z, acq.rcv_x))
    print(f"simulating {cfg.num_shots} marine shots "
          f"({nz}x{nx} @ dx={cfg.dx}, nt={cfg.nt}) with the "
          f"split-PML reference scheme ...", flush=True)
    ovx, ovz = simulate_elastic(jnp.asarray(vp), jnp.asarray(vs),
                                jnp.asarray(rho), wav, *geom, ecfg)
    ovx, ovz = np.asarray(ovx), np.asarray(ovz)  # [ns, nt, nr]

    su_dir = args.su_dir or (args.out.rstrip("/") + "_su")
    os.makedirs(su_dir, exist_ok=True)
    dt_us = int(round(cfg.dt * 1e6))
    for k in range(cfg.num_shots):
        write_su_gather(os.path.join(su_dir, f"seis_x.su.shot{k+1}"),
                        ovx[k].T, dt_us)
        write_su_gather(os.path.join(su_dir, f"seis_y.su.shot{k+1}"),
                        ovz[k].T, dt_us)
    shape, dt_read = prepare_su_observed(su_dir, args.out)
    print(f"ingested SU {shape} dt={dt_read}s from {su_dir}")

    # start model (trainC, /100 hectometer units): smoothed vp, the
    # pinned vs/rho — field practice has no trainB; the loader falls
    # back to C for the (unused) oracle metric
    c = np.stack([smooth_model(vp, iters=40, preserve_rows=0),
                  vs, rho]) / 100.0
    d = os.path.join(args.out, "trainC")
    os.makedirs(d, exist_ok=True)
    np.save(os.path.join(d, "0.npy"), c.astype(np.float32))
    # keep the truth on the side for honest reporting (NOT part of the
    # workload contract — the engine never reads trainB_oracle)
    np.save(os.path.join(args.out, "trainB_oracle.npy"),
            np.stack([vp, vs, rho]) / 100.0)
    print(f"wrote start triple to {d}; oracle vp kept at "
          f"{args.out}/trainB_oracle.npy")


if __name__ == "__main__":
    main()
