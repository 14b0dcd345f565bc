"""Synthetic workload generation.

The reference trains against pre-generated .npy shot gathers (and for
elastic, pre-generated DENISE .su files copied at runtime —
networks.py:7669-7692).  The rebuild generates equivalent observed
data with its own propagators: Marmousi-like layered velocity models
+ simulated gathers, either in memory or written out in the
reference's directory contract (trainA/trainB/trainC/trainD).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax.numpy as jnp

from physicsbasedfwi2_tpu.geo import Grid2D, check_cfl, ricker, surface_line
from physicsbasedfwi2_tpu.geo.acquisition import Acquisition
from physicsbasedfwi2_tpu.ops import (
    AcousticConfig, ElasticConfig, select_operator, trace_normalize,
)
from physicsbasedfwi2_tpu.geo.filters import lowpass_filter_time


def make_layered_model(nz: int, nx: int, *, v_top=1500.0, v_bottom=4000.0,
                       water_rows: int = 0, seed: int = 0,
                       n_layers: int = 8) -> np.ndarray:
    """Random layered velocity model with lateral undulation."""
    rng = np.random.default_rng(seed)
    depths = np.sort(rng.uniform(water_rows, nz, n_layers))
    vels = np.linspace(v_top if water_rows == 0 else 1600.0, v_bottom,
                       n_layers + 1)
    x = np.arange(nx)
    model = np.full((nz, nx), vels[0], np.float32)
    for i, d in enumerate(depths):
        und = d + 5.0 * np.sin(2 * np.pi * x / nx * rng.integers(1, 4)
                               + rng.uniform(0, 2 * np.pi))
        mask = np.arange(nz)[:, None] >= und[None, :]
        model[mask] = vels[i + 1]
    if water_rows > 0:
        model[:water_rows] = 1500.0
    return model


def make_marmousi_like(nz: int = 151, nx: int = 200, *, seed: int = 0,
                       water_rows: int = 26) -> np.ndarray:
    """Marmousi-flavoured model: water, dipping layers, a fault and a
    high-velocity wedge (stand-in for the reference's trainB data)."""
    m = make_layered_model(nz, nx, water_rows=water_rows, seed=seed)
    rng = np.random.default_rng(seed + 1)
    # dipping fault: shift columns progressively
    f0 = int(nx * 0.45)
    shift = ((np.arange(nx) - f0) * 0.15).astype(int)
    for j in range(nx):
        if shift[j] > 0:
            m[:, j] = np.roll(m[:, j], min(shift[j], 10))
    m[:water_rows] = 1500.0
    # wedge anomaly
    zc, xc = int(nz * 0.6), int(nx * 0.55)
    z, x = np.mgrid[0:nz, 0:nx]
    wedge = (np.abs(z - zc) < 12) & (np.abs(x - xc) < 30)
    m[wedge] += 250.0
    return np.clip(m, 1500.0, 4700.0).astype(np.float32)


def smooth_model(m: np.ndarray, iters: int = 40,
                 preserve_rows: int = 0) -> np.ndarray:
    """Heavy smoothing -> the low-frequency starting model (trainC
    role)."""
    s = m.astype(np.float32).copy()
    for _ in range(iters):
        s[1:-1, :] = 0.25 * s[2:, :] + 0.5 * s[1:-1, :] + 0.25 * s[:-2, :]
        s[:, 1:-1] = 0.25 * s[:, 2:] + 0.5 * s[:, 1:-1] + 0.25 * s[:, :-2]
    if preserve_rows > 0:
        s[:preserve_rows] = m[:preserve_rows]
    return s


def make_elastic_model(vp: np.ndarray, *, vpvs: float = 1.8,
                       water_rows: int = 0):
    """(vp, vs, rho) from vp via vp/vs ratio and Gardner density."""
    vs = (vp / vpvs).astype(np.float32)
    rho = (310.0 * vp ** 0.25).astype(np.float32)  # Gardner
    if water_rows > 0:
        vs[:water_rows] = 0.0
        rho[:water_rows] = 1000.0
    return vp.astype(np.float32), vs, rho


@dataclasses.dataclass
class SyntheticAcousticWorkload:
    """In-memory equivalent of the unalignedVelABCD2 npy tree:
    A = observed gathers, B = true model, C = smooth start model."""

    grid: Grid2D
    cfg: AcousticConfig
    acq: Acquisition
    wavelet: jnp.ndarray
    vp_true: jnp.ndarray     # B
    vp_start: jnp.ndarray    # C
    obs: jnp.ndarray         # A  [ns, nt, nr]
    obs_norm: jnp.ndarray
    from_disk: bool = False  # True: obs is real stored data, not
                             # regenerable by our operators

    @classmethod
    def build(cls, *, nz=151, nx=200, dx=10.0, nt=4001, dt=0.001,
              pml_width=20, freq=8.0, num_shots=18, num_receivers=200,
              seed=0, water_rows=26, chunk=64):
        grid = Grid2D(nz=nz, nx=nx, dx=dx, nt=nt, dt=dt,
                      pml_width=pml_width)
        cfg = AcousticConfig(grid=grid, chunk=chunk, vmax_pml=5000.0)
        wav = ricker(freq, nt, dt)
        acq = surface_line(num_shots, num_receivers, nx,
                           src_depth=0, rcv_depth=0)
        vp_true = jnp.asarray(make_marmousi_like(
            nz, nx, seed=seed, water_rows=water_rows))
        check_cfl(float(vp_true.max()), grid)
        vp_start = jnp.asarray(smooth_model(
            np.asarray(vp_true), preserve_rows=water_rows))
        geom = tuple(jnp.asarray(a) for a in
                     (acq.src_z, acq.src_x, acq.rcv_z, acq.rcv_x))
        _, simulate = select_operator("acoustic")
        obs = simulate(vp_true, wav, *geom, cfg)
        return cls(grid=grid, cfg=cfg, acq=acq, wavelet=wav,
                   vp_true=vp_true, vp_start=vp_start, obs=obs,
                   obs_norm=trace_normalize(obs))

    @property
    def geom(self):
        return tuple(jnp.asarray(a) for a in
                     (self.acq.src_z, self.acq.src_x,
                      self.acq.rcv_z, self.acq.rcv_x))


@dataclasses.dataclass
class SyntheticElasticWorkload:
    """In-memory equivalent of unalignedVelABCDEl: A/D = vx/vz
    gathers, B = (vp, vs, rho) true, C = smooth low-frequency
    start."""

    grid: Grid2D
    cfg: ElasticConfig
    acq: Acquisition
    wavelet: jnp.ndarray
    true: dict               # {"vp","vs","rho"}
    start: dict
    obs_vx: jnp.ndarray
    obs_vz: jnp.ndarray
    from_disk: bool = False

    @classmethod
    def build(cls, *, nz=100, nx=300, dx=20.0, nt=1667, dt=0.0015,
              pml_width=20, freq=10.0, num_shots=35, num_receivers=298,
              seed=0, water_rows=26, chunk=64, free_surface=True,
              fc_low: float | None = None, src_depth_row=None,
              rcv_depth_row=None, rcv_follow_seabed=False):
        """src_depth_row / rcv_depth_row: explicit acquisition rows
        (SEAM: sources at 180 m = row 6 at dx=30, receivers at
        depth_rec = 23*30 m = row 23, networks.py:9688-9712);
        default water_rows+1 (the Marmousi just-below-seabed line).
        rcv_follow_seabed: per-column receiver depths from the water
        bottom — the reference's nnz geometry (networks.py:
        4898-4946)."""
        grid = Grid2D(nz=nz, nx=nx, dx=dx, nt=nt, dt=dt,
                      pml_width=pml_width, free_surface=free_surface)
        cfg = ElasticConfig(grid=grid, chunk=chunk, vmax_pml=5000.0)
        wav = ricker(freq, nt, dt)
        vp = make_marmousi_like(nz, nx, seed=seed, water_rows=water_rows)
        check_cfl(float(vp.max()), grid)
        vp_t, vs_t, rho_t = make_elastic_model(vp, water_rows=water_rows)
        vp_s = smooth_model(vp_t, preserve_rows=water_rows)
        vs_s = smooth_model(vs_t, preserve_rows=water_rows)
        rho_s = smooth_model(rho_t, preserve_rows=water_rows)
        from physicsbasedfwi2_tpu.geo.acquisition import (
            elastic_line, seabed_rows)
        src_row = (src_depth_row if src_depth_row is not None
                   else water_rows + 1)
        rcv_row = (rcv_depth_row if rcv_depth_row is not None
                   else water_rows + 1)
        acq = elastic_line(
            num_shots, num_receivers, nx, nz, src_row=src_row,
            rcv_row=rcv_row,
            rcv_rows_per_col=(seabed_rows(vp_t)
                              if rcv_follow_seabed else None))
        geom = tuple(jnp.asarray(a) for a in
                     (acq.src_z, acq.src_x, acq.rcv_z, acq.rcv_x))
        # the split-PML reference: engines whose inversion operator
        # differs regenerate these gathers with their own
        _, simulate = select_operator("elastic", "reference")
        ovx, ovz = simulate(jnp.asarray(vp_t), jnp.asarray(vs_t),
                            jnp.asarray(rho_t), wav, *geom, cfg)
        if fc_low:
            ovx = lowpass_filter_time(ovx, fc_low, dt, axis=1)
            ovz = lowpass_filter_time(ovz, fc_low, dt, axis=1)
        return cls(grid=grid, cfg=cfg, acq=acq, wavelet=wav,
                   true={"vp": jnp.asarray(vp_t), "vs": jnp.asarray(vs_t),
                         "rho": jnp.asarray(rho_t)},
                   start={"vp": jnp.asarray(vp_s), "vs": jnp.asarray(vs_s),
                          "rho": jnp.asarray(rho_s)},
                   obs_vx=ovx, obs_vz=ovz)

    @property
    def geom(self):
        return tuple(jnp.asarray(a) for a in
                     (self.acq.src_z, self.acq.src_x,
                      self.acq.rcv_z, self.acq.rcv_x))


def acoustic_workload_from_disk(dataroot: str, *, nz, nx, dx, nt, dt,
                                pml_width=20, freq=8.0, num_shots=None,
                                num_receivers=None, chunk=64,
                                phase: str = "train",
                                wavelet_from_data: bool = False):
    """Build an acoustic workload from the reference's on-disk npy
    contract (trainA = gathers [ns, nt, nr], trainB = true model,
    trainC = low-frequency start model) so datasets prepared for the
    reference train unchanged here.

    wavelet_from_data: take the per-shot source wavelets from trainD
    (the AutoWav capability, networks.py:13163-13165:
    ``source_amplitudes_true = swapaxes(wav, 0, 2)`` from the data
    dict) instead of a synthetic Ricker."""
    from physicsbasedfwi2_tpu.data.npy_datasets import NpyDictDataset
    ds = NpyDictDataset(dataroot, "unalignedVelABCD2", phase=phase)
    item = ds[0]
    obs = jnp.asarray(item["A"])
    vp_true = jnp.asarray(item["B"]).reshape(nz, nx)
    vp_start = jnp.asarray(item.get("C", item["B"])).reshape(nz, nx)
    ns, nt_d, nr = obs.shape
    if num_shots is None:
        num_shots = ns
    if num_receivers is None:
        num_receivers = nr
    assert nt_d == nt, f"data nt {nt_d} != config nt {nt}"
    grid = Grid2D(nz=nz, nx=nx, dx=dx, nt=nt, dt=dt,
                  pml_width=pml_width)
    cfg = AcousticConfig(grid=grid, chunk=chunk, vmax_pml=5000.0)
    if wavelet_from_data and "D" in item:
        wav = jnp.asarray(item["D"]).reshape(num_shots, nt)
    else:
        wav = ricker(freq, nt, dt)
    acq = surface_line(num_shots, num_receivers, nx, src_depth=0,
                       rcv_depth=0)
    return SyntheticAcousticWorkload(
        grid=grid, cfg=cfg, acq=acq, wavelet=wav, vp_true=vp_true,
        vp_start=vp_start, obs=obs, obs_norm=trace_normalize(obs),
        from_disk=True)


def latent_workload_from_disk(dataroot: str, *, nz, nx, dx, nt, dt,
                              pml_width=20, freq=15.0, num_shots=None,
                              num_receivers=None, chunk=64,
                              phase: str = "train", sample: int = 0):
    """Acoustic workload from the reference's Latent2 contract
    (unalignedVelLatent2_dataset.py: trainA = shot gathers, trainB =
    velocity model; the latent-inversion workload of
    VaeLatent2NoPhy_model.py:395-560 — 10 shots, nt=800, dt=1.5 ms,
    15 Hz).  ``sample`` picks one of the many stored samples (the
    reference ran batch 64 over them; latent inversion here optimizes
    one sample's latent at a time)."""
    from physicsbasedfwi2_tpu.data.npy_datasets import NpyDictDataset
    ds = NpyDictDataset(dataroot, "unalignedVelLatent2", phase=phase)
    item = ds[sample]
    obs = jnp.asarray(item["A"], jnp.float32)
    vp_true = jnp.asarray(item["B"], jnp.float32).reshape(nz, nx)
    ns, nt_d, nr = obs.shape
    num_shots = num_shots or ns
    num_receivers = num_receivers or nr
    assert nt_d == nt, f"data nt {nt_d} != config nt {nt}"
    grid = Grid2D(nz=nz, nx=nx, dx=dx, nt=nt, dt=dt,
                  pml_width=pml_width)
    cfg = AcousticConfig(grid=grid, chunk=chunk, vmax_pml=5000.0)
    wav = ricker(freq, nt, dt)
    acq = surface_line(num_shots, num_receivers, nx, src_depth=0,
                       rcv_depth=0)
    return SyntheticAcousticWorkload(
        grid=grid, cfg=cfg, acq=acq, wavelet=wav, vp_true=vp_true,
        vp_start=vp_true, obs=obs, obs_norm=trace_normalize(obs),
        from_disk=True)


def elastic_workload_from_disk(dataroot: str, *, nz, nx, dx, nt, dt,
                               pml_width=20, freq=10.0,
                               free_surface=True, chunk=64,
                               num_shots=None, num_receivers=None,
                               water_rows=26, phase: str = "train",
                               src_depth_row=None, rcv_depth_row=None,
                               rcv_follow_seabed=False):
    """Elastic workload from the unalignedVelABCDEl contract
    (A = vx gathers, B = [Vp;Vs;Rho]/100, C = low-freq triple /100,
    D = vz gathers — the /100 storage units are undone by the dataset
    mode's scale, data/unalignedVelABCDEl_dataset.py:84-87).

    trainB is OPTIONAL: field data (the AutoRealData workload, SU
    gathers ingested by ``fwi-prep --su-obs``) has no ground-truth
    model — the starting model (trainC) then doubles as the metric
    reference, so reported "model MSE" measures distance from the
    start, not inversion quality."""
    from physicsbasedfwi2_tpu.data.npy_datasets import NpyDictDataset
    ds = NpyDictDataset(dataroot, "unalignedVelABCDEl", phase=phase)
    item = ds[0]
    ovx = jnp.asarray(item["A"])
    ovz = jnp.asarray(item["D"])
    c = jnp.asarray(item["C"]).reshape(3, nz, nx)
    b = (jnp.asarray(item["B"]).reshape(3, nz, nx) if "B" in item
         else c)
    ns, nt_d, nr = ovx.shape
    assert nt_d == nt, f"data nt {nt_d} != config nt {nt}"
    grid = Grid2D(nz=nz, nx=nx, dx=dx, nt=nt, dt=dt,
                  pml_width=pml_width, free_surface=free_surface)
    cfg = ElasticConfig(grid=grid, chunk=chunk, vmax_pml=5000.0)
    wav = ricker(freq, nt, dt)
    num_shots = num_shots or ns
    num_receivers = num_receivers or nr
    from physicsbasedfwi2_tpu.geo.acquisition import (
        elastic_line, seabed_rows)
    src_row = (src_depth_row if src_depth_row is not None
               else water_rows + 1)
    rcv_row = (rcv_depth_row if rcv_depth_row is not None
               else water_rows + 1)
    acq = elastic_line(
        num_shots, num_receivers, nx, nz, src_row=src_row,
        rcv_row=rcv_row,
        rcv_rows_per_col=(seabed_rows(np.asarray(b[0]))
                          if rcv_follow_seabed else None))
    return SyntheticElasticWorkload(
        grid=grid, cfg=cfg, acq=acq, wavelet=wav,
        true={"vp": b[0], "vs": b[1], "rho": b[2]},
        start={"vp": c[0], "vs": c[1], "rho": c[2]},
        obs_vx=ovx, obs_vz=ovz, from_disk=True)


def write_npy_tree(root: str, workload: SyntheticAcousticWorkload,
                   *, phase: str = "train",
                   write_wavelets: bool = False):
    """Materialize the reference's on-disk contract
    (<root>/<phase>A/0.npy etc.) from a synthetic workload.
    write_wavelets adds <phase>D = per-shot source wavelets [ns, nt]
    (the AutoWav trainD contract, networks.py:13163)."""
    import os
    entries = [("A", workload.obs), ("B", workload.vp_true),
               ("C", workload.vp_start)]
    if write_wavelets:
        wav = np.asarray(workload.wavelet)
        if wav.ndim == 1:
            wav = np.broadcast_to(
                wav[None], (len(np.asarray(workload.acq.src_z)),
                            wav.shape[0]))
        entries.append(("D", wav))
    for letter, arr in entries:
        d = os.path.join(root, phase + letter)
        os.makedirs(d, exist_ok=True)
        np.save(os.path.join(d, "0.npy"), np.asarray(arr))


def write_elastic_npy_tree(root: str, wl: SyntheticElasticWorkload,
                           *, phase: str = "train"):
    """Materialize the elastic contract (stored /100, bottom-up order
    NOT applied — row 0 = surface as the loaders expect)."""
    import os
    b = np.stack([np.asarray(wl.true["vp"]), np.asarray(wl.true["vs"]),
                  np.asarray(wl.true["rho"])]) / 100.0
    c = np.stack([np.asarray(wl.start["vp"]), np.asarray(wl.start["vs"]),
                  np.asarray(wl.start["rho"])]) / 100.0
    for letter, arr in (("A", np.asarray(wl.obs_vx)), ("B", b),
                        ("C", c), ("D", np.asarray(wl.obs_vz))):
        d = os.path.join(root, phase + letter)
        os.makedirs(d, exist_ok=True)
        np.save(os.path.join(d, "0.npy"), arr)
