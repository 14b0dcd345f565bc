"""Multi-chip dry run: one FULL sharded FWI training step.

This module is executed as a *fresh subprocess* by
``__graft_entry__.dryrun_multichip`` so that platform selection (CPU
with N virtual devices) happens before ANY backend initialization —
env vars / ``jax.config`` are too late once a backend has initialized
in the parent process.

Parallelism layout (FWI's natural axes — SURVEY.md §2.2: no
attention/MoE in this domain, so TP/PP/EP degenerate; DP == shot
parallelism, SP == the time axis handled by rematerialized scan):
generator weights replicated, shots + observed data sharded over the
mesh's "shot" axis, psum for loss/grad reduction.  This replaces the
reference's Ray per-shot GPU fan-out (Auto_model.py:69-199) and
DENISE's MPI ranks (networks.py:7709-7710).
"""

from __future__ import annotations

import functools
import os
import sys


def _force_cpu_devices(n_devices: int) -> None:
    """Select the CPU platform with n virtual devices.  MUST run
    before any jax backend initialization in this process."""
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={n_devices}"
        ).strip()
    import jax
    jax.config.update("jax_platforms", "cpu")


def run(n_devices: int) -> float:
    """One sharded training step on an already-configured backend.

    Requires >= n_devices jax devices; returns the (finite) loss.
    """
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from jax import shard_map

    from physicsbasedfwi2_tpu.geo import Grid2D, ricker, surface_line
    from physicsbasedfwi2_tpu.ops import (
        AcousticConfig, simulate_acoustic, trace_normalize)
    from physicsbasedfwi2_tpu.models import (
        AutoEncoderNet, apply_velocity_output)
    from physicsbasedfwi2_tpu.parallel import make_mesh

    if len(jax.devices()) < n_devices:
        raise RuntimeError(
            f"need {n_devices} devices, have {len(jax.devices())}")

    mesh = make_mesh(n_devices)
    ns = 2 * n_devices  # 2 shots per device
    nz, nx, nt, nr = 32, 48, 128, 24
    grid = Grid2D(nz=nz, nx=nx, dx=10.0, nt=nt, dt=0.002, pml_width=12)
    cfg = AcousticConfig(grid=grid, chunk=32, vmax_pml=3000.0)
    wav = ricker(10.0, nt, 0.002)
    acq = surface_line(ns, nr, nx, src_depth=2, rcv_depth=2)
    sz, sx, rz, rx = (jnp.asarray(a) for a in
                      (acq.src_z, acq.src_x, acq.rcv_z, acq.rcv_x))

    vp_true = jnp.full((nz, nx), 1800.0, jnp.float32).at[16:, :].set(2200.0)
    obs = simulate_acoustic(vp_true, wav, sz, sx, rz, rx, cfg)
    obs_norm = trace_normalize(obs)
    shots_in = jnp.transpose(obs, (1, 2, 0))[None]
    true_b = vp_true[None, :, :, None]

    net = AutoEncoderNet(out_shape=(nz, nx), latent_dim=8, filters=(4, 8, 16))
    params = net.init(jax.random.PRNGKey(0), shots_in)
    opt = optax.adam(1e-3)
    opt_state = opt.init(params)

    # place sharded operands
    shot_sharding = NamedSharding(mesh, P("shot"))
    repl = NamedSharding(mesh, P())
    obs_norm = jax.device_put(obs_norm, shot_sharding)
    sz = jax.device_put(sz, shot_sharding)
    sx = jax.device_put(sx, shot_sharding)
    rz = jax.device_put(rz, shot_sharding)
    rx = jax.device_put(rx, shot_sharding)
    params = jax.device_put(params, repl)

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(), P(), P("shot"), P("shot"), P("shot"), P("shot"),
                  P("shot")),
        out_specs=P(),
        check_vma=False)
    def sharded_data_loss(vp, wav_, sz_, sx_, rz_, rx_, obs_):
        pred = simulate_acoustic(vp, wav_, sz_, sx_, rz_, rx_, cfg)
        m = jnp.max(jnp.abs(pred), axis=1, keepdims=True)
        pred = pred / (m + 1e-10)
        local = jnp.sum((pred - obs_) ** 2)
        return jax.lax.psum(local, "shot") / (ns * nt * nr)

    @jax.jit
    def train_step(params, opt_state):
        def loss_fn(p):
            f01, _ = net.apply(p, shots_in)
            vp = apply_velocity_output(f01, true_b)[0, :, :, 0]
            return sharded_data_loss(vp, wav, sz, sx, rz, rx, obs_norm)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    params, opt_state, loss = train_step(params, opt_state)
    loss = float(loss)
    assert np.isfinite(loss), f"non-finite loss {loss}"
    return loss


def run_mesh2d(n_devices: int) -> float:
    """One gradient on a 2D {sample, shot} mesh — the reference's
    batch_size + Ray per-sample fan-out as a single shard_map
    (Auto_model.py:185-199)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from physicsbasedfwi2_tpu.geo import Grid2D, ricker, surface_line
    from physicsbasedfwi2_tpu.ops import (
        AcousticConfig, simulate_acoustic, trace_normalize)
    from physicsbasedfwi2_tpu.parallel import (
        make_mesh2d, sample_shot_sharded_acoustic_gradient)

    n_sample = min(2, n_devices)
    n_shot = max(1, n_devices // n_sample)
    mesh = make_mesh2d(n_sample, n_shot)
    ns = 2 * n_shot
    nz, nx, nt, nr = 32, 48, 128, 24
    grid = Grid2D(nz=nz, nx=nx, dx=10.0, nt=nt, dt=0.002, pml_width=12)
    cfg = AcousticConfig(grid=grid, chunk=32, vmax_pml=3000.0)
    wav = ricker(10.0, nt, 0.002)
    acq = surface_line(ns, nr, nx, src_depth=2, rcv_depth=2)
    sz, sx, rz, rx = (jnp.asarray(a) for a in
                      (acq.src_z, acq.src_x, acq.rcv_z, acq.rcv_x))
    vps_true = jnp.stack([
        jnp.full((nz, nx), 1800.0, jnp.float32).at[14 + 4 * i :, :].set(
            2200.0) for i in range(n_sample)])
    obs = jax.vmap(lambda v: simulate_acoustic(
        v, wav, sz, sx, rz, rx, cfg))(vps_true)
    obs_norm = trace_normalize(obs)
    vps0 = jnp.full((n_sample, nz, nx), 1900.0, jnp.float32)
    loss, g = jax.jit(lambda v: sample_shot_sharded_acoustic_gradient(
        mesh, v, obs_norm, wav, sz, sx, rz, rx, cfg, misfit="l2"))(vps0)
    loss = float(loss)
    assert np.isfinite(loss) and np.isfinite(np.asarray(g)).all()
    return loss


def run_domain_decomp(n_devices: int) -> float:
    """One forward on a laterally grid-sharded mesh with per-step
    ppermute halo exchange (parallel/halo.py) — the DENISE
    domain-decomposition analogue (networks.py:7709-7710)."""
    import jax.numpy as jnp
    import numpy as np

    from physicsbasedfwi2_tpu.geo import Grid2D, ricker
    from physicsbasedfwi2_tpu.ops import AcousticConfig
    from physicsbasedfwi2_tpu.parallel import make_mesh
    from physicsbasedfwi2_tpu.parallel.halo import simulate_acoustic_dd

    mesh = make_mesh(n_devices)
    # padded lateral width (nx + 2*pml) must divide by the mesh size
    nz, nx, nt = 32, max(24 * n_devices - 16, 32), 96
    grid = Grid2D(nz=nz, nx=nx, dx=10.0, nt=nt, dt=0.002, pml_width=8)
    cfg = AcousticConfig(grid=grid, chunk=32, vmax_pml=3000.0)
    wav = ricker(10.0, nt, 0.002)
    sz = jnp.array([2], jnp.int32)
    sx = jnp.array([nx // 2], jnp.int32)
    rz = jnp.full((1, 8), 2, jnp.int32)
    rx = jnp.arange(4, nx - 4, (nx - 8) // 8, dtype=jnp.int32)[None, :8]
    vp = jnp.full((nz, nx), 1800.0, jnp.float32)
    rec = simulate_acoustic_dd(vp, wav, sz, sx, rz, rx, cfg, mesh=mesh)
    s = float(jnp.sum(rec ** 2))
    assert np.isfinite(s) and s > 0
    return s


def run_elastic_engine(n_devices: int) -> float:
    """One sharded ElasticDIPEngine training step — the full
    DENISE-replacement engine (two-branch generator, gradient
    conditioning, custom-VJP injection, optax update) with its
    per-iteration shot subset fanned out over the mesh
    (networks.py:7709-7710's 30-rank role)."""
    import numpy as np
    import jax
    import jax.numpy as jnp

    from physicsbasedfwi2_tpu.engine.config import get_workload
    from physicsbasedfwi2_tpu.engine.engines import ElasticDIPEngine
    from physicsbasedfwi2_tpu.parallel import make_mesh

    mesh = make_mesh(n_devices)
    cfg = get_workload(
        "marmousi_elastic", nz=24, nx=32, nt=120, dt=0.0015,
        num_shots=n_devices, shots_per_iter=n_devices,
        num_receivers=12, filters=(4, 8), chunk=20, water_rows=4,
        pml_width=8, lstart=0, freq=12.0, freq_stages=(),
        # the flagship's grad_taper_rows=27 would zero EVERY row of
        # this 24-row grid, turning the step into a no-op that can't
        # catch a broken psum; taper only the 4 water rows here
        grad_taper_rows=4).replace(
            name="dryrun_elastic", save_dir="/tmp/dryrun_el")
    eng = ElasticDIPEngine(cfg, mesh=mesh)
    p0 = jax.tree_util.tree_leaves(eng.params)[0].copy()
    out = eng.optimize_parameters(1)
    loss = out["loss_D_MSE"]
    assert np.isfinite(loss), f"non-finite elastic loss {loss}"
    # the sharded gradient must actually reach the optimizer: a wrong
    # spec/reduction that silently zeroes it would still print a
    # finite loss
    p1 = jax.tree_util.tree_leaves(eng.params)[0]
    assert float(jnp.max(jnp.abs(p1 - p0))) > 0, \
        "sharded elastic step did not update the generator"
    return loss


def main(argv=None) -> None:
    argv = argv if argv is not None else sys.argv[1:]
    n = int(argv[0]) if argv else 8
    _force_cpu_devices(n)
    loss = run(n)
    print(f"dryrun_multichip({n}): one sharded FWI train step OK, "
          f"loss={loss:.6e}")
    loss2 = run_mesh2d(n)
    print(f"dryrun_multichip({n}): {{sample, shot}} 2D-mesh gradient "
          f"OK, loss={loss2:.6e}")
    e = run_domain_decomp(n)
    print(f"dryrun_multichip({n}): domain-decomposed forward (halo "
          f"ppermute) OK, energy={e:.6e}")
    le = run_elastic_engine(n)
    print(f"dryrun_multichip({n}): sharded elastic engine step OK, "
          f"loss={le:.6e}")


if __name__ == "__main__":
    main()
