"""Multi-device sharding on the virtual 8-device CPU mesh: sharded
gradients must equal single-device gradients."""

import jax
import jax.numpy as jnp
import numpy as np

from physicsbasedfwi2_tpu.geo import Grid2D, ricker, surface_line
from physicsbasedfwi2_tpu.ops import (
    simulate_acoustic, acoustic_gradient, AcousticConfig,
    simulate_elastic, elastic_gradient, ElasticConfig, trace_normalize,
)
from physicsbasedfwi2_tpu.parallel import (
    make_mesh, shot_sharded_acoustic_gradient,
    shot_sharded_elastic_gradient, pad_shots_to_multiple,
)


def test_mesh_has_8_devices():
    mesh = make_mesh()
    assert mesh.shape["shot"] == 8


def _acoustic_setup(ns=8):
    grid = Grid2D(nz=40, nx=50, dx=10.0, nt=200, dt=0.002, pml_width=16)
    cfg = AcousticConfig(grid=grid, chunk=25, vmax_pml=2500.0)
    wav = ricker(10.0, grid.nt, grid.dt)
    acq = surface_line(ns, 20, 50, src_depth=2, rcv_depth=2)
    geom = tuple(jnp.asarray(a) for a in
                 (acq.src_z, acq.src_x, acq.rcv_z, acq.rcv_x))
    vp_true = jnp.full((40, 50), 1800.0, jnp.float32).at[20:30, 15:35].set(2100.0)
    vp0 = jnp.full((40, 50), 1800.0, jnp.float32)
    obs_norm = trace_normalize(simulate_acoustic(vp_true, wav, *geom, cfg))
    return cfg, wav, geom, vp0, obs_norm


def test_sharded_acoustic_matches_single_device():
    cfg, wav, geom, vp0, obs_norm = _acoustic_setup(ns=8)
    mesh = make_mesh()
    loss_s, grad_s = shot_sharded_acoustic_gradient(
        mesh, vp0, obs_norm, wav, *geom, cfg, misfit="l2")

    def loss_fn(pred):
        pred = trace_normalize(pred)
        return jnp.mean((pred - obs_norm) ** 2)

    loss_r, grad_r = acoustic_gradient(vp0, loss_fn, wav, *geom, cfg)
    np.testing.assert_allclose(float(loss_s), float(loss_r),
                               rtol=1e-5)
    np.testing.assert_allclose(np.asarray(grad_s), np.asarray(grad_r),
                               rtol=1e-3, atol=1e-10)


def test_sharded_with_padding_mask():
    """6 real shots padded to 8: padded shots must not contribute."""
    cfg, wav, geom, vp0, obs_norm = _acoustic_setup(ns=6)
    mesh = make_mesh()
    (sz, sx, rz, rx, obs_p), mask = pad_shots_to_multiple(
        [geom[0], geom[1], geom[2], geom[3], obs_norm], 8)
    loss_s, grad_s = shot_sharded_acoustic_gradient(
        mesh, vp0, obs_p, wav, sz, sx, rz, rx, cfg,
        misfit="l2", shot_mask=mask)

    def loss_fn(pred):
        pred = trace_normalize(pred)
        return jnp.mean((pred - obs_norm) ** 2)

    loss_r, grad_r = acoustic_gradient(vp0, loss_fn, wav, *geom, cfg)
    np.testing.assert_allclose(float(loss_s), float(loss_r), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(grad_s), np.asarray(grad_r),
                               rtol=1e-3, atol=1e-10)


def test_sharded_elastic_matches_single_device():
    grid = Grid2D(nz=36, nx=48, dx=10.0, nt=150, dt=0.0015, pml_width=14)
    cfg = ElasticConfig(grid=grid, chunk=25, vmax_pml=2800.0)
    wav = ricker(12.0, grid.nt, grid.dt)
    ns, nr = 8, 16
    acq = surface_line(ns, nr, 48, src_depth=2, rcv_depth=2)
    geom = tuple(jnp.asarray(a) for a in
                 (acq.src_z, acq.src_x, acq.rcv_z, acq.rcv_x))
    vp = jnp.full((36, 48), 2000.0, jnp.float32)
    vs = jnp.full((36, 48), 1100.0, jnp.float32)
    rho = jnp.full((36, 48), 2000.0, jnp.float32)
    vp_t = vp.at[18:28, 15:35].add(200.0)
    ovx, ovz = simulate_elastic(vp_t, vs, rho, wav, *geom, cfg)

    mesh = make_mesh()
    loss_s, grads_s = shot_sharded_elastic_gradient(
        mesh, vp, vs, rho, ovx, ovz, wav, *geom, cfg, wrt=("vp", "vs"))

    def loss_fn(pred):
        pvx, pvz = pred
        return (jnp.mean((pvx - ovx) ** 2) + jnp.mean((pvz - ovz) ** 2)) / 2

    loss_r, grads_r = elastic_gradient(vp, vs, rho, loss_fn, wav, *geom,
                                       cfg, wrt=("vp", "vs"))
    np.testing.assert_allclose(float(loss_s), float(loss_r), rtol=1e-5)
    for k in ("vp", "vs"):
        np.testing.assert_allclose(np.asarray(grads_s[k]),
                                   np.asarray(grads_r[k]) / 1.0,
                                   rtol=1e-3, atol=1e-12)


def test_engine_with_mesh_trains():
    """AcousticDIPEngine with a shot-sharded physics gradient on the
    8-device virtual mesh behaves like the single-device engine."""
    from physicsbasedfwi2_tpu.engine import get_workload
    from physicsbasedfwi2_tpu.engine.engines import AcousticDIPEngine
    cfg = get_workload(
        "marmousi_acoustic", nz=40, nx=48, nt=300, dt=0.001, num_shots=8,
        num_receivers=24, filters=(4, 8, 16), chunk=25, water_rows=6,
        pml_width=12).replace(name="t_mesh", save_dir="/tmp/fwi_test_ck",
                              misfit="l2")
    mesh = make_mesh()
    eng = AcousticDIPEngine(cfg, mesh=mesh)
    losses = [eng.optimize_parameters(e)["loss_D"] for e in range(1, 5)]
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]


def test_domain_decomposed_matches_single_device():
    """Halo-exchange propagation over the 8-device mesh == the
    single-chip result (DENISE's NPROCX role, SURVEY §2.2)."""
    from physicsbasedfwi2_tpu.parallel.halo import simulate_acoustic_dd
    grid = Grid2D(nz=32, nx=88, dx=10.0, nt=160, dt=0.002, pml_width=16)
    cfg = AcousticConfig(grid=grid, chunk=20, vmax_pml=2500.0)
    wav = ricker(10.0, grid.nt, grid.dt)
    src_z = jnp.array([4, 4], jnp.int32)
    src_x = jnp.array([20, 60], jnp.int32)
    rcv_z = jnp.full((2, 10), 3, jnp.int32)
    rcv_x = jnp.tile(jnp.arange(10, dtype=jnp.int32) * 8 + 4, (2, 1))
    vp = jnp.full((32, 88), 1800.0, jnp.float32).at[16:, :].set(2200.0)
    ref = np.asarray(simulate_acoustic(vp, wav, src_z, src_x, rcv_z,
                                       rcv_x, cfg))
    mesh = make_mesh()
    dd = np.asarray(simulate_acoustic_dd(vp, wav, src_z, src_x, rcv_z,
                                         rcv_x, cfg, mesh))
    assert dd.shape == ref.shape
    rel = np.abs(dd - ref).max() / (np.abs(ref).max() + 1e-20)
    assert rel < 1e-4, rel


def test_elastic_engine_with_mesh_matches_single_device():
    """ElasticDIPEngine(mesh=...) — the DENISE-over-30-MPI-ranks
    replacement (networks.py:7709-7710) — must produce the same step
    as the single-device engine (shots fan out over the mesh, psum
    reduction)."""
    from physicsbasedfwi2_tpu.engine import get_workload
    from physicsbasedfwi2_tpu.engine.engines import ElasticDIPEngine
    cfg = get_workload(
        "marmousi_elastic", nz=32, nx=48, nt=160, dt=0.0015,
        num_shots=8, num_receivers=16, filters=(4, 8), chunk=20,
        water_rows=4, pml_width=10, lstart=0, freq=12.0,
        freq_stages=(), shots_per_iter=8).replace(
            name="t_el_mesh", save_dir="/tmp/fwi_test_ck")
    ref = ElasticDIPEngine(cfg)
    out_r = ref.optimize_parameters(1)
    eng = ElasticDIPEngine(cfg, mesh=make_mesh())
    assert eng.physics_path.endswith("+mesh")
    out_s = eng.optimize_parameters(1)
    np.testing.assert_allclose(out_s["loss_D_MSE"], out_r["loss_D_MSE"],
                               rtol=1e-4)
    np.testing.assert_allclose(out_s["loss_M_MSE"], out_r["loss_M_MSE"],
                               rtol=1e-4)
    # a second step keeps training finitely
    out2 = eng.optimize_parameters(2)
    assert np.isfinite(out2["loss_D_MSE"])


def test_elastic_engine_mesh_requires_divisible_shots():
    from physicsbasedfwi2_tpu.engine import get_workload
    from physicsbasedfwi2_tpu.engine.engines import ElasticDIPEngine
    import pytest
    cfg = get_workload(
        "marmousi_elastic", num_shots=10, shots_per_iter=5).replace(
            name="t_el_mesh_bad", save_dir="/tmp/fwi_test_ck")
    with pytest.raises(ValueError, match="divisible"):
        ElasticDIPEngine(cfg, mesh=make_mesh())


def test_acoustic_engine_mesh_matches_single_device():
    """AcousticDIPEngine(mesh=...) — the Ray per-shot fan-out
    replacement — pads the shot axis to the mesh with zero-weight
    shots and takes the same step as the single-device engine."""
    from physicsbasedfwi2_tpu.engine import get_workload
    from physicsbasedfwi2_tpu.engine.engines import AcousticDIPEngine
    import optax
    cfg = get_workload(
        "marmousi_acoustic", nz=32, nx=48, nt=160, dt=0.001, freq=20.0,
        num_shots=6, num_receivers=16, filters=(4, 8, 16), chunk=16,
        water_rows=4, pml_width=8).replace(
            name="t_mesh_ac", save_dir="/tmp/fwi_test_ck",
            validate_on_twin=False)
    mesh = make_mesh()  # 6 shots over 8 devices: 2 padded shots
    eng = AcousticDIPEngine(cfg, mesh=mesh)
    assert eng.physics_path == "xla+mesh"
    ref = AcousticDIPEngine(cfg.replace(name="t_single_ac"))
    assert ref.physics_path == "xla"
    out_s = eng.optimize_parameters(1)
    out_r = ref.optimize_parameters(1)
    np.testing.assert_allclose(out_s["loss_D"], out_r["loss_D"],
                               rtol=1e-4)
    np.testing.assert_allclose(out_s["loss_M_MSE"], out_r["loss_M_MSE"],
                               rtol=1e-4)
    # Adam's first moment after one step is 0.1 x the generator
    # gradient; the L1 misfit's sign(residual) makes it sensitive to
    # summation order, hence 5e-3 rather than f32 round-off
    mu_s = np.concatenate([np.ravel(x) for x in jax.tree_util.tree_leaves(
        optax.tree_utils.tree_get(eng.opt_state, "mu"))])
    mu_r = np.concatenate([np.ravel(x) for x in jax.tree_util.tree_leaves(
        optax.tree_utils.tree_get(ref.opt_state, "mu"))])
    assert np.linalg.norm(mu_s - mu_r) < 5e-3 * np.linalg.norm(mu_r)
