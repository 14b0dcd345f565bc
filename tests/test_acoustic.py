"""Propagator correctness: travel time, absorption, adjoint identity,
FD-vs-AD gradient check (the test pyramid the reference lacks,
SURVEY.md §4)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from physicsbasedfwi2_tpu.geo import Grid2D, ricker
from physicsbasedfwi2_tpu.ops import (
    simulate_acoustic, acoustic_gradient, AcousticConfig,
    trace_normalize, l2_misfit,
)


def small_setup(nz=60, nx=80, nt=500, dt=0.002, dx=10.0, v0=1500.0):
    grid = Grid2D(nz=nz, nx=nx, dx=dx, nt=nt, dt=dt, pml_width=20)
    cfg = AcousticConfig(grid=grid, chunk=25, vmax_pml=2500.0)
    wav = ricker(10.0, nt, dt)
    src_z = jnp.array([2], jnp.int32)
    src_x = jnp.array([nx // 2], jnp.int32)
    rcv_z = jnp.array([[2]], jnp.int32)
    rcv_x = jnp.array([[nx - 10]], jnp.int32)
    vp = jnp.full((nz, nx), v0, jnp.float32)
    return cfg, wav, vp, (src_z, src_x, rcv_z, rcv_x)


def test_travel_time_homogeneous():
    """First-arrival time in a constant medium matches distance/v."""
    cfg, wav, vp, geom = small_setup()
    rec = np.asarray(simulate_acoustic(vp, wav, *geom, cfg))[0, :, 0]
    dist = 30 * cfg.grid.dx  # 300 m
    t_expected = dist / 1500.0 + 0.1  # + wavelet peak delay (1/10 Hz)
    it_peak = int(np.argmax(np.abs(rec)))
    t_peak = it_peak * cfg.grid.dt
    assert abs(t_peak - t_expected) < 0.015, (t_peak, t_expected)


def test_pml_absorbs():
    """Late-time energy must be tiny relative to the direct arrival."""
    cfg, wav, vp, geom = small_setup(nt=1200)
    rec = np.asarray(simulate_acoustic(vp, wav, *geom, cfg))[0, :, 0]
    peak = np.abs(rec).max()
    tail = np.abs(rec[900:]).max()
    assert tail < 2e-2 * peak, (peak, tail)


def test_reflection_from_interface():
    """A velocity contrast produces a later reflected arrival."""
    cfg, wav, vp, geom = small_setup(nt=900)
    vp2 = vp.at[40:, :].set(3000.0)
    rec_h = np.asarray(simulate_acoustic(vp, wav, *geom, cfg))[0, :, 0]
    rec_r = np.asarray(simulate_acoustic(vp2, wav, *geom, cfg))[0, :, 0]
    diff = rec_r - rec_h  # isolates the reflection
    # reflection arrives after the direct wave
    it_direct = int(np.argmax(np.abs(rec_h)))
    it_refl = int(np.argmax(np.abs(diff)))
    assert it_refl > it_direct + 50
    assert np.abs(diff).max() > 1e-4 * np.abs(rec_h).max()


def test_linearization_dot_product():
    """Adjoint consistency: <J v, w> == <v, J^T w> via jvp/vjp."""
    cfg, wav, vp, geom = small_setup(nz=40, nx=50, nt=300)

    def fwd(v):
        return simulate_acoustic(v, wav, *geom, cfg)

    key = jax.random.PRNGKey(0)
    dv = jax.random.normal(key, vp.shape, jnp.float32)
    dw = jax.random.normal(jax.random.PRNGKey(1),
                           (1, cfg.grid.nt, 1), jnp.float32)
    _, jv = jax.jvp(fwd, (vp,), (dv,))
    _, vjp_fn = jax.vjp(fwd, vp)
    (jtw,) = vjp_fn(dw)
    lhs = jnp.vdot(jv, dw)
    rhs = jnp.vdot(dv, jtw)
    rel = abs(float(lhs - rhs)) / (abs(float(lhs)) + 1e-20)
    assert rel < 1e-4, (float(lhs), float(rhs))


def test_gradient_vs_finite_difference():
    """AD gradient matches central finite differences to <=1e-3
    rel-err (the BASELINE.md north-star accuracy bar)."""
    cfg, wav, vp, geom = small_setup(nz=40, nx=50, nt=300)
    vp_true = vp.at[20:30, 20:35].add(300.0)
    obs = simulate_acoustic(vp_true, wav, *geom, cfg)

    def loss_fn(pred):
        return l2_misfit(pred, obs)

    loss, grad = acoustic_gradient(vp, loss_fn, wav, *geom, cfg)
    grad = np.asarray(grad, np.float64)

    def scalar_loss(v):
        return float(loss_fn(simulate_acoustic(v, wav, *geom, cfg)))

    # Directional derivative along a smooth random direction: much
    # better conditioned than pointwise FD in float32.
    rng = np.random.default_rng(0)
    d = rng.standard_normal(vp.shape)
    # smooth it so the perturbation is physical
    for ax in (0, 1):
        d = 0.25 * (np.roll(d, 1, ax) + np.roll(d, -1, ax)) + 0.5 * d
    d = d / np.abs(d).max()
    d_j = jnp.asarray(d, jnp.float32)
    eps = 2.0
    fd = (scalar_loss(vp + eps * d_j) - scalar_loss(vp - eps * d_j)) / (2 * eps)
    ad = float(np.vdot(grad, d))
    rel = abs(fd - ad) / max(abs(fd), 1e-20)
    assert rel < 1e-3, (fd, ad, rel)


def test_shot_vmap_consistency():
    """Two shots simulated together equal two singles."""
    cfg, wav, vp, _ = small_setup(nz=40, nx=50, nt=200)
    src_z = jnp.array([2, 2], jnp.int32)
    src_x = jnp.array([10, 35], jnp.int32)
    rcv_z = jnp.full((2, 5), 2, jnp.int32)
    rcv_x = jnp.tile(jnp.arange(5, dtype=jnp.int32) * 9 + 3, (2, 1))
    both = np.asarray(simulate_acoustic(vp, wav, src_z, src_x, rcv_z, rcv_x, cfg))
    one = np.asarray(simulate_acoustic(
        vp, wav, src_z[1:], src_x[1:], rcv_z[1:], rcv_x[1:], cfg))
    # XLA fuses the batched and single programs differently; allow
    # f32 reassociation noise.
    np.testing.assert_allclose(both[1], one[0], rtol=1e-3, atol=1e-5)


def test_trace_normalize():
    x = jnp.array([[[1.0, 2.0], [3.0, -4.0]]])  # [1, nt=2, nr=2]
    y = np.asarray(trace_normalize(x))
    np.testing.assert_allclose(np.abs(y).max(axis=1), np.ones((1, 2)),
                               rtol=1e-5)


def test_impedance_synthetic_pipeline():
    from physicsbasedfwi2_tpu.ops.impedance import (
        impedance, reflectivity, impedance_synthetic, impedance_misfit)
    vp = jnp.full((50, 8), 2000.0, jnp.float32).at[25:, :].set(3000.0)
    zp = impedance(vp)
    r = np.asarray(reflectivity(zp, axis=0))
    # single interface -> single nonzero reflectivity row
    assert np.count_nonzero(np.abs(r[:, 0]) > 1e-6) == 1
    assert abs(r[24, 0]) > 0.1
    syn = np.asarray(impedance_synthetic(vp, axis=0))
    assert syn.shape == vp.shape
    assert np.abs(syn[20:30]).max() > 10 * np.abs(syn[:10]).max()
    assert float(impedance_misfit(vp, vp)) < 1e-8
    assert float(impedance_misfit(vp, vp.at[25:, :].set(2800.0))) > 0
