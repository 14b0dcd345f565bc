"""Optimizers: schedules, L-BFGS convergence, SGLD/SGHMC sampling."""

import jax
import jax.numpy as jnp
import numpy as np
import optax

from physicsbasedfwi2_tpu.optim import make_scheduler, lbfgs_wolfe, sgld, sghmc
from physicsbasedfwi2_tpu.optim.lbfgs import make_lbfgs_step, run_lbfgs
from physicsbasedfwi2_tpu.optim.schedules import PlateauController


def test_schedules():
    lin = make_scheduler("linear", lr=0.1, n_epochs=10, n_epochs_decay=10)
    assert abs(float(lin(0)) - 0.1) < 1e-6
    assert abs(float(lin(15)) - 0.05) < 1e-6
    assert abs(float(lin(20))) < 1e-6
    step = make_scheduler("step", lr=0.1, lr_decay_iters=10)
    assert abs(float(step(10)) - 0.01) < 1e-9
    cos = make_scheduler("cosine", lr=0.1, n_epochs=100)
    assert abs(float(cos(0)) - 0.1) < 1e-6 and float(cos(100)) < 1e-8


def test_plateau_controller():
    pc = PlateauController(lr=0.1, patience=2, factor=0.5)
    for _ in range(10):
        lr = pc.step(1.0)  # no improvement
    assert lr < 0.1


def test_lbfgs_rosenbrock():
    def rosen(p):
        x, y = p
        return (1 - x) ** 2 + 100.0 * (y - x ** 2) ** 2

    p0 = jnp.array([-1.2, 1.0])
    p, losses = run_lbfgs(rosen, p0, steps=60)
    assert losses[-1] < 1e-6, losses[-1]
    np.testing.assert_allclose(np.asarray(p), [1.0, 1.0], atol=1e-3)


def test_lbfgs_quadratic_fast():
    A = jnp.array([[3.0, 1.0], [1.0, 2.0]])

    def quad(p):
        return 0.5 * p @ A @ p

    p, losses = run_lbfgs(quad, jnp.array([5.0, -3.0]), steps=15)
    assert losses[-1] < 1e-8


def test_sgld_samples_gaussian():
    """SGLD on a 1D Gaussian potential: sample variance ~ target."""
    opt = sgld(1e-2, seed=0)
    p = jnp.zeros((1,))
    state = opt.init(p)

    @jax.jit
    def step(p, state):
        g = p  # grad of 0.5 p^2 -> stationary N(0, 1)
        up, state = opt.update(g, state)
        return p + up, state

    samples = []
    for i in range(3000):
        p, state = step(p, state)
        if i > 500:
            samples.append(float(p[0]))
    var = np.var(samples)
    assert 0.5 < var < 2.0, var


def test_sghmc_runs_and_explores():
    opt = sghmc(1e-3, friction=0.1, seed=0)
    p = jnp.zeros((2,))
    state = opt.init(p)

    @jax.jit
    def step(p, state):
        up, state = opt.update(p, state)
        return p + up, state

    traj = []
    for _ in range(2000):
        p, state = step(p, state)
        traj.append(np.asarray(p))
    traj = np.stack(traj)
    assert np.isfinite(traj).all()
    assert traj[1000:].std() > 0.05  # explores, not stuck


def test_checkpoint_npz_roundtrip(tmp_path):
    """engine/checkpoint.py stores {params, opt_state, epoch} as one
    .npz array per pytree leaf and restores it into a template."""
    import pytest
    from physicsbasedfwi2_tpu.engine.checkpoint import (
        restore_tree, save_tree)
    params = {"params": {"Dense_0": {"kernel": jnp.arange(6.0).reshape(2, 3),
                                     "bias": jnp.ones(3)}}}
    opt = optax.inject_hyperparams(optax.adam)(learning_rate=0.1)
    state = opt.init(params)
    _, state = opt.update(params, state, params)
    tree = {"params": params, "opt_state": state,
            "epoch": np.asarray(7)}
    path = save_tree(str(tmp_path / "ck" / "state"), tree)
    assert path.endswith(".npz")
    template = jax.tree_util.tree_map(jnp.zeros_like, tree)
    back = restore_tree(path, template)
    assert int(back["epoch"]) == 7
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)
    bad = dict(template, epoch=np.zeros(2))
    with pytest.raises(ValueError, match="shape"):
        restore_tree(path, bad)
