"""The flax-free module layer (models/nn.py) and the generator registry
built on it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from physicsbasedfwi2_tpu.models import nn, define_generator, pack_output
from physicsbasedfwi2_tpu.models import _GENERATORS

KEY = jax.random.PRNGKey(0)
X = jax.random.normal(jax.random.PRNGKey(1), (2, 6, 8, 4))


def _shapes(params):
    return jax.tree_util.tree_map(lambda a: a.shape, params)


def test_conv_dense_layouts_and_outputs():
    conv = nn.Conv(3, (3, 3), strides=(2, 2))
    p = conv.init(KEY, X)
    assert _shapes(p) == {"params": {"kernel": (3, 3, 4, 3), "bias": (3,)}}
    y = conv.apply(p, X)
    ref = jax.lax.conv_general_dilated(
        X, p["params"]["kernel"], (2, 2), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC")) + p["params"]["bias"]
    np.testing.assert_allclose(y, ref, rtol=1e-6)
    assert y.shape == (2, 3, 4, 3)
    dense = nn.Dense(5)
    p = dense.init(KEY, X)
    assert _shapes(p) == {"params": {"kernel": (4, 5), "bias": (5,)}}
    np.testing.assert_allclose(dense.apply(p, X),
                               X @ p["params"]["kernel"], rtol=1e-5,
                               atol=1e-6)
    # bias starts at zero, the kernel is lecun-normal (fan-in scaled)
    k = np.asarray(conv.init(KEY, jnp.ones((1, 64, 64, 32)))
                   ["params"]["kernel"])
    assert abs(k.std() * np.sqrt(3 * 3 * 32) - 1.0) < 0.1


def test_group_and_layer_norm_statistics():
    x = X * 3.0 + 2.0
    gn = nn.GroupNorm(num_groups=2)
    p = gn.init(KEY, x)
    assert _shapes(p) == {"params": {"scale": (4,), "bias": (4,)}}
    y = np.asarray(gn.apply(p, x)).reshape(2, 6, 8, 2, 2)
    np.testing.assert_allclose(y.mean(axis=(1, 2, 4)), 0.0, atol=1e-5)
    np.testing.assert_allclose(y.std(axis=(1, 2, 4)), 1.0, atol=1e-3)
    with pytest.raises(ValueError, match="groups"):
        nn.GroupNorm(num_groups=3).init(KEY, x)
    ln = nn.LayerNorm()
    y = np.asarray(ln.apply(ln.init(KEY, x), x))
    np.testing.assert_allclose(y.mean(-1), 0.0, atol=1e-5)


def test_dropout_rng_and_determinism():
    d = nn.Dropout(0.5)
    x = jnp.ones((4, 100))
    assert d.init(KEY, x, deterministic=True) == {"params": {}}
    assert (d.apply({"params": {}}, x, deterministic=True) == x).all()
    a = d.apply({"params": {}}, x, deterministic=False,
                rngs={"dropout": jax.random.PRNGKey(2)})
    b = d.apply({"params": {}}, x, deterministic=False,
                rngs={"dropout": jax.random.PRNGKey(3)})
    assert set(np.unique(np.asarray(a))) <= {0.0, 2.0}
    assert not (a == b).all()
    with pytest.raises(ValueError, match="dropout"):
        d.apply({"params": {}}, x, deterministic=False)


class _Compact(nn.Module):
    features: int

    @nn.compact
    def __call__(self, x):
        shared = nn.Dense(self.features)
        x = nn.relu(nn.Conv(self.features, (1, 1))(x))
        x = nn.Conv(self.features, (3, 3), name="named")(x)
        return shared(x) + shared(x), nn.Sequential(
            [nn.Dense(2), nn.sigmoid])(x)


class _Setup(nn.Module):
    def setup(self):
        self.enc = _Compact(3)
        self.head = nn.Dense(1)

    def __call__(self, x):
        return self.decode(self.enc(x)[0])

    def decode(self, h):
        return self.head(h)


def test_submodule_naming_and_sharing():
    m = _Setup()
    p = m.init(KEY, X)["params"]
    assert sorted(p) == ["enc", "head"]
    assert sorted(p["enc"]) == ["Conv_0", "Dense_0", "Dense_1", "named"]
    out = m.apply({"params": p}, X)
    assert out.shape == (2, 6, 8, 1)
    h = jnp.ones((1, 3))
    np.testing.assert_allclose(
        m.apply({"params": p}, h, method=m.decode),
        h @ p["head"]["kernel"] + p["head"]["bias"], rtol=1e-6)
    with pytest.raises(KeyError, match="missing"):
        m.apply({"params": {"enc": p["enc"]}}, X)
    with pytest.raises(RuntimeError, match="unbound"):
        nn.Dense(2)(X)


def test_matches_flax_numerically():
    """Same init key -> bit-identical parameters; same parameters ->
    the same outputs as flax.linen (compared where flax is installed)."""
    linen = pytest.importorskip("flax.linen")

    class Ours(nn.Module):
        @nn.compact
        def __call__(self, x, *, deterministic=True):
            x = nn.Conv(8, (3, 3), kernel_dilation=(2, 2))(x)
            x = nn.leaky_relu(nn.GroupNorm(num_groups=4)(x), 0.1)
            x = nn.Dropout(0.3)(x, deterministic=deterministic)
            x = nn.avg_pool(x, (2, 2), strides=(2, 2))
            return nn.Dense(3)(nn.LayerNorm()(x))

    class Theirs(linen.Module):
        @linen.compact
        def __call__(self, x, *, deterministic=True):
            x = linen.Conv(8, (3, 3), kernel_dilation=(2, 2))(x)
            x = linen.leaky_relu(linen.GroupNorm(num_groups=4)(x), 0.1)
            x = linen.Dropout(0.3)(x, deterministic=deterministic)
            x = linen.avg_pool(x, (2, 2), strides=(2, 2))
            return linen.Dense(3)(linen.LayerNorm()(x))

    p_ours, p_theirs = Ours().init(KEY, X), Theirs().init(KEY, X)
    jax.tree_util.tree_map(np.testing.assert_array_equal, p_ours,
                           jax.tree_util.tree_map(np.asarray, p_theirs))
    rngs = {"dropout": jax.random.PRNGKey(4)}
    np.testing.assert_allclose(
        Ours().apply(p_ours, X, deterministic=False, rngs=rngs),
        Theirs().apply(p_theirs, X, deterministic=False, rngs=rngs),
        rtol=1e-5, atol=1e-6)


def _generator_inputs(name):
    """Tiny inputs per generator family (shots [B, nt, nr, ns] for the
    seismic-input nets, images for the image-to-image ones)."""
    fam = _GENERATORS[name][0].__name__
    shots = jax.random.normal(KEY, (1, 32, 16, 2))
    if fam == "ElasticAutoEncoderNet":
        return dict(out_shape=(12, 20), filters=(4, 8)), (shots, shots)
    if fam in ("AutoEncoderNet", "FlowAutoEncoderNet", "VaeNet",
               "VaeFlowNet"):
        return dict(out_shape=(12, 20), filters=(4, 8)), (shots,)
    img = jax.random.normal(KEY, (1, 16, 16, 2))
    if fam == "ModelVae":
        return dict(out_shape=(16, 16), filters=(4, 8)), (img,)
    if fam == "FNO2d":
        return dict(width=4, depth=1, modes=3), (img,)
    if fam == "ResnetGenerator":
        return dict(base=8, n_blocks=1), (img,)
    return dict(out_shape=(12, 20), filters=(4, 8)), (img,)


@pytest.mark.parametrize("name", sorted(_GENERATORS))
def test_registered_generator_init_apply(name):
    kw, args = _generator_inputs(name)
    net = define_generator(name, **kw)
    params = net.init({"params": KEY, "latent": KEY}, *args)
    leaves = jax.tree_util.tree_leaves(params)
    assert leaves and all(jnp.all(jnp.isfinite(x)) for x in leaves)
    field = pack_output(net.apply(params, *args)).field
    if "out_shape" in kw and _GENERATORS[name][0].__name__ != "ModelVae":
        assert field.shape[1:3] == kw["out_shape"]
    else:
        assert field.shape[1:3] == args[0].shape[1:3]
    assert bool(jnp.all(jnp.isfinite(field)))


def test_engine_runs_without_flax_or_orbax():
    """Building and stepping an engine imports neither flax nor orbax
    (the GPU host is only sure to have jax, numpy, scipy, optax)."""
    import os
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys, jax; jax.config.update('jax_platforms', 'cpu')\n"
        "from physicsbasedfwi2_tpu.engine import create_engine, "
        "get_workload\n"
        "cfg = get_workload('marmousi_acoustic', nz=40, nx=48, nt=40, "
        "num_shots=2, num_receivers=8, water_rows=6, pml_width=8, "
        "chunk=10, filters=(4, 8)).replace(validate_on_twin=False)\n"
        "out = create_engine(cfg).optimize_parameters(1)\n"
        "bad = sorted(m for m in sys.modules "
        "if m.split('.')[0] in ('flax', 'orbax'))\n"
        "print(out['loss_D'], bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=repo,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-1000:] + r.stderr[-2000:]
