"""Engine layer: every engine family trains a step and improves or at
least produces finite losses; drivers, checkpointing, MC sampling."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from physicsbasedfwi2_tpu.engine import (
    ExperimentConfig, get_workload, list_workloads, create_engine,
)
from physicsbasedfwi2_tpu.engine.train import train, PlateauDetector
from physicsbasedfwi2_tpu.engine.test import evaluate


SMALL_AC = dict(nz=40, nx=48, nt=400, dt=0.001, num_shots=4,
                num_receivers=24, filters=(4, 8, 16), chunk=25,
                water_rows=6, pml_width=12)
SMALL_EL = dict(nz=36, nx=48, nt=160, dt=0.0015, num_shots=4,
                num_receivers=20, filters=(4, 8, 16), chunk=25,
                water_rows=4, shots_per_iter=2, pml_width=12,
                lstart=0)  # physics from epoch 1 (the registered
                           # elastic workloads default to a 30-epoch
                           # anchor warmup)


def test_workload_registry():
    names = list_workloads()
    for required in ("marmousi_acoustic", "marmousi_elastic",
                     "marmousi_elastic_lbfgs", "latent_inversion",
                     "seam_elastic", "mcdip_uq", "classic_fwi_acoustic",
                     "pix2pix_baseline", "unet_ssim_baseline"):
        assert required in names, required


def test_parse_set_overrides():
    """fwi-train/--set generic overrides: python literals, bare-string
    fallback, unknown-field rejection (the reference's three-stage
    argparse exposed every option, base_options.py:20-57)."""
    from physicsbasedfwi2_tpu.engine.config import parse_set_overrides
    out = parse_set_overrides(["tether_weight=0.5",
                               "freq_stages=(4.0, 8.0)",
                               "misfit=tnl1", "lstart=10"])
    assert out == {"tether_weight": 0.5, "freq_stages": (4.0, 8.0),
                   "misfit": "tnl1", "lstart": 10}
    cfg = get_workload("marmousi_elastic", **out)
    assert cfg.misfit == "tnl1" and cfg.freq_stages == (4.0, 8.0)
    with pytest.raises(ValueError, match="unknown config field"):
        parse_set_overrides(["nosuch=1"])
    with pytest.raises(ValueError, match="unknown config field"):
        parse_set_overrides(["justastring"])
    # whitespace around the value must not survive into the config
    # (a padded misfit string would silently fall through every
    # `cfg.misfit == 'tnl1'` check to the plain-L2 path)
    assert parse_set_overrides(["misfit= tnl1 "]) == {"misfit": "tnl1"}
    # `name` is a config field like any other — get_workload must not
    # double-pass it
    assert get_workload("marmousi_elastic", name="myrun").name == "myrun"


def test_acoustic_dip_engine_trains():
    cfg = get_workload("marmousi_acoustic", **SMALL_AC).replace(
        name="t_ac", save_dir="/tmp/fwi_test_ck", lstart=0)
    eng = create_engine(cfg)
    losses = [eng.optimize_parameters(epoch=e)[
        "loss_D"] for e in range(1, 6)]
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    val, img = eng.test()
    assert np.isfinite(val["loss_V_MSE"]) and img.shape == (40, 48)
    # save/load roundtrip
    eng.save_networks("latest")
    eng2 = create_engine(cfg)
    eng2.load_networks("latest")
    v2, _ = eng2.test()
    assert abs(v2["loss_V_MSE"] - val["loss_V_MSE"]) < 1e-3


def test_elastic_dip_engine_trains():
    cfg = get_workload("marmousi_elastic", **SMALL_EL).replace(
        name="t_el", save_dir="/tmp/fwi_test_ck")
    eng = create_engine(cfg)
    r1 = eng.optimize_parameters(epoch=1, freq=12.0)
    r2 = eng.optimize_parameters(epoch=2, freq=12.0)
    assert np.isfinite(r1["loss_D_MSE"]) and np.isfinite(r2["loss_D_MSE"])
    val, m = eng.test()
    assert m.shape == (36, 48, 2)


def test_acoustic_freq_continuation_stages(tmp_path):
    """Acoustic frequency continuation (round 4): the engine's
    stage-filtered physics pytree shares the base treedef (one
    compiled step serves all stages), really band-limits the wavelet,
    and the train loop advances the stages (the real-Marmousi recipe,
    marmousi_acoustic_real; mirror of DENISE's source-side continuation
    the elastic engine uses, reference networks.py:7711-7713)."""
    import jax
    cfg = get_workload("marmousi_acoustic_real", **SMALL_AC).replace(
        name="t_ac_stage", save_dir=str(tmp_path),
        freq_stages=(4.0, 8.0, 0.0), stage_max_epochs=3,
        save_epoch_freq=10 ** 9)
    eng = create_engine(cfg)
    base = eng._pack["phys"]
    st = eng._stage_phys_pd(4.0)
    assert (jax.tree_util.tree_structure(base)
            == jax.tree_util.tree_structure(st))
    w = np.asarray(st["wav"])
    spec = np.abs(np.fft.rfft(w))
    f = np.fft.rfftfreq(w.shape[-1], cfg.dt)
    # zero-phase Butterworth at 4 Hz: spectrum above 2x the corner
    # must be negligible vs the passband peak
    assert spec[f > 8.0].max() < 0.05 * spec.max()
    # the filtered pd reaches the loss: same params, different misfit
    l_lo = eng.optimize_parameters(1, freq=4.0)["loss_D"]
    # full-band stage (0.0) falls back to the base pytree
    assert eng._stage_phys_pd(0.0) is base
    # full wiring: train() drives the plateau/stage machinery
    from physicsbasedfwi2_tpu.engine.train import train
    _, hist = train(cfg, epochs=8, quiet=True)
    stages = [r["freq_stage"] for r in hist]
    assert len(set(stages)) >= 2, stages
    assert np.isfinite(l_lo)


def test_direct_wave_toggle_changes_loss():
    """The trained misfit must include the constant-model direct-wave
    subtraction (networks.py:5396-5411, 5467): toggling it changes
    the physics loss (VERDICT r1 missing #10)."""
    base = get_workload("marmousi_acoustic", **SMALL_AC).replace(
        name="t_dw", save_dir="/tmp/fwi_test_ck", validate_on_twin=False)
    e_on = create_engine(base.replace(direct_wave=True))
    e_off = create_engine(base.replace(direct_wave=False))
    assert e_on._direct is not None and e_off._direct is None
    l_on = e_on.optimize_parameters(1)["loss_D"]
    l_off = e_off.optimize_parameters(1)["loss_D"]
    assert np.isfinite(l_on) and np.isfinite(l_off)
    assert abs(l_on - l_off) > 1e-9


def test_lr_policy_decays_in_history():
    """cfg.lr_policy drives the actual optimizer lr per epoch
    (reference get_scheduler, networks.py:79-106)."""
    cfg = get_workload("marmousi_acoustic", **SMALL_AC).replace(
        name="t_lr", save_dir="/tmp/fwi_test_ck", lr_policy="cosine",
        n_epochs=6, validate_on_twin=False, direct_wave=False)
    eng = create_engine(cfg)
    lrs = [eng.optimize_parameters(e)["lr"] for e in range(1, 6)]
    assert all(lrs[i + 1] < lrs[i] for i in range(len(lrs) - 1)), lrs
    # plateau policy reduces lr after stagnation
    from physicsbasedfwi2_tpu.optim.schedules import PlateauController
    pc = PlateauController(lr=1.0, patience=1, threshold=0.5)
    for _ in range(4):
        lr = pc.step(1.0)
    assert lr < 1.0


def test_validation_uses_heldout_twin():
    """engine.test() evaluates a held-out sample (the reference's
    create_dataset2 Test twin, data/__init__.py:41-62), not the
    training sample (VERDICT r1 aux 'validation split')."""
    cfg = get_workload("marmousi_acoustic", **SMALL_AC).replace(
        name="t_twin", save_dir="/tmp/fwi_test_ck")
    eng = create_engine(cfg)
    assert eng.val_wl is not None
    assert not np.allclose(np.asarray(eng.val_wl.vp_true),
                           np.asarray(eng.wl.vp_true))
    val, img = eng.test()
    assert np.isfinite(val["loss_V_MSE"])


def test_elastic_no_rho_oracle_leak():
    """The forward model must never see the TRUE density: at the true
    (vp, vs) the misfit stays > 0 because the simulation uses the
    low-frequency rho (networks.py:7458), not wl.true['rho']."""
    cfg = get_workload("marmousi_elastic", **SMALL_EL).replace(
        name="t_leak", save_dir="/tmp/fwi_test_ck")
    eng = create_engine(cfg)
    m_true = jnp.stack([eng.wl.true["vp"], eng.wl.true["vs"]], -1)
    idx = jnp.arange(2)
    loss_true = float(eng._physics_loss_raw(m_true, idx,
                                            eng._stage_pack(0.0)))
    # with the oracle rho this would be exactly 0 (obs generated by
    # the same operator); with the smooth rho it must not be
    assert loss_true > 1e-12, loss_true


def test_elastic_rho_inversion():
    """AutoElFullRhoMar22: three decoder heads, rho actually enters
    the simulation and receives gradient (VERDICT r1 missing #2)."""
    cfg = get_workload("marmousi_elastic_rho", **SMALL_EL).replace(
        name="t_rho", save_dir="/tmp/fwi_test_ck")
    eng = create_engine(cfg)
    assert eng.n_fields == 3
    r1 = eng.optimize_parameters(epoch=1, freq=12.0)
    assert np.isfinite(r1["loss_D_MSE"])
    val, m = eng.test()
    assert m.shape == (36, 48, 3)
    # rho output must differ from the starting rho below the pinned
    # rows (i.e. the rho head is live, not a passthrough)
    rho_out = m[SMALL_EL["water_rows"]:, :, 2]
    rho_start = np.asarray(eng.wl.start["rho"])[SMALL_EL["water_rows"]:, :]
    assert np.abs(rho_out - rho_start).max() > 1e-3
    # the reference's "Zp" net is the same three-head decoder under a
    # vestigial label (networks.py:10740-10880) — it must build 3-field
    zp = create_engine(get_workload("marmousi_elastic_zp", **SMALL_EL)
                       .replace(name="t_zp", save_dir="/tmp/fwi_test_ck"),
                       workload=eng.wl)
    assert zp.n_fields == 3


def test_classic_fwi_elastic_runs_elastic_physics():
    """classic_fwi_elastic must drive the P-SV solver and invert
    vp+vs grids (ref AutoEl22N, networks.py:6477-6520) — it silently
    ran acoustic physics in round 1 (VERDICT missing #1)."""
    cfg = get_workload("classic_fwi_elastic", **SMALL_EL).replace(
        name="t_clel", save_dir="/tmp/fwi_test_ck", lr=10.0,
        shots_per_iter=4)
    eng = create_engine(cfg)
    assert eng.is_elastic
    vs0 = np.asarray(eng.params["vs"]).copy()
    losses = [eng.optimize_parameters(e)["loss_D_MSE"] for e in range(6)]
    assert all(np.isfinite(losses))
    assert min(losses[1:]) < losses[0]
    # vs grid is a live parameter
    assert np.abs(np.asarray(eng.params["vs"]) - vs0).max() > 0
    val, m = eng.test()
    assert m.shape == (36, 48, 2)


def test_mcdip_realizations_differ():
    cfg = get_workload("mcdip_uq", **SMALL_EL).replace(
        name="t_mc", save_dir="/tmp/fwi_test_ck")
    eng = create_engine(cfg)
    samples = eng.mc_realizations(3)
    assert samples.shape[0] == 3
    assert samples.std(axis=0).mean() > 0  # dropout variability


def test_classic_fwi_engine():
    cfg = get_workload("classic_fwi_acoustic", **SMALL_AC).replace(
        name="t_cl", save_dir="/tmp/fwi_test_ck", lr=5.0)
    eng = create_engine(cfg)
    losses = [eng.optimize_parameters(e)["loss_D_MSE"] for e in range(10)]
    assert all(np.isfinite(losses))
    assert min(losses[1:]) < losses[0]


def test_latent_inversion_engine():
    cfg = get_workload("latent_inversion", **SMALL_AC).replace(
        name="t_lat", save_dir="/tmp/fwi_test_ck", lr=0.05)
    eng = create_engine(cfg)
    losses = [eng.optimize_parameters(e)["loss_D_MSE"] for e in range(4)]
    assert all(np.isfinite(losses))


def test_vae_pretrain_then_latent_inversion():
    """The reference's two-stage pipeline: VaeNoPhy/Vaevel pretrain a
    model-domain VAE, VaeLatent2NoPhy freezes its decoder and inverts
    the latent through the propagator (VaeLatent2NoPhy_model.py:
    395-560; VERDICT r1 missing #7)."""
    from physicsbasedfwi2_tpu.engine.pretrain import (
        make_model_bank, pretrain_model_vae)
    nz, nx = 40, 48
    bank = make_model_bank(12, nz, nx, water_rows=6, seed=3)
    net, params, norm, hist = pretrain_model_vae(
        bank, latent_dim=8, filters=(4, 8, 16), epochs=60,
        batch_size=6, lr=2e-3)
    assert hist[-1] < hist[0] * 0.5, (hist[0], hist[-1])  # recon learns
    cfg = get_workload("latent_inversion", **SMALL_AC).replace(
        name="t_pre", save_dir="/tmp/fwi_test_ck", lr=0.1)
    eng = create_engine(cfg, decoder_params=params, decoder_net=net,
                        decoder_norm=norm)
    v0, _ = eng.test()
    losses = [eng.optimize_parameters(e)["loss_D_MSE"]
              for e in range(1, 13)]
    assert all(np.isfinite(losses))
    assert min(losses[1:]) < losses[0]  # physics misfit drops
    v1, _ = eng.test()
    assert v1["loss_V_MSE"] < v0["loss_V_MSE"]  # model improves


def test_supervised_engine_gan_and_ssim():
    cfg = get_workload("pix2pix_baseline").replace(
        name="t_gan", save_dir="/tmp/fwi_test_ck")
    eng = create_engine(cfg, in_shape=(32, 32))
    a = jnp.zeros((1, 32, 32, 1))
    b = jnp.ones((1, 32, 32, 1)) * 0.5
    r = eng.optimize_parameters(a, b)
    assert np.isfinite(r["loss_G"]) and np.isfinite(r["loss_D"])
    cfg2 = get_workload("unet_ssim_baseline").replace(
        name="t_ssim", save_dir="/tmp/fwi_test_ck")
    eng2 = create_engine(cfg2, in_shape=(32, 32))
    r2 = eng2.optimize_parameters(a, b)
    assert np.isfinite(r2["loss_G"]) and "loss_D" not in r2


_DIP_GENERATORS = ["Auto22", "Unet22", "classic", "Att", "ASPP",
                   "ResUNET", "UNet3Plus", "R2U", "Multi", "Vae2",
                   "AutoNF", "VaeNormalizingPhy", "Simple24"]


@pytest.fixture(scope="module")
def shared_acoustic_workload():
    from physicsbasedfwi2_tpu.data import SyntheticAcousticWorkload
    return SyntheticAcousticWorkload.build(
        nz=40, nx=48, nt=400, dt=0.001, num_shots=4, num_receivers=24,
        water_rows=6, chunk=25, pml_width=12)


@pytest.mark.parametrize("netg", _DIP_GENERATORS)
def test_every_registered_generator_trains(netg, shared_acoustic_workload):
    """Registry != capability was a round-1 gap: every generator name
    that claims the acoustic DIP engine must take finite training
    steps that actually update its parameters (VERDICT r1 #5)."""
    cfg = get_workload("marmousi_acoustic", **SMALL_AC).replace(
        name=f"t_all_{netg}", save_dir="/tmp/fwi_test_ck", netG=netg,
        kl_weight=1e-4 if netg.lower().startswith("vae") else 0.0,
        direct_wave=False, validate_on_twin=False)
    eng = create_engine(cfg, workload=shared_acoustic_workload)
    p0 = [np.asarray(x).copy()
          for x in jax.tree_util.tree_leaves(eng.params)]
    l1 = eng.optimize_parameters(1)["loss_D"]
    l2 = eng.optimize_parameters(2)["loss_D"]
    assert np.isfinite(l1) and np.isfinite(l2), netg
    p1 = [np.asarray(x) for x in jax.tree_util.tree_leaves(eng.params)]
    moved = max(np.abs(a - b).max() for a, b in zip(p1, p0))
    assert moved > 0, netg
    val, img = eng.test()
    assert np.isfinite(val["loss_V_MSE"]) and img.shape == (40, 48)


def test_autonf_logdet_in_loss(shared_acoustic_workload):
    """The AutoNF flow's logdet must enter the loss: changing
    flow_weight changes the total loss (VERDICT r1 missing #9)."""
    base = get_workload("marmousi_acoustic_nf", **SMALL_AC).replace(
        name="t_nf", save_dir="/tmp/fwi_test_ck", direct_wave=False,
        validate_on_twin=False)
    e1 = create_engine(base.replace(flow_weight=0.0),
                       workload=shared_acoustic_workload)
    e2 = create_engine(base.replace(flow_weight=10.0),
                       workload=shared_acoustic_workload)
    l1 = e1.optimize_parameters(1)["loss_D"]
    l2 = e2.optimize_parameters(1)["loss_D"]
    assert np.isfinite(l1) and np.isfinite(l2)
    assert abs(l1 - l2) > 1e-10


def test_fno_supervised_workload():
    cfg = get_workload("fno_baseline").replace(
        name="t_fno", save_dir="/tmp/fwi_test_ck")
    eng = create_engine(cfg, in_shape=(32, 32))
    a = jnp.linspace(0, 1, 32 * 32).reshape(1, 32, 32, 1)
    b = a * 0.5
    losses = [eng.optimize_parameters(a, b)["loss_G"] for _ in range(4)]
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]


def test_impedance_engine_trains():
    """BASELINE config 1: Auto2's impedance-synthetic L1 loss drives
    training (VERDICT r1 missing #3)."""
    cfg = get_workload("marmousi_impedance").replace(
        name="t_imp", save_dir="/tmp/fwi_test_ck", nz=40, nx=48,
        filters=(4, 8, 16), num_receivers=24, chunk=25, pml_width=12)
    eng = create_engine(cfg)
    losses = [eng.optimize_parameters(e)["loss_D_MSE"]
              for e in range(1, 9)]
    assert all(np.isfinite(losses))
    assert min(losses[1:]) < losses[0]
    val, vp = eng.test()
    assert vp.shape == (40, 48) and np.isfinite(val["loss_V_MSE"])


def test_autowav_engine_uses_data_wavelet(tmp_path):
    """AutoWav feeds the per-shot wavelets stored in trainD
    (networks.py:13163-13165) into the propagator (VERDICT r1 #4)."""
    from physicsbasedfwi2_tpu.data import SyntheticAcousticWorkload
    from physicsbasedfwi2_tpu.data.synthetic import write_npy_tree
    wl = SyntheticAcousticWorkload.build(
        nz=40, nx=48, nt=400, dt=0.001, num_shots=4, num_receivers=24,
        water_rows=6, chunk=25, pml_width=12)
    write_npy_tree(str(tmp_path), wl, write_wavelets=True)
    assert os.path.exists(os.path.join(str(tmp_path), "trainD", "0.npy"))
    cfg = get_workload("marmousi_acoustic_wav", **SMALL_AC).replace(
        name="t_wav", save_dir="/tmp/fwi_test_ck",
        dataroot=str(tmp_path), validate_on_twin=False)
    eng = create_engine(cfg)
    # wavelet is the per-shot [ns, nt] array from trainD
    assert eng.wl.wavelet.shape == (4, 400)
    np.testing.assert_allclose(np.asarray(eng.wl.wavelet[0]),
                               np.asarray(wl.wavelet), rtol=1e-6)
    r = eng.optimize_parameters(1)
    assert np.isfinite(r["loss_D"])
    # synthetic path: the engine materializes per-shot wavelets too
    cfg2 = get_workload("marmousi_acoustic_wav", **SMALL_AC).replace(
        name="t_wav2", save_dir="/tmp/fwi_test_ck",
        validate_on_twin=False)
    eng2 = create_engine(cfg2)
    assert eng2.wl.wavelet.ndim == 2


def test_train_driver_and_plateau():
    pd = PlateauDetector(history=3, eps=1e-3)
    assert not pd.update(1.0)
    assert not pd.update(1.0)
    assert pd.update(1.0)  # constant -> plateau

    cfg = get_workload("marmousi_acoustic", **SMALL_AC).replace(
        name="t_drv", save_dir="/tmp/fwi_test_ck", save_epoch_freq=2)
    eng, hist = train(cfg, epochs=2, quiet=True)
    assert len(hist) == 2
    assert os.path.exists("/tmp/fwi_test_ck/t_drv/loss_log.txt")
    assert os.path.exists("/tmp/fwi_test_ck/t_drv/latest_net_G.npz")


def test_supervised_batch_epoch_loop(tmp_path):
    """fwi-train drives the GAN/supervised baselines over dataset
    batches (the reference's train4d.py loop; VERDICT r1 missing
    #8)."""
    rng = np.random.default_rng(0)
    for phase, n in (("train", 6), ("test", 2)):
        for L in "AB":
            d = tmp_path / (phase + L)
            d.mkdir()
            for i in range(n):
                img = rng.uniform(0.1, 1.0, (32, 32)).astype(np.float32)
                np.save(d / f"{i}.npy", img)
    cfg = get_workload("pix2pix_baseline").replace(
        name="t_sup_loop", save_dir="/tmp/fwi_test_ck",
        dataroot=str(tmp_path), batch_size=3, n_epochs=2)
    eng, hist = train(cfg, epochs=2, quiet=True)
    assert len(hist) == 2
    assert all(np.isfinite(h["loss_G"]) for h in hist)
    assert "loss_V_L1" in hist[-1]  # validated on the test twin
    # the driver CLI path resolves too
    from physicsbasedfwi2_tpu.engine.train import main as train_main
    train_main(["--workload", "pix2pix_baseline",
                "--dataroot", str(tmp_path), "--epochs", "1",
                "--name", "t_sup_cli", "--save-dir", "/tmp/fwi_test_ck"])
    # multi-channel letter combos (unalignedBD2/BDE2) run through the
    # same letter-generic loop
    # (no testD/testE twin on purpose — the loop must then skip
    # validation instead of crashing)
    for phase, n in (("train", 4),):
        for L in "DE":
            d = tmp_path / (phase + L)
            d.mkdir()
            for i in range(n):
                img = rng.uniform(0.1, 1.0, (32, 32)).astype(np.float32)
                np.save(d / f"{i}.npy", img)
    for wl in ("pix2pix_bd", "pix2pix_bde"):
        cfg = get_workload(wl).replace(
            name=f"t_{wl}", save_dir="/tmp/fwi_test_ck",
            dataroot=str(tmp_path), batch_size=2, n_epochs=1)
        eng2, hist = train(cfg, epochs=1, quiet=True)
        assert np.isfinite(hist[-1]["loss_G"]), wl
        # BDE's extra E letter must actually reach the net: some conv
        # consumes 2 input channels (B + E concat)
        n_in = 2 if wl == "pix2pix_bde" else 1
        leaves = jax.tree_util.tree_leaves(eng2.params)
        assert any(getattr(l, "ndim", 0) == 4 and l.shape[2] == n_in
                   for l in leaves), wl


def test_multi_sample_engine_sharded():
    """A 2-sample acoustic DIP workload trains on a {sample, shot}
    mesh, and matches the unsharded vmap path (the reference's Ray
    per-sample fan-out, Auto_model.py:185-199; VERDICT r1 #7)."""
    import jax as _jax
    from physicsbasedfwi2_tpu.parallel import make_mesh2d
    small = dict(SMALL_AC)
    cfg = get_workload("marmousi_acoustic", **small).replace(
        name="t_ms", save_dir="/tmp/fwi_test_ck",
        engine="acoustic_dip_multi")
    if len(_jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    mesh = make_mesh2d(2, 4)
    eng = create_engine(cfg, mesh=mesh, n_samples=2)
    eng_ref = create_engine(cfg, n_samples=2)
    r1 = eng.optimize_parameters(1)
    r2 = eng_ref.optimize_parameters(1)
    assert np.isfinite(r1["loss_D"])
    np.testing.assert_allclose(r1["loss_D"], r2["loss_D"],
                               rtol=1e-4, atol=1e-7)
    val, vps = eng.test()
    assert vps.shape == (2, small["nz"], small["nx"])


def test_eval_driver_with_mc():
    cfg = get_workload("mcdip_uq", **SMALL_EL).replace(
        name="t_ev", save_dir="/tmp/fwi_test_ck")
    res = evaluate(cfg, realizations=3, results_dir="/tmp/fwi_test_res")
    assert res["realizations"] == 3
    assert np.isfinite(res["mc_std_mean"])


def test_orbax_full_state_checkpoint():
    from physicsbasedfwi2_tpu.engine.checkpoint import (
        save_engine, restore_engine)
    cfg = get_workload("marmousi_acoustic", **SMALL_AC).replace(
        name="t_orb", save_dir="/tmp/fwi_test_ck")
    eng = create_engine(cfg)
    eng.optimize_parameters(1)
    save_engine(eng, "/tmp/fwi_test_ck/orbax_state", epoch=1)
    eng2 = create_engine(cfg)
    ep = restore_engine(eng2, "/tmp/fwi_test_ck/orbax_state")
    assert ep == 1
    v1, _ = eng.test()
    v2, _ = eng2.test()
    assert abs(v1["loss_V_MSE"] - v2["loss_V_MSE"]) < 1e-3


def test_cyclegan_engine():
    from physicsbasedfwi2_tpu.engine.cyclegan import CycleGanEngine
    eng = CycleGanEngine(in_shape=(32, 32), base=8, n_blocks=2)
    a = jnp.zeros((1, 32, 32, 1))
    b = jnp.ones((1, 32, 32, 1)) * 0.3
    r = eng.optimize_parameters(a, b)
    assert np.isfinite(r["loss_G"]) and np.isfinite(r["loss_D"])
    assert eng.translate(a).shape == (1, 32, 32, 1)


def test_engine_from_dataroot(tmp_path):
    """An npy tree written in the reference's contract trains the
    engine directly (the 'switch from the reference' path)."""
    from physicsbasedfwi2_tpu.data import SyntheticAcousticWorkload
    from physicsbasedfwi2_tpu.data.synthetic import write_npy_tree
    wl = SyntheticAcousticWorkload.build(
        nz=40, nx=48, nt=400, dt=0.001, num_shots=4, num_receivers=24,
        water_rows=6, chunk=25, pml_width=12)
    write_npy_tree(str(tmp_path), wl)
    cfg = get_workload("marmousi_acoustic", **SMALL_AC).replace(
        name="t_dr", save_dir="/tmp/fwi_test_ck",
        dataroot=str(tmp_path))
    eng = create_engine(cfg)
    np.testing.assert_allclose(np.asarray(eng.wl.obs), np.asarray(wl.obs),
                               rtol=1e-6)
    r = eng.optimize_parameters(1)
    assert np.isfinite(r["loss_D"])


def test_continue_train_and_opt_dump(tmp_path):
    cfg = get_workload("marmousi_acoustic", **SMALL_AC).replace(
        name="t_res", save_dir=str(tmp_path), save_epoch_freq=2)
    eng, h1 = train(cfg, epochs=2, quiet=True)
    v1, _ = eng.test()
    # resume from latest
    eng2, h2 = train(cfg, epochs=3, quiet=True,
                     continue_from="latest", start_epoch=3)
    assert h2[0]["epoch"] == 3
    assert os.path.exists(os.path.join(str(tmp_path), "t_res",
                                       "train_opt.txt"))
    txt = open(os.path.join(str(tmp_path), "t_res",
                            "train_opt.txt")).read()
    assert "netG: Auto22" in txt


def test_diagnostics():
    from physicsbasedfwi2_tpu.utils import diagnose_params, is_legal, grad_norms
    tree = {"a": jnp.ones((3,)), "b": {"c": jnp.zeros((2, 2))}}
    assert is_legal(tree)
    assert not is_legal({"a": jnp.asarray([jnp.nan])})
    s = diagnose_params(tree)
    assert "finite=True" in s
    n = grad_norms(tree)
    assert any("a" in k for k in n)


def test_elastic_engine_from_dataroot(tmp_path):
    from physicsbasedfwi2_tpu.data import SyntheticElasticWorkload
    from physicsbasedfwi2_tpu.data.synthetic import write_elastic_npy_tree
    wl = SyntheticElasticWorkload.build(
        nz=36, nx=48, nt=160, dt=0.0015, num_shots=4, num_receivers=20,
        water_rows=4, chunk=25, pml_width=12)
    write_elastic_npy_tree(str(tmp_path), wl)
    cfg = get_workload("marmousi_elastic", **SMALL_EL).replace(
        name="t_eldr", save_dir="/tmp/fwi_test_ck",
        dataroot=str(tmp_path))
    eng = create_engine(cfg)
    np.testing.assert_allclose(np.asarray(eng.wl.obs_vx),
                               np.asarray(wl.obs_vx), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(eng.wl.true["vp"]),
                               np.asarray(wl.true["vp"]), rtol=1e-4)
    r = eng.optimize_parameters(1, freq=12.0)
    assert np.isfinite(r["loss_D_MSE"])


def test_elastic_dataroot_shot_count_wins(tmp_path, capsys):
    """A dataroot whose gather count differs from cfg.num_shots must
    drive shot sampling from the DATA's count: sampling cfg.num_shots
    would clamp out-of-range gather indices silently under jit
    (double-weighting the last shot) or never touch the extras."""
    from physicsbasedfwi2_tpu.data import SyntheticElasticWorkload
    from physicsbasedfwi2_tpu.data.synthetic import write_elastic_npy_tree
    wl = SyntheticElasticWorkload.build(
        nz=36, nx=48, nt=160, dt=0.0015, num_shots=3, num_receivers=20,
        water_rows=4, chunk=25, pml_width=12)
    write_elastic_npy_tree(str(tmp_path), wl)
    # config says 4 shots; the tree carries 3
    cfg = get_workload("marmousi_elastic", **SMALL_EL).replace(
        name="t_elshots", save_dir="/tmp/fwi_test_ck",
        dataroot=str(tmp_path), shots_per_iter=None)
    eng = create_engine(cfg)
    assert eng.n_shots == 3
    assert "using the workload's count" in capsys.readouterr().out
    seen = []

    def fake_step(params, opt_state, idx, rng, use_physics, pack):
        seen.append(np.asarray(idx))
        return params, opt_state, 0.0, 0.0, 0.0

    eng._step_cache["step"] = fake_step
    eng.optimize_parameters(5, freq=12.0)
    assert seen[0].shape == (3,)
    assert set(seen[0].tolist()) == {0, 1, 2}


def test_elastic_trailing_tether_refreshes():
    """tether_mode="stage": the tether reference is the model snapshot
    at the current segment's start — refreshed on stage advance and
    every tether_refresh_epochs inside a stage — instead of the fixed
    low-frequency model (whose equilibrium caps total progress,
    docs/RESULTS.md)."""
    cfg = get_workload("marmousi_elastic", **SMALL_EL).replace(
        name="t_trail", save_dir="/tmp/fwi_test_ck",
        tether_weight=0.3, tether_mode="stage",
        tether_refresh_epochs=3, freq_stages=(6.0, 12.0))
    eng = create_engine(cfg)
    assert eng._tether_ref is None
    eng.optimize_parameters(1, freq=6.0)
    ref1 = eng._tether_ref
    assert ref1 is not None and ref1.shape == eng.lowf[0].shape
    # same stage, within the refresh window: reference held
    eng.optimize_parameters(2, freq=6.0)
    assert eng._tether_ref is ref1
    # stage advance refreshes
    eng.optimize_parameters(3, freq=12.0)
    ref2 = eng._tether_ref
    assert ref2 is not ref1
    # interval refresh inside the final stage (3 epochs later)
    eng.optimize_parameters(4, freq=12.0)
    eng.optimize_parameters(5, freq=12.0)
    assert eng._tether_ref is ref2
    eng.optimize_parameters(6, freq=12.0)
    assert eng._tether_ref is not ref2
    # fixed-lowf mode never touches the trailing state
    eng2 = create_engine(cfg.replace(tether_mode="lowf",
                                     name="t_trail2"))
    eng2.optimize_parameters(1, freq=6.0)
    assert eng2._tether_ref is None


def test_elastic_illumination_preconditioning():
    """grad_illum_eps > 0 divides the processed gradient by the
    starting model's source-illumination map (DENISE EPRECOND): deep
    poorly-lit cells get boosted relative to the shallow src/rcv
    band, and the injected VJP reflects it."""
    base = get_workload("marmousi_elastic", **SMALL_EL).replace(
        name="t_illum", save_dir="/tmp/fwi_test_ck", tether_weight=0.0,
        grad_depth_power=0.0, grad_rescale="none", grad_scale=1.0)
    eng0 = create_engine(base)
    eng1 = create_engine(base.replace(grad_illum_eps=0.05))
    # the map is lazy: engine construction (e.g. fwi-test) never pays
    # the all-shot forward sweep
    assert eng0._ilw is None and eng1._ilw is None
    ilw_dev = eng1._illum_weight()
    assert eng1._ilw is not None
    m = jnp.stack([eng1.wl.start["vp"], eng1.wl.start["vs"]], -1)
    idx = jnp.arange(2)
    pd = dict(eng1._stage_pack(0.0), fw=jnp.asarray([1.0, 1.0]),
              tw=jnp.float32(0.0), lowf_m=eng1.lowf[0])
    g0 = jax.grad(lambda mm: eng0._make_physics_loss()(mm, idx, pd))(m)
    g1 = jax.grad(lambda mm: eng1._make_physics_loss()(
        mm, idx, dict(pd, ilw=ilw_dev)))(m)
    ratio = np.asarray(jnp.abs(g1[..., 0]) / (jnp.abs(g0[..., 0]) + 1e-30))
    ilw = np.asarray(ilw_dev)
    # the applied weight IS the illumination reciprocal, cell for cell
    mask = np.abs(np.asarray(g0[..., 0])) > 1e-12
    np.testing.assert_allclose(ratio[mask], ilw[mask], rtol=1e-3)
    # deep rows (dim illumination) are boosted vs the source row
    assert ilw[-1].mean() > 2.0 * ilw[SMALL_EL["water_rows"] + 1].mean()
    # EPRECOND REPLACES the z^p ramp: enabling both must match the
    # illum-only gradient (no compounded ~z^p/eps deep boost)
    eng2 = create_engine(base.replace(grad_illum_eps=0.05,
                                      grad_depth_power=2.0))
    g2 = jax.grad(lambda mm: eng2._make_physics_loss()(
        mm, idx, dict(pd, ilw=ilw_dev)))(m)
    np.testing.assert_allclose(np.asarray(g2), np.asarray(g1), rtol=1e-6)
    # and a real training epoch still runs finite
    r = eng1.optimize_parameters(1, freq=12.0)
    assert np.isfinite(r["loss_D_MSE"])


def test_elastic_lstart_warmup_then_physics():
    """epoch <= lstart trains the pure low-frequency anchor (the
    reference's loss_G = loss_L_MSE phase); physics starts after
    (AutoElMar22_model.py:374 vs 398-420)."""
    cfg = get_workload("marmousi_elastic", **SMALL_EL).replace(
        name="t_lstart", save_dir="/tmp/fwi_test_ck", lstart=2)
    eng = create_engine(cfg)
    anchor0 = float(jnp.mean(
        (eng._sample_model(eng.params) - eng.lowf) ** 2))
    r1 = eng.optimize_parameters(epoch=1, freq=12.0)
    r2 = eng.optimize_parameters(epoch=2, freq=12.0)
    assert r1["loss_D_MSE"] == 0.0 and r2["loss_D_MSE"] == 0.0
    anchor2 = float(jnp.mean(
        (eng._sample_model(eng.params) - eng.lowf) ** 2))
    assert anchor2 < anchor0  # warmup pulls the output toward lowf
    r3 = eng.optimize_parameters(epoch=3, freq=12.0)
    assert r3["loss_D_MSE"] > 0.0  # physics phase engaged


def test_elastic_field_gating():
    """Per-field staging: grad_field_weights zeroes a field's
    processed gradient; field_start_epochs gates it by epoch (the
    reference's currenterror-gated rho backward,
    AutoElMar22_model.py:446-451, generalized to vs)."""
    cfg = get_workload("marmousi_elastic", **SMALL_EL).replace(
        name="t_gate", save_dir="/tmp/fwi_test_ck",
        grad_field_weights=(1.0, 0.0), tether_weight=0.0)
    eng = create_engine(cfg)
    physics_loss = eng._make_physics_loss()
    m = jnp.stack([eng.wl.start["vp"], eng.wl.start["vs"]], -1)
    idx = jnp.arange(2)
    pd = dict(eng._stage_pack(0.0), fw=jnp.asarray([1.0, 0.0]))
    g = jax.grad(lambda mm: physics_loss(mm, idx, pd))(m)
    assert float(jnp.abs(g[..., 0]).max()) > 0.0   # vp flows
    assert float(jnp.abs(g[..., 1]).max()) == 0.0  # vs gated off
    # epoch gate: fw becomes 0 before lstart + start_epoch
    cfg2 = cfg.replace(grad_field_weights=None,
                       field_start_epochs=(0, 3), lstart=0)
    eng2 = create_engine(cfg2)
    fw_early = eng2._field_weights(1)   # epoch 1 < lstart+3 -> vs off
    fw_late = eng2._field_weights(5)    # epoch 5 >= lstart+3 -> vs on
    assert fw_early[1] == 0.0 and fw_late[1] == 1.0
    assert fw_early[0] == 1.0


def test_elastic_gradient_tether():
    """tether_weight adds a pull toward the low-frequency model inside
    the injected VJP, scaled to the physics gradient's RMS (null-space
    drift suppression; see engines.py _make_physics_loss)."""
    cfg = get_workload("marmousi_elastic", **SMALL_EL).replace(
        name="t_teth", save_dir="/tmp/fwi_test_ck", tether_weight=1.0)
    eng = create_engine(cfg)
    physics_loss = eng._make_physics_loss()
    m = jnp.stack([eng.wl.start["vp"], eng.wl.start["vs"]], -1)
    # displace the model from lowf so the tether has a direction
    m = m + 40.0
    lowf = eng.lowf[0]
    idx = jnp.arange(2)
    base_pd = dict(eng._stage_pack(0.0), fw=jnp.asarray([1.0, 1.0]),
                   tw=jnp.float32(cfg.tether_weight), lowf_m=lowf)
    g1 = jax.grad(lambda mm: physics_loss(mm, idx, base_pd))(m)
    eng0 = create_engine(cfg.replace(tether_weight=0.0))
    pl0 = eng0._make_physics_loss()
    g0 = jax.grad(lambda mm: pl0(mm, idx, base_pd))(m)
    d = g1 - g0
    dm = m - lowf
    # the added term is parallel to (m - lowf) PER FIELD (each field
    # is scaled by its own g_rms/d_rms, so the stacked vectors are
    # only field-wise parallel), with per-field RMS equal to the
    # physics gradient's RMS (w=1)
    for k in range(2):
        corr = jnp.sum(d[..., k] * dm[..., k]) / (
            jnp.linalg.norm(d[..., k]) * jnp.linalg.norm(dm[..., k])
            + 1e-20)
        assert float(corr) > 0.99, (k, float(corr))
        r_d = float(jnp.sqrt(jnp.mean(d[..., k] ** 2)))
        r_g = float(jnp.sqrt(jnp.mean(g0[..., k] ** 2)))
        assert abs(r_d - r_g) / (r_g + 1e-20) < 0.05, (r_d, r_g)


def test_elastic_tether_decays_per_stage():
    """tether_decay relaxes the tether as continuation advances:
    the step pack's tw carries tether_weight * decay**stage_i (the
    stage is threaded as data, never a recompile)."""
    cfg = get_workload("marmousi_elastic", **SMALL_EL).replace(
        name="t_tethdec", save_dir="/tmp/fwi_test_ck",
        tether_weight=0.4, tether_decay=0.5,
        freq_stages=(6.0, 10.0, 15.0))
    eng = create_engine(cfg)
    seen = []

    def fake_step(params, opt_state, idx, rng, use_physics, pack):
        seen.append(float(pack["phys"]["tw"]))
        return params, opt_state, 0.0, 0.0, 0.0

    eng._step_cache["step"] = fake_step
    for freq in (6.0, 10.0, 15.0):
        eng.optimize_parameters(1, freq=freq)
    assert seen == [pytest.approx(0.4), pytest.approx(0.2),
                    pytest.approx(0.1)], seen


def test_tether_anneals_past_final_stage():
    """tether_anneal_plateaus: once the LAST frequency stage is
    reached, each further plateau-detector fire relaxes the tether one
    more tether_decay notch (train.py passes tether_stage =
    stage_i + anneal_i), capped at the configured count.  Lets long
    runs escape the tether equilibrium after continuation ends."""
    cfg = get_workload("marmousi_elastic", **SMALL_EL).replace(
        name="t_tethann", save_dir="/tmp/fwi_test_ck",
        tether_weight=0.4, tether_decay=0.5, lstart=1,
        freq_stages=(6.0, 10.0), plateau_history=2, plateau_eps=0.5,
        tether_anneal_plateaus=2, save_epoch_freq=10 ** 9,
        stage_max_epochs=0)
    eng = create_engine(cfg)
    seen = []

    def fake_step(params, opt_state, idx, rng, use_physics, pack):
        seen.append(float(pack["phys"]["tw"]))
        # constant loss -> every full window is a plateau
        return params, opt_state, 1.0, 1.0, 0.0

    eng._step_cache["step"] = fake_step
    train(cfg, epochs=20, quiet=True, engine=eng)
    # stage 0 (tw .4) -> stage 1 (.2) -> anneal 1 (.1) -> anneal 2
    # (.05), then held: no further decay past the cap
    assert seen[0] == pytest.approx(0.4)
    assert set(round(t, 3) for t in seen) == {0.4, 0.2, 0.1, 0.05}, seen
    assert seen[-1] == pytest.approx(0.05), seen[-1]
    # order is monotone non-increasing
    assert all(a >= b - 1e-9 for a, b in zip(seen, seen[1:])), seen


def test_lbfgs_elastic_workload_descends():
    """The registered L-BFGS elastic workload must make real progress:
    its (value, grad) pair is consistent (no Adam-era gradient
    conditioning), so the zoom linesearch takes non-trivial steps and
    the full-batch data misfit falls.  Regression for the stale
    round-2 config, whose conditioned gradient mis-estimated the
    directional derivative by ~1e6 and froze the step at ~1e-8."""
    cfg = get_workload("marmousi_elastic_lbfgs", **SMALL_EL).replace(
        name="t_lbfgs_desc", save_dir="/tmp/fwi_test_ck", lstart=3,
        shots_per_iter=None, freq_stages=(6.0,),
        save_epoch_freq=10 ** 9)
    assert cfg.optimizer == "lbfgs" and cfg.grad_scale == 1.0
    eng, hist = train(cfg, epochs=12, quiet=True)
    d_first = hist[cfg.lstart]["loss_D_MSE"]   # first physics epoch
    d_last = hist[-1]["loss_D_MSE"]
    assert np.isfinite(d_last) and d_last < 0.9 * d_first, (
        d_first, d_last)


def test_encoded_acoustic_engine_trains():
    """Simultaneous-source mode: the engine inverts on random-polarity
    super-shots with a fresh encoding each iteration (ops/encoding.py;
    capability beyond the reference)."""
    cfg = get_workload("marmousi_acoustic_encoded", **SMALL_AC).replace(
        name="t_enc", save_dir="/tmp/fwi_test_ck",
        validate_on_twin=False, encoded_shots=2)
    eng = create_engine(cfg)
    assert eng.physics_path == "encoded"
    losses = [eng.optimize_parameters(epoch=e)["loss_D"]
              for e in range(1, 7)]
    assert all(np.isfinite(losses))
    # stochastic re-encoding makes per-iteration loss noisy; the
    # trend over a few steps must still be downward
    assert min(losses[1:]) < losses[0]


def test_latent_inversion_from_dataroot(tmp_path):
    """Latent2-from-disk (VERDICT r2 missing #2): the engine consumes
    the unalignedVelLatent2 npy contract (trainA = gathers, trainB =
    velocity; unalignedVelLatent2_dataset.py:29-67) instead of always
    building a synthetic workload."""
    from physicsbasedfwi2_tpu.data.synthetic import (
        SyntheticAcousticWorkload)
    # author a tiny Latent2 tree from a synthetic workload
    wl = SyntheticAcousticWorkload.build(
        nz=40, nx=48, nt=300, dt=0.001, num_shots=4, num_receivers=24,
        pml_width=12, freq=10.0, seed=5, chunk=25)
    for letter, arr in (("A", np.asarray(wl.obs) / 10.0),  # stored /10
                        ("B", np.asarray(wl.vp_true))):
        d = tmp_path / f"train{letter}"
        d.mkdir()
        np.save(d / "0.npy", arr.astype(np.float32))
    cfg = get_workload(
        "latent_inversion", nz=40, nx=48, nt=300, dt=0.001,
        num_shots=4, num_receivers=24, filters=(4, 8, 16), chunk=25,
        pml_width=12, freq=10.0).replace(
            name="t_lat_disk", save_dir="/tmp/fwi_test_ck",
            dataroot=str(tmp_path))
    eng = create_engine(cfg)
    assert getattr(eng.wl, "from_disk", False)
    # the x10 runtime conditioning must be applied by the loader
    np.testing.assert_allclose(np.asarray(eng.wl.obs),
                               np.asarray(wl.obs), rtol=1e-6)
    losses = [eng.optimize_parameters(e)["loss_D_MSE"]
              for e in range(1, 9)]
    assert all(np.isfinite(losses))
    assert min(losses[1:]) < losses[0]


def test_multi_sample_engine_direct_wave_and_warmup():
    """The batch engine shares the single-sample misfit pipeline
    (VERDICT r2 weak #4): direct-wave subtraction changes the loss
    (networks.py:5396-5411 applied per sample) and lstart gates a
    model-MSE warmup phase."""
    small = dict(SMALL_AC)
    base = get_workload("marmousi_acoustic", **small).replace(
        name="t_msdw", save_dir="/tmp/fwi_test_ck",
        engine="acoustic_dip_multi")
    e_on = create_engine(base.replace(direct_wave=True), n_samples=2)
    e_off = create_engine(base.replace(direct_wave=False), n_samples=2)
    assert e_on._direct is not None and e_off._direct is None
    l_on = e_on.optimize_parameters(1)["loss_D"]
    l_off = e_off.optimize_parameters(1)["loss_D"]
    assert np.isfinite(l_on) and np.isfinite(l_off)
    assert abs(l_on - l_off) > 1e-9
    # warmup phase: epoch <= lstart reports loss_M (oracle), after
    # reports loss_D
    e_w = create_engine(base.replace(lstart=2), n_samples=2)
    r1 = e_w.optimize_parameters(1)
    assert "loss_M" in r1 and "loss_D" not in r1
    r3 = e_w.optimize_parameters(3)
    assert "loss_D" in r3


def test_real_data_su_to_train_end_to_end(tmp_path):
    """Field-data pipeline (VERDICT r2 missing #3): DENISE .su shots
    -> `fwi-prep --su-obs` ingestion -> real_data workload training,
    with no trainB (field data has no ground truth; trainC doubles as
    the metric reference)."""
    from physicsbasedfwi2_tpu.data.prep import prepare_su_observed
    from physicsbasedfwi2_tpu.data.synthetic import (
        SyntheticElasticWorkload)
    nz, nx, nt, ns, nr = 24, 32, 96, 2, 10
    dt = 0.002
    wl = SyntheticElasticWorkload.build(
        nz=nz, nx=nx, dx=30.0, nt=nt, dt=dt, num_shots=ns,
        num_receivers=nr, water_rows=4, chunk=16, pml_width=8,
        freq=10.0, free_surface=False, src_depth_row=2,
        rcv_depth_row=6)
    su = tmp_path / "su"
    su.mkdir()
    dt_us = int(dt * 1e6)

    def write_su(path, data_tr_ns):
        with open(path, "wb") as f:
            for tr in data_tr_ns:  # [ntr, nsamples]
                hdr = np.zeros(240, np.uint8)
                hdr[114:116] = np.frombuffer(
                    np.array([nt], "<u2").tobytes(), np.uint8)
                hdr[116:118] = np.frombuffer(
                    np.array([dt_us], "<u2").tobytes(), np.uint8)
                f.write(hdr.tobytes())
                f.write(tr.astype("<f4").tobytes())

    for k in range(ns):
        write_su(su / f"seis_x.su.shot{k+1}", np.asarray(wl.obs_vx[k]).T)
        write_su(su / f"seis_y.su.shot{k+1}", np.asarray(wl.obs_vz[k]).T)
    root = tmp_path / "root"
    shape, dt_read = prepare_su_observed(str(su), str(root))
    assert shape == (ns, nt, nr) and abs(dt_read - dt) < 1e-9
    # trainC only (no trainB): the start triple, stored /100
    c = np.stack([np.asarray(wl.start["vp"]), np.asarray(wl.start["vs"]),
                  np.asarray(wl.start["rho"])]) / 100.0
    d = root / "trainC"
    d.mkdir()
    np.save(d / "0.npy", c.astype(np.float32))
    cfg = get_workload(
        "real_data", nz=nz, nx=nx, nt=nt, dt=dt, num_shots=ns,
        shots_per_iter=ns, num_receivers=nr, filters=(4, 8), chunk=16,
        pml_width=8, water_rows=4, lstart=0, freq_stages=(),
        clip_min=None, clip_max=None,
    ).replace(name="t_realdata", save_dir="/tmp/fwi_test_ck",
              dataroot=str(tmp_path / "root"),
              extras={"src_depth_row": 2, "rcv_depth_row": 6})
    eng = create_engine(cfg)
    assert eng.wl.from_disk
    # B fell back to C
    np.testing.assert_allclose(np.asarray(eng.wl.true["vp"]),
                               np.asarray(eng.wl.start["vp"]))
    out = [eng.optimize_parameters(e) for e in (1, 2)]
    assert all(np.isfinite(o["loss_D_MSE"]) for o in out)


def test_seabed_nnz_geometry():
    """seabed_rows == the reference's per-column nnz water-bottom
    index (networks.py:4898-4905), and the seam seabed workload hangs
    receivers on it (networks.py:9696 depth_rec role)."""
    from physicsbasedfwi2_tpu.geo.acquisition import seabed_rows
    from physicsbasedfwi2_tpu.data.synthetic import (
        SyntheticElasticWorkload)
    m = np.full((10, 6), 2000.0, np.float32)
    m[:3, :2] = 1500.0   # 3 water rows in cols 0-1
    m[:5, 2:4] = 1500.0  # 5 water rows in cols 2-3
    rows = seabed_rows(m)
    np.testing.assert_array_equal(rows, [3, 3, 5, 5, 0, 0])
    wl = SyntheticElasticWorkload.build(
        nz=24, nx=32, dx=20.0, nt=64, dt=0.0015, num_shots=2,
        num_receivers=8, water_rows=5, chunk=16, pml_width=8,
        rcv_follow_seabed=True)
    # every receiver sits on the water bottom of ITS column
    want = seabed_rows(np.asarray(wl.true["vp"]))
    rz = np.asarray(wl.acq.rcv_z)
    rx = np.asarray(wl.acq.rcv_x)
    np.testing.assert_array_equal(rz[0], want[rx[0]])


def test_elastic_parity_workload_runs():
    """The strict-parity workload (reference literal recipe: raw L2,
    per-iteration max rescale, water-rows taper, range detector at
    eps=5e-10, no tether) trains through the full driver — verifying
    the MIGRATION.md claim that reference hyperparameters transfer.
    Quality is documented as worse than the defaults; this asserts
    the wiring, not inversion quality."""
    from physicsbasedfwi2_tpu.engine.train import train

    cfg = get_workload("marmousi_elastic_parity", **SMALL_EL).replace(
        name="t_parity", save_dir="/tmp/fwi_test_ck",
        n_epochs=4, n_epochs_decay=2)
    assert cfg.misfit == "l2" and cfg.grad_rescale == "max"
    assert cfg.tether_weight == 0.0 and cfg.plateau_eps == 5e-10
    eng, hist = train(cfg, epochs=3, quiet=True)
    assert all(np.isfinite(r["loss_D_MSE"]) for r in hist)
    assert hist[-1]["freq_stage"] == 10.0  # literal detector: no
    # plateau fires at SGD loss scales (the vestigial-freqL behavior)

def test_elastic_snl2_misfit_shot_normalized():
    """snl2: per-shot RMS scaling folded into wavelet+obs by linearity
    (engines.py _stage_data).  The scaled obs have unit combined RMS
    per shot, the loss is finite under training, and the misfit at the
    true vp/vs (same rho path the engine simulates with) is far below
    the misfit at the start — the amplitude information trace-max
    normalization destroys is retained (docs/RESULTS.md line-scan)."""
    cfg = get_workload("marmousi_elastic", **SMALL_EL).replace(
        name="t_snl2", save_dir="/tmp/fwi_test_ck", misfit="snl2")
    eng = create_engine(cfg)
    wav, ovx, ovz = eng._stage_data(12.0)
    rms = np.sqrt(np.mean(np.asarray(ovx) ** 2 + np.asarray(ovz) ** 2,
                          axis=(1, 2)))
    np.testing.assert_allclose(rms, 1.0, rtol=1e-4)
    assert wav.ndim == 2 and wav.shape[0] == ovx.shape[0]
    r = eng.optimize_parameters(epoch=1, freq=12.0)
    assert np.isfinite(r["loss_D_MSE"])
    # misfit ranks truth far below start (snl2 keeps amplitudes; the
    # synthetic workload regenerates obs with the same operator but
    # TRUE rho, while the engine simulates with start rho, so truth
    # is near-but-not-exactly zero — assert a 5x separation)
    wl = eng.wl
    pd = eng._stage_pack(12.0)
    import jax.numpy as jnp
    idx = jnp.arange(wl.geom[0].shape[0])
    m_start = jnp.stack([wl.start["vp"], wl.start["vs"]], -1)
    m_true = jnp.stack([wl.true["vp"], wl.true["vs"]], -1)
    j_start = float(eng._physics_loss_raw(m_start, idx, pd))
    j_true = float(eng._physics_loss_raw(m_true, idx, pd))
    assert j_true < 0.2 * j_start, (j_true, j_start)


def test_elastic_holdout_early_stopping(tmp_path):
    """cfg.holdout_shots: k evenly spaced shots never enter the
    training pool, their misfit is logged as loss_H every
    holdout_every epochs, and the train loop saves the best
    final-stage loss_H checkpoint as 'selected' (the unsupervised
    replacement for the reference's manual --epoch N resume practice,
    trainVelAutoElMar22ModelPhy.sh)."""
    cfg = get_workload("marmousi_elastic", **SMALL_EL).replace(
        name="t_holdout", save_dir=str(tmp_path),
        lstart=1, freq_stages=(4.0, 8.0), stage_max_epochs=3,
        plateau_history=2, holdout_shots=2, holdout_every=2)
    eng, hist = train(cfg, epochs=10, quiet=True)
    hold = np.asarray(eng._holdout_idx)
    pool = np.asarray(eng._train_pool)
    assert len(hold) == 2 and len(pool) == cfg.num_shots - 2
    assert not set(hold.tolist()) & set(pool.tolist())
    hs = [r["loss_H"] for r in hist if "loss_H" in r]
    assert len(hs) >= 2 and all(np.isfinite(hs))
    sel = [r["selected_epoch"] for r in hist if "selected_epoch" in r]
    assert sel, "no selected checkpoint recorded"
    assert os.path.exists(os.path.join(
        str(tmp_path), "t_holdout", "selected_net_G.npz"))
    # the selected tag loads back
    eng.load_networks("selected")


def test_elastic_drift_guard_reverts(tmp_path):
    """cfg.guard_patience: the unsupervised loss_H trust region
    (train.py drift guard).  Script the held-out misfit so the guard
    logic is tested deterministically: one improvement, then two evals
    above guard_tol x the stage best -> exactly one revert at
    patience 2, recorded in history, with the engine's post-revert lr
    ramp armed (engine.guard_revert) and training continuing finite."""
    from physicsbasedfwi2_tpu.engine import create_engine
    cfg = get_workload("marmousi_elastic", **SMALL_EL).replace(
        name="t_guard", save_dir=str(tmp_path),
        lstart=1, freq_stages=(4.0,), stage_max_epochs=100,
        tether_weight=0.0, holdout_shots=2, holdout_every=1,
        guard_patience=2, guard_tol=1.05, guard_lr_ramp=3)
    eng = create_engine(cfg)
    # warmup snapshot 1.0; evals ep2..ep7: improve, worse, worse ->
    # revert at ep4, then recover
    seq = iter([1.0, 0.9, 1.2, 1.2, 0.85, 0.8, 0.79])
    eng.holdout_misfit = lambda fc=None: next(seq)
    eng2, hist = train(cfg, epochs=7, quiet=True, engine=eng)
    reverts = [r["guard_revert"] for r in hist if "guard_revert" in r]
    assert reverts == [4], reverts
    assert eng._guard_ramp_from == 4
    assert all(np.isfinite(r["loss_D_MSE"]) for r in hist[1:])
    # the post-revert evals resumed tracking (0.85 < 0.9 stage best
    # -> no further revert) and 'selected' still points at the best
    sel = [r["selected_epoch"] for r in hist if "selected_epoch" in r]
    assert sel and sel[-1] == 7, sel


def test_seed_race_selects_and_continues(tmp_path):
    """engine.race: K seeds probe, the best FINAL-STAGE held-out
    misfit wins, and the winner continues from its 'selected'
    checkpoint to the full budget (the unsupervised version of the
    reference's manual --continue_train --epoch N practice)."""
    from physicsbasedfwi2_tpu.engine.race import race
    cfg = get_workload("marmousi_elastic", **SMALL_EL).replace(
        name="t_race", save_dir=str(tmp_path),
        lstart=1, freq_stages=(4.0, 8.0), stage_max_epochs=3,
        plateau_history=2, holdout_shots=2, holdout_every=2)
    wseed, summaries, eng, hist = race(
        cfg, seeds=(0, 1), probe_epochs=8, epochs=12, quiet=True)
    assert wseed in (0, 1)
    assert len(summaries) == 2
    assert summaries[0]["best_loss_H"] > 0
    # winner's combined history covers probe + continuation
    assert hist[-1]["epoch"] == 12
    assert os.path.exists(os.path.join(
        str(tmp_path), f"t_race_s{wseed}", "selected_net_G.npz"))
