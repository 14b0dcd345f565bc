"""Inversion engines — the reference's BaseModel layer.

Each engine owns: a generator (models.nn modules), an optax optimizer,
the physics configuration, and jitted train/eval steps.  The public API mirrors
the reference's BaseModel contract (models/base_model.py:8-244):
``setup``, ``optimize_parameters``, ``test``/``compute_losses``,
``save_networks``/``load_networks`` — but the compute path is one
autodiff graph under jit instead of the reference's detach +
``fake_B.backward(grad)`` VJP injection (Auto22_model.py:284-330).
The reference's gradient post-processing (scale x1e5, depth^2
weighting, water mask) is preserved exactly via a `jax.custom_vjp`
wrapper around the physics loss, so its hyperparameters transfer.
"""

from __future__ import annotations

import functools
import os
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import optax

from physicsbasedfwi2_tpu.engine.checkpoint import restore_tree, save_tree
from physicsbasedfwi2_tpu.engine.config import ExperimentConfig
from physicsbasedfwi2_tpu.data.synthetic import (
    SyntheticAcousticWorkload, SyntheticElasticWorkload,
)
from physicsbasedfwi2_tpu.geo.filters import lowpass_filter_time
from physicsbasedfwi2_tpu.models import (
    define_generator, apply_velocity_output, apply_elastic_output,
    kl_divergence,
)
from physicsbasedfwi2_tpu.ops import (
    select_operator, trace_normalize,
)
from physicsbasedfwi2_tpu.ops.misfit import l1_misfit, l2_misfit
from physicsbasedfwi2_tpu.ops.gradproc import (
    depth_weighting, water_mask, taper_top, rescale_to_model,
)
from physicsbasedfwi2_tpu.optim.lbfgs import lbfgs_wolfe
from physicsbasedfwi2_tpu.optim.sgmcmc import sgld, sghmc
from physicsbasedfwi2_tpu.optim.schedules import (
    make_scheduler, PlateauController,
)


def _evict_stale_stages(cache: dict, fc: float) -> None:
    """Drop cached stage data for every stage but ``fc``.

    Each stage entry holds a full low-passed copy of the observed
    gathers (plus wavelet/direct/scattered rows) on device; stages
    advance monotonically and are never revisited, so keeping old
    entries pins ~n_stages x the dataset in HBM for the rest of the
    run.  Keys are either the stage float or ("pack", float)."""
    for k in [k for k in cache
              if (k[1] if isinstance(k, tuple) else k) != fc]:
        del cache[k]


def _make_optimizer(cfg: ExperimentConfig):
    if cfg.optimizer == "adam":
        # inject_hyperparams so LrPolicy can steer the lr per epoch
        # (the reference steps a torch scheduler every epoch,
        # networks.py:79-106 + base_model.py:126-136)
        return optax.inject_hyperparams(optax.adam)(
            learning_rate=cfg.lr, b1=cfg.beta1, eps=cfg.adam_eps)
    if cfg.optimizer == "lbfgs":
        # memory 10 = the reference config (AutoElMar22LBFGS_model.py:
        # 135-137); both knobs overridable for tuning studies
        # (benchmarks/adam_vs_lbfgs.py)
        return lbfgs_wolfe(
            memory_size=int(cfg.extras.get("lbfgs_memory", 10)),
            max_linesearch_steps=int(
                cfg.extras.get("lbfgs_linesearch", 20)))
    if cfg.optimizer == "sgld":
        return sgld(cfg.lr, seed=cfg.seed)
    if cfg.optimizer == "sghmc":
        return sghmc(cfg.lr, seed=cfg.seed)
    raise ValueError(f"unknown optimizer {cfg.optimizer!r}")


class LrPolicy:
    """Host-side lr controller driving the injected Adam lr: wraps the
    reference's get_scheduler policies (linear/step/cosine as
    epoch-indexed schedules; plateau as the stateful
    ReduceLROnPlateau)."""

    def __init__(self, cfg: ExperimentConfig):
        self.lr = cfg.lr
        self.sched = None
        self.plateau = None
        pol = (cfg.lr_policy or "constant").lower()
        if pol not in ("constant", "none", ""):
            s = make_scheduler(pol, lr=cfg.lr, n_epochs=cfg.n_epochs,
                               n_epochs_decay=cfg.n_epochs_decay)
            if isinstance(s, PlateauController):
                self.plateau = s
            else:
                self.sched = s

    def lr_for_epoch(self, epoch: int) -> float:
        if self.sched is not None:
            self.lr = float(self.sched(epoch))
        return self.lr

    def after_epoch(self, metric: float) -> float:
        if self.plateau is not None:
            self.lr = float(self.plateau.step(metric))
        return self.lr


def _set_lr(opt_state, lr: float):
    """Update the injected learning_rate on an
    optax.inject_hyperparams state (no-op for other optimizers)."""
    hp = getattr(opt_state, "hyperparams", None)
    if hp is not None and "learning_rate" in hp:
        hp["learning_rate"] = jnp.asarray(lr, jnp.float32)
    return opt_state


def _log_path(name: str, physics: str, path: str):
    """One line per engine build naming the selected physics path
    (the bench JSON carries the same string)."""
    print(f"[{name}] {physics} physics path: {path}")


class EngineBase:
    """Shared checkpoint/bookkeeping plumbing."""

    cfg: ExperimentConfig
    params: Any
    opt_state: Any

    def save_networks(self, tag: str | int):
        """Portable weight save: np .npz of path-keyed flattened
        params — the <epoch>_net_G.pth role (base_model.py:154-170)
        with NO pickle anywhere in the default path (pickle.load
        executes arbitrary code from the file).  Full train-state
        checkpointing (optimizer state included — which the
        reference drops) lives in engine/checkpoint.py."""
        return save_tree(os.path.join(self._dir(), f"{tag}_net_G.npz"),
                         self.params)

    def load_networks(self, tag: str | int):
        """Restore weights saved by :meth:`save_networks` into the
        engine's (already-initialized) params template.  Falls back
        to a ONE-WAY import of a legacy round-2 ``.pkl`` checkpoint
        when no ``.npz`` exists."""
        path = os.path.join(self._dir(), f"{tag}_net_G.npz")
        if os.path.exists(path):
            self.params = restore_tree(path, self.params)
            return path
        legacy = os.path.join(self._dir(), f"{tag}_net_G.pkl")
        if os.path.exists(legacy):
            import pickle  # legacy import only; new saves are .npz
            with open(legacy, "rb") as f:
                loaded = pickle.load(f)
            self.params = jax.tree_util.tree_map(jnp.asarray, loaded)
            return legacy
        raise FileNotFoundError(path)

    def _dir(self):
        return os.path.join(self.cfg.save_dir, self.cfg.name)


# ---------------------------------------------------------------------------
# acoustic deep-image-prior engine (Auto22/Unet22/Vae2/... workloads)
# ---------------------------------------------------------------------------

class AcousticDIPEngine(EngineBase):
    """Generator-reparameterized acoustic FWI (reference call stack
    SURVEY.md §3.1).

    Pass ``mesh`` (jax.sharding.Mesh with a "shot" axis) to shard the
    physics gradient across devices — the multi-chip path replacing
    the reference's Ray per-shot GPU fan-out."""

    def __init__(self, cfg: ExperimentConfig, workload=None, mesh=None,
                 val_workload=None):
        self.cfg = cfg
        self.mesh = mesh
        if workload is None and cfg.dataroot:
            from physicsbasedfwi2_tpu.data.synthetic import (
                acoustic_workload_from_disk)
            workload = acoustic_workload_from_disk(
                cfg.dataroot, nz=cfg.nz, nx=cfg.nx, dx=cfg.dx,
                nt=cfg.nt, dt=cfg.dt, pml_width=cfg.pml_width,
                freq=cfg.freq, chunk=cfg.chunk,
                wavelet_from_data=cfg.wavelet_from_data)
        self.wl = workload or SyntheticAcousticWorkload.build(
            nz=cfg.nz, nx=cfg.nx, dx=cfg.dx, nt=cfg.nt, dt=cfg.dt,
            pml_width=cfg.pml_width, freq=cfg.freq,
            num_shots=cfg.num_shots, num_receivers=cfg.num_receivers,
            seed=cfg.seed, chunk=cfg.chunk)
        if cfg.wavelet_from_data and self.wl.wavelet.ndim == 1:
            # AutoWav on a synthetic workload: materialize the
            # per-shot wavelet array the trainD data would carry
            # (sized to the WORKLOAD's shot count — a dataroot may
            # carry a different gather count than the config)
            self.wl.wavelet = jnp.broadcast_to(
                self.wl.wavelet[None, :],
                (int(self.wl.geom[0].shape[0]),
                 self.wl.wavelet.shape[0]))
        if cfg.encoded_shots > 0:
            # encoded_fwi_gradient combines observed gathers with shot
            # 0's receiver spread for every super-shot (encoding.py:
            # 118-119) — valid ONLY for a common spread.  Disk-loaded
            # geometries with per-shot receiver layouts would get a
            # silently wrong gradient, so refuse here.
            rcv_z_np = np.asarray(self.wl.geom[2])
            rcv_x_np = np.asarray(self.wl.geom[3])
            common = bool((rcv_z_np == rcv_z_np[:1]).all()
                          and (rcv_x_np == rcv_x_np[:1]).all())
            if not common:
                raise ValueError(
                    "encoded_shots>0 requires an identical receiver "
                    "spread (rcv_z/rcv_x) across all shots; this "
                    "workload's geometry varies per shot")
        path, self._sim = select_operator("acoustic", cfg.backend)
        if cfg.encoded_shots > 0:
            self.physics_path = "encoded"
        else:
            self.physics_path = path + ("+mesh" if mesh is not None
                                        else "")
        _log_path(cfg.name, "acoustic", self.physics_path)
        # direct-wave (constant water-velocity model) simulated ONCE at
        # setup with the inversion operator
        # (networks.py:5396-5411: receiver_amplitudes_cte)
        self._direct = None
        if cfg.direct_wave:
            const = jnp.full_like(self.wl.vp_true, cfg.water_vel)
            self._direct = self._sim(const, self.wl.wavelet,
                                     *self.wl.geom, self.wl.cfg)
            if not getattr(self.wl, "from_disk", False):
                # The reference normalizes the OBSERVED gathers raw
                # (networks.py:5418) while subtracting the direct from
                # pred (5467) — consistent only because its stored
                # trainA data lacks the direct arrival.  Synthetic
                # workloads mirror that storage convention here.
                self.wl.obs = self.wl.obs - self._direct
                self.wl.obs_norm = trace_normalize(self.wl.obs)
        self.net = define_generator(
            cfg.netG, out_shape=(cfg.nz, cfg.nx), latent_dim=cfg.latent_dim,
            filters=cfg.filters, time_decimation=cfg.time_decimation,
            dropout=cfg.dropout)
        self.is_vae = cfg.netG.lower().startswith("vae")
        # net input: [1, nt, nr, ns]
        self.shots_in = jnp.transpose(self.wl.obs, (1, 2, 0))[None]
        self.true_b = self.wl.vp_true[None, :, :, None]
        # validation twin (the reference's create_dataset2 Test
        # dataset, data/__init__.py:41-62): held-out sample, never the
        # training sample
        self.val_wl = val_workload
        if self.val_wl is None and cfg.validate_on_twin:
            self.val_wl = self._build_val_twin()
        rngs = {"params": jax.random.PRNGKey(cfg.seed)}
        if self.is_vae:
            rngs["latent"] = jax.random.PRNGKey(cfg.seed + 1)
        self.params = self.net.init(rngs, self.shots_in)
        self.opt = _make_optimizer(cfg)
        self.opt_state = self.opt.init(self.params)
        self.lr_policy = LrPolicy(cfg) if cfg.optimizer == "adam" else None
        self._build_steps()

    def _build_val_twin(self):
        cfg = self.cfg
        if cfg.dataroot:
            import os as _os
            if _os.path.isdir(_os.path.join(cfg.dataroot, "testA")):
                from physicsbasedfwi2_tpu.data.synthetic import (
                    acoustic_workload_from_disk)
                return acoustic_workload_from_disk(
                    cfg.dataroot, nz=cfg.nz, nx=cfg.nx, dx=cfg.dx,
                    nt=cfg.nt, dt=cfg.dt, pml_width=cfg.pml_width,
                    freq=cfg.freq, chunk=cfg.chunk, phase="test")
            return None  # no twin on disk: fall back to train sample
        return SyntheticAcousticWorkload.build(
            nz=cfg.nz, nx=cfg.nx, dx=cfg.dx, nt=cfg.nt, dt=cfg.dt,
            pml_width=cfg.pml_width, freq=cfg.freq,
            num_shots=cfg.num_shots, num_receivers=cfg.num_receivers,
            seed=cfg.seed + 101, chunk=cfg.chunk)

    # -- physics loss with reference-style gradient post-processing --
    def _physics_loss_raw(self, vp, pd):
        """Reference misfit pipeline (networks.py:5467-5476): subtract
        the constant-model direct wave from pred, trace-normalize,
        L1/L2 against the (raw-normalized) observed data.  ``pd`` is
        the physics-data pytree from :meth:`_make_physics_loss` (or
        its stage-filtered variant from :meth:`_stage_phys_pd`) — the
        wavelet rides in it so frequency continuation swaps data, not
        compiled code."""
        cfg, wl = self.cfg, self.wl
        pred = self._sim(vp, pd["wav"], *wl.geom, wl.cfg)
        from physicsbasedfwi2_tpu.ops.misfit import normalized_trace_misfit
        return normalized_trace_misfit(pred, pd["obs_norm"],
                                       direct=pd["direct"],
                                       kind=cfg.misfit)

    def _make_physics_loss(self):
        """custom_vjp wrapper reproducing the reference's processed
        VJP (networks.py:5491-5493 + Auto22_model.py:300): dJ/dvp is
        depth^2-weighted, water-masked and scaled before injection
        into the generator's autodiff.  With a mesh, the (loss, grad)
        pair comes from the shot-sharded shard_map path.

        Returns ``(physics_loss, pd)``: the observed-data arrays ride
        in the ``pd`` pytree and must be passed to the jitted step as
        ARGUMENTS, never closed over — closed-over device arrays get
        embedded in the serialized HLO as literal constants, bloating
        every compile by the size of the dataset."""
        cfg = self.cfg
        raw = self._physics_loss_raw
        true_model = self.wl.vp_true
        mesh = self.mesh
        wl = self.wl
        encoded = cfg.encoded_shots > 0
        pd = {"obs_norm": wl.obs_norm, "direct": self._direct,
              "wav": wl.wavelet}
        if encoded:
            # random-polarity simultaneous-source mode: raw per-shot
            # gathers combine linearly into super-gathers; the
            # polarity draw changes every iteration (enc_key rides in
            # pd from optimize_parameters), averaging out crosstalk
            pd["obs"] = wl.obs
            pd["enc_key"] = jax.random.PRNGKey(cfg.seed + 77)
        if mesh is not None:
            from physicsbasedfwi2_tpu.parallel import pad_shots_to_multiple
            pad_list = [*wl.geom, wl.obs_norm]
            if self._direct is not None:
                pad_list.append(self._direct)
            padded, mask = pad_shots_to_multiple(pad_list,
                                                 mesh.shape["shot"])
            pd.update(padded=list(padded), mask=mask)

        def value_and_grad_physics(vp, pd):
            if encoded:
                from physicsbasedfwi2_tpu.ops.encoding import (
                    encoded_fwi_gradient)
                return encoded_fwi_gradient(
                    vp, pd["obs"], pd["wav"], *wl.geom, wl.cfg,
                    pd["enc_key"], cfg.encoded_shots,
                    misfit=cfg.misfit)
            if mesh is None:
                return jax.value_and_grad(raw)(vp, pd)
            from physicsbasedfwi2_tpu.parallel import (
                shot_sharded_acoustic_gradient)
            sz, sx, rz, rx, obs = pd["padded"][:5]
            direct = (pd["padded"][5] if self._direct is not None
                      else None)
            return shot_sharded_acoustic_gradient(
                mesh, vp, obs, pd["wav"], sz, sx, rz, rx, wl.cfg,
                misfit=cfg.misfit, shot_mask=pd["mask"], direct=direct)

        @jax.custom_vjp
        def physics_loss(vp, pd):
            if encoded:
                # primal must share the encoded objective (value_fn
                # probes); the paired gradient is discarded by DCE
                return value_and_grad_physics(vp, pd)[0]
            return raw(vp, pd)

        def fwd(vp, pd):
            loss, grad = value_and_grad_physics(vp, pd)
            grad = depth_weighting(grad, 2.0)
            grad = water_mask(grad, true_model, cfg.water_vel)
            return loss, (grad * cfg.grad_scale, pd)

        def bwd(res, g):
            grad, pd = res
            return (g * grad,
                    jax.tree_util.tree_map(jnp.zeros_like, pd))

        physics_loss.defvjp(fwd, bwd)
        return physics_loss, pd

    def _apply_net(self, params, *, deterministic=True, rng=None,
                   shots_in=None):
        """Apply the generator; returns a GenOut regardless of the
        net family's raw tuple arity (models.pack_output)."""
        from physicsbasedfwi2_tpu.models import apply_generator
        x = self.shots_in if shots_in is None else shots_in
        rngs = None
        if rng is not None:
            rngs = ({"latent": rng} if self.is_vae
                    else {"dropout": rng})
        det = deterministic and rng is None
        return apply_generator(self.net, params, x,
                               deterministic=det, rngs=rngs)

    def _build_steps(self):
        cfg = self.cfg
        physics_loss, phys_pd = self._make_physics_loss()
        # all large arrays enter the jitted steps as this argument
        # pytree (see _make_physics_loss for why closures won't do)
        self._pack = {"shots_in": self.shots_in, "true_b": self.true_b,
                      "vp_true": self.wl.vp_true, "phys": phys_pd}
        self._stage_cache = {}

        def total_loss(params, use_physics, rng, pack):
            out = self._apply_net(
                params, shots_in=pack["shots_in"],
                deterministic=cfg.dropout == 0 and not self.is_vae,
                rng=rng if (cfg.dropout > 0 or self.is_vae) else None)
            vp = apply_velocity_output(out.field, pack["true_b"],
                                       water_vel=cfg.water_vel)[0, :, :, 0]
            model_mse = jnp.mean((vp - pack["vp_true"]) ** 2)
            loss = jnp.where(use_physics,
                             physics_loss(vp, pack["phys"]), 0.0)
            if cfg.supervised_weight > 0:
                loss = loss + cfg.supervised_weight * model_mse
            elif not cfg.lstart == 0:
                # warmup phase trains on the model-MSE oracle
                loss = loss + jnp.where(use_physics, 0.0, model_mse)
            if out.mu is not None and cfg.kl_weight > 0:
                kl = kl_divergence(out.mu, out.logvar)
                if out.logdet is not None:
                    # flow-sharpened posterior: KL(q0||N) - E[logdet]
                    # (VaeNormalizing ELBO, networks.py:15746-16190)
                    kl = kl - jnp.mean(out.logdet)
                loss = loss + cfg.kl_weight * kl
            elif out.logdet is not None:
                # invertible-latent NLL (AutoNF, networks.py:
                # 13316-13624): 0.5||z||^2 - log|det J|
                nll = (0.5 * jnp.mean(jnp.sum(out.latent ** 2, -1))
                       - jnp.mean(out.logdet))
                loss = loss + cfg.flow_weight * nll
            return loss, (model_mse, vp)

        @functools.partial(jax.jit, static_argnames=("use_physics",))
        def train_step(params, opt_state, rng, use_physics: bool, pack):
            (loss, (model_mse, vp)), grads = jax.value_and_grad(
                total_loss, has_aux=True)(params, use_physics, rng,
                                          pack)
            if cfg.optimizer == "lbfgs":
                updates, opt_state = self.opt.update(
                    grads, opt_state, params, value=loss, grad=grads,
                    value_fn=lambda p: total_loss(p, use_physics, rng,
                                                  pack)[0])
            else:
                updates, opt_state = self.opt.update(grads, opt_state,
                                                     params)
            params = optax.apply_updates(params, updates)
            return params, opt_state, loss, model_mse

        # validation on the held-out twin when available (the
        # reference's create_dataset2 + compute_loss_only path,
        # trainValLatent4dVel2.py:56-62); training sample otherwise
        if self.val_wl is not None:
            val_in = jnp.transpose(self.val_wl.obs, (1, 2, 0))[None]
            val_true_b = self.val_wl.vp_true[None, :, :, None]
            val_true = self.val_wl.vp_true
        else:
            val_in, val_true_b, val_true = (self.shots_in, self.true_b,
                                            self.wl.vp_true)
        self._eval_pack = {"val_in": val_in, "val_true_b": val_true_b,
                           "val_true": val_true}

        @jax.jit
        def eval_step(params, epack):
            out = self._apply_net(params, deterministic=True,
                                  shots_in=epack["val_in"])
            vp = apply_velocity_output(out.field, epack["val_true_b"],
                                       water_vel=cfg.water_vel)[0, :, :, 0]
            return jnp.mean((vp - epack["val_true"]) ** 2), vp

        self._train_step = train_step
        self._eval_step = eval_step
        self._rng = jax.random.PRNGKey(cfg.seed + 7)

    def _stage_phys_pd(self, fc):
        """Stage-filtered variant of the physics pytree — frequency
        continuation for the acoustic engine, mirroring
        ElasticDIPEngine._stage_data (DENISE's source-side band limit,
        reference networks.py:7711-7713): the wavelet and the observed
        gathers (and the cached direct wave) are zero-phase low-passed
        once per stage; by linearity simulating with the filtered
        wavelet equals filtering the prediction.  The variant shares
        the base pytree's treedef and shapes, so every stage reuses
        ONE compiled train step."""
        key = float(fc or 0.0)
        if key <= 0.0:
            return self._pack["phys"]
        if key not in self._stage_cache:
            from physicsbasedfwi2_tpu.geo.filters import (
                lowpass_filter_time)
            cfg, wl = self.cfg, self.wl
            base = self._pack["phys"]
            pd = dict(base)
            pd["wav"] = lowpass_filter_time(wl.wavelet, key, cfg.dt,
                                            axis=-1)
            obs = lowpass_filter_time(wl.obs, key, cfg.dt, axis=1)
            pd["obs_norm"] = trace_normalize(obs)
            if base.get("direct") is not None:
                pd["direct"] = lowpass_filter_time(self._direct, key,
                                                   cfg.dt, axis=1)
            if "obs" in base:  # encoded-source mode filters raw obs
                pd["obs"] = obs
            if self.mesh is not None:
                from physicsbasedfwi2_tpu.parallel import (
                    pad_shots_to_multiple)
                pad_list = [*wl.geom, pd["obs_norm"]]
                if self._direct is not None:
                    pad_list.append(pd["direct"])
                padded, mask = pad_shots_to_multiple(
                    pad_list, self.mesh.shape["shot"])
                pd.update(padded=list(padded), mask=mask)
            _evict_stale_stages(self._stage_cache, key)
            self._stage_cache[key] = pd
        return self._stage_cache[key]

    def optimize_parameters(self, epoch: int, freq: float | None = None,
                            tether_stage: int | None = None):
        """One iteration (reference optimize_parameters,
        Auto22_model.py:284-330).  ``freq`` is the continuation
        stage's corner frequency from the train loop (None/0 = full
        band); ``tether_stage`` is accepted for train-loop API
        symmetry (the tether is an elastic-engine recipe)."""
        self._rng, sub = jax.random.split(self._rng)
        use_physics = epoch > self.cfg.lstart
        if self.lr_policy is not None:
            _set_lr(self.opt_state, self.lr_policy.lr_for_epoch(epoch))
        pack = self._pack
        if freq:
            pd = self._stage_phys_pd(freq)
            if pd is not pack["phys"]:
                pack = dict(pack, phys=pd)
        if self.cfg.encoded_shots > 0:
            # fresh polarity draw every iteration (identical pytree
            # structure, so the compiled step is reused)
            self._rng, ek = jax.random.split(self._rng)
            pack = dict(pack, phys=dict(pack["phys"], enc_key=ek))
        self.params, self.opt_state, loss, model_mse = self._train_step(
            self.params, self.opt_state, sub, use_physics, pack)
        # one host round trip for both scalars
        loss, model_mse = map(float, jax.device_get((loss, model_mse)))
        out = {"loss_D" if use_physics else "loss_M": loss,
               "loss_M_MSE": model_mse}
        if self.lr_policy is not None:
            out["lr"] = self.lr_policy.after_epoch(loss)
        return out

    def test(self):
        """Validation (reference model.test + compute_loss_only)."""
        mse, vp = self._eval_step(self.params, self._eval_pack)
        mse, vp = jax.device_get((mse, vp))
        return {"loss_V_MSE": float(mse)}, np.asarray(vp)


# ---------------------------------------------------------------------------
# multi-sample acoustic DIP: batch axis through the CNN + {sample,
# shot} mesh through the physics (the reference's batch_size=8 + Ray
# per-sample fan-out, Auto_model.py:69-199)
# ---------------------------------------------------------------------------

class MultiSampleAcousticDIPEngine(EngineBase):
    """One generator trained on a BATCH of FWI samples: the CNN runs
    data-parallel over the batch, and the physics misfit fans out
    over a 2D {sample, shot} device mesh (or a vmap on one chip) —
    the Ray-remote-GPU pattern as one shard_map."""

    def __init__(self, cfg: ExperimentConfig, workloads=None, mesh=None,
                 n_samples: int = 2):
        self.cfg = cfg
        self.mesh = mesh
        if workloads is None:
            workloads = [
                SyntheticAcousticWorkload.build(
                    nz=cfg.nz, nx=cfg.nx, dx=cfg.dx, nt=cfg.nt,
                    dt=cfg.dt, pml_width=cfg.pml_width, freq=cfg.freq,
                    num_shots=cfg.num_shots,
                    num_receivers=cfg.num_receivers,
                    seed=cfg.seed + i, chunk=cfg.chunk)
                for i in range(n_samples)]
        self.wls = workloads
        wl0 = workloads[0]
        self.vp_true = jnp.stack([w.vp_true for w in workloads])
        self.obs = jnp.stack([w.obs for w in workloads])
        wl_cfg, geom, wav = wl0.cfg, wl0.geom, wl0.wavelet
        _, sim = select_operator("acoustic", cfg.backend)
        # direct wave: the constant water model is sample-independent,
        # so ONE simulation serves every sample (the reference
        # recomputed it per sample per iteration, networks.py:
        # 5396-5411)
        self._direct = None
        if cfg.direct_wave:
            const = jnp.full_like(wl0.vp_true, cfg.water_vel)
            self._direct = sim(const, wav, *geom, wl_cfg)
            # disk trees store direct-removed gathers (data/prep.py);
            # synthetic obs are full wavefields and need the direct
            # arrival removed PER SAMPLE (a batch may mix both)
            synth = jnp.asarray(
                [0.0 if getattr(w, "from_disk", False) else 1.0
                 for w in workloads], jnp.float32)
            self.obs = self.obs - (synth[:, None, None, None]
                                   * self._direct[None])
        self.obs_norm = trace_normalize(self.obs)
        self.shots_in = jnp.transpose(self.obs, (0, 2, 3, 1))
        self.true_b = self.vp_true[..., None]
        self.net = define_generator(
            cfg.netG, out_shape=(cfg.nz, cfg.nx),
            latent_dim=cfg.latent_dim, filters=cfg.filters,
            time_decimation=cfg.time_decimation)
        self.params = self.net.init(jax.random.PRNGKey(cfg.seed),
                                    self.shots_in)
        self.opt = _make_optimizer(cfg)
        self.opt_state = self.opt.init(self.params)
        self.lr_policy = LrPolicy(cfg) if cfg.optimizer == "adam" else None
        mis = cfg.misfit
        self.physics_path = "xla+mesh" if mesh is not None else "xla"
        _log_path(cfg.name, "multi-sample acoustic", self.physics_path)
        # batch data as step arguments (n_samples x 18 shots of
        # gathers — at reference scale hundreds of MB of would-be
        # HLO constants; see AcousticDIPEngine._make_physics_loss)
        self._pack = {"shots_in": self.shots_in, "true_b": self.true_b,
                      "vp_true": self.vp_true,
                      "obs_norm": self.obs_norm,
                      "direct": (self._direct
                                 if self._direct is not None
                                 else jnp.zeros_like(self.obs[0]))}

        def raw(vps, obs_norm, direct):
            def per_sample(vp, obs):
                pred = sim(vp, wav, *geom, wl_cfg)
                pred = trace_normalize(pred - direct)
                r = pred - obs
                per = jnp.abs(r) if mis == "l1" else r * r
                return jnp.mean(per)
            return jnp.mean(jax.vmap(per_sample)(vps, obs_norm))

        def value_and_grad_physics(vps, obs_norm, direct):
            if mesh is None:
                return jax.value_and_grad(raw)(vps, obs_norm, direct)
            from physicsbasedfwi2_tpu.parallel import (
                sample_shot_sharded_acoustic_gradient)
            return sample_shot_sharded_acoustic_gradient(
                mesh, vps, obs_norm, wav, *geom, wl_cfg, misfit=mis,
                direct=direct)

        @jax.custom_vjp
        def physics_loss(vps, obs_norm, vp_true, direct):
            return raw(vps, obs_norm, direct)

        def fwd(vps, obs_norm, vp_true, direct):
            loss, g = value_and_grad_physics(vps, obs_norm, direct)
            g = jax.vmap(lambda gi, ti: water_mask(
                depth_weighting(gi, 2.0), ti, cfg.water_vel))(
                g, vp_true)
            return loss, (g * cfg.grad_scale, obs_norm, vp_true, direct)

        def bwd(res, ct):
            g, obs_norm, vp_true, direct = res
            return (ct * g, jnp.zeros_like(obs_norm),
                    jnp.zeros_like(vp_true), jnp.zeros_like(direct))

        physics_loss.defvjp(fwd, bwd)

        def total_loss(params, use_physics, pack):
            from physicsbasedfwi2_tpu.models import pack_output
            out = pack_output(self.net.apply(params, pack["shots_in"]))
            vps = apply_velocity_output(out.field, pack["true_b"],
                                        water_vel=cfg.water_vel)[..., 0]
            mse = jnp.mean((vps - pack["vp_true"]) ** 2)
            if not use_physics:
                # lstart warmup: model-MSE oracle phase, matching the
                # single-sample engine (grad only if epoch > lstart,
                # networks.py:5286)
                return mse, mse
            return physics_loss(vps, pack["obs_norm"],
                                pack["vp_true"], pack["direct"]), mse

        @functools.partial(jax.jit, static_argnames=("use_physics",))
        def train_step(params, opt_state, use_physics: bool, pack):
            (loss, mse), grads = jax.value_and_grad(
                total_loss, has_aux=True)(params, use_physics, pack)
            updates, opt_state = self.opt.update(grads, opt_state, params)
            return optax.apply_updates(params, updates), opt_state, \
                loss, mse

        self._train_step = train_step

    def optimize_parameters(self, epoch: int):
        if self.lr_policy is not None:
            _set_lr(self.opt_state, self.lr_policy.lr_for_epoch(epoch))
        use_physics = epoch > self.cfg.lstart
        self.params, self.opt_state, loss, mse = self._train_step(
            self.params, self.opt_state, use_physics, self._pack)
        loss, mse = map(float, jax.device_get((loss, mse)))
        out = {"loss_D" if use_physics else "loss_M": loss,
               "loss_M_MSE": mse}
        if self.lr_policy is not None:
            out["lr"] = self.lr_policy.after_epoch(loss)
        return out

    def test(self):
        from physicsbasedfwi2_tpu.models import pack_output
        out = pack_output(self.net.apply(self.params, self.shots_in))
        vps = apply_velocity_output(out.field, self.true_b,
                                    water_vel=self.cfg.water_vel)[..., 0]
        mse = float(jnp.mean((vps - self.vp_true) ** 2))
        return {"loss_V_MSE": mse}, np.asarray(vps)


# ---------------------------------------------------------------------------
# elastic deep-image-prior engine (AutoElMar22 family)
# ---------------------------------------------------------------------------

class ElasticDIPEngine(EngineBase):
    """Two-branch elastic FWI with frequency continuation (reference
    call stack SURVEY.md §3.2).

    Pass ``mesh`` (jax.sharding.Mesh with a "shot" axis) to fan the
    per-iteration shot subset out across devices — the replacement
    for DENISE's 30-MPI-rank gradient call (networks.py:7709-7710).
    Each device autodiffs the selected operator on its shot shard
    inside shard_map, with a psum reduction.  Requires
    shots_per_iter divisible by the mesh's shot axis."""

    def __init__(self, cfg: ExperimentConfig, workload=None, mesh=None):
        self.cfg = cfg
        self.mesh = mesh
        if mesh is not None:
            nsub = cfg.shots_per_iter or cfg.num_shots
            n_dev = mesh.shape["shot"]
            if nsub % n_dev:
                raise ValueError(
                    f"shots_per_iter ({nsub}) must be divisible by the "
                    f"mesh shot axis ({n_dev}) — pick e.g. "
                    f"shots_per_iter={-(-nsub // n_dev) * n_dev}")
        if workload is None and cfg.dataroot:
            from physicsbasedfwi2_tpu.data.synthetic import (
                elastic_workload_from_disk)
            workload = elastic_workload_from_disk(
                cfg.dataroot, nz=cfg.nz, nx=cfg.nx, dx=cfg.dx,
                nt=cfg.nt, dt=cfg.dt, pml_width=cfg.pml_width,
                freq=cfg.freq, free_surface=cfg.free_surface,
                chunk=cfg.chunk, water_rows=cfg.water_rows,
                src_depth_row=cfg.extras.get("src_depth_row"),
                rcv_depth_row=cfg.extras.get("rcv_depth_row"),
                rcv_follow_seabed=cfg.extras.get("rcv_follow_seabed",
                                                 False))
        self.wl = workload or SyntheticElasticWorkload.build(
            nz=cfg.nz, nx=cfg.nx, dx=cfg.dx, nt=cfg.nt, dt=cfg.dt,
            pml_width=cfg.pml_width, freq=cfg.freq,
            num_shots=cfg.num_shots, num_receivers=cfg.num_receivers,
            seed=cfg.seed, chunk=cfg.chunk,
            free_surface=cfg.free_surface, water_rows=cfg.water_rows,
            src_depth_row=cfg.extras.get("src_depth_row"),
            rcv_depth_row=cfg.extras.get("rcv_depth_row"),
            rcv_follow_seabed=cfg.extras.get("rcv_follow_seabed",
                                             False))
        # the shot-sampling space is the WORKLOAD's shot count: a
        # dataroot may carry fewer/more gathers than the registered
        # config (e.g. an SU field survey), and sampling cfg.num_shots
        # would clamp out-of-range gathers silently under jit
        self.n_shots = int(self.wl.geom[0].shape[0])
        if self.n_shots != cfg.num_shots:
            print(f"[{cfg.name}] workload has {self.n_shots} shots; "
                  f"config num_shots={cfg.num_shots} — using the "
                  f"workload's count")
        # held-out shots for unsupervised early stopping: k evenly
        # spaced INTERIOR shots never enter the training pool; their
        # misfit (loss_H) is the selection metric a user without the
        # ground-truth model can compute (train.py saves the best
        # final-stage loss_H checkpoint as 'selected')
        import numpy as _nph
        if cfg.holdout_shots > 0:
            k = min(cfg.holdout_shots, max(self.n_shots - 1, 1))
            hold = _nph.unique(_nph.round(_nph.linspace(
                0, self.n_shots - 1, k + 2)[1:-1]).astype(_nph.int64))
            pool = _nph.setdiff1d(_nph.arange(self.n_shots), hold)
            self._holdout_idx = jnp.asarray(hold, jnp.int32)
            self._train_pool = jnp.asarray(pool, jnp.int32)
        else:
            self._holdout_idx = None
            self._train_pool = jnp.arange(self.n_shots,
                                          dtype=jnp.int32)
        path, self._sim = select_operator("elastic", cfg.backend)
        self.physics_path = path + ("+mesh" if mesh is not None else "")
        _log_path(cfg.name, "elastic", self.physics_path)
        if path != "reference" and not getattr(self.wl, "from_disk",
                                               False):
            # synthetic gathers come from the split-PML reference
            # (SyntheticElasticWorkload.build): regenerate them with
            # the inversion operator so the misfit is zero at the true
            # model
            wl = self.wl
            wl.obs_vx, wl.obs_vz = self._sim(
                wl.true["vp"], wl.true["vs"], wl.true["rho"],
                wl.wavelet, *wl.geom, wl.cfg)
        self.net = define_generator(
            cfg.netG, out_shape=(cfg.nz, cfg.nx), latent_dim=cfg.latent_dim,
            filters=cfg.filters, time_decimation=cfg.time_decimation,
            dropout=cfg.dropout, head=cfg.elastic_head)
        self.in_vx = jnp.transpose(self.wl.obs_vx, (1, 2, 0))[None]
        self.in_vz = jnp.transpose(self.wl.obs_vz, (1, 2, 0))[None]
        # n_fields comes from the generator: 2 = vp/vs with rho taken
        # from the low-frequency model (networks.py:7458), 3 = rho
        # inversion head (AutoElFullRhoMar22, networks.py:8552-8936).
        self.n_fields = int(getattr(self.net, "n_fields", 2))
        names = ("vp", "vs", "rho")[: self.n_fields]
        self.field_names = names
        self.lowf = jnp.stack([self.wl.start[k] for k in names], -1)[None]
        self.true_m = jnp.stack([self.wl.true[k] for k in names], -1)[None]
        self.params = self.net.init(jax.random.PRNGKey(cfg.seed),
                                    self.in_vx, self.in_vz)
        self.opt = _make_optimizer(cfg)
        self.opt_state = self.opt.init(self.params)
        # per-field box constraints (DENISE VPUPPERLIM..RHOLOWERLIM,
        # networks.py:7723-7730); delta scale is a hard bound for the
        # tanh head, a unit-conditioning gain for the linear head
        default_scale = ((300.0, 200.0, 150.0)
                         if cfg.elastic_head == "tanh"
                         else (100.0, 100.0, 100.0))
        self.delta_scale = tuple(
            cfg.delta_scale or default_scale)[: self.n_fields]
        self.clip_min = tuple(
            cfg.clip_min or (1500.0, 0.0, 900.0))[: self.n_fields]
        self.clip_max = tuple(
            cfg.clip_max or (4700.0, 2700.0, 3000.0))[: self.n_fields]
        self.lr_policy = LrPolicy(cfg) if cfg.optimizer == "adam" else None
        self._ilw = None  # lazy: see _illum_weight()
        self._rng = jax.random.PRNGKey(cfg.seed + 7)
        self._step_cache = {}
        self._stage_cache = {}
        self._phase_reset_done = False
        # trailing-tether state (cfg.tether_mode="stage"): the
        # reference model the tether pulls toward, refreshed at stage
        # advances / every tether_refresh_epochs
        self._tether_ref = None
        self._tether_stage_i = -1
        self._tether_epoch = 0
        # drift-guard state (cfg.guard_patience>0): epoch of the last
        # revert, for the post-revert lr ramp
        self._guard_ramp_from = None

    def _illum_weight(self):
        """DENISE EPRECOND: reciprocal source-illumination weight,
        computed ONCE from the starting model over all shots — lazily
        on the first training step, so evaluation-only engine builds
        (fwi-test) never pay the full-geometry forward sweep."""
        if self._ilw is None:
            from physicsbasedfwi2_tpu.ops.elastic_fast import (
                elastic_illumination)
            wl, cfg = self.wl, self.cfg
            il = elastic_illumination(
                wl.start["vp"], wl.start["vs"], wl.start["rho"],
                wl.wavelet, wl.geom[0], wl.geom[1], wl.cfg)
            il = il / jnp.max(il)
            self._ilw = 1.0 / (il + cfg.grad_illum_eps)
        return self._ilw

    def _stage_data(self, fc):
        """Per-stage (wavelet_fc, obs_vx_fc, obs_vz_fc), cached.

        Frequency continuation is applied on the SOURCE side: the
        wavelet is low-passed once per stage (exactly DENISE's
        FC_SPIKE_1/2 band limit, networks.py:7711-7713) — by
        linearity of the wave equation, simulating with the filtered
        wavelet equals filtering the prediction, so the per-iteration
        filtering of pred drops out of the hot loop entirely.  The
        observed data is filtered once per stage."""
        key = float(fc or 0.0)
        if key not in self._stage_cache:
            wl, cfg = self.wl, self.cfg
            if key > 0:
                wav = lowpass_filter_time(wl.wavelet, key, cfg.dt,
                                          axis=-1)
                ovx = lowpass_filter_time(wl.obs_vx, key, cfg.dt, axis=1)
                ovz = lowpass_filter_time(wl.obs_vz, key, cfg.dt, axis=1)
            else:
                wav, ovx, ovz = wl.wavelet, wl.obs_vx, wl.obs_vz
            if cfg.misfit == "snl2":
                # shot-normalized raw L2: divide each shot's gathers
                # AND its wavelet by the shot's observed RMS.  By
                # linearity of the wave equation the scaled wavelet
                # scales the prediction identically, so the raw-L2
                # kernel path computes sum((pred - obs)^2 / rms^2) —
                # amplitude/AVO information survives (trace-max
                # normalization destroys it and admits data-consistent
                # drift basins, docs/RESULTS.md line-scan) while the
                # f32 conditioning problem of unscaled amplitudes
                # (~1e-7 losses) disappears.
                s = jnp.sqrt(jnp.mean(ovx ** 2 + ovz ** 2,
                                      axis=(1, 2), keepdims=True))
                s = jnp.maximum(s, 1e-30)
                if wav.ndim == 1:
                    wav = jnp.broadcast_to(
                        wav[None], (ovx.shape[0], wav.shape[-1]))
                wav = wav / s[:, :, 0]
                ovx, ovz = ovx / s, ovz / s
            _evict_stale_stages(self._stage_cache, key)
            self._stage_cache[key] = (wav, ovx, ovz)
        return self._stage_cache[key]

    def _stage_pack(self, fc):
        """Stage-data pytree passed to the jitted step as an ARGUMENT
        (same rationale as AcousticDIPEngine._make_physics_loss: the
        35-shot observed gathers are hundreds of MB — closed over,
        they would be serialized into the HLO of every compile).
        Because the step takes the stage data as input, frequency
        continuation reuses ONE compiled step across all stages."""
        key = ("pack", float(fc or 0.0))
        if key not in self._stage_cache:
            wav, ovx, ovz = self._stage_data(fc)
            pd = {"wav": wav, "ovx": ovx, "ovz": ovz}
            _evict_stale_stages(self._stage_cache, key[1])
            self._stage_cache[key] = pd
        return self._stage_cache[key]

    def _physics_loss_raw(self, m, shot_idx, pd):
        """Misfit on a shot subset at the given continuation stage —
        the d.grad() role (networks.py:7787).  ``m`` is the stacked
        [nz, nx, F] model; with F == 2 the density entering the
        simulation is the LOW-FREQUENCY rho (networks.py:7458 — never
        the ground truth).

        misfit="l2" is DENISE's raw L2 (lnorm=2); "tnl2"/"tnl1" are
        trace-max-normalized variants (the conditioning the
        reference's ACOUSTIC path uses, networks.py:5418-5419 —
        equalizes trace energy so near-source/interface events don't
        dominate)."""
        wl = self.wl
        wav = pd["wav"]
        sz = wl.geom[0][shot_idx]
        sx = wl.geom[1][shot_idx]
        rz = wl.geom[2][shot_idx]
        rx = wl.geom[3][shot_idx]
        if wav.ndim == 2:
            wav = wav[shot_idx]
        vp, vs = m[..., 0], m[..., 1]
        rho = m[..., 2] if self.n_fields == 3 else wl.start["rho"]
        pvx, pvz = self._sim(vp, vs, rho, wav, sz, sx, rz, rx, wl.cfg)
        ovx = pd["ovx"][shot_idx]
        ovz = pd["ovz"][shot_idx]
        if self.cfg.misfit in ("tnl2", "tnl1"):
            pvx, pvz = trace_normalize(pvx), trace_normalize(pvz)
            ovx, ovz = trace_normalize(ovx), trace_normalize(ovz)
            if self.cfg.misfit == "tnl1":
                return (jnp.mean(jnp.abs(pvx - ovx))
                        + jnp.mean(jnp.abs(pvz - ovz)))
        return jnp.mean((pvx - ovx) ** 2) + jnp.mean((pvz - ovz) ** 2)

    def _sharded_value_and_grad(self, m, shot_idx, pd):
        """(loss, dJ/dm) with the shot subset sharded over the mesh's
        "shot" axis — the DENISE-over-30-MPI-ranks replacement
        (networks.py:7709-7710).  Each device autodiffs the selected
        operator on its shard; loss and per-field gradients reduce by
        psum."""
        from jax.sharding import PartitionSpec as P
        from jax import shard_map
        from jax import lax
        mesh, wl = self.mesh, self.wl
        names = self.field_names
        n_fields = self.n_fields
        nsub = shot_idx.shape[0]
        wav = pd["wav"]
        wav_s = (wav[shot_idx] if wav.ndim == 2 else
                 jnp.broadcast_to(wav[None], (nsub, wav.shape[-1])))
        sz = wl.geom[0][shot_idx]
        sx = wl.geom[1][shot_idx]
        rz = wl.geom[2][shot_idx]
        rx = wl.geom[3][shot_idx]
        vp, vs = m[..., 0], m[..., 1]
        rho = m[..., 2] if n_fields == 3 else wl.start["rho"]
        specs = (P(), P(), P()) + (P("shot"),) * 7
        outs = (P(),) * (1 + n_fields)

        sim = self._sim
        ovx = pd["ovx"][shot_idx]
        ovz = pd["ovz"][shot_idx]
        denom = nsub * ovx.shape[1] * ovx.shape[2]
        misfit = self.cfg.misfit

        @functools.partial(shard_map, mesh=mesh, in_specs=specs,
                           out_specs=outs, check_vma=False)
        def _local(vp, vs, rho, wavb, szb, sxb, rzb, rxb, ovxb, ovzb):
            def local_loss(*fields):
                full = [vp, vs, rho]
                for i, f in enumerate(fields):
                    full[i] = f
                pvx, pvz = sim(full[0], full[1], full[2], wavb,
                               szb, sxb, rzb, rxb, wl.cfg)
                ox, oz = ovxb, ovzb
                if misfit in ("tnl2", "tnl1"):
                    # per-trace normalization is shot-local -> exact
                    # under shot sharding
                    pvx, pvz = trace_normalize(pvx), trace_normalize(pvz)
                    ox, oz = trace_normalize(ox), trace_normalize(oz)
                    if misfit == "tnl1":
                        return (jnp.sum(jnp.abs(pvx - ox))
                                + jnp.sum(jnp.abs(pvz - oz))) / denom
                return (jnp.sum((pvx - ox) ** 2)
                        + jnp.sum((pvz - oz) ** 2)) / denom

            args = (vp, vs, rho)[:n_fields]
            loss, gs = jax.value_and_grad(
                local_loss, argnums=tuple(range(n_fields)))(*args)
            return (lax.psum(loss, "shot"),
                    *(lax.psum(g, "shot") for g in gs))

        out = _local(vp, vs, rho, wav_s, sz, sx, rz, rx, ovx, ovz)
        return out[0], jnp.stack(out[1:], -1)

    def _make_physics_loss(self):
        """Per-field gradient post-processing chain (networks.py:
        7799-7862): top-rows taper + per-field rescale to the model
        magnitude, over all inverted fields (vp, vs[, rho]).

        Two DENISE conditioning steps the reference relied on
        implicitly (they live inside DENISE, not networks.py) are
        exposed via the config:

        - ``grad_taper_rows``/``grad_taper_smooth``: the raw adjoint
          gradient is near-singular at the src/rcv row (water_rows+1
          here) — measured 70x (vp) / 500x (vs) the interior p99 at
          the start model.  Tapering only the 26 water rows (the
          literal networks.py:7808-7814 mask) leaves those spikes to
          dominate the max-normalized update, saturating the decoder.
          DENISE's SWS_TAPER_CIRCULAR_PER_SHOT covers them.
        - ``grad_smooth``: binomial spatial smoothing (DENISE
          SPATFILTER role) for the remaining point singularities.
        """
        cfg = self.cfg
        raw = self._physics_loss_raw
        n_fields = self.n_fields
        taper_rows = (cfg.grad_taper_rows if cfg.grad_taper_rows
                      is not None else cfg.water_rows)
        from physicsbasedfwi2_tpu.ops.gradproc import smooth_spatial

        @jax.custom_vjp
        def physics_loss(m, shot_idx, pd):
            return raw(m, shot_idx, pd)

        mesh = self.mesh

        def fwd(m, shot_idx, pd):
            if mesh is not None:
                loss, gm = self._sharded_value_and_grad(m, shot_idx, pd)
            else:
                loss, gm = jax.value_and_grad(
                    lambda mm: raw(mm, shot_idx, pd))(m)
            cols = []
            for k in range(n_fields):
                g = taper_top(gm[..., k], taper_rows,
                              smooth=cfg.grad_taper_smooth)
                if cfg.grad_illum_eps > 0:
                    # DENISE EPRECOND: divide by the starting model's
                    # source illumination (pd["ilw"] precomputes the
                    # reciprocal weight once per inversion)
                    g = g * pd["ilw"]
                if cfg.grad_smooth > 0:
                    g = smooth_spatial(g, cfg.grad_smooth)
                if cfg.grad_depth_power > 0 and cfg.grad_illum_eps <= 0:
                    # the illumination weight REPLACES the crude z^p
                    # ramp (DENISE applies EPRECOND instead of, not on
                    # top of, simple depth preconditioning) — applying
                    # both would boost deep cells by ~z^p/eps
                    g = depth_weighting(g, cfg.grad_depth_power)
                if cfg.grad_rescale == "max":
                    g = rescale_to_model(g, m[..., k])
                else:
                    g = g * cfg.grad_scale
                # dynamic per-field weight (grad_field_weights x the
                # field_start_epochs gate, computed per epoch in
                # optimize_parameters and threaded through the pack so
                # staging never triggers a recompile)
                cols.append(g * pd["fw"][k])
            gm = jnp.stack(cols, -1)
            if cfg.tether_weight > 0:
                # Tikhonov-to-start tether in gradient units: pull
                # each field toward the low-frequency model with
                # tether_weight x the field's physics-gradient RMS.
                # The data term barely separates good from bad basins
                # here (misfit plateaus at the same value whether the
                # model converges or diverges, docs/RESULTS.md), so
                # null-space drift must be suppressed at the
                # gradient level, where the scales are commensurate.
                d = m - pd["lowf_m"]
                g_rms = jnp.sqrt(jnp.mean(gm ** 2, axis=(0, 1),
                                          keepdims=True))
                d_rms = jnp.sqrt(jnp.mean(d ** 2, axis=(0, 1),
                                          keepdims=True))
                # pd["tw"] = tether_weight * tether_decay**stage_i,
                # computed per epoch in optimize_parameters and
                # threaded through the pack so stage advances never
                # trigger a recompile
                gm = gm + pd["tw"] * g_rms * d / (d_rms + 1e-20)
            return loss, (gm, pd)

        def bwd(res, g):
            gm, pd = res
            return (g * gm, None,
                    jax.tree_util.tree_map(jnp.zeros_like, pd))

        physics_loss.defvjp(fwd, bwd)
        return physics_loss

    def _get_step(self):
        if "step" in self._step_cache:
            return self._step_cache["step"]
        cfg = self.cfg
        physics_loss = self._make_physics_loss()

        def total_loss(params, shot_idx, rng, use_physics, pack):
            det = cfg.dropout == 0
            rngs = {"dropout": rng} if not det else None
            deltas, z = self.net.apply(params, pack["in_vx"],
                                       pack["in_vz"],
                                       deterministic=det, rngs=rngs)
            m = apply_elastic_output(
                deltas, pack["lowf"], pack["true_m"],
                delta_scale=self.delta_scale, clip_min=self.clip_min,
                clip_max=self.clip_max, pin_rows=cfg.water_rows,
                clip_mode=cfg.clip_mode)
            anchor = jnp.mean((m - pack["lowf"]) ** 2)
            if not use_physics:
                # warmup (epoch <= lstart): pure anchor regression to
                # the low-frequency model — the reference's
                # loss_G = loss_L_MSE phase (AutoElMar22_model.py:
                # 374 with the physics backward commented out)
                return anchor, (jnp.float32(0.0),
                                jnp.mean((m - pack["true_m"]) ** 2))
            loss_d = physics_loss(m[0], shot_idx, pack["phys"])
            loss = loss_d
            if cfg.anchor_weight > 0:
                # optional low-frequency anchor in the physics phase
                # (off by default: the reference's physics branch
                # injects only the field gradients,
                # AutoElMar22_model.py:398-420)
                loss = loss + cfg.anchor_weight * anchor * 1e-6
            mse = jnp.mean((m - pack["true_m"]) ** 2)
            return loss, (loss_d, mse)

        @functools.partial(jax.jit, static_argnames=("use_physics",))
        def train_step(params, opt_state, shot_idx, rng,
                       use_physics: bool, pack):
            (loss, (loss_d, mse)), grads = jax.value_and_grad(
                total_loss, has_aux=True)(params, shot_idx, rng,
                                          use_physics, pack)
            if cfg.optimizer == "lbfgs":
                updates, opt_state = self.opt.update(
                    grads, opt_state, params, value=loss, grad=grads,
                    value_fn=lambda p: total_loss(p, shot_idx, rng,
                                                  use_physics, pack)[0])
            else:
                updates, opt_state = self.opt.update(grads, opt_state,
                                                     params)
            if cfg.step_cap > 0 and use_physics:
                # hard model-space trust region (cfg.step_cap): scale
                # the whole parameter update so the decoded model
                # moves at most step_cap m/s RMS this iteration.  Two
                # extra decoder forwards (~1M-param CNN) per step —
                # negligible next to the physics kernel.
                def _decode(p):
                    deltas, _ = self.net.apply(
                        p, pack["in_vx"], pack["in_vz"],
                        deterministic=True)
                    return apply_elastic_output(
                        deltas, pack["lowf"], pack["true_m"],
                        delta_scale=self.delta_scale,
                        clip_min=self.clip_min, clip_max=self.clip_max,
                        pin_rows=cfg.water_rows,
                        clip_mode=cfg.clip_mode)
                m_old = _decode(params)

                def _dm(scale):
                    scaled = jax.tree_util.tree_map(
                        lambda u: scale * u, updates)
                    m_try = _decode(optax.apply_updates(params, scaled))
                    return jnp.sqrt(jnp.mean((m_try - m_old) ** 2))

                # two fixed-point rounds: weight->model response is
                # nonlinear (GroupNorm), so one first-order scaling
                # overshoots the cap by ~50%; the second measurement
                # at the scaled update tightens it.  The cap VALUE is
                # step data (pack["cap"]) so per-stage caps
                # (step_cap_final) never recompile.
                cap = pack["cap"]
                s = jnp.minimum(1.0, cap / (_dm(1.0) + 1e-20))
                s = s * jnp.minimum(1.0, cap / (_dm(s) + 1e-20))
                updates = jax.tree_util.tree_map(lambda u: s * u,
                                                 updates)
            params = optax.apply_updates(params, updates)
            return params, opt_state, loss, loss_d, mse

        self._step_cache["step"] = train_step
        return train_step

    def _field_weights(self, epoch: int):
        """Per-field gradient multipliers for this epoch:
        grad_field_weights masked by the field_start_epochs gate
        (staged multi-parameter FWI; the reference gates rho on
        currenterror < 0.4*initerror, AutoElMar22_model.py:446-451)."""
        cfg = self.cfg
        fw = [1.0] * self.n_fields
        if cfg.grad_field_weights is not None:
            fw = [float(w) for w in
                  cfg.grad_field_weights[: self.n_fields]]
        if cfg.field_start_epochs is not None:
            for k, e0 in enumerate(
                    cfg.field_start_epochs[: self.n_fields]):
                if epoch < cfg.lstart + int(e0):
                    fw[k] = 0.0
        return fw

    def optimize_parameters(self, epoch: int, freq: float | None = None,
                            tether_stage: int | None = None):
        cfg = self.cfg
        fc = freq if freq is not None else (
            cfg.freq_stages[0] if cfg.freq_stages else 0.0)
        nsub = cfg.shots_per_iter or self.n_shots
        self._rng, s1, s2 = jax.random.split(self._rng, 3)
        # random shot subset per iteration (AutoElMar22_model.py:512),
        # drawn from the training pool (excludes any held-out shots)
        pool = self._train_pool
        nsub = min(nsub, int(pool.shape[0]))
        idx = pool[jax.random.permutation(s1, pool.shape[0])[:nsub]]
        use_physics = epoch > cfg.lstart
        if (use_physics and cfg.lstart > 0 and cfg.phase_reset_opt
                and not self._phase_reset_done):
            # fresh optimizer at the warmup->physics switch: the
            # reference resumed its physics phase from a pretrained
            # checkpoint with a NEW optimizer
            # (trainVelAutoElMar22ModelPhy.sh --continue_train); a
            # carried-over Adam state has near-zero second moments
            # from the converged anchor loss plus a stale timestep,
            # so its first physics steps are several times oversized
            self.opt_state = self.opt.init(self.params)
            self._phase_reset_done = True
        if self.lr_policy is not None:
            lr = self.lr_policy.lr_for_epoch(epoch)
            if use_physics and cfg.phase_lr_ramp > 0:
                # linear lr ramp over the first physics epochs
                lr *= min(1.0, (epoch - cfg.lstart) / cfg.phase_lr_ramp)
            if (use_physics and cfg.guard_lr_ramp > 0
                    and self._guard_ramp_from is not None):
                # same ramp after each drift-guard revert: the revert
                # re-initialized Adam, so the first steps are the
                # catapult-prone ones
                k = epoch - self._guard_ramp_from
                if k < cfg.guard_lr_ramp:
                    lr *= (k + 1) / cfg.guard_lr_ramp
            _set_lr(self.opt_state, lr)
        step = self._get_step()
        stage_i = (cfg.freq_stages.index(fc)
                   if cfg.freq_stages and fc in cfg.freq_stages else 0)
        if tether_stage is not None:
            # train.py passes stage + post-final-stage anneal count
            # when cfg.tether_anneal_plateaus > 0
            stage_i = tether_stage
        tw = cfg.tether_weight * cfg.tether_decay ** stage_i
        tether_m = self.lowf[0]
        if cfg.tether_weight > 0 and cfg.tether_mode == "stage":
            # trailing (proximal) tether: pull toward the model
            # snapshot at the start of the current segment.  Each
            # segment's displacement is bounded like the fixed tether
            # bounds it, but the reference follows locked-in progress,
            # so continuation can descend arbitrarily far while
            # null-space drift is re-zeroed per segment — the
            # seed-robust flagship recipe (docs/RESULTS.md round 5).
            if use_physics:
                refresh = (self._tether_ref is None
                           or stage_i != self._tether_stage_i
                           or (cfg.tether_refresh_epochs > 0
                               and epoch - self._tether_epoch
                               >= cfg.tether_refresh_epochs))
                if refresh:
                    self._tether_ref = self._sample_model(self.params)[0]
                    self._tether_stage_i = stage_i
                    self._tether_epoch = epoch
                tether_m = self._tether_ref
        phys = dict(self._stage_pack(fc),
                    fw=jnp.asarray(self._field_weights(epoch),
                                   jnp.float32),
                    tw=jnp.float32(tw), lowf_m=tether_m)
        if cfg.grad_illum_eps > 0:
            phys["ilw"] = self._illum_weight()
        cap = cfg.step_cap
        if (cfg.step_cap > 0 and cfg.freq_stages
                and stage_i == len(cfg.freq_stages) - 1):
            # final continuation stage: step_cap_final (-1 = keep,
            # 0 = effectively uncapped, >0 = that value)
            if cfg.step_cap_final == 0:
                cap = 1e9
            elif cfg.step_cap_final > 0:
                cap = cfg.step_cap_final
        pack = {"in_vx": self.in_vx, "in_vz": self.in_vz,
                "lowf": self.lowf, "true_m": self.true_m,
                "cap": jnp.float32(cap), "phys": phys}
        self.params, self.opt_state, loss, loss_d, mse = step(
            self.params, self.opt_state, idx, s2, use_physics, pack)
        loss_d, mse = map(float, jax.device_get((loss_d, mse)))
        out = {"loss_D_MSE": loss_d, "loss_M_MSE": mse}
        if (self._holdout_idx is not None and use_physics
                and epoch % max(cfg.holdout_every, 1) == 0):
            out["loss_H"] = self.holdout_misfit(fc)
        if self.lr_policy is not None:
            if use_physics:
                out["lr"] = self.lr_policy.after_epoch(loss_d)
            else:
                # warmup's constant-zero loss_d must not feed the
                # plateau lr controller (same race as the freq-stage
                # detector, train.py)
                out["lr"] = self.lr_policy.lr
        return out

    def holdout_misfit(self, fc=None) -> float:
        """cfg.misfit on the held-out shots at continuation stage
        ``fc`` — the unsupervised early-stopping metric (loss_H).
        The held-out gathers never enter a training gradient, so this
        is what a real user (no ground-truth model) watches instead
        of the oracle model-MSE the per-iteration train misfit cannot
        substitute for (trace-normalized misfits admit data-consistent
        drift, docs/RESULTS.md)."""
        if self._holdout_idx is None:
            raise ValueError("holdout_misfit needs cfg.holdout_shots>0")
        if "holdout" not in self._step_cache:
            hidx = self._holdout_idx
            raw = self._physics_loss_raw
            self._step_cache["holdout"] = jax.jit(
                lambda m, pd: raw(m, hidx, pd))
        wav, ovx, ovz = self._stage_data(fc)
        m = self._sample_model(self.params)[0]
        return float(self._step_cache["holdout"](
            m, {"wav": wav, "ovx": ovx, "ovz": ovz}))

    def guard_revert(self, params, epoch: int):
        """Drift-guard revert (cfg.guard_patience, train.py): restore
        the best-held-out-misfit parameter snapshot with a FRESH
        optimizer (the catapult mechanism is a stale Adam second
        moment — phase_reset_opt rationale) and start the post-revert
        lr ramp.  The trailing-tether reference, if any, is reset so
        the next segment anchors at the restored model."""
        self.params = params
        self.opt_state = self.opt.init(params)
        self._guard_ramp_from = epoch
        self._tether_ref = None

    def _sample_model(self, params, rng=None):
        """One deterministic (rng=None) or dropout-sampled model from
        the decoder, as a single jitted program over argument data."""
        if not hasattr(self, "_sample_step"):
            cfg = self.cfg

            def sample_step(params, key, det: bool, pack):
                rngs = None if det else {"dropout": key}
                deltas, _ = self.net.apply(params, pack["in_vx"],
                                           pack["in_vz"],
                                           deterministic=det, rngs=rngs)
                m = apply_elastic_output(
                    deltas, pack["lowf"], pack["true_m"],
                    delta_scale=self.delta_scale,
                    clip_min=self.clip_min, clip_max=self.clip_max,
                    pin_rows=cfg.water_rows, clip_mode=cfg.clip_mode)
                return m

            self._sample_step = jax.jit(sample_step,
                                        static_argnames=("det",))
        pack = {"in_vx": self.in_vx, "in_vz": self.in_vz,
                "lowf": self.lowf, "true_m": self.true_m}
        key = rng if rng is not None else jax.random.PRNGKey(0)
        return self._sample_step(params, key, rng is None, pack)

    def test(self, *, rng=None):
        m = self._sample_model(self.params, rng)
        mse = float(jnp.mean((m - self.true_m) ** 2))
        return {"loss_V_MSE": mse}, np.asarray(m[0])

    def mc_realizations(self, n: int, seed: int = 0):
        """MC-dropout posterior sampling (test4d.py:69-79
        --realization loop): returns stacked model samples.

        One jit-compiled vmap over dropout keys — the whole ensemble
        runs as a single device program instead of n host round
        trips."""
        keys = jax.random.split(jax.random.PRNGKey(seed), n)
        pack = {"in_vx": self.in_vx, "in_vz": self.in_vz,
                "lowf": self.lowf, "true_m": self.true_m}
        if not hasattr(self, "_mc_ensemble"):
            cfg = self.cfg

            def ensemble(params, keys, pack):
                def sample(key):
                    deltas, _ = self.net.apply(
                        params, pack["in_vx"], pack["in_vz"],
                        deterministic=False, rngs={"dropout": key})
                    m = apply_elastic_output(
                        deltas, pack["lowf"], pack["true_m"],
                        delta_scale=self.delta_scale,
                        clip_min=self.clip_min,
                        clip_max=self.clip_max,
                        pin_rows=cfg.water_rows,
                        clip_mode=cfg.clip_mode)
                    return m[0]

                return jax.vmap(sample)(keys)

            # cached on the engine: a fresh @jax.jit per call would
            # defeat the jit cache and re-trace every invocation
            self._mc_ensemble = jax.jit(ensemble)
        return np.asarray(self._mc_ensemble(self.params, keys, pack))


# ---------------------------------------------------------------------------
# classic FWI (no net) — AutoEl22N capability
# ---------------------------------------------------------------------------

class ClassicFWIEngine(EngineBase):
    """The model grids ARE the parameters (ref AutoEl22N via
    define_G1, networks.py:6477-6520: tensors loaded from trainC with
    requires_grad=True; the same training loop then performs plain
    adjoint FWI).  Acoustic workloads invert vp; elastic workloads
    (dataset_mode unalignedVelABCDEl) run the elastic P-SV physics
    and invert vp + vs starting from the low-frequency model, with
    rho held at the low-frequency model (networks.py:7458)."""

    def __init__(self, cfg: ExperimentConfig, workload=None):
        self.cfg = cfg
        self.is_elastic = cfg.dataset_mode.lower().endswith("el")
        self.lr_policy = LrPolicy(cfg) if cfg.optimizer == "adam" else None
        if self.is_elastic:
            self._init_elastic(workload)
        else:
            self._init_acoustic(workload)

    def _init_acoustic(self, workload):
        cfg = self.cfg
        self.wl = workload or SyntheticAcousticWorkload.build(
            nz=cfg.nz, nx=cfg.nx, dx=cfg.dx, nt=cfg.nt, dt=cfg.dt,
            pml_width=cfg.pml_width, freq=cfg.freq,
            num_shots=cfg.num_shots, num_receivers=cfg.num_receivers,
            seed=cfg.seed, chunk=cfg.chunk)
        self.params = {"vp": self.wl.vp_start}
        self.opt = _make_optimizer(cfg)
        self.opt_state = self.opt.init(self.params)

        wl = self.wl
        _, sim = select_operator("acoustic", cfg.backend)
        mis = l1_misfit if cfg.misfit == "l1" else l2_misfit
        # observed data rides as a step ARGUMENT (see
        # AcousticDIPEngine._make_physics_loss for the HLO-constant
        # rationale)
        self._pd = {"obs_norm": wl.obs_norm}

        def loss_fn(params, pd):
            pred = sim(params["vp"], wl.wavelet, *wl.geom, wl.cfg)
            return mis(trace_normalize(pred), pd["obs_norm"])

        @jax.jit
        def train_step(params, opt_state, pd):
            loss, grads = jax.value_and_grad(loss_fn)(params, pd)
            g = water_mask(grads["vp"], wl.vp_true, cfg.water_vel)
            g = depth_weighting(g, 2.0)
            grads = {"vp": g}
            if cfg.optimizer == "lbfgs":
                updates, opt_state = self.opt.update(
                    grads, opt_state, params, value=loss, grad=grads,
                    value_fn=lambda p: loss_fn(p, pd))
            else:
                updates, opt_state = self.opt.update(grads, opt_state,
                                                     params)
            params = optax.apply_updates(params, updates)
            params = {"vp": jnp.clip(params["vp"], 1490.0, 4700.0)}
            mse = jnp.mean((params["vp"] - wl.vp_true) ** 2)
            return params, opt_state, loss, mse

        self._train_step = train_step

    def _init_elastic(self, workload):
        cfg = self.cfg
        if workload is None and cfg.dataroot:
            from physicsbasedfwi2_tpu.data.synthetic import (
                elastic_workload_from_disk)
            workload = elastic_workload_from_disk(
                cfg.dataroot, nz=cfg.nz, nx=cfg.nx, dx=cfg.dx,
                nt=cfg.nt, dt=cfg.dt, pml_width=cfg.pml_width,
                freq=cfg.freq, free_surface=cfg.free_surface,
                chunk=cfg.chunk, water_rows=cfg.water_rows,
                src_depth_row=cfg.extras.get("src_depth_row"),
                rcv_depth_row=cfg.extras.get("rcv_depth_row"),
                rcv_follow_seabed=cfg.extras.get("rcv_follow_seabed",
                                                 False))
        self.wl = workload or SyntheticElasticWorkload.build(
            nz=cfg.nz, nx=cfg.nx, dx=cfg.dx, nt=cfg.nt, dt=cfg.dt,
            pml_width=cfg.pml_width, freq=cfg.freq,
            num_shots=cfg.num_shots, num_receivers=cfg.num_receivers,
            seed=cfg.seed, chunk=cfg.chunk,
            free_surface=cfg.free_surface, water_rows=cfg.water_rows)
        wl = self.wl
        path, sim = select_operator("elastic", cfg.backend)
        if path != "reference" and not getattr(wl, "from_disk", False):
            # regenerate the reference-scheme synthetic gathers with
            # the inversion operator (see ElasticDIPEngine)
            wl.obs_vx, wl.obs_vz = sim(
                wl.true["vp"], wl.true["vs"], wl.true["rho"],
                wl.wavelet, *wl.geom, wl.cfg)
        self.params = {"vp": wl.start["vp"], "vs": wl.start["vs"]}
        self.opt = _make_optimizer(cfg)
        self.opt_state = self.opt.init(self.params)
        # sample from the workload's actual shot count (a dataroot may
        # carry a different gather count than the registered config)
        self.n_shots = int(wl.geom[0].shape[0])
        nsub = cfg.shots_per_iter or self.n_shots
        # observed gathers enter the step as an argument pytree —
        # at reference scale (35 shots x 5 s x 298 rcv x 2 comps)
        # closing over them would serialize ~280 MB into the HLO
        self._pd = {"ovx": wl.obs_vx, "ovz": wl.obs_vz}

        def loss_fn(params, shot_idx, pd):
            sz = wl.geom[0][shot_idx]
            sx = wl.geom[1][shot_idx]
            rz = wl.geom[2][shot_idx]
            rx = wl.geom[3][shot_idx]
            pvx, pvz = sim(
                params["vp"], params["vs"], wl.start["rho"], wl.wavelet,
                sz, sx, rz, rx, wl.cfg)
            return (jnp.mean((pvx - pd["ovx"][shot_idx]) ** 2)
                    + jnp.mean((pvz - pd["ovz"][shot_idx]) ** 2))

        @jax.jit
        def train_step(params, opt_state, shot_idx, pd):
            loss, grads = jax.value_and_grad(loss_fn)(params, shot_idx,
                                                      pd)
            # DENISE-style post-processing: water rows zeroed, grads
            # rescaled to model magnitude (networks.py:7808-7862)
            grads = {k: rescale_to_model(taper_top(g, cfg.water_rows),
                                         params[k])
                     for k, g in grads.items()}
            if cfg.optimizer == "lbfgs":
                updates, opt_state = self.opt.update(
                    grads, opt_state, params, value=loss, grad=grads,
                    value_fn=lambda p: loss_fn(p, shot_idx, pd))
            else:
                updates, opt_state = self.opt.update(grads, opt_state,
                                                     params)
            params = optax.apply_updates(params, updates)
            params = {"vp": jnp.clip(params["vp"], 1490.0, 4700.0),
                      "vs": jnp.clip(params["vs"], 0.0, 2700.0)}
            mse = (jnp.mean((params["vp"] - wl.true["vp"]) ** 2)
                   + jnp.mean((params["vs"] - wl.true["vs"]) ** 2))
            return params, opt_state, loss, mse

        self._train_step_el = train_step
        self._nsub = nsub
        self._rng = jax.random.PRNGKey(cfg.seed + 11)

    def optimize_parameters(self, epoch: int, freq: float | None = None,
                            tether_stage: int | None = None):
        # tether_stage accepted for train.py API symmetry; classic FWI
        # optimizes pixels directly and carries no lowf tether
        if self.lr_policy is not None:
            _set_lr(self.opt_state, self.lr_policy.lr_for_epoch(epoch))
        if self.is_elastic:
            self._rng, sub = jax.random.split(self._rng)
            idx = jax.random.permutation(
                sub, self.n_shots)[: self._nsub]
            self.params, self.opt_state, loss, mse = self._train_step_el(
                self.params, self.opt_state, idx, self._pd)
        else:
            self.params, self.opt_state, loss, mse = self._train_step(
                self.params, self.opt_state, self._pd)
        loss, mse = map(float, jax.device_get((loss, mse)))
        out = {"loss_D_MSE": loss, "loss_M_MSE": mse}
        if self.lr_policy is not None:
            out["lr"] = self.lr_policy.after_epoch(loss)
        return out

    def test(self):
        if self.is_elastic:
            mse = float(
                jnp.mean((self.params["vp"] - self.wl.true["vp"]) ** 2)
                + jnp.mean((self.params["vs"] - self.wl.true["vs"]) ** 2))
            m = np.stack([np.asarray(self.params["vp"]),
                          np.asarray(self.params["vs"])], -1)
            return {"loss_V_MSE": mse}, m
        mse = float(jnp.mean((self.params["vp"] - self.wl.vp_true) ** 2))
        return {"loss_V_MSE": mse}, np.asarray(self.params["vp"])


# ---------------------------------------------------------------------------
# latent-space inversion — VaeLatent2NoPhy capability
# ---------------------------------------------------------------------------

class LatentInversionEngine(EngineBase):
    """Frozen decoder; optimize the latent through the propagator
    (VaeLatent2NoPhy_model.py:395-560).  The reference mutates model
    pixels with an inner Adam(lr=10); this engine optimizes
    the latent directly through decoder + propagator in one graph."""

    def __init__(self, cfg: ExperimentConfig, workload=None,
                 decoder_params=None, decoder_net=None,
                 decoder_norm=None):
        """decoder_net/decoder_params/decoder_norm: a pretrained
        model-domain VAE from engine.pretrain.pretrain_model_vae (the
        VaeNoPhy/Vaevel stage); decoder_norm = (vmin, vmax) maps the
        decoder's [0,1] output to velocities.  Without them a fresh
        (random) VaeNet decoder is used."""
        from physicsbasedfwi2_tpu.models import VaeNet
        self.cfg = cfg
        if workload is None and cfg.dataroot:
            # the reference's latent workload consumed real npy data
            # (unalignedVelLatent2_dataset.py; VaeLatent2NoPhy_model
            # .py:395-560)
            from physicsbasedfwi2_tpu.data.synthetic import (
                latent_workload_from_disk)
            workload = latent_workload_from_disk(
                cfg.dataroot, nz=cfg.nz, nx=cfg.nx, dx=cfg.dx,
                nt=cfg.nt, dt=cfg.dt, pml_width=cfg.pml_width,
                freq=cfg.freq, chunk=cfg.chunk,
                sample=int(cfg.extras.get("latent_sample", 0)))
        self.wl = workload or SyntheticAcousticWorkload.build(
            nz=cfg.nz, nx=cfg.nx, dx=cfg.dx, nt=cfg.nt, dt=cfg.dt,
            pml_width=cfg.pml_width, freq=cfg.freq,
            num_shots=cfg.num_shots, num_receivers=cfg.num_receivers,
            seed=cfg.seed, chunk=cfg.chunk)
        shots_in = jnp.transpose(self.wl.obs, (1, 2, 0))[None]
        self.shots_in = shots_in
        if decoder_net is not None:
            if decoder_params is None:
                raise ValueError("decoder_net requires decoder_params")
            self.net = decoder_net
            self.decoder_params = decoder_params
        else:
            self.net = VaeNet(out_shape=(cfg.nz, cfg.nx),
                              latent_dim=cfg.latent_dim,
                              filters=cfg.filters)
            full = self.net.init(
                {"params": jax.random.PRNGKey(cfg.seed),
                 "latent": jax.random.PRNGKey(1)}, shots_in)
            self.decoder_params = decoder_params or full
        latent_dim = getattr(self.net, "latent_dim", cfg.latent_dim)
        self.z = jnp.zeros((1, latent_dim))
        self.opt = _make_optimizer(cfg)
        self.opt_state = self.opt.init(self.z)
        self.lr_policy = LrPolicy(cfg) if cfg.optimizer == "adam" else None
        self.decoder_norm = decoder_norm
        wl, ccfg = self.wl, cfg
        _, sim = select_operator("acoustic", cfg.backend)
        vmin, vmax = decoder_norm if decoder_norm is not None else (
            None, None)

        # decoder weights + observed data as step arguments (frozen
        # params are data here, not code — same HLO-constant rule)
        self._pd = {"dec": self.decoder_params, "obs_norm": wl.obs_norm,
                    "vp_true": wl.vp_true}

        def loss_fn(z, pd):
            f01 = self.net.apply(pd["dec"], z, method=self.net.decode)
            vp = apply_velocity_output(f01,
                                       pd["vp_true"][None, :, :, None],
                                       vmin=vmin, vmax=vmax,
                                       water_vel=ccfg.water_vel)[0, :, :, 0]
            pred = sim(vp, wl.wavelet, *wl.geom, wl.cfg)
            mis = l1_misfit if ccfg.misfit == "l1" else l2_misfit
            return mis(trace_normalize(pred), pd["obs_norm"]), vp

        @jax.jit
        def train_step(z, opt_state, pd):
            (loss, vp), g = jax.value_and_grad(loss_fn, has_aux=True)(
                z, pd)
            updates, opt_state = self.opt.update(g, opt_state)
            mse = jnp.mean((vp - pd["vp_true"]) ** 2)
            return optax.apply_updates(z, updates), opt_state, loss, mse

        self._train_step = train_step

    def optimize_parameters(self, epoch: int):
        if self.lr_policy is not None:
            _set_lr(self.opt_state, self.lr_policy.lr_for_epoch(epoch))
        self.z, self.opt_state, loss, mse = self._train_step(
            self.z, self.opt_state, self._pd)
        loss, mse = map(float, jax.device_get((loss, mse)))
        out = {"loss_D_MSE": loss, "loss_M_MSE": mse}
        if self.lr_policy is not None:
            out["lr"] = self.lr_policy.after_epoch(loss)
        return out

    def test(self):
        vmin, vmax = self.decoder_norm if self.decoder_norm is not None \
            else (None, None)
        f01 = self.net.apply(self.decoder_params, self.z,
                             method=self.net.decode)
        vp = apply_velocity_output(
            f01, self.wl.vp_true[None, :, :, None],
            vmin=vmin, vmax=vmax)[0, :, :, 0]
        mse = float(jnp.mean((vp - self.wl.vp_true) ** 2))
        return {"loss_V_MSE": mse}, np.asarray(vp)


# ---------------------------------------------------------------------------
# supervised / GAN baseline engine (pix2pix2 / unetSSIMAC capability)
# ---------------------------------------------------------------------------

class SupervisedEngine(EngineBase):
    """Image-to-image baselines: L1 (+GAN, +SSIM) supervised training
    (pix2pix2_model.py:110-126, unetSSIMAC_model.py:109-131,
    pix2pix2SSIM_model.py:76-81)."""

    def __init__(self, cfg: ExperimentConfig, in_shape=(128, 128),
                 in_channels=1, out_channels=1):
        from physicsbasedfwi2_tpu.models import (
            define_discriminator, gan_loss)
        from physicsbasedfwi2_tpu.ops.ssim import ssim
        self.cfg = cfg
        self.gan_mode = cfg.extras.get("gan_mode", "lsgan")
        self.lambda_l1 = cfg.extras.get("lambda_l1", 10.0)
        self.ssim_window = cfg.extras.get("ssim_window", 0)
        self.net = define_generator(cfg.netG, out_shape=None,
                                    out_channels=out_channels,
                                    filters=(16, 32, 64))
        x = jnp.zeros((1, *in_shape, in_channels))
        self.params = self.net.init(jax.random.PRNGKey(cfg.seed), x)
        self.opt = _make_optimizer(cfg)
        self.opt_state = self.opt.init(self.params)
        self.lr_policy = LrPolicy(cfg)
        self._epoch = 0
        self.use_gan = self.gan_mode != "none"
        if self.use_gan:
            self.disc = define_discriminator("n_layers", base=32,
                                             n_layers=3)
            xy = jnp.zeros((1, *in_shape, in_channels + out_channels))
            self.d_params = self.disc.init(jax.random.PRNGKey(1), xy)
            self.d_opt = optax.adam(cfg.lr, b1=cfg.beta1)
            self.d_opt_state = self.d_opt.init(self.d_params)
        self._gan_loss = gan_loss
        self._ssim = ssim
        self._build()

    def _build(self):
        cfg = self.cfg

        def g_loss(params, d_params, a, b):
            fake, _ = self.net.apply(params, a)
            loss = self.lambda_l1 * jnp.mean(jnp.abs(fake - b))
            if self.ssim_window:
                loss = loss + (1.0 - self._ssim(
                    fake, b, window_size=self.ssim_window))
            if self.use_gan:
                pred = self.disc.apply(d_params,
                                       jnp.concatenate([a, fake], -1))
                loss = loss + self._gan_loss(pred, True, self.gan_mode)
            return loss, fake

        @jax.jit
        def g_step(params, opt_state, d_params, a, b):
            (loss, fake), grads = jax.value_and_grad(
                g_loss, has_aux=True)(params, d_params, a, b)
            updates, opt_state = self.opt.update(grads, opt_state)
            return optax.apply_updates(params, updates), opt_state, loss, fake

        self._g_step = g_step

        if self.use_gan:
            def d_loss(d_params, a, b, fake):
                pr = self.disc.apply(d_params, jnp.concatenate([a, b], -1))
                pf = self.disc.apply(d_params,
                                     jnp.concatenate([a, fake], -1))
                return 0.5 * (self._gan_loss(pr, True, self.gan_mode)
                              + self._gan_loss(pf, False, self.gan_mode))

            @jax.jit
            def d_step(d_params, d_opt_state, a, b, fake):
                loss, grads = jax.value_and_grad(d_loss)(d_params, a, b,
                                                         fake)
                updates, d_opt_state = self.d_opt.update(grads, d_opt_state)
                return (optax.apply_updates(d_params, updates),
                        d_opt_state, loss)

            self._d_step = d_step

    def optimize_parameters(self, a, b, epoch: int | None = None):
        self._epoch = epoch if epoch is not None else self._epoch + 1
        _set_lr(self.opt_state, self.lr_policy.lr_for_epoch(self._epoch))
        d_params = self.d_params if self.use_gan else None
        self.params, self.opt_state, gl, fake = self._g_step(
            self.params, self.opt_state, d_params, a, b)
        if self.use_gan:
            self.d_params, self.d_opt_state, dl = self._d_step(
                self.d_params, self.d_opt_state, a, b,
                jax.lax.stop_gradient(fake))
            gl, dl = map(float, jax.device_get((gl, dl)))
            return {"loss_G": gl, "loss_D": dl, "lr": self.lr_policy.lr}
        return {"loss_G": float(gl), "lr": self.lr_policy.lr}

    def test(self, a, b):
        fake, _ = self.net.apply(self.params, a)
        return {"loss_V_L1": float(jnp.mean(jnp.abs(fake - b)))}, \
            np.asarray(fake)


# ---------------------------------------------------------------------------
# impedance-synthetic engine — BASELINE config 1's Auto2 capability
# ---------------------------------------------------------------------------

class ImpedanceDIPEngine(EngineBase):
    """Deep-image-prior inversion through the impedance convolutional
    forward model (Auto2_model.py:240-342): the generator maps the
    observed post-stack section to a velocity model; reflectivity =
    (Zp2-Zp1)/(Zp2+Zp1) convolved with a Ricker wavelet gives the
    synthetic, L1 against the data.  Fully differentiable — no
    custom VJP needed (conv1d + elementwise ops)."""

    def __init__(self, cfg: ExperimentConfig, workload=None):
        from physicsbasedfwi2_tpu.ops.impedance import impedance_synthetic
        self.cfg = cfg
        self.wl = workload or SyntheticAcousticWorkload.build(
            nz=cfg.nz, nx=cfg.nx, dx=cfg.dx, nt=max(cfg.nt, 64),
            dt=cfg.dt, pml_width=cfg.pml_width, freq=cfg.freq,
            num_shots=max(cfg.num_shots, 1),
            num_receivers=cfg.num_receivers, seed=cfg.seed,
            chunk=cfg.chunk)
        wfreq = cfg.extras.get("impedance_freq", 20.0)
        wdt = cfg.extras.get("impedance_dt", 2e-3)
        nwav = cfg.extras.get("impedance_nwav", 100)
        self._synth = lambda vp: impedance_synthetic(
            vp, freq=wfreq, n_wavelet=nwav, dt=wdt, axis=-2)
        # observed post-stack section = synthetic of the true model
        # (the reference's trainA for Auto2 was prepared that way)
        vp_true = self.wl.vp_true
        self.obs_stack = self._synth(vp_true[None, :, :, None])
        self.net = define_generator(
            cfg.netG, out_shape=(cfg.nz, cfg.nx),
            latent_dim=cfg.latent_dim, filters=cfg.filters,
            time_decimation=1)
        self.params = self.net.init(jax.random.PRNGKey(cfg.seed),
                                    self.obs_stack)
        self.opt = _make_optimizer(cfg)
        self.opt_state = self.opt.init(self.params)
        self.lr_policy = LrPolicy(cfg) if cfg.optimizer == "adam" else None
        mis = l1_misfit if cfg.misfit == "l1" else l2_misfit
        self._pack = {"obs_stack": self.obs_stack,
                      "true_b": vp_true[None, :, :, None],
                      "vp_true": vp_true}

        def total_loss(params, pack):
            from physicsbasedfwi2_tpu.models import pack_output
            out = pack_output(self.net.apply(params, pack["obs_stack"]))
            vp = apply_velocity_output(out.field, pack["true_b"],
                                       water_vel=cfg.water_vel)
            loss = mis(self._synth(vp), pack["obs_stack"])
            mse = jnp.mean((vp[0, :, :, 0] - pack["vp_true"]) ** 2)
            return loss, mse

        @jax.jit
        def train_step(params, opt_state, pack):
            (loss, mse), grads = jax.value_and_grad(
                total_loss, has_aux=True)(params, pack)
            updates, opt_state = self.opt.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            return params, opt_state, loss, mse

        self._train_step = train_step

    def optimize_parameters(self, epoch: int):
        if self.lr_policy is not None:
            _set_lr(self.opt_state, self.lr_policy.lr_for_epoch(epoch))
        self.params, self.opt_state, loss, mse = self._train_step(
            self.params, self.opt_state, self._pack)
        loss, mse = map(float, jax.device_get((loss, mse)))
        out = {"loss_D_MSE": loss, "loss_M_MSE": mse}
        if self.lr_policy is not None:
            out["lr"] = self.lr_policy.after_epoch(loss)
        return out

    def test(self):
        from physicsbasedfwi2_tpu.models import pack_output
        out = pack_output(self.net.apply(self.params, self.obs_stack))
        vp = apply_velocity_output(
            out.field, self.wl.vp_true[None, :, :, None],
            water_vel=self.cfg.water_vel)[0, :, :, 0]
        mse = float(jnp.mean((vp - self.wl.vp_true) ** 2))
        return {"loss_V_MSE": mse}, np.asarray(vp)


_ENGINES = {
    "acoustic_dip": AcousticDIPEngine,
    "acoustic_dip_multi": MultiSampleAcousticDIPEngine,
    "elastic_dip": ElasticDIPEngine,
    "classic_fwi": ClassicFWIEngine,
    "latent_inversion": LatentInversionEngine,
    "supervised": SupervisedEngine,
    "impedance_dip": ImpedanceDIPEngine,
}


def create_engine(cfg: ExperimentConfig, **kw):
    """Factory (reference models/__init__.py:54-67 create_model)."""
    return _ENGINES[cfg.engine](cfg, **kw)
