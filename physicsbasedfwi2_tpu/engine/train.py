"""Training driver.

Capability-equivalent of trainValLatent4dVel2.py (acoustic, lines
31-149) and trainValLatent4dVel2Elastic.py (elastic + frequency
continuation, lines 49-160): epoch loop with validation, per-epoch
aggregated losses, loss-plateau frequency-stage advance, periodic
checkpointing, wall-clock metrics.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import time

from physicsbasedfwi2_tpu.engine.config import (
    ExperimentConfig, get_workload, list_workloads,
)
from physicsbasedfwi2_tpu.engine.engines import create_engine
from physicsbasedfwi2_tpu.engine.visualizer import Visualizer


class PlateauDetector:
    """Frequency-continuation plateau detector.

    mode="range" is the reference's shift-register
    (trainValLatent4dVel2Elastic.py:136-146): advance when the
    relative spread of the last N losses drops below eps.  Its 5e-10
    eps never fires on real SGD loss scales (the random 5-shot subset
    makes per-epoch losses jitter at the percent level), which is why
    the reference's detector — pointed at a one-element freqL=[20] —
    was vestigial in practice.

    mode="improve" compares the median of the current window against
    the median of the previous window: advance when the relative
    improvement falls below eps.  Medians are robust to the
    shot-subset jitter, so a percent-level eps is meaningful.

    stage_max_epochs > 0 force-advances after that many epochs in the
    stage regardless (the DENISE practice of a fixed iteration budget
    per fc stage)."""

    def __init__(self, history: int = 5, eps: float = 5e-10,
                 mode: str = "range", stage_max_epochs: int = 0):
        self.hist = collections.deque(maxlen=2 * history
                                      if mode == "improve" else history)
        self.window = history
        self.eps = eps
        self.mode = mode
        self.stage_max_epochs = stage_max_epochs
        self.epochs_in_stage = 0

    def _advance(self) -> bool:
        self.hist.clear()
        self.epochs_in_stage = 0
        return True

    def update(self, loss: float) -> bool:
        self.hist.append(loss)
        self.epochs_in_stage += 1
        if (self.stage_max_epochs
                and self.epochs_in_stage >= self.stage_max_epochs):
            return self._advance()
        if len(self.hist) < self.hist.maxlen:
            return False
        h = list(self.hist)
        if self.mode == "improve":
            def median(xs):
                xs = sorted(xs)
                n = len(xs)
                return (xs[n // 2] if n % 2 else
                        0.5 * (xs[n // 2 - 1] + xs[n // 2]))
            prev, cur = median(h[: self.window]), median(h[self.window:])
            rel = (prev - cur) / (abs(prev) + 1e-30)
            if rel <= self.eps:
                return self._advance()
            return False
        lo, hi = min(h), max(h)
        rel = (hi - lo) / (abs(hi) + 1e-30)
        if rel <= self.eps:
            return self._advance()
        return False


def _prep_img(x):
    """[B?, H, W(, C)] float array -> NHWC."""
    import numpy as np
    x = np.asarray(x, np.float32)
    return x[..., None] if x.ndim in (2, 3) else x


def train_supervised(cfg: ExperimentConfig, *, epochs: int | None = None,
                     quiet: bool = False):
    """Batch/epoch data loop for the supervised & GAN baselines —
    the reference's train4d.py/trainVal4d.py role: iterate dataset
    batches through SupervisedEngine, validate on the test twin.

    Returns (engine, history)."""
    import jax.numpy as jnp
    import numpy as np
    from physicsbasedfwi2_tpu.data.npy_datasets import create_dataset

    if not cfg.dataroot:
        raise ValueError(
            "supervised workloads need --dataroot (an npy tree with "
            f"{cfg.dataset_mode}'s letter directories)")
    ds = create_dataset(cfg.dataroot, cfg.dataset_mode)
    item0 = ds[0]
    letters = [L for L in "ABCDE" if L in item0]
    if len(letters) < 2:
        raise ValueError(f"need input+target dirs, found {letters}")
    # first letter = input, second = target; any FURTHER letters
    # (e.g. unalignedBDE2's E) concatenate onto the input channels —
    # the reference registered the 3-letter dataset but left E
    # unconsumed by every model (no model sets that dataset_mode)
    la, lb = letters[0], letters[1]
    extra = letters[2:]

    def prep_in(item):
        import numpy as np
        parts = [_prep_img(item[la])] + [_prep_img(item[L])
                                         for L in extra]
        return parts[0] if not extra else np.concatenate(parts, -1)

    a0, b0 = prep_in(item0), _prep_img(item0[lb])
    engine = create_engine(cfg, in_shape=a0.shape[:2],
                           in_channels=a0.shape[-1],
                           out_channels=b0.shape[-1])
    need = {la, lb, *extra}
    try:
        ds_val = create_dataset(cfg.dataroot, cfg.dataset_mode,
                                phase="test")
        if len(ds_val) == 0 or not need <= set(ds_val[0]):
            ds_val = None  # twin missing (or missing a needed letter)
    except (FileNotFoundError, OSError):
        ds_val = None
    viz = Visualizer(cfg)
    viz.dump_config(cfg)
    epochs = epochs if epochs is not None else cfg.n_epochs
    history = []
    flip = bool(cfg.extras.get("flip", False))
    for epoch in range(1, epochs + 1):
        t0 = time.time()
        agg = collections.defaultdict(float)
        nb = 0
        for batch in ds.batches(cfg.batch_size, seed=cfg.seed + epoch,
                                flip=flip):
            a = jnp.asarray(prep_in(batch))
            b = jnp.asarray(_prep_img(batch[lb]))
            losses = engine.optimize_parameters(a, b, epoch=epoch)
            for k, v in losses.items():
                agg[k] += v
            nb += 1
        rec = {"epoch": epoch,
               **{k: v / max(nb, 1) for k, v in agg.items()},
               "epoch_time": time.time() - t0}
        if ds_val is not None:
            it = ds_val[0]
            va = jnp.asarray(prep_in(it)[None])
            vb = jnp.asarray(_prep_img(it[lb])[None])
            val, _ = engine.test(va, vb)
            rec.update(val)
        history.append(rec)
        viz.log_epoch(rec)
        if epoch % cfg.save_epoch_freq == 0 or epoch == epochs:
            engine.save_networks(epoch)
            engine.save_networks("latest")
    return engine, history


def train(cfg: ExperimentConfig, *, epochs: int | None = None,
          iters_per_epoch: int = 1, workload=None, quiet: bool = False,
          continue_from: str | int | None = None, start_epoch: int = 1,
          profile_dir: str | None = None, profile_epochs: int = 0,
          engine=None):
    """Run the training loop; returns (engine, history).

    continue_from: checkpoint tag to resume weights from
        (the reference's --continue_train --epoch N,
        base_options.py:53-54).
    profile_dir: capture a jax.profiler trace of the first
        ``profile_epochs`` epochs (the reference only had wall-clock
        prints; this is the upgrade SURVEY §5 tracing asks for).
    engine: drive a pre-built engine instead of create_engine(cfg)
        (programmatic/test use).

    Supervised/GAN workloads (engine == 'supervised') route to the
    batch/epoch data loop (:func:`train_supervised`).
    """
    if cfg.engine == "supervised":
        return train_supervised(cfg, epochs=epochs, quiet=quiet)
    if engine is None:
        engine = create_engine(cfg, workload=workload) \
            if workload is not None else create_engine(cfg)
    if continue_from is not None:
        engine.load_networks(continue_from)
        if not quiet:
            print(f"resumed weights from checkpoint {continue_from!r}")
    viz = Visualizer(cfg)
    viz.dump_config(cfg)
    epochs = epochs if epochs is not None else cfg.n_epochs
    stages = list(cfg.freq_stages) or [None]
    stage_i = 0
    anneal_i = 0  # extra tether-decay steps fired past the final stage
    plateau = PlateauDetector(cfg.plateau_history, cfg.plateau_eps,
                              mode=cfg.plateau_mode,
                              stage_max_epochs=cfg.stage_max_epochs)
    history = []
    # unsupervised model selection: track the best held-out-shot
    # misfit (loss_H, cfg.holdout_shots) over the FINAL frequency
    # stage — loss_H scales jump at stage advances, so only the last
    # stage's values are comparable — and keep that checkpoint as
    # 'selected' (the honest alternative to picking the oracle-best
    # model-MSE epoch, which needs the ground truth)
    best_h = float("inf")
    selected_epoch = None
    # drift guard (cfg.guard_patience > 0): an unsupervised trust
    # region on loss_H.  Track the best held-out misfit PER
    # continuation stage (loss_H scales jump at stage advances) and
    # its parameter snapshot; after guard_patience consecutive evals
    # above guard_tol x the stage best, revert the model to that
    # snapshot with a fresh optimizer (engine.guard_revert).  This is
    # what makes untethered descent seed-robust: the catapult/drift
    # basins that the TRAIN misfit cannot reject (docs/RESULTS.md
    # line-scan) ARE rejected by the held-out misfit (measured,
    # runs_r5/el_armB_s1), so drift segments get rolled back while
    # genuine descent is kept at full untethered speed.
    guard_on = (cfg.guard_patience > 0 and cfg.holdout_shots > 0
                and hasattr(engine, "guard_revert"))
    guard_best_h = float("inf")
    guard_snap = None
    guard_worse = 0
    guard_stage_i = 0
    guard_reverts = 0
    if profile_dir and profile_epochs > 0:
        import jax
        jax.profiler.start_trace(profile_dir)

    for epoch in range(start_epoch, epochs + 1):
        t0 = time.time()
        # ---- validation first (reference does val at epoch top) ----
        val_losses, model_img = engine.test()
        # ---- training iterations ----
        agg = collections.defaultdict(float)
        for _ in range(iters_per_epoch):
            if stages[stage_i] is not None:
                kw = ({"tether_stage": stage_i + anneal_i}
                      if cfg.tether_anneal_plateaus > 0 else {})
                losses = engine.optimize_parameters(
                    epoch, freq=stages[stage_i], **kw)
            else:
                losses = engine.optimize_parameters(epoch)
            for k, v in losses.items():
                agg[k] += v / iters_per_epoch
        # ---- drift guard (before the stage advance: this epoch's
        # loss_H was evaluated at the CURRENT stage's band) ----
        guard_fired = None
        if guard_on and epoch == cfg.lstart:
            # anchor snapshot at the warmup->physics boundary: the
            # catapult can outrun the first scheduled loss_H eval
            # (probe F drifted 3x within 30 physics epochs)
            guard_best_h = engine.holdout_misfit(stages[stage_i])
            guard_snap = engine.params
            guard_stage_i = stage_i
        elif guard_on and "loss_H" in agg and epoch > cfg.lstart:
            h = agg["loss_H"]
            if stage_i != guard_stage_i:
                guard_stage_i, guard_worse = stage_i, 0
                guard_best_h, guard_snap = h, engine.params
            elif h < guard_best_h:
                guard_best_h, guard_snap = h, engine.params
                guard_worse = 0
            elif h > cfg.guard_tol * guard_best_h:
                guard_worse += 1
                if (guard_worse >= cfg.guard_patience
                        and guard_snap is not None):
                    engine.guard_revert(guard_snap, epoch)
                    guard_worse = 0
                    guard_reverts += 1
                    guard_fired = epoch
                    if not quiet:
                        print(f"[drift-guard] loss_H {h:.4f} > "
                              f"{cfg.guard_tol:g} x stage best "
                              f"{guard_best_h:.4f}: reverted to the "
                              f"best-loss_H snapshot at epoch {epoch}")
            else:
                guard_worse = 0
        # ---- frequency continuation ----
        # (suspended during the lstart warmup: its physics loss is a
        # constant 0, a perfect "plateau" that would race the stage
        # index to the final frequency before inversion even starts)
        key = "loss_D_MSE" if "loss_D_MSE" in agg else next(iter(agg))
        if (epoch > cfg.lstart and stages[stage_i] is not None
                and plateau.update(agg[key])):
            if stage_i + 1 < len(stages):
                stage_i += 1
                if not quiet:
                    print(f"[freq-continuation] advancing to stage "
                          f"{stages[stage_i]} Hz at epoch {epoch}")
            elif anneal_i < cfg.tether_anneal_plateaus:
                # final stage reached: each further plateau relaxes
                # the lowf tether one more tether_decay notch (the
                # detector self-resets on fire, so this recurs every
                # ~window epochs while the loss stays flat)
                anneal_i += 1
                if not quiet:
                    tw = (cfg.tether_weight
                          * cfg.tether_decay
                          ** (stage_i + anneal_i))
                    print(f"[tether-anneal] plateau at final stage: "
                          f"tether -> {tw:.4f} at epoch {epoch}")
        rec = {"epoch": epoch, **agg, **val_losses,
               "freq_stage": stages[stage_i],
               "epoch_time": time.time() - t0}
        if guard_fired is not None:
            rec["guard_revert"] = guard_fired
        if ("loss_H" in agg and stage_i == len(stages) - 1
                and agg["loss_H"] < best_h):
            best_h = agg["loss_H"]
            selected_epoch = epoch
            rec["selected_epoch"] = epoch
            engine.save_networks("selected")
        history.append(rec)
        viz.log_epoch(rec, model_img=model_img)
        if profile_dir and epoch - start_epoch + 1 == profile_epochs:
            import jax
            jax.profiler.stop_trace()
            if not quiet:
                print(f"profiler trace written to {profile_dir}")
        if epoch % cfg.save_epoch_freq == 0 or epoch == epochs:
            engine.save_networks(epoch)
            engine.save_networks("latest")
    if selected_epoch is not None and not quiet:
        print(f"[early-stop] selected checkpoint: epoch "
              f"{selected_epoch} (held-out misfit {best_h:.6f}) "
              f"-> tag 'selected'")
    if guard_on and not quiet:
        print(f"[drift-guard] {guard_reverts} revert(s) over "
              f"{epochs - start_epoch + 1} epochs")
    return engine, history


def main(argv=None):
    from physicsbasedfwi2_tpu.utils.cache import enable_persistent_cache
    enable_persistent_cache()
    p = argparse.ArgumentParser(description="FWI training")
    p.add_argument("--workload", default="marmousi_acoustic",
                   choices=list_workloads())
    p.add_argument("--name", default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--iters-per-epoch", type=int, default=1)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--optimizer", default=None)
    p.add_argument("--netG", default=None)
    p.add_argument("--lstart", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--save-dir", default=None)
    p.add_argument("--dataroot", default=None,
                   help="npy tree in the reference's contract; "
                        "default: synthetic workload")
    p.add_argument("--small", action="store_true",
                   help="shrink the workload for smoke testing")
    p.add_argument("--continue-train", action="store_true",
                   help="resume from --epoch-tag (default latest)")
    p.add_argument("--epoch-tag", default="latest")
    p.add_argument("--start-epoch", type=int, default=1)
    p.add_argument("--profile-dir", default=None)
    p.add_argument("--profile-epochs", type=int, default=2)
    p.add_argument("--set", action="append", default=[],
                   metavar="FIELD=VALUE", dest="set_fields",
                   help="override any ExperimentConfig field (the "
                        "reference exposed every option through its "
                        "three-stage argparse, base_options.py:20-57); "
                        "values parse as python literals, e.g. "
                        "--set tether_weight=0.5 "
                        "--set 'freq_stages=(4.0,8.0)'")
    args = p.parse_args(argv)

    overrides = {}
    for k in ("lr", "optimizer", "netG", "lstart", "seed"):
        v = getattr(args, k)
        if v is not None:
            overrides[k] = v
    if args.save_dir:
        overrides["save_dir"] = args.save_dir
    if args.dataroot:
        overrides["dataroot"] = args.dataroot
    from physicsbasedfwi2_tpu.engine.config import parse_set_overrides
    try:
        overrides.update(parse_set_overrides(args.set_fields))
    except ValueError as e:
        p.error(str(e))
    cfg = get_workload(args.workload, **overrides)
    if args.name:
        cfg = cfg.replace(name=args.name)
    if args.small:
        cfg = cfg.replace(nz=48, nx=64, nt=300, num_shots=4,
                          num_receivers=32, filters=(4, 8, 16),
                          chunk=25, water_rows=6)
    _, history = train(
        cfg, epochs=args.epochs, iters_per_epoch=args.iters_per_epoch,
        continue_from=args.epoch_tag if args.continue_train else None,
        start_epoch=args.start_epoch, profile_dir=args.profile_dir,
        profile_epochs=args.profile_epochs if args.profile_dir else 0)
    print(json.dumps(history[-1]))


if __name__ == "__main__":
    main()
