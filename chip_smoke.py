"""Smoke test of the FWI training path on an NVIDIA GPU.

Run from the repository root on a machine with one GPU:

    python chip_smoke.py            # one card, every phase below
    python chip_smoke.py --cards 4  # shot-sharded engine step on 4 cards

Phases (any failure exits non-zero and prints no result line):

1. device: JAX must find a GPU; prints the card's name and power limit
   (``nvidia-smi``) and the JAX version.
2. parity against the plain reference: the committed goldens
   (tests/golden/*.npz), then the acoustic gradient (18 shots, 151x200,
   nt 4001) and the elastic gradient (5 shots, 100x300, nt 3334) of
   bench.py, each compared with the same code run on the host CPU in
   this process; and the generator at default matmul precision against
   ``jax.default_matmul_precision("highest")``.
3. ``marmousi_acoustic`` trains a few epochs through ``create_engine``
   and ``train`` at its registered size (physics path ``xla``).
4. ``marmousi_elastic`` (``lstart=0``) the same (physics path ``fast``).
5. per workload: seconds per ``optimize_parameters`` after compilation,
   compile seconds, peak device memory; and one profiler trace of one
   acoustic gradient (under ``chiprun_out/``), reduced to kernels and
   seconds per time step.

``--cards 4`` runs only: one ``optimize_parameters`` of
``marmousi_acoustic`` on a 4-card shot mesh (18 shots padded to 20,
padded shots masked out) against the single-card engine from the same
parameters.

The line before the last is ``nvidia-smi``'s name and power limit of
each card; the last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import glob
import importlib.util
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "chiprun_out", "chip_smoke")
DEVICE_PLANE = "/device:GPU"  # profiler planes of the cards

# Tolerances, each with its reason.  The stencils do no matrix
# products, so TF32 never applies to the physics: GPU and CPU differ
# only in summation and fused-multiply-add order, accumulated over
# thousands of f32 time steps.
GOLDEN_RTOL = 2e-4      # tests/test_golden.py's own bound (max-scaled)
TRACE_RTOL = 1e-4       # relative L2, forward traces over 3334-4001 steps
GRAD_RTOL = 1e-3        # relative L2 of the L2-misfit gradient, f32
                        # accumulated over 3334-4001 adjoint steps.  The
                        # L1 misfit's gradient is not compared: its
                        # sign(residual) is random wherever the residual
                        # is at round-off level (before first arrivals)
GEN_RTOL = 5e-2         # generator, default vs highest matmul precision:
                        # f32 convs may run as TF32 (10-bit mantissa)
MESH_LOSS_RTOL = 1e-4   # 4-card vs 1-card loss: psum order only
MESH_GRAD_RTOL = 2e-2   # Adam first moment (0.1 x gradient): shots
                        # summed in another order, then cancellation in
                        # the generator's backward pass (2e-3 measured
                        # on 4 virtual CPU devices)
T0 = time.perf_counter()


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:7.1f} s] {msg}", flush=True)


def rel_l2(a, b) -> float:
    import numpy as np
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-300))


def check(name: str, value: float, tol: float) -> None:
    ok = value <= tol
    log(f"  {name}: {value:.3e} (tolerance {tol:g}) "
        f"{'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError(f"{name} {value:.3e} > {tol:g}")


def card_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip()


def _leaves(tree):
    import jax
    import numpy as np
    return np.concatenate([np.ravel(np.asarray(x, np.float64))
                           for x in jax.tree_util.tree_leaves(tree)])


class CompileClock:
    """Seconds JAX spent tracing, lowering and compiling (its own
    monitoring events), so compilation is reported as set-up time."""

    def __init__(self):
        import jax
        self.seconds = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event: str, duration: float, **_):
        if event.startswith("/jax/core/compile/"):
            self.seconds += duration


def phase_parity():
    import jax
    import jax.numpy as jnp
    import numpy as np
    import bench

    cpu = jax.devices("cpu")[0]
    log("phase 2: parity with the plain reference")

    spec = importlib.util.spec_from_file_location(
        "test_golden", os.path.join(ROOT, "tests", "test_golden.py"))
    golden = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(golden)
    for name, build in (("acoustic_small", golden.acoustic_golden_arrays),
                        ("elastic_small", golden.elastic_golden_arrays)):
        ref = np.load(os.path.join(ROOT, "tests", "golden", f"{name}.npz"))
        for k, v in build().items():
            err = float(np.max(np.abs(np.asarray(v) - ref[k]))
                        / (np.abs(ref[k]).max() + 1e-30))
            check(f"golden {name}/{k} max|diff|/max|ref|", err,
                  GOLDEN_RTOL)

    def l2_misfit(simulate):
        def loss(m, data, obs):
            pred = jax.tree_util.tree_leaves(simulate(m, data))
            return sum(jnp.mean((p - o) ** 2) for p, o in
                       zip(pred, jax.tree_util.tree_leaves(obs)))
        return loss

    for label, problem in (("acoustic", bench.acoustic_problem),
                           ("elastic", bench.elastic_problem)):
        path, simulate, _, m0, data = problem()
        sim = jax.jit(simulate)
        vg = jax.jit(jax.value_and_grad(l2_misfit(simulate)))
        # observed data of a 3% faster model, made once on the GPU
        obs = sim(jax.tree_util.tree_map(lambda a: 1.03 * a, m0), data)
        on_cpu = jax.device_put((m0, data, obs), cpu)
        t = time.perf_counter()
        tr_gpu = jax.block_until_ready(sim(m0, data))
        loss_gpu, g_gpu = jax.block_until_ready(vg(m0, data, obs))
        t_gpu = time.perf_counter() - t
        t = time.perf_counter()
        tr_cpu = jax.block_until_ready(sim(*on_cpu[:2]))
        loss_cpu, g_cpu = jax.block_until_ready(vg(*on_cpu))
        t_cpu = time.perf_counter() - t
        log(f"  {label} (path {path}): gpu {t_gpu:.1f} s, cpu {t_cpu:.1f} s "
            f"(each incl. compile); L2 misfit gpu {float(loss_gpu):.9e} "
            f"cpu {float(loss_cpu):.9e}")
        if not np.all(np.isfinite(_leaves(g_gpu))):
            raise FloatingPointError(f"{label} gradient not finite")
        check(f"{label} traces rel L2", rel_l2(_leaves(tr_gpu),
                                               _leaves(tr_cpu)), TRACE_RTOL)
        check(f"{label} gradient rel L2", rel_l2(_leaves(g_gpu),
                                                 _leaves(g_cpu)), GRAD_RTOL)

    from physicsbasedfwi2_tpu.engine import create_engine, get_workload
    cfg = get_workload("marmousi_acoustic").replace(validate_on_twin=False)
    eng = create_engine(cfg)
    apply = jax.jit(lambda p, x: eng.net.apply(p, x)[0])
    out = apply(eng.params, eng.shots_in)
    with jax.default_matmul_precision("highest"):
        out_hi = jax.jit(lambda p, x: eng.net.apply(p, x)[0])(
            eng.params, eng.shots_in)
    log(f"  generator {cfg.netG} on input {tuple(eng.shots_in.shape)}; "
        f"engines run at jax_default_matmul_precision="
        f"{jax.config.jax_default_matmul_precision}")
    check("generator default vs highest precision rel L2",
          rel_l2(out, out_hi), GEN_RTOL)


def train_workload(name: str, clock: CompileClock, epochs: int, **overrides):
    import jax
    import numpy as np
    from physicsbasedfwi2_tpu.engine import create_engine, get_workload
    from physicsbasedfwi2_tpu.engine.train import train

    cfg = get_workload(name, **overrides).replace(
        save_dir=os.path.join(ROOT, ".cache", "chip_smoke"),
        save_epoch_freq=10 ** 9)
    c0 = clock.seconds
    t = time.perf_counter()
    eng = create_engine(cfg)
    t_setup = time.perf_counter() - t
    p0 = _leaves(eng.params)
    _, hist = train(cfg, epochs=epochs, engine=eng, quiet=True)
    compile_s = clock.seconds - c0
    key = "loss_D" if "loss_D" in hist[0] else "loss_D_MSE"
    losses = [h[key] for h in hist]
    log(f"  {name}: physics path {eng.physics_path}; {key} per epoch "
        f"{losses}")
    if not np.all(np.isfinite(losses)):
        raise FloatingPointError(f"{name}: non-finite loss {losses}")
    moved = float(np.max(np.abs(_leaves(eng.params) - p0)))
    if not moved > 0:
        raise AssertionError(f"{name}: parameters did not change")
    times = []
    for e in range(epochs + 1, epochs + 4):
        t = time.perf_counter()
        eng.optimize_parameters(e)
        times.append(time.perf_counter() - t)
    stats = jax.devices()[0].memory_stats() or {}
    return {"workload": name, "path": eng.physics_path,
            "setup_s": t_setup, "compile_s": compile_s,
            "s_per_optimize_parameters": sorted(times)[len(times) // 2],
            "all_s": times, "max_param_change": moved,
            "peak_bytes_in_use_so_far": stats.get("peak_bytes_in_use")}


def trace_acoustic_gradient() -> dict:
    """Profile one acoustic gradient and count what ran on the GPU."""
    import jax
    import bench

    path, _, loss, vp0, data = bench.acoustic_problem()
    nt = int(data["wav"].shape[-1])
    vg = jax.jit(jax.value_and_grad(loss))
    jax.block_until_ready(vg(vp0, data))
    t = time.perf_counter()
    jax.block_until_ready(vg(vp0, data))
    wall = time.perf_counter() - t
    tdir = os.path.join(OUT, "trace_acoustic_gradient")
    with jax.profiler.trace(tdir):
        jax.block_until_ready(vg(vp0, data))
    files = sorted(glob.glob(os.path.join(tdir, "**", "*.xplane.pb"),
                             recursive=True))
    pd = jax.profiler.ProfileData.from_file(files[-1])
    lines = {}
    for plane in pd.planes:
        if not plane.name.startswith(DEVICE_PLANE):
            continue
        for line in plane.lines:
            evs = list(line.events)
            if evs:
                lines[f"{plane.name} | {line.name}"] = (
                    len(evs), sum(e.duration_ns for e in evs) * 1e-9)
    if not lines:
        raise AssertionError(f"no {DEVICE_PLANE} events in {files[-1]}")
    for k, (n, s) in sorted(lines.items(), key=lambda kv: -kv[1][0]):
        log(f"  trace line {k}: {n} events, {s:.4f} s")
    # the busiest stream line holds the kernels as the card ran them
    kern = max((v for k, v in lines.items() if "stream" in k.lower()),
               default=max(lines.values()))
    return {"path": path, "nt": nt, "gradient_wall_s": wall,
            "s_per_time_step": wall / nt,
            "kernel_events": kern[0], "kernels_per_time_step": kern[0] / nt,
            "kernel_busy_s": kern[1], "trace_dir": tdir}


def phase_mesh(n_cards: int):
    import jax
    import numpy as np
    import optax
    from physicsbasedfwi2_tpu.engine import get_workload
    from physicsbasedfwi2_tpu.engine.engines import AcousticDIPEngine
    from physicsbasedfwi2_tpu.parallel import make_mesh

    log(f"shot mesh over {n_cards} cards vs one card")
    cfg = get_workload("marmousi_acoustic").replace(validate_on_twin=False)
    eng_m = AcousticDIPEngine(cfg, mesh=make_mesh(n_cards))
    eng_1 = AcousticDIPEngine(cfg)
    pad = eng_m._pack["phys"]["mask"]
    log(f"  {cfg.num_shots} shots padded to {pad.shape[0]} "
        f"({int(np.sum(np.asarray(pad)))} real)")
    if rel_l2(_leaves(eng_m.params), _leaves(eng_1.params)) != 0.0:
        raise AssertionError("engines did not start from equal parameters")
    t = time.perf_counter()
    out_m = eng_m.optimize_parameters(1)
    t_m = time.perf_counter() - t
    t = time.perf_counter()
    out_1 = eng_1.optimize_parameters(1)
    t_1 = time.perf_counter() - t
    log(f"  {n_cards} cards: {out_m} ({t_m:.1f} s incl. compile); "
        f"1 card: {out_1} ({t_1:.1f} s incl. compile)")
    check("loss_D relative difference",
          abs(out_m["loss_D"] - out_1["loss_D"]) / abs(out_1["loss_D"]),
          MESH_LOSS_RTOL)
    mu_m = _leaves(optax.tree_utils.tree_get(eng_m.opt_state, "mu"))
    mu_1 = _leaves(optax.tree_utils.tree_get(eng_1.opt_state, "mu"))
    check("Adam first moment (0.1 x gradient) rel L2", rel_l2(mu_m, mu_1),
          MESH_GRAD_RTOL)
    p = _leaves(eng_1.params)
    du = np.abs(_leaves(eng_m.params) - p)
    log(f"  updated parameters: rel L2 {rel_l2(_leaves(eng_m.params), p):.3e}"
        f"; share moved differently by > lr/10: "
        f"{float(np.mean(du > 0.1 * cfg.lr)):.3e} (Adam's first step is "
        f"lr x sign(gradient), so weights whose gradient is at noise "
        f"level can flip)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="4: run only the shot-sharded engine step")
    args = ap.parse_args(argv)

    import jax
    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU, JAX found {devices[0].platform}",
              file=sys.stderr)
        return 1
    if len(devices) < args.cards:
        print(f"chip_smoke: --cards {args.cards} needs {args.cards} GPUs, "
              f"found {len(devices)}", file=sys.stderr)
        return 1
    log(f"phase 1: device {devices[0].device_kind} x {len(devices)}; "
        f"jax {jax.__version__}")
    log(f"card: {card_line()}")

    from physicsbasedfwi2_tpu.utils.cache import enable_persistent_cache
    log(f"compile cache: {enable_persistent_cache()}")
    os.makedirs(OUT, exist_ok=True)

    if args.cards > 1:
        phase_mesh(args.cards)
    else:
        clock = CompileClock()
        phase_parity()
        log("phase 3: marmousi_acoustic training")
        rows = [train_workload("marmousi_acoustic", clock, epochs=3)]
        log("phase 4: marmousi_elastic training (lstart=0)")
        rows.append(train_workload("marmousi_elastic", clock, epochs=3,
                                   lstart=0))
        log("phase 5: timings and trace")
        card = card_line()
        for r in rows:
            log(json.dumps({**r, "card": card}))
        log(json.dumps({**trace_acoustic_gradient(), "card": card}))
        for r, want in zip(rows, ("xla", "fast")):
            if r["path"] != want:
                raise AssertionError(f"{r['workload']} ran path {r['path']}")
    print(card_line(), flush=True)
    d = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind,
        "count": len(d)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
