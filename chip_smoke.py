#!/usr/bin/env python3
# ------------------------------------------------------------------
"""Smoke run of the PyTorch/CUDA port (idee_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. build    the card's name and power limit, then nvcc builds every kernel
              of the main paths from the sources in this checkout, one nvcc
              per source, all started together
  2. kernel   each kernel against its plain PyTorch version at the shapes the
              main paths give it (max abs error, stated tolerance), then both
              timed with CUDA events beside the card's least possible time:
              the fused scan forward, the linear scan forward and reverse
              (plus a long L=200 check), and the fused scan's backward
              through its autograd Function against autograd of the plain
              forward
  3. main     synthetic evaluation (train.evaluate.test_synthetic) with the
              Mamba encoder at the bench width: 6 variables x 1 channel,
              delta_t=8, 200x200, batch 1, random weights from a seed. The
              launch counters are zeroed just before and read just after;
              then steady-state steps/s, a profile, and one forward of the
              same weights and batch with the plain scan for comparison
  4. train    synthetic training (train.driver.train_synthetic) at the same
              width for 2 epochs, counters zeroed around it; checkpoints,
              history and a resumed third epoch; steady train steps/s, peak
              memory, a profile of one train step, and one train step's
              gradients with the kernels against the plain scans
  5. kernels  one line listing every kernel: route, source, launches, error
              and times
The card's name and power limit stand on a line of their own, and the last
line is {"ok": true, "device": {...}}. Any failure exits non-zero before
that line; without a CUDA card the script exits non-zero at once.
"""
# ------------------------------------------------------------------

import json
import math
import os
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.abspath(__file__))
LOG_DIR = os.path.join(REPO, "build", "chip_smoke_log")

# (L, M) of the scans per launch at the bench width, batch 1: stage 0
# (window (2,4,4): 10,000 windows x 6 variables x 16 channels) runs once per
# block, twice per forward; stage 1 (window (8,1,1): 40,000 windows x 96)
# once. A train step's backward runs the reverse linear scan at the same
# shapes, once per forward launch.
SCAN_SHAPES = {"stage0": (32, 960_000), "stage1": (8, 3_840_000)}
LAUNCHES_PER_STEP = {"stage0": 2, "stage1": 1}
# no model window has L > 64; the long check is the TPU's two-level
# _scan_pallas_2d shape, which the CUDA kernel walks in one pass
LONG_SCAN = (200, 1_000_000)
SCAN_RTOL, SCAN_ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-5
# cuDNN's backward convolutions are not bit-deterministic
STEP_GRAD_REL = 1e-4

N_WEEKS = 40  # fake cube length: 33 eval samples at delta_t=8
# global (not weekly-climatology) normalisation: a cube shorter than two
# years has one sample per week of year, so its climatology-scaled inputs
# are exactly 0
IS_CLIMA_SCALE = False
TRAIN_WEEKS, VAL_WEEKS = (1, 24), (25, 40)  # 17 train, 9 val samples
N_EPOCHS = 2


def _finite(obj):
    """NaN/inf -> None, so every line is strict JSON."""
    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    if isinstance(obj, dict):
        return {k: _finite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_finite(v) for v in obj]
    return obj


def emit(**obj):
    print(json.dumps(_finite(obj), allow_nan=False), flush=True)


def card_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn() over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def fused_inputs(L: int, M: int, seed: int):
    """Inputs in the ranges the Mamba block produces: softplus deltas,
    A = -exp(A_log) < 0, unit-scale u, B, C, z, D."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    delta = torch.rand(L, M, device=dev, generator=g) * 0.7 + 0.01
    u, B, C, z = (torch.randn(L, M, device=dev, generator=g)
                  for _ in range(4))
    A = -torch.rand(M, device=dev, generator=g) * 2.0 - 0.1
    D = torch.randn(M, device=dev, generator=g)
    return delta, u, B, C, z, A, D


def scan_inputs(L: int, M: int, seed: int):
    """Coefficients in (0, 1) as exp(delta A) gives them, and unit-scale
    increments."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    a = torch.rand(L, M, device="cuda", generator=g) * 0.9 + 0.05
    b = torch.randn(L, M, device="cuda", generator=g)
    return a, b


def max_err(got, want, name, rtol, atol) -> float:
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol,
                               msg=lambda m: f"{name}: {m}")
    return (got - want).abs().max().item()


def phase_build():
    from idee_tpu_torch.kernels import build
    from idee_tpu_torch.kernels import selective_scan as ss

    sources = sorted(set(ss.SOURCES.values()))
    seconds = build.build(sources)
    emit(phase="build", seconds=seconds,
         libraries=[os.path.relpath(build.library_path(s), REPO)
                    for s in sources])


def check_fused_forward(ss, bounds):
    per_shape = {}
    for i, (stage, (L, M)) in enumerate(SCAN_SHAPES.items()):
        args = fused_inputs(L, M, seed=i)
        y_p, h_p = ss.fused_selective_scan_n1_plain(*args)
        y = ss.fused_selective_scan_n1(*args)
        y_h, h = ss.fused_selective_scan_n1(*args, return_h=True)
        torch.cuda.synchronize()
        err = max(max_err(y, y_p, f"{stage} y", SCAN_RTOL, SCAN_ATOL),
                  max_err(y_h, y_p, f"{stage} y_with_h", SCAN_RTOL,
                          SCAN_ATOL),
                  max_err(h, h_p, f"{stage} h", SCAN_RTOL, SCAN_ATOL))
        del y, y_h, h, h_p, y_p
        ms = cuda_ms(lambda: ss.fused_selective_scan_n1(*args), iters=50)
        plain_ms = cuda_ms(lambda: ss.fused_selective_scan_n1_plain(*args),
                           iters=5, warmup=1)
        bound_ms, bound_by = bounds.fused_scan_fwd(L, M, with_h=False)
        per_shape[stage] = dict(L=L, M=M, max_abs_err=err, ms=ms,
                                plain_ms=plain_ms, bound_ms=bound_ms,
                                bound_by=bound_by,
                                share_of_bound=bound_ms / ms)
        del args
    return per_shape


def check_linear_scan(ss, bounds):
    per_shape = {}
    shapes = dict(SCAN_SHAPES, long=LONG_SCAN)
    for i, (stage, (L, M)) in enumerate(shapes.items()):
        a, b = scan_inputs(L, M, seed=10 + i)
        row = dict(L=L, M=M)
        for direction, rev in (("forward", False), ("reverse", True)):
            h = ss.linear_scan_2d(a, b, reverse=rev)
            torch.cuda.synchronize()
            err = max_err(h, ss.linear_scan_plain(a, b, rev),
                          f"{stage} {direction}", SCAN_RTOL, SCAN_ATOL)
            del h
            row[direction] = dict(
                max_abs_err=err,
                ms=cuda_ms(lambda: ss.linear_scan_2d(a, b, reverse=rev),
                           iters=50),
                plain_ms=cuda_ms(lambda: ss.linear_scan_plain(a, b, rev),
                                 iters=3, warmup=1))
        row["bound_ms"], row["bound_by"] = bounds.linear_scan(L, M)
        row["share_of_bound"] = row["bound_ms"] / row["reverse"]["ms"]
        per_shape[stage] = row
        del a, b
    return per_shape


def check_fused_backward(ss, bounds):
    """The Function's backward (the reverse linear-scan kernel and PyTorch
    ops) against autograd through the plain forward loop."""
    names = ("ddelta", "du", "dB", "dC", "dz", "dA", "dD")
    per_shape = {}
    for i, (stage, (L, M)) in enumerate(SCAN_SHAPES.items()):
        args = [t.requires_grad_() for t in fused_inputs(L, M, seed=20 + i)]
        g = torch.randn(L, M, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(i))
        y = ss.fused_selective_scan_n1(*args)
        got = torch.autograd.grad(y, args, g)
        want = torch.autograd.grad(ss.fused_selective_scan_n1_plain(*args)[0],
                                   args, g)
        torch.cuda.synchronize()
        err = max(max_err(a, b, f"{stage} {n}", GRAD_RTOL, GRAD_ATOL)
                  for n, a, b in zip(names, got, want))
        del got, want

        def fwd_bwd():
            torch.autograd.grad(ss.fused_selective_scan_n1(*args), args, g)

        def fwd():
            with torch.no_grad():
                ss.fused_selective_scan_n1(*args, return_h=True)

        bwd_ms = cuda_ms(fwd_bwd, iters=10) - cuda_ms(fwd, iters=10)
        bound_ms, bound_by = bounds.fused_scan_bwd(L, M)
        per_shape[stage] = dict(L=L, M=M, max_abs_err=err,
                                backward_ms=bwd_ms, bound_ms=bound_ms,
                                bound_by=bound_by,
                                share_of_bound=bound_ms / bwd_ms)
        del args, y, g
    return per_shape


def phase_kernel():
    from idee_tpu_torch.kernels import bounds
    from idee_tpu_torch.kernels import selective_scan as ss

    fused = check_fused_forward(ss, bounds)
    scan = check_linear_scan(ss, bounds)
    backward = check_fused_backward(ss, bounds)
    emit(phase="kernel", rtol=SCAN_RTOL, atol=SCAN_ATOL,
         grad_rtol=GRAD_RTOL, grad_atol=GRAD_ATOL,
         **{ss.FUSED_FWD: fused, ss.LINEAR_SCAN: scan,
            "fused_scan_backward": backward})
    return fused, scan, backward


def zero_launches(ss):
    for k in ss.launches:
        ss.launches[k] = 0


def profile_steps(run_step, n: int):
    """Where a steady step's time goes: torch.profiler over ``n`` calls of
    run_step(); device time by operator, and the device's busy share of
    the wall time (the profiler's own host cost included)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run_step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            run_step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / n
    rows = []
    for e in prof.key_averages():
        # device activity only (kernels, copies): an operator's row repeats
        # the time of the kernels it launched
        if e.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = e.self_cuda_time_total
        if dev_us > 0:
            rows.append((dev_us / 1e3 / n, e.key))
    rows.sort(reverse=True)
    device_ms = sum(ms for ms, _ in rows)
    return dict(steps=n, wall_ms_per_step=wall_ms,
                device_ms_per_step=device_ms,
                device_busy_share=device_ms / wall_ms,
                top_device_ops=[{"op": k[:80], "ms_per_step": ms}
                                for ms, k in rows[:14]])


def phase_main(cube):
    import idee_tpu_torch.nn.mamba as mamba_mod
    from idee_tpu_torch.config import synthetic_config
    from idee_tpu_torch.data.loader import DataLoader
    from idee_tpu_torch.data.synthetic import SyntheticDataset
    from idee_tpu_torch.kernels import selective_scan as ss
    from idee_tpu_torch.models.vq_model import build_model
    from idee_tpu_torch.train.evaluate import test_synthetic
    from idee_tpu_torch.train.steps import init_epoch_metrics, make_eval_step

    cfg = synthetic_config(encoder="Mamba", x_max=200, y_max=200,
                           times_test=(1, N_WEEKS), dir_log=LOG_DIR,
                           is_clima_scale=IS_CLIMA_SCALE, name="chip_smoke")
    params = build_model(cfg, torch.Generator().manual_seed(0)).state_dict()
    n_steps = N_WEEKS - cfg.delta_t + 1

    # --- the main path, with the launch counters zeroed around it
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    zero_launches(ss)
    t0 = time.perf_counter()
    result = test_synthetic(cfg, cube=cube, params=params, device="cuda")
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dict(ss.launches)
    peak_bytes = torch.cuda.max_memory_allocated()

    want = {ss.FUSED_FWD: sum(LAUNCHES_PER_STEP.values()) * n_steps,
            ss.LINEAR_SCAN: 0}
    if launches != want:
        raise SystemExit(f"eval launches {launches}, expected {want}")
    if not math.isfinite(result["mean_loss"]):
        raise SystemExit(f"non-finite mean loss: {result}")

    # --- steady state: the same eval step, host batch assembly included
    ds = SyntheticDataset(cube=cube, times=cfg.times_test,
                          variables=list(cfg.variables), delta_t=cfg.delta_t,
                          is_clima_scale=cfg.is_clima_scale, x_max=200,
                          y_max=200)
    model = build_model(cfg)
    model.load_state_dict(params)
    model.to("cuda")
    step = make_eval_step(model, cfg, t0=float(ds.timestep[0]))
    metrics = init_epoch_metrics(ds.anomaly.shape, "cuda")
    loader = DataLoader(ds, 1, device="cuda",
                        keys=["x", "mask_extreme", "mask_extreme_loss",
                              "timestep"])
    batches = iter(loader)
    for _ in range(3):
        step(metrics, next(batches))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed = 0
    for batch in batches:
        step(metrics, batch)
        timed += 1
    torch.cuda.synchronize()
    steps_per_s = timed / (time.perf_counter() - t0)
    batches = iter(loader)
    profile = profile_steps(lambda: step(metrics, next(batches)), n=5)

    # --- one forward with the plain scan, against the kernel's
    x = torch.from_numpy(ds[0]["x"][None]).cuda()
    with torch.inference_mode():
        out_k = model(x)
        kernel_wrapper = mamba_mod.fused_selective_scan_n1
        mamba_mod.fused_selective_scan_n1 = (
            lambda *a: ss.fused_selective_scan_n1_plain(*a)[0])
        try:
            out_p = model(x)
        finally:
            mamba_mod.fused_selective_scan_n1 = kernel_wrapper
    logit_err = max((out_k.z - out_p.z).abs().max().item(),
                    (out_k.y - out_p.y).abs().max().item())
    bits_agree = (out_k.anomaly == out_p.anomaly).float().mean().item()
    if not (torch.isfinite(out_k.z).all() and logit_err <= 1e-4
            and bits_agree >= 0.999):
        raise SystemExit(f"kernel forward disagrees with the plain one: "
                         f"logit err {logit_err}, bits agree {bits_agree}")

    emit(phase="main", encoder=cfg.encoder, shape=[1, 6, 1, 8, 200, 200],
         metrics=result, steps=n_steps, launches=launches,
         launches_per_step={k: v / n_steps for k, v in launches.items()},
         wall_s_with_setup=wall_s, steady_steps_per_s=steps_per_s,
         steady_samples_per_s=steps_per_s, steady_steps_timed=timed,
         max_memory_allocated=peak_bytes,
         plain_scan_logit_max_abs_err=logit_err,
         plain_scan_anomaly_bit_agreement=bits_agree)
    emit(phase="profile", path="eval", **profile)
    return launches


def train_config():
    from idee_tpu_torch.config import synthetic_config

    return synthetic_config(encoder="Mamba", x_max=200, y_max=200,
                            times_train=TRAIN_WEEKS, times_val=VAL_WEEKS,
                            n_epochs=N_EPOCHS, is_aug=False, batch_size=1,
                            is_clima_scale=IS_CLIMA_SCALE, dir_log=LOG_DIR,
                            name="chip_smoke_train")


def step_gradients(cfg, params, batch, plain: bool):
    """Every parameter's gradient of one train step from ``params``, with
    the scan kernels or (plain) with autograd through the plain scans."""
    import idee_tpu_torch.nn.mamba as mamba_mod
    from idee_tpu_torch.kernels import selective_scan as ss
    from idee_tpu_torch.models.vq_model import build_model
    from idee_tpu_torch.train.state import create_train_state
    from idee_tpu_torch.train.steps import init_epoch_metrics, make_train_step

    model = build_model(cfg)
    model.load_state_dict(params)
    state = create_train_state(cfg, model, "cuda", steps_per_epoch=17)
    step = make_train_step(model, cfg, t0=float(TRAIN_WEEKS[0]),
                           steps_per_epoch=17)
    metrics = init_epoch_metrics((6, N_WEEKS, 200, 200), "cuda")
    kernel_wrapper = mamba_mod.fused_selective_scan_n1
    if plain:
        mamba_mod.fused_selective_scan_n1 = (
            lambda *a: ss.fused_selective_scan_n1_plain(*a)[0])
    try:
        step(state, metrics, batch)
    finally:
        mamba_mod.fused_selective_scan_n1 = kernel_wrapper
    torch.cuda.synchronize()
    return {k: p.grad for k, p in model.named_parameters()}


def phase_train(cube):
    import shutil

    from idee_tpu_torch.data.loader import DataLoader
    from idee_tpu_torch.kernels import selective_scan as ss
    from idee_tpu_torch.models.vq_model import build_model
    from idee_tpu_torch.train.driver import _make_datasets, train_synthetic
    from idee_tpu_torch.train.state import create_train_state
    from idee_tpu_torch.train.steps import init_epoch_metrics, make_train_step

    cfg = train_config()
    shutil.rmtree(cfg.log_dir, ignore_errors=True)
    train_cube, val_cube = cube.time_slice(*TRAIN_WEEKS), \
        cube.time_slice(*VAL_WEEKS)
    n_train = (TRAIN_WEEKS[1] - TRAIN_WEEKS[0] + 1) - cfg.delta_t + 1
    n_val = (VAL_WEEKS[1] - VAL_WEEKS[0] + 1) - cfg.delta_t + 1

    # --- the main path, with the launch counters zeroed around it
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    zero_launches(ss)
    t0 = time.perf_counter()
    history = train_synthetic(cfg, train_cube=train_cube, val_cube=val_cube,
                              device="cuda")
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dict(ss.launches)
    peak_bytes = torch.cuda.max_memory_allocated()

    train_steps, val_steps = N_EPOCHS * n_train, N_EPOCHS * n_val
    want = {ss.FUSED_FWD: 3 * (train_steps + val_steps),
            ss.LINEAR_SCAN: 3 * train_steps}
    if launches != want:
        raise SystemExit(f"train launches {launches}, expected {want}")
    curves = history["train_loss"] + history["val_loss"]
    if len(curves) != 2 * N_EPOCHS or not all(map(math.isfinite, curves)):
        raise SystemExit(f"bad loss history: {history}")
    ckpt_dir = os.path.join(cfg.log_dir, "model_checkpoints")
    written = sorted(os.listdir(ckpt_dir))
    for name in ("latest.pt", "best_loss_model.pt"):
        if name not in written:
            raise SystemExit(f"{name} not written: {written}")
    with open(os.path.join(cfg.log_dir, "history.json")) as fh:
        if json.load(fh)["train_loss"] != history["train_loss"]:
            raise SystemExit("history.json differs from the run's history")

    # --- one more epoch resumes from latest
    resumed = train_synthetic(cfg.replace(n_epochs=N_EPOCHS + 1),
                              train_cube=train_cube, val_cube=val_cube,
                              device="cuda")
    if (resumed["train_loss"][:N_EPOCHS] != history["train_loss"]
            or len(resumed["train_loss"]) != N_EPOCHS + 1
            or resumed["state"].step != (N_EPOCHS + 1) * n_train):
        raise SystemExit(f"resume did not continue at epoch {N_EPOCHS}: "
                         f"{resumed['train_loss']}")

    # --- steady state: train steps from fresh weights, host batch assembly
    # included
    train_ds, _ = _make_datasets(cfg, train_cube, val_cube)
    loader = DataLoader(train_ds, 1, device="cuda", shuffle=True,
                        keys=["x", "mask_extreme", "mask_extreme_loss",
                              "timestep"])
    params = build_model(cfg, torch.Generator().manual_seed(0)).state_dict()
    model = build_model(cfg)
    model.load_state_dict(params)
    state = create_train_state(cfg, model, "cuda", steps_per_epoch=n_train)
    step = make_train_step(model, cfg, t0=float(TRAIN_WEEKS[0]),
                           steps_per_epoch=n_train)
    metrics = init_epoch_metrics(train_ds.anomaly.shape, "cuda")
    batches = iter(loader)
    for _ in range(3):
        step(state, metrics, next(batches))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed = 0
    for batch in batches:
        step(state, metrics, batch)
        timed += 1
    torch.cuda.synchronize()
    steps_per_s = timed / (time.perf_counter() - t0)
    batches = iter(loader)
    profile = profile_steps(lambda: step(state, metrics, next(batches)), n=3)

    emit(phase="train", encoder=cfg.encoder, shape=[1, 6, 1, 8, 200, 200],
         epochs=N_EPOCHS, train_steps=train_steps, val_steps=val_steps,
         launches=launches,
         launches_per_train_step={
             ss.LINEAR_SCAN: launches[ss.LINEAR_SCAN] / train_steps},
         history={k: v for k, v in history.items() if k != "state"},
         resumed_train_loss=resumed["train_loss"],
         wall_s_with_setup=wall_s, steady_train_steps_per_s=steps_per_s,
         steady_steps_timed=timed, max_memory_allocated=peak_bytes,
         checkpoints=written)
    emit(phase="profile", path="train", **profile)

    # --- one train step's gradients, kernels against plain scans
    batch = next(iter(loader))
    got = step_gradients(cfg, params, batch, plain=False)
    want = step_gradients(cfg, params, batch, plain=True)
    worst = 0.0
    for k, w in want.items():
        scale = w.abs().max().item()
        err = (got[k] - w).abs().max().item()
        if err > STEP_GRAD_REL * scale:
            raise SystemExit(f"gradient of {k}: kernel vs plain error {err}"
                             f" > {STEP_GRAD_REL} x max|grad| {scale}")
        worst = max(worst, err / scale if scale > 0 else 0.0)
        if k.startswith("encoder.") and got[k].abs().max().item() == 0.0:
            raise SystemExit(f"encoder parameter {k} got no gradient")
    emit(phase="train_gradients", parameters=len(want),
         encoder_parameters=sum(1 for k in got if k.startswith("encoder.")),
         max_err_over_max_abs_grad=worst, limit=STEP_GRAD_REL)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import idee_tpu_torch  # noqa: F401 -- fails outside a checkout
    from idee_tpu_torch.data.fake import make_fake_cube
    from idee_tpu_torch.kernels import selective_scan as ss

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_name_and_power()
    print(card, flush=True)

    phase_build()
    fused, scan, _ = phase_kernel()
    cube = make_fake_cube(n_vars=6, n_time=N_WEEKS, height=200, width=200,
                          seed=0)
    eval_launches = phase_main(cube)
    train_launches = phase_train(cube)

    def per_step(rows, key):
        # the launches of one step: two at the stage-0 shape, one at the
        # stage-1 shape
        return sum(key(rows[s]) * n for s, n in LAUNCHES_PER_STEP.items())

    emit(kernels=[{
        "name": ss.FUSED_FWD, "route": "cuda",
        "source": "idee_tpu_torch/kernels/csrc/selective_scan.cu",
        "replaces": "idee_tpu/kernels/selective_scan.py:189",
        "launches": train_launches[ss.FUSED_FWD],
        "launches_by_path": {"eval": eval_launches[ss.FUSED_FWD],
                             "train": train_launches[ss.FUSED_FWD]},
        "max_abs_err": max(v["max_abs_err"] for v in fused.values()),
        # times per step: two stage-0 launches and one stage-1 launch
        "ms": per_step(fused, lambda r: r["ms"]),
        "plain_ms": per_step(fused, lambda r: r["plain_ms"]),
        "bound_ms": per_step(fused, lambda r: r["bound_ms"]),
        "bound_by": fused["stage0"]["bound_by"],
        "library_ms": None,
    }, {
        "name": ss.LINEAR_SCAN, "route": "cuda",
        "source": "idee_tpu_torch/kernels/csrc/linear_scan.cu",
        "replaces": "idee_tpu/kernels/selective_scan.py:75",
        "launches": train_launches[ss.LINEAR_SCAN],
        "launches_by_path": {"eval": eval_launches[ss.LINEAR_SCAN],
                             "train": train_launches[ss.LINEAR_SCAN]},
        "max_abs_err": max(r[d]["max_abs_err"] for r in scan.values()
                           for d in ("forward", "reverse")),
        # times per train step: the backward's three reverse scans
        "ms": per_step(scan, lambda r: r["reverse"]["ms"]),
        "plain_ms": per_step(scan, lambda r: r["reverse"]["plain_ms"]),
        "bound_ms": per_step(scan, lambda r: r["bound_ms"]),
        "bound_by": scan["stage0"]["bound_by"],
        "library_ms": None,
    }], card=card)
    print(card, flush=True)
    emit(ok=True, device={"platform": "gpu",
                          "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
