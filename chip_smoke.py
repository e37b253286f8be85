#!/usr/bin/env python3
# ------------------------------------------------------------------
"""Smoke run of the PyTorch/CUDA port (idee_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. build   the card's name and power limit, then nvcc builds every kernel
             of the main path from the sources in this checkout
  2. kernel  each kernel against its plain PyTorch version at the shapes the
             main path gives it (max abs error, stated tolerance), then both
             timed with CUDA events beside the card's least possible time
  3. main    synthetic evaluation (train.evaluate.test_synthetic) with the
             Mamba encoder at the bench width: 6 variables x 1 channel,
             delta_t=8, 200x200, batch 1, random weights from a seed. The
             kernels' launch counters are zeroed just before and read just
             after; then steady-state steps/s, and one forward of the same
             weights and batch with the plain scan for comparison
  4. kernels one line per kernel: route, source, launches, error and times
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

# (L, M) of the fused scan per launch at the bench width, batch 1:
# stage 0 (window (2,4,4): 10,000 windows x 6 variables x 16 channels)
# runs once per block, twice per forward; stage 1 (window (8,1,1): 40,000
# windows x 96) once.
SCAN_SHAPES = {"stage0": (32, 960_000), "stage1": (8, 3_840_000)}
SCAN_LAUNCHES_PER_FORWARD = {"stage0": 2, "stage1": 1}
SCAN_RTOL, SCAN_ATOL = 1e-5, 1e-6

N_WEEKS = 40  # fake cube length: 33 test samples at delta_t=8


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


def scan_inputs(L: int, M: int, seed: int):
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


def phase_build():
    from idee_tpu_torch.kernels import build
    from idee_tpu_torch.kernels import selective_scan as ss

    seconds = build.build([ss.SOURCE])
    emit(phase="build", seconds=seconds,
         libraries=[os.path.relpath(build.library_path(ss.SOURCE), REPO)])


def phase_kernel():
    from idee_tpu_torch.kernels import bounds
    from idee_tpu_torch.kernels import selective_scan as ss

    per_shape = {}
    for i, (stage, (L, M)) in enumerate(SCAN_SHAPES.items()):
        args = scan_inputs(L, M, seed=i)
        y_p, h_p = ss.fused_selective_scan_n1_plain(*args)
        y = ss.fused_selective_scan_n1(*args)
        y_h, h = ss.fused_selective_scan_n1(*args, return_h=True)
        torch.cuda.synchronize()
        err = 0.0
        for name, got, want in (("y", y, y_p), ("y_with_h", y_h, y_p),
                                ("h", h, h_p)):
            torch.testing.assert_close(got, want, rtol=SCAN_RTOL,
                                       atol=SCAN_ATOL, msg=lambda m: (
                                           f"{stage} {name}: {m}"))
            err = max(err, (got - want).abs().max().item())
        rel = ((y - y_p).abs() / y_p.abs().clamp_min(1e-3)).max().item()
        del y, y_h, h, h_p, y_p
        ms = cuda_ms(lambda: ss.fused_selective_scan_n1(*args), iters=50)
        plain_ms = cuda_ms(lambda: ss.fused_selective_scan_n1_plain(*args),
                           iters=5, warmup=1)
        bound_ms, bound_by = bounds.fused_scan_fwd(L, M, with_h=False)
        per_shape[stage] = dict(L=L, M=M, max_abs_err=err,
                                max_rel_err=rel, ms=ms, plain_ms=plain_ms,
                                bound_ms=bound_ms, bound_by=bound_by,
                                share_of_bound=bound_ms / ms)
        del args
    emit(phase="kernel", kernel=ss.KERNEL_NAME, rtol=SCAN_RTOL,
         atol=SCAN_ATOL, shapes=per_shape)
    return per_shape


def phase_main(log_dir: str):
    import idee_tpu_torch.nn.mamba as mamba_mod
    from idee_tpu_torch.config import synthetic_config
    from idee_tpu_torch.data.fake import make_fake_cube
    from idee_tpu_torch.data.loader import DataLoader
    from idee_tpu_torch.data.synthetic import SyntheticDataset
    from idee_tpu_torch.kernels import selective_scan as ss
    from idee_tpu_torch.models.vq_model import build_model
    from idee_tpu_torch.train.evaluate import test_synthetic
    from idee_tpu_torch.train.steps import init_epoch_metrics, make_eval_step

    cfg = synthetic_config(encoder="Mamba", x_max=200, y_max=200,
                           times_test=(1, N_WEEKS), dir_log=log_dir,
                           name="chip_smoke")
    t0 = time.perf_counter()
    cube = make_fake_cube(n_vars=6, n_time=N_WEEKS, height=200, width=200,
                          seed=0)
    cube_s = time.perf_counter() - t0
    params = build_model(cfg, torch.Generator().manual_seed(0)).state_dict()
    n_steps = N_WEEKS - cfg.delta_t + 1

    # --- the main path, with the launch counters zeroed around it
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    ss.launches = 0
    t0 = time.perf_counter()
    result = test_synthetic(cfg, cube=cube, params=params, device="cuda")
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {ss.KERNEL_NAME: ss.launches}
    peak_bytes = torch.cuda.max_memory_allocated()

    want = sum(SCAN_LAUNCHES_PER_FORWARD.values()) * n_steps
    if launches[ss.KERNEL_NAME] != want:
        raise SystemExit(f"{ss.KERNEL_NAME} launched "
                         f"{launches[ss.KERNEL_NAME]} times, expected {want}")
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
    profile = profile_steps(step, metrics, loader, n=5)

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
         launches_per_step=launches[ss.KERNEL_NAME] / n_steps,
         wall_s_with_setup=wall_s, cube_s=cube_s,
         steady_steps_per_s=steps_per_s, steady_samples_per_s=steps_per_s,
         steady_steps_timed=timed, max_memory_allocated=peak_bytes,
         plain_scan_logit_max_abs_err=logit_err,
         plain_scan_anomaly_bit_agreement=bits_agree)
    emit(phase="profile", **profile)
    return launches


def profile_steps(step, metrics, loader, n: int):
    """Where a steady eval step's time goes: torch.profiler over ``n``
    steps; device time by operator, and the device's busy share of the
    wall time (the profiler's own host cost included)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    batches = iter(loader)
    step(metrics, next(batches))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step(metrics, next(batches))
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
                                for ms, k in rows[:12]])


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import idee_tpu_torch  # noqa: F401 -- fails outside a checkout

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_name_and_power()
    print(card, flush=True)

    phase_build()
    per_shape = phase_kernel()
    launches = phase_main(os.path.join(REPO, "build", "chip_smoke_log"))

    from idee_tpu_torch.kernels import selective_scan as ss

    def per_forward(key):
        return sum(per_shape[s][key] * n
                   for s, n in SCAN_LAUNCHES_PER_FORWARD.items())

    emit(kernels=[{
        "name": ss.KERNEL_NAME, "route": "cuda",
        "source": "idee_tpu_torch/kernels/csrc/selective_scan.cu",
        "replaces": "idee_tpu/kernels/selective_scan.py:189",
        "launches": launches[ss.KERNEL_NAME],
        "max_abs_err": max(v["max_abs_err"] for v in per_shape.values()),
        # times per forward: two stage-0 launches and one stage-1 launch
        "ms": per_forward("ms"), "plain_ms": per_forward("plain_ms"),
        "bound_ms": per_forward("bound_ms"),
        "bound_by": per_shape["stage0"]["bound_by"],
        "library_ms": None,
    }], card=card)
    print(card, flush=True)
    emit(ok=True, device={"platform": "gpu",
                          "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
