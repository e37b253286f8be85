# ------------------------------------------------------------------
"""CLI: where does a train step's time go? (counterpart of
scripts/profile_step.py)

Times each segment of the synthetic train step on one batch of a
make_fake_cube at the bench width (6 variables, delta_t 8, 1-bit LFQ,
CNN_3D classifier): the encoder forward, the quantizer, the classifier,
the loss, the metric and vote counters, the optimizer update, the
forward-only step (model forward and loss) and the full step (forward,
loss, backward, Adam, counters). Each segment runs ``--iters`` times
after a warm-up, timed per call with CUDA events, and reports the
median. FLOPs come from ``torch.utils.flop_counter.FlopCounterMode``
over one call (the aten products and convolutions; the hand-written scan
and attention kernels are not counted), and the MFU is achieved FLOP/s
over the H100's dense peak for the compute dtype (kernels/bounds.py: 67
TFLOP/s float32, 989 bf16). The card's name and power limit print with
the numbers.

    python -m idee_tpu_torch.cli.profile_step [--encoder CNN_3D] \
        [--hw 200] [--batch 1] [--iters 30] [--dtype float32] \
        [--out profile.json] [--device cpu]

On the CPU (``--device cpu``) the segments run and are timed with the
host clock under ``cpu_ms``; no device time or MFU is reported.
"""
# ------------------------------------------------------------------

import argparse
import json
import statistics
import subprocess
import time
from typing import Callable, Dict, List

import torch
from torch.utils.flop_counter import FlopCounterMode

from idee_tpu_torch import losses, resolve_device
from idee_tpu_torch.config import synthetic_config
from idee_tpu_torch.data.fake import make_fake_cube
from idee_tpu_torch.data.loader import DataLoader
from idee_tpu_torch.data.synthetic import SyntheticDataset
from idee_tpu_torch.kernels.bounds import PEAK_BF16_PER_S, PEAK_FP32_PER_S
from idee_tpu_torch.models.vq_model import build_model, compute_dtype
from idee_tpu_torch.train.state import create_train_state
from idee_tpu_torch.train.steps import (_accumulate, _bce_kwargs,
                                        init_epoch_metrics, make_train_step)

N_WEEKS = 64
PEAKS = {"float32": PEAK_FP32_PER_S, "bfloat16": PEAK_BF16_PER_S}


def card_name_and_power() -> str:
    """The card as ``nvidia-smi --query-gpu=name,power.limit`` names it."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _times_ms(fn: Callable[[], object], iters: int, device) -> List[float]:
    """ms of each of ``iters`` calls after one warm-up call: CUDA events
    around each call on a card (read after one synchronise), the host
    clock on the CPU."""
    fn()
    if device.type != "cuda":
        out = []
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            out.append(1e3 * (time.perf_counter() - t0))
        return out
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize(device)
    return [start.elapsed_time(end) for start, end in events]


def _flops(fn: Callable[[], object]) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def profile(encoder: str = "CNN_3D", hw: int = 200, batch: int = 1,
            iters: int = 30, dtype: str = "float32", device=None) -> Dict:
    """The segments' rows and the step's summary (see the module doc)."""
    dev = resolve_device(device)
    cfg = synthetic_config(encoder=encoder, dtype=dtype, batch_size=batch,
                           x_max=hw, y_max=hw, is_aug=False)
    cube = make_fake_cube(n_vars=6, n_time=N_WEEKS, height=hw, width=hw,
                          seed=0)
    ds = SyntheticDataset(cube=cube, times=(1, N_WEEKS),
                          variables=cube.variables, delta_t=cfg.delta_t,
                          is_clima_scale=False, x_max=hw, y_max=hw)
    b = next(iter(DataLoader(ds, batch, device=dev, prefetch=0,
                             keys=["x", "mask_extreme", "mask_extreme_loss",
                                   "timestep"],
                             x_dtype=compute_dtype(cfg))))
    model = build_model(cfg, torch.Generator().manual_seed(0))
    state = create_train_state(cfg, model, dev, steps_per_epoch=100)
    if not model._scalar_lfq():
        raise ValueError("profile_step times the packed 1-bit LFQ path")
    metrics = init_epoch_metrics(ds.anomaly.shape, dev)
    train_step = make_train_step(model, cfg, t0=float(ds.timestep[0]))
    bce = _bce_kwargs(cfg)
    V = cfg.in_channels_dynamic
    x = b["x"]

    def full_step():
        train_step(state, metrics, b)

    @torch.no_grad()
    def forward():
        model.eval()
        out = model(x, train=False, mask_extreme_loss=b["mask_extreme_loss"])
        return out, losses.total_loss_synthetic(
            out, b["mask_extreme"], b["mask_extreme_loss"],
            cfg.lambda_anomaly, **bce)

    @torch.no_grad()
    def encoder_fwd():
        return model.encoder(x.to(model.dtype), train=False, packed_out=True)

    zp = encoder_fwd()

    @torch.no_grad()
    def quantizer():
        parts = model.vq.quantize_packed(zp, V, train=False)
        w_out, b_out = model.vq.out_proj_params()
        return (parts.s_q[..., None] * w_out + b_out).reshape(zp.shape)

    zq = quantizer()

    @torch.no_grad()
    def classifier():
        return model.cls(zq.to(model.dtype), train=False, packed=True)

    out, _ = forward()

    @torch.no_grad()
    def loss():
        return losses.total_loss_synthetic(
            out, b["mask_extreme"], b["mask_extreme_loss"],
            cfg.lambda_anomaly, **bce)

    _, comps = loss()
    scratch = init_epoch_metrics(ds.anomaly.shape, dev)

    @torch.no_grad()
    def counters():
        _accumulate(scratch, comps, out, b, float(ds.timestep[0]),
                    cfg.delta_t)

    def optimizer():
        for p in model.parameters():
            p.grad = torch.zeros_like(p)
        state.update()

    segments = [("train_step (fwd+bwd+adam+counters)", full_step),
                ("forward + loss (no grad)", forward),
                ("encoder forward", encoder_fwd),
                ("quantizer", quantizer),
                ("classifier", classifier),
                ("loss", loss),
                ("metric and vote counters", counters),
                ("optimizer update (adam)", optimizer)]
    on_card = dev.type == "cuda"
    key = "ms" if on_card else "cpu_ms"
    peak = PEAKS[dtype]
    rows = []
    for name, fn in segments:
        ms = statistics.median(_times_ms(fn, iters, dev))
        flops = _flops(fn)
        row = {"segment": name, key: ms, "gflop": flops / 1e9}
        if on_card:
            row["tflop_per_s"] = flops / (ms * 1e-3) / 1e12
            row["mfu"] = flops / (ms * 1e-3) / peak
        rows.append(row)
        print(f"{name:38s} {ms:10.3f} {key:6s} {flops / 1e9:10.2f} GFLOP",
              flush=True)
    step = rows[0]
    summary = {"encoder": encoder, "hw": hw, "batch": batch, "dtype": dtype,
               "iters": iters, "device": dev.type,
               "params": sum(p.numel() for p in model.parameters()),
               "segments": rows, f"step_{key}": step[key],
               "step_gflop": step["gflop"]}
    if on_card:
        summary.update(card=card_name_and_power(),
                       kind=torch.cuda.get_device_name(dev),
                       step_tflop_per_s=step["tflop_per_s"],
                       step_mfu=step["mfu"], peak_tflop_per_s=peak / 1e12)
    return summary


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--encoder", default="CNN_3D")
    ap.add_argument("--hw", type=int, default=200)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--out", default=None, help="write the summary here")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    summary = profile(args.encoder, args.hw, args.batch, args.iters,
                      args.dtype, args.device)
    if "card" in summary:
        print(summary["card"], flush=True)
    print(json.dumps({k: v for k, v in summary.items() if k != "segments"}),
          flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(summary, fh, indent=1)
    return summary


if __name__ == "__main__":
    main()
