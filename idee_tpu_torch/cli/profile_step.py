# ------------------------------------------------------------------
"""CLI: where does a step's time go? (counterpart of
scripts/profile_step.py)

Runs the fused epochs of the synthetic train or eval step
(train/steps.py::FusedEpoch over a data/device.py::DeviceLoader) on a
make_fake_cube at the bench width (6 variables, delta_t 8, 1-bit LFQ,
CNN_3D classifier), ``--iters`` steps an epoch. On a card the epochs run
until the step is captured (the warm-up steps, then the capture), and one
more epoch, all CUDA-graph replays, runs under torch.profiler. Each span
of utils/spans.py is read from its device marks over the epoch's whole
steps (``steps`` of them: a trace can lose marks at its edges), paired
as ``spans.read_spans`` pairs them: its device ms a step and its share of
the step. Beside them: how much of the step its child spans cover, the
share of the device's busy time that falls inside the steps, and the
marks' own device us a step. The card's name and power limit print with
the numbers.

    python -m idee_tpu_torch.cli.profile_step [--encoder CNN_3D] \
        [--hw 200 | --hw 512x832] [--batch 1] [--iters 8] \
        [--dtype float32] [--mode train|eval] [--out profile.json] \
        [--device cpu]

On the CPU (``--device cpu``) the same epoch runs eagerly and the spans'
host ranges give each span's host ms a step under ``cpu_ms``; no device
time is measured there.
"""
# ------------------------------------------------------------------

import argparse
import json
import subprocess
from typing import Dict, List, Tuple

import torch

from idee_tpu_torch import resolve_device
from idee_tpu_torch.cli.memory_fit import parse_hw
from idee_tpu_torch.config import synthetic_config
from idee_tpu_torch.data.device import DeviceLoader
from idee_tpu_torch.data.fake import make_fake_cube
from idee_tpu_torch.data.synthetic import SyntheticDataset
from idee_tpu_torch.models.vq_model import build_model, compute_dtype
from idee_tpu_torch.train.state import create_train_state
from idee_tpu_torch.train.steps import (make_eval_epoch, make_train_epoch,
                                        metrics_to_host)
from idee_tpu_torch.utils import spans


def card_name_and_power() -> str:
    """The card as ``nvidia-smi --query-gpu=name,power.limit`` names it."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _whole_steps(events, host) -> Tuple[int, int]:
    """The device time of the traced epoch's whole steps: from its first
    ``step`` begin mark to its last ``step`` end mark, both inside the
    epoch's host ranges. A trace can lose or deliver late the records at
    its edges; a step cut there is left out, and ``steps`` counts the
    rest."""
    lo, hi = host["order"][0][0], host["metrics_to_host"][-1][1]
    marks = spans.device_marks(events, (lo, hi))
    begins = [a for a, _, n in marks if n == spans.MARK + "step_begin"]
    ends = [b for _, b, n in marks if n == spans.MARK + "step_end"]
    if not begins or not ends:
        raise RuntimeError("the traced epoch holds no whole step")
    return min(begins), max(ends)


def _table(found: Dict[str, List[Tuple[int, int]]], key: str
           ) -> Tuple[List[dict], dict]:
    """Each span's row (instances, ms a step, share of the step) and the
    children's cover of the step."""
    total = {k: sum(b - a for a, b in v) for k, v in found.items()}
    steps = len(found.get("step", ()))
    if not steps:
        raise RuntimeError("the traced epoch holds no step span")
    rows = [{"span": k, "n": len(found[k]), key: total[k] * 1e-6 / steps,
             "share": total[k] / total["step"]}
            for k in spans.NAMES if k in found]
    children = sum(t for k, t in total.items()
                   if spans.PARENT.get(k) == "step")
    return rows, {"steps": steps,
                  f"step_{key}": total["step"] * 1e-6 / steps,
                  "children_cover": children / total["step"]}


def profile(encoder: str = "CNN_3D", hw="200", batch: int = 1,
            iters: int = 8, dtype: str = "float32", mode: str = "train",
            device=None) -> Dict:
    """The spans' rows and the step's summary (see the module doc).
    ``hw``: "HxW" or one square size."""
    dev = resolve_device(device)
    H, W = parse_hw(str(hw))
    train = mode == "train"
    cfg = synthetic_config(encoder=encoder, dtype=dtype, batch_size=batch,
                           x_max=W, y_max=H, is_aug=train)
    n_weeks = iters * batch + cfg.delta_t - 1
    cube = make_fake_cube(n_vars=6, n_time=n_weeks, height=H, width=W,
                          seed=0)
    ds = SyntheticDataset(cube=cube, times=(1, n_weeks),
                          variables=cube.variables, delta_t=cfg.delta_t,
                          is_aug=train, is_clima_scale=False, x_max=W,
                          y_max=H)
    loader = DeviceLoader(ds, batch, seed=0, dtype=compute_dtype(cfg),
                          device=dev)
    model = build_model(cfg, torch.Generator().manual_seed(0),
                        input_size=ds.input_size).to(dev)
    if not model._scalar_lfq():
        raise ValueError("profile_step runs the packed 1-bit LFQ path")
    t0 = float(ds.timestep[0])
    if train:
        state = create_train_state(cfg, model, dev,
                                   steps_per_epoch=len(loader))
        fused = make_train_epoch(model, cfg, loader, ds.anomaly.shape,
                                 t0=t0, steps_per_epoch=len(loader))

        def epoch():
            return metrics_to_host(fused(state))
    else:
        fused = make_eval_epoch(model, cfg, loader, ds.anomaly.shape, t0=t0)

        def epoch():
            return metrics_to_host(fused())

    on_card = dev.type == "cuda"
    epoch()
    while on_card and fused.graph is None:
        epoch()
    activities = [torch.profiler.ProfilerActivity.CPU]
    if on_card:
        torch.cuda.synchronize(dev)
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        epoch()  # its metric read synchronises
    events = prof.profiler.kineto_results.events()

    key = "ms" if on_card else "cpu_ms"
    host = spans.host_ranges(events)
    found = host
    if on_card:
        window = _whole_steps(events, host)
        found = spans.read_spans(events, window)
    rows, step = _table(found, key)
    for r in rows:
        print(f"{r['span']:18s} {r['n']:5d} {r[key]:12.4f} {key:6s} "
              f"{100 * r['share']:7.2f} % of the step", flush=True)
    summary = {"encoder": encoder, "hw": f"{H}x{W}", "batch": batch,
               "dtype": dtype, "mode": mode, "iters": iters,
               "device": dev.type,
               "params": sum(p.numel() for p in model.parameters()),
               "spans": rows, **step}
    if on_card:
        marks = spans.device_marks(events, window)
        steps = step["steps"]
        summary.update(
            busy_cover=spans.busy_ns(events, within=found["step"])
            / spans.busy_ns(events, within=[window]),
            marks_us_per_step=sum(b - a for a, b, _ in marks) * 1e-3
            / steps,
            marks_per_step=len(marks) / steps,
            card=card_name_and_power(),
            kind=torch.cuda.get_device_name(dev))
    return summary


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--encoder", default="CNN_3D")
    ap.add_argument("--hw", default="200", help='"HxW" or one square size')
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--iters", type=int, default=8,
                    help="steps of the traced epoch")
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--mode", default="train", choices=["train", "eval"])
    ap.add_argument("--out", default=None, help="write the summary here")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    summary = profile(args.encoder, args.hw, args.batch, args.iters,
                      args.dtype, args.mode, args.device)
    if "card" in summary:
        print(summary["card"], flush=True)
    print(json.dumps({k: v for k, v in summary.items() if k != "spans"}),
          flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(summary, fh, indent=1)
    return summary


if __name__ == "__main__":
    main()
