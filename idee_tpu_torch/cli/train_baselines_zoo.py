# ------------------------------------------------------------------
"""CLI: train the baseline zoo end to end on the benchmark cube and record
the best validation driver F1 of each baseline (counterpart of
scripts/train_baselines_zoo.py).

The baselines train through their drivers on the cube of the accuracy
runs (data/fake.py::make_benchmark_cube, 6 variables), split 34 years /
rest as the reference protocol splits them, batch 8, augmentation on,
global statistics. Driver F1 is the majority-vote anomaly F1
(evaluator_anomaly_synthetic semantics).

    python -m idee_tpu_torch.cli.train_baselines_zoo \
        --which deepmil,arnet,rtfm,mgfn,simplenet,steal,uniad --hw 48 \
        --epochs 6 --pretrained <dir_log>/<run>/model_checkpoints/best_F1_model \
        [--out zoo.json] [--device cpu]

--which takes any of the seven (default deepmil,simplenet,steal,uniad).
--pretrained is a checkpoint of the port's core trainer (a .pt file, or
its alias without the suffix, e.g. an accuracy run's best_F1_model), or
the JAX package's params as a flax-path .npz: SimpleNet's frozen backbone
(the reference protocol, Baselines_OneClass/models/build_simplenet.py:
146-163; with a random backbone its median threshold flags nearly
nothing). UniAD runs at delta_t=1 on 6 input planes with (hw/2, hw/2)
tokens. STEAL runs at the synthetic delta_t of 8: at the reconstruction
config's delta_t of 1 its decoder cannot give the window back (the JAX
script broadcasts the mismatch into the loss; the port's STEAL raises).
The JSON list is rewritten after each baseline. Takes the JAX script's
flags, with ``--device`` (default cuda) in place of ``--platform``.
"""
# ------------------------------------------------------------------

import argparse
import json
import os
import tempfile
import time
from typing import Optional

from idee_tpu_torch.baselines.config import (mil_config, oneclass_config,
                                             recon_config)
from idee_tpu_torch.baselines.mil.driver import train_mil_synthetic
from idee_tpu_torch.baselines.oneclass.driver import train_simplenet_synthetic
from idee_tpu_torch.baselines.recon.driver import train_recon_synthetic
from idee_tpu_torch.cli.train_benchmark_accuracy import split_weeks
from idee_tpu_torch.data.fake import make_benchmark_cube

MIL = ("deepmil", "arnet", "rtfm", "mgfn")
ALL = MIL + ("simplenet", "steal", "uniad")


def checkpoint_path(path: Optional[str]) -> Optional[str]:
    """``path``, or ``path``.pt where only that exists (an alias)."""
    if path and not os.path.exists(path) and os.path.exists(path + ".pt"):
        return path + ".pt"
    return path


def zoo_config(which: str, hw: int, epochs: int, years: int, dir_log: str,
               pretrained: Optional[str] = None):
    """The config the zoo trains ``which`` with."""
    n_time, t_train = split_weeks(years)
    common = dict(
        in_channels_dynamic=6, name=f"zoo_{which}_{hw}", dir_log=dir_log,
        x_max=hw, y_max=hw,
        times_train=(1, t_train), times_val=(t_train + 1, n_time),
        n_epochs=epochs, batch_size=8, is_aug=True, is_clima_scale=False)
    if which in MIL:
        return mil_config(**common)
    if which == "simplenet":
        return oneclass_config(model_pretrained=checkpoint_path(pretrained),
                               **common)
    if which == "steal":
        return recon_config(delta_t=8, **common)
    if which == "uniad":
        return recon_config(delta_t=1, inplanes=6,
                            feature_size=(hw // 2, hw // 2), **common)
    raise SystemExit(f"unknown baseline {which}; choose from {ALL}")


def run_one(which: str, cube, hw: int, epochs: int, years: int,
            dir_log: str, pretrained: Optional[str] = None,
            device=None) -> dict:
    """Train ``which`` on ``cube``; its line of the JSON list."""
    cfg = zoo_config(which, hw, epochs, years, dir_log, pretrained)
    n_time, t_train = split_weeks(years)
    cubes = dict(train_cube=cube.time_slice(1, t_train),
                 val_cube=cube.time_slice(t_train + 1, n_time),
                 device=device)
    t0 = time.time()
    if which in MIL:
        hist = train_mil_synthetic(cfg, which, **cubes)
    elif which == "simplenet":
        hist = train_simplenet_synthetic(cfg, **cubes)
    else:
        hist = train_recon_synthetic(cfg, which, **cubes)
    hist.pop("state", None)
    hist.pop("bb_variables", None)
    f1s = [v for v in hist.get("val_anom_f1", [])
           if v is not None and v == v]
    return {
        "baseline": which,
        "epochs": epochs,
        "best_val_anom_f1": max(f1s) if f1s else None,
        "final_val_loss": (hist.get("val_loss") or [None])[-1],
        "steps_per_sec": (hist.get("steps_per_sec") or [None])[-1],
        "history": hist,
        "secs": round(time.time() - t0, 1),
    }


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--which", default="deepmil,simplenet,steal,uniad")
    ap.add_argument("--hw", type=int, default=48)
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--years", type=int, default=40)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dir_log",
                    default=os.path.join(tempfile.gettempdir(), "zoo_runs"))
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "baseline_zoo.json"))
    ap.add_argument("--pretrained", default=None,
                    help="core checkpoint for SimpleNet's frozen backbone")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    cube = make_benchmark_cube(n_vars=6, n_time=split_weeks(args.years)[0],
                               height=args.hw, width=args.hw, seed=args.seed)
    results = []
    for which in args.which.split(","):
        res = run_one(which.strip(), cube, args.hw, args.epochs, args.years,
                      args.dir_log, pretrained=args.pretrained,
                      device=args.device)
        results.append(res)
        print(json.dumps({k: res[k] for k in
                          ("baseline", "best_val_anom_f1",
                           "final_val_loss", "secs")}), flush=True)
        with open(args.out, "w") as f:  # rewritten after each baseline
            json.dump(results, f, indent=1)
    return results


if __name__ == "__main__":
    main()
