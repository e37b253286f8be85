# ------------------------------------------------------------------
"""CLI: an accuracy run on the benchmark cube (counterpart of
scripts/train_benchmark_accuracy.py).

Trains one encoder and codebook on data/fake.py::make_benchmark_cube (the
stand-in for the reference's 46 GB synthetic dataset: causal
anomaly-to-extreme structure with distractors) over a 34-year / rest split
of 52-week years, and records the best validation extremes F1 and
majority-vote driver F1 with the reference evaluator's semantics.

It trains with the stable recipe of the JAX package's study (BASELINE.md,
"Training dynamics"): init_scheme="lecun", codebook_freeze_out=True,
lambda_anomaly=0, lambda_commitment from the flag (0 unless given), global
statistics (is_clima_scale=False), augmentation on, bf16 compute.

    python -m idee_tpu_torch.cli.train_benchmark_accuracy --encoder CNN_3D \
        --hw 48 --years 40 --batch 8 --epochs 15 --cube_npz cube48.npz \
        [--codebook VQ_EMA --lambda_commitment 0.25] [--dtype float32] \
        [--device cpu]

Takes the JAX script's flags, with ``--device`` (default cuda) in place of
``--platform`` and ``--dtype`` (default bfloat16, which the JAX script
fixes), so one arm can run in float32; a run that is not bf16 gets
``_<dtype>`` at the end of its name. ``device_data`` stays off (the
JAX script turns it on): batches come from the host loader, as in the
arms PERF.md records; chip_smoke.py's accuracy_device phase runs this
geometry with device_data.
Writes the JAX script's JSON payload to --out (default
<tmp>/<name>.json) and returns it; checkpoints go to <dir_log>/<name>/.
"""
# ------------------------------------------------------------------

import argparse
import json
import os
import tempfile

from idee_tpu_torch.config import Config, synthetic_config
from idee_tpu_torch.data.fake import (load_cube_npz, make_benchmark_cube,
                                      save_cube_npz)
from idee_tpu_torch.data.synthetic import SyntheticCube
from idee_tpu_torch.train.driver import train_synthetic

RECIPE = "stable (lecun, freeze_out, no commitment, no anomaly-L1)"


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--encoder", default="CNN_3D")
    ap.add_argument("--codebook", default="LFQ",
                    help="LFQ | VQ (learnable) | VQ_EMA (EMA, k-means init, "
                    "dead-code expiry) | FSQ | LatentQuantize | Random_VQ")
    ap.add_argument("--bce_weighting", default="reference",
                    choices=["reference", "capped", "focal"])
    ap.add_argument("--epochs", type=int, default=15)
    ap.add_argument("--hw", type=int, default=200)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--years", type=int, default=40,
                    help="cube length in years (34 train / rest val)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--name", default=None)
    ap.add_argument("--dir_log",
                    default=os.path.join(tempfile.gettempdir(), "acc_runs"))
    ap.add_argument("--out", default=None)
    ap.add_argument("--cube_npz", default=None,
                    help="cache of the generated cube: loaded when it "
                    "exists, written after generation when it does not")
    ap.add_argument("--lambda_commitment", type=float, default=0.0,
                    help="commitment weight; the VQ codebooks need it to "
                    "anchor the encoder's scale (BASELINE.md)")
    ap.add_argument("--d_state", type=int, default=None,
                    help="Mamba state size of both stages (default: the "
                    "config's)")
    ap.add_argument("--density_ref_hw", type=int, default=48,
                    help="hold the planted event density per unit area at "
                    "this grid size (events and distractors per year scale "
                    "by (hw/ref)^2; the event radii are absolute); 0 "
                    "disables the scaling")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    ap.add_argument("--device", default=None)
    return ap.parse_args(argv)


def run_name(args) -> str:
    suffix = "" if args.codebook == "LFQ" else f"_{args.codebook}"
    if args.bce_weighting != "reference":
        suffix += f"_{args.bce_weighting}"
    if args.d_state is not None:
        suffix += f"_ds{args.d_state}"
    if args.lambda_commitment:
        suffix += f"_commit{args.lambda_commitment:g}"
    if args.dtype != "bfloat16":
        suffix += f"_{args.dtype}"
    return args.name or f"acc_{args.encoder}_{args.hw}{suffix}"


def split_weeks(years: int):
    """(n_time, last training week): 34 years of 52 weeks for training,
    the rest for validation; 85 % for training in a cube of 34 years or
    fewer."""
    n_time = years * 52
    return n_time, 34 * 52 if years > 34 else int(n_time * 0.85)


def build_config(args) -> Config:
    cb_kw = {}
    if args.codebook == "VQ_EMA":
        cb_kw = dict(codebook="VQ", vq_ema_update=True, vq_kmeans_init=True,
                     vq_threshold_ema_dead_code=2.0)
    elif args.codebook != "LFQ":
        cb_kw = dict(codebook=args.codebook)
    if args.d_state is not None:
        cb_kw["d_state"] = [args.d_state, args.d_state]
    n_time, t_train = split_weeks(args.years)
    return synthetic_config(
        encoder=args.encoder, name=run_name(args), dir_log=args.dir_log,
        batch_size=args.batch, n_epochs=args.epochs,
        x_max=args.hw, y_max=args.hw,
        times_train=(1, t_train), times_val=(t_train + 1, n_time),
        is_clima_scale=False, is_aug=True, dtype=args.dtype,
        # the stable recipe (BASELINE.md, "Training dynamics")
        init_scheme="lecun", codebook_freeze_out=True,
        lambda_commitment=args.lambda_commitment, lambda_anomaly=0.0,
        bce_weighting=args.bce_weighting, seed=args.seed, **cb_kw)


def benchmark_cube(args) -> SyntheticCube:
    """The run's cube: from --cube_npz when it exists, else generated (and
    cached there when given)."""
    if args.cube_npz and os.path.exists(args.cube_npz):
        return load_cube_npz(args.cube_npz)
    dens = ((args.hw / args.density_ref_hw) ** 2
            if args.density_ref_hw else 1.0)
    cube = make_benchmark_cube(
        n_vars=6, n_time=split_weeks(args.years)[0], height=args.hw,
        width=args.hw, seed=args.seed, events_per_year=8.0 * dens,
        distractors_per_year=10.0 * dens)
    if args.cube_npz:
        os.makedirs(os.path.dirname(os.path.abspath(args.cube_npz)),
                    exist_ok=True)
        save_cube_npz(args.cube_npz, cube)
    return cube


def _nan_safe_max(values):
    """max over the finite-or-inf entries; None when all are NaN (an
    epoch with no predicted positive)."""
    kept = [v for v in values if v == v]
    return max(kept) if kept else None


def main(argv=None) -> dict:
    args = parse_args(argv)
    cfg = build_config(args)
    out = args.out or os.path.join(tempfile.gettempdir(), f"{cfg.name}.json")
    cube = benchmark_cube(args)
    n_time, t_train = split_weeks(args.years)
    history = train_synthetic(
        cfg, train_cube=cube.time_slice(1, t_train),
        val_cube=cube.time_slice(t_train + 1, n_time), device=args.device)
    history.pop("state", None)

    payload = {
        "encoder": args.encoder, "hw": args.hw, "batch": args.batch,
        "codebook": args.codebook, "bce_weighting": args.bce_weighting,
        "density_ref_hw": args.density_ref_hw, "d_state": args.d_state,
        "lambda_commitment": args.lambda_commitment,
        "epochs": args.epochs, "recipe": RECIPE, "history": history,
        "best_val_f1": _nan_safe_max(history["val_f1"]),
        "best_val_anom_f1": _nan_safe_max(history["val_anom_f1"]),
    }
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(payload, f, indent=1)
    print(json.dumps({k: payload[k] for k in
                      ("encoder", "best_val_f1", "best_val_anom_f1")}))
    return payload


if __name__ == "__main__":
    main()
