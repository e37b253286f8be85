# ------------------------------------------------------------------
"""CLI: export prediction maps of a trained real-world run (counterpart of
scripts/predict_real.py).

The reference's test_CERRA.py:95-127 prints the drought evaluator and
discards the maps. This restores a trained run and writes, per test sample
(= target week), what downstream users consume:

  drought_prob  [N, H, W] float32  sigmoid of the joint logits
  drought_mask  [N, H, W] uint8    prob > 0.35 (train_CERRA.py:212) and
                                   valid
  anomaly       [N, V, T, H, W] u8 the driver bits over the delta_t input
                                   window, in chronological order
  valid_mask    [N, H, W] uint8    1 - sea - cold - no_vegetation
                                   (test_CERRA.py:112-113)
  name_code     [N] int64          <year><www> of the target week's file
  variables     [V]                the variable names

with ``np.savez_compressed``, and prints the 2-class evaluator over the
valid pixels.

    python -m idee_tpu_torch.cli.predict_real --run_dir log/cerra_run \
        --family CERRA [--years "['2020','2021']"] \
        [--checkpoint best_F1_model] [--out predictions_real.npz] \
        [--device cpu]
"""
# ------------------------------------------------------------------

import argparse
import ast
import os
from typing import Dict, Optional

import numpy as np
import torch

from idee_tpu_torch import resolve_device
from idee_tpu_torch.config import Config, load_config
from idee_tpu_torch.data.loader import DataLoader
from idee_tpu_torch.data.reanalysis import ReanalysisDataset
from idee_tpu_torch.models.vq_model import build_model, compute_dtype
from idee_tpu_torch.train.checkpoint import load_pretrained_weights
from idee_tpu_torch.train.driver_real import TEST_KEYS, make_reanalysis_dataset
from idee_tpu_torch.train.metrics import Evaluator
from idee_tpu_torch.train.steps import metrics_to_host
from idee_tpu_torch.train.steps_real import (THRESHOLD,
                                             init_epoch_metrics_real,
                                             make_eval_step_real)
from idee_tpu_torch.utils.logging import get_logger, log_string


def predict_real(cfg: Config, family: str, ckpt_path: str, out_path: str,
                 test_ds: Optional[ReanalysisDataset] = None,
                 device=None) -> Dict[str, np.ndarray]:
    """Load the weights at ``ckpt_path`` (a checkpoint of the port's trainer
    or the JAX package's params as a flax-path .npz), export the maps of
    cfg.years_test to ``out_path``; returns the payload written.
    ``device``: cuda unless given."""
    dev = resolve_device(device)
    logger = get_logger(cfg)
    if test_ds is None:
        test_ds = make_reanalysis_dataset(cfg, family, cfg.years_test, False)
    log_string(logger, "# prediction samples: %d" % len(test_ds))

    model = build_model(cfg, input_size=test_ds.input_size)
    model.load_state_dict(load_pretrained_weights(cfg, ckpt_path))
    model.to(dev)
    step = make_eval_step_real(model, cfg, test_mode=True, return_preds=True)
    loader = DataLoader(test_ds, cfg.batch_size, device=dev,
                        keys=TEST_KEYS + ["name_code"], drop_last=False,
                        seed=cfg.seed, workers=cfg.loader_workers,
                        x_dtype=compute_dtype(cfg))

    parts = {k: [] for k in ("drought_prob", "drought_mask", "anomaly",
                             "valid_mask", "name_code")}
    metrics = init_epoch_metrics_real(dev)
    for batch in loader:
        metrics, preds = step(metrics, batch)
        # fractional where ERA5-Land's land fraction is: the decision rule
        # takes valid > 0, valid_mask its truncation to uint8, as the JAX
        # exporter does
        valid = torch.clamp(1.0 - batch["mask_sea"]
                            - batch["mask_cold_surface"]
                            - batch["mask_no_vegetation"], min=0.0)
        prob = preds["pred"]
        parts["drought_prob"].append(prob)
        parts["drought_mask"].append((prob > THRESHOLD) & (valid > 0))
        # the input window is time-reversed (index 0 = target week)
        parts["anomaly"].append(preds["anomaly"].flip(2))
        parts["valid_mask"].append(valid)
        parts["name_code"].append(batch["name_code"])

    ev = Evaluator(logger, "Prediction")
    ev.update_counts(metrics_to_host(metrics)["counts"])
    ev.get_results(0, 0)

    dtypes = {"drought_prob": np.float32, "drought_mask": np.uint8,
              "anomaly": np.uint8, "valid_mask": np.uint8,
              "name_code": np.int64}
    payload = {k: torch.cat(v).cpu().numpy().astype(dtypes[k])
               for k, v in parts.items()}
    payload["variables"] = np.asarray(cfg.variables)
    np.savez_compressed(out_path, **payload)
    log_string(logger, "wrote %s" % out_path)
    return payload


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--run_dir", required=True)
    ap.add_argument("--family", default="CERRA",
                    choices=["CERRA", "ERA5_Land"])
    ap.add_argument("--checkpoint", default="best_F1_model",
                    help="checkpoint alias under <run_dir>/model_checkpoints")
    ap.add_argument("--years", default=None,
                    help="override years_test, e.g. \"['2020','2021']\"")
    ap.add_argument("--batch_size", type=int, default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)

    snap = os.path.join(args.run_dir, "config.json")
    if not os.path.exists(snap):
        snap = os.path.join(args.run_dir, "config.pkl")
    over = {"is_aug": False}
    if args.years:
        over["years_test"] = list(ast.literal_eval(args.years))
    if args.batch_size:
        over["batch_size"] = args.batch_size
    cfg = load_config(snap).replace(**over)

    ckpt = os.path.join(args.run_dir, "model_checkpoints",
                        f"{args.checkpoint}.pt")
    out = args.out or os.path.join(args.run_dir, "predictions_real.npz")
    return predict_real(cfg, args.family, ckpt, out, device=args.device)


if __name__ == "__main__":
    main()
