# ------------------------------------------------------------------
"""CLI: export prediction maps of a trained synthetic run (counterpart of
scripts/predict_synthetic.py).

The reference's test_synthetic.py:27-129 computes metrics and never
exports the model's predictions. This restores a trained run directory
(config snapshot and a checkpoint) and writes one npz over cfg.times_test:

  extreme_prob  [T, H, W] float32  sigmoid of the joint logits at each
                                   target week (NaN for the delta_t - 1
                                   warm-up weeks that are never a target)
  extreme_mask  [T, H, W] uint8    extreme_prob > 0.5 (the reference's
                                   synthetic decision rule,
                                   train_synthetic.py:211)
  anomaly       [V, T, H, W] f32   majority-vote driver timeline
                                   (anomaly_collector semantics,
                                   utils/utils_train.py:529-554); NaN =
                                   a timeline slot no window covers
  timestep      [T] int32          absolute week index
  variables     [V]                the variable names

with ``np.savez_compressed``, and prints the evaluator tables (the same
metrics as evaluation). It runs in cfg.dtype, like training.

    python -m idee_tpu_torch.cli.predict_synthetic --run_dir log/exp1 \
        [--checkpoint best_F1_model] [--times "(2081,2132)"] \
        [--root_synthetic <dir> | --cube_npz <cache>] \
        [--out predictions.npz] [--device cpu]

``--cube_npz`` reads a run trained on an in-memory cube from the cube
cache of cli/train_benchmark_accuracy.py (data/fake.py::save_cube_npz)
and slices it to times_test.
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
from idee_tpu_torch.data.fake import load_cube_npz
from idee_tpu_torch.data.loader import DataLoader
from idee_tpu_torch.data.synthetic import SyntheticCube, SyntheticDataset
from idee_tpu_torch.models.vq_model import build_model, compute_dtype
from idee_tpu_torch.train.checkpoint import load_pretrained_weights
from idee_tpu_torch.train.metrics import (EvaluatorAnomalySynthetic,
                                          EvaluatorSynthetic,
                                          majority_vote_from_device)
from idee_tpu_torch.train.steps import (init_epoch_metrics, make_eval_step,
                                        metrics_to_host)
from idee_tpu_torch.utils.logging import get_logger, log_string

THRESHOLD = 0.5


def predict_synthetic(cfg: Config, ckpt_path: str, out_path: str,
                      cube: Optional[SyntheticCube] = None,
                      device=None) -> Dict[str, np.ndarray]:
    """Load the weights at ``ckpt_path`` (a checkpoint of the port's trainer
    or the JAX package's params as a flax-path .npz) and export the maps
    of cfg.times_test to ``out_path``; returns the payload written. With an
    in-memory ``cube`` the caller slices it to the prediction window
    (``cube.time_slice``): times_test then sets only the absolute-timestep
    offset. ``device``: cuda unless given."""
    dev = resolve_device(device)
    logger = get_logger(cfg)
    ds = SyntheticDataset(
        cube=cube, root_datacube=None if cube is not None
        else cfg.root_synthetic,
        times=cfg.times_test, is_aug=False, is_norm=cfg.is_norm,
        is_clima_scale=cfg.is_clima_scale, variables=list(cfg.variables),
        variables_static=list(cfg.variables_static), delta_t=cfg.delta_t,
        window_size=cfg.window_size, x_min=cfg.x_min, x_max=cfg.x_max,
        y_min=cfg.y_min, y_max=cfg.y_max)
    log_string(logger, "# prediction samples: %d" % len(ds))

    model = build_model(cfg, input_size=ds.input_size)
    model.load_state_dict(load_pretrained_weights(cfg, ckpt_path))
    model.to(dev)

    t0 = float(ds.timestep[0])
    step = make_eval_step(model, cfg, t0=t0, return_preds=True)
    loader = DataLoader(ds, cfg.batch_size, device=dev,
                        keys=["x", "mask_extreme", "mask_extreme_loss",
                              "timestep"], drop_last=False, seed=cfg.seed,
                        x_dtype=compute_dtype(cfg))

    V, T, H, W = ds.anomaly.shape
    probs, slots = [], []
    metrics = init_epoch_metrics(ds.anomaly.shape, dev)
    for batch in loader:
        metrics, preds = step(metrics, batch)
        probs.append(preds["pred"][:, 0])                  # [B, H, W]
        slots.append((batch["timestep"][:, 0] - t0).long())
    # one copy to the host after the loop: the steps never wait on the card
    prob = np.full((T, H, W), np.nan, np.float32)
    prob[torch.cat(slots).cpu().numpy()] = torch.cat(probs).float().cpu() \
        .numpy()

    m = metrics_to_host(metrics)
    anomaly = majority_vote_from_device(m["vote_sum"], m["vote_cnt"])

    # the evaluator tables (get_results logs them)
    ev = EvaluatorSynthetic(logger, "Prediction")
    covered = ~np.isnan(prob[:, 0, 0])
    ev((prob[covered] > THRESHOLD).astype(np.float32)[:, None],
       ds.extreme[covered][:, None])
    ev.get_results()
    ev_a = EvaluatorAnomalySynthetic(logger, "Prediction", cfg.variables)
    ev_a(np.swapaxes(anomaly, 0, 1), np.swapaxes(ds.anomaly, 0, 1))
    ev_a.get_results()

    payload = {
        "extreme_prob": prob,
        "extreme_mask": (np.nan_to_num(prob) > THRESHOLD).astype(np.uint8),
        "anomaly": anomaly.astype(np.float32),
        "timestep": np.asarray(ds.timestep, np.int32),
        "variables": np.asarray(cfg.variables),
    }
    np.savez_compressed(out_path, **payload)
    log_string(logger, "wrote %s" % out_path)
    return payload


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--run_dir", required=True,
                    help="training log dir (config snapshot + checkpoints)")
    ap.add_argument("--checkpoint", default="best_F1_model",
                    help="checkpoint alias under <run_dir>/model_checkpoints")
    ap.add_argument("--times", default=None,
                    help='override times_test, e.g. "(2081,2132)"')
    ap.add_argument("--root_synthetic", default=None)
    ap.add_argument("--cube_npz", default=None,
                    help="generated-cube cache (train_benchmark_accuracy's "
                    "--cube_npz) for runs trained on in-memory cubes; "
                    "sliced to times_test here")
    ap.add_argument("--batch_size", type=int, default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)

    snap = os.path.join(args.run_dir, "config.json")
    if not os.path.exists(snap):
        snap = os.path.join(args.run_dir, "config.pkl")
    over = {"is_aug": False}
    if args.times:
        over["times_test"] = tuple(ast.literal_eval(args.times))
    if args.root_synthetic:
        over["root_synthetic"] = args.root_synthetic
    if args.batch_size:
        over["batch_size"] = args.batch_size
    cfg = load_config(snap).replace(**over)
    cube = None
    if args.cube_npz:
        cube = load_cube_npz(args.cube_npz).time_slice(*cfg.times_test)

    ckpt = os.path.join(args.run_dir, "model_checkpoints",
                        f"{args.checkpoint}.pt")
    out = args.out or os.path.join(args.run_dir, "predictions.npz")
    return predict_synthetic(cfg, ckpt, out, cube=cube, device=args.device)


if __name__ == "__main__":
    main()
