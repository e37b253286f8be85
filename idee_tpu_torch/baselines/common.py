# ------------------------------------------------------------------
"""What the three baseline drivers share (each JAX driver keeps its own
copy): the datasets, the device-resident vote metrics and the epoch loop
with its checkpoints.

An epoch's loss sum, step count and anomaly vote timeline stay on the
device; the host reads them once per epoch, as in the port's core driver.
"""
# ------------------------------------------------------------------

from typing import Callable, Dict

import numpy as np
import torch

from idee_tpu_torch.config import Config
from idee_tpu_torch.data.synthetic import SyntheticDataset
from idee_tpu_torch.train.checkpoint import CheckpointManager
from idee_tpu_torch.train.driver import _nanmean as nanmean
from idee_tpu_torch.train.metrics import (EvaluatorAnomalySynthetic,
                                          majority_vote_from_device)
from idee_tpu_torch.train.steps import _scatter_votes, metrics_to_host
from idee_tpu_torch.utils.logging import StepTimer, log_string


def make_datasets(cfg: Config, train_cube=None, val_cube=None,
                  replace_anomaly: bool = False):
    """Train and validation datasets without static variables; with
    ``replace_anomaly`` the training one is anomaly-replaced
    (cfg.is_replace_anomaly of the one-class and reconstruction
    configs)."""
    common = dict(
        variables=list(cfg.variables), variables_static=[],
        delta_t=cfg.delta_t, is_norm=cfg.is_norm,
        is_clima_scale=cfg.is_clima_scale, window_size=cfg.window_size,
        x_min=cfg.x_min, x_max=cfg.x_max, y_min=cfg.y_min, y_max=cfg.y_max,
        seed=cfg.seed)
    train_ds = SyntheticDataset(
        cube=train_cube,
        root_datacube=None if train_cube is not None else cfg.root_synthetic,
        times=cfg.times_train, is_aug=cfg.is_aug,
        is_replace_anomaly=replace_anomaly, **common)
    val_ds = SyntheticDataset(
        cube=val_cube,
        root_datacube=None if val_cube is not None else cfg.root_synthetic,
        times=cfg.times_val, is_aug=False, **common)
    return train_ds, val_ds


def test_dataset(cfg: Config, cube=None) -> SyntheticDataset:
    return SyntheticDataset(
        cube=cube, root_datacube=None if cube is not None
        else cfg.root_synthetic,
        times=cfg.times_test, is_aug=False, is_norm=cfg.is_norm,
        is_clima_scale=cfg.is_clima_scale, variables=list(cfg.variables),
        variables_static=[], delta_t=cfg.delta_t,
        window_size=cfg.window_size, x_min=cfg.x_min, x_max=cfg.x_max,
        y_min=cfg.y_min, y_max=cfg.y_max)


def init_vote_metrics(anomaly_shape, device) -> Dict[str, torch.Tensor]:
    V, T, H, W = anomaly_shape
    return {"loss_sum": torch.zeros((), device=device),
            "n_steps": torch.zeros((), dtype=torch.int64, device=device),
            "vote_sum": torch.zeros((V, T, H, W), dtype=torch.uint8,
                                    device=device),
            "vote_cnt": torch.zeros((T,), dtype=torch.int32,
                                    device=device)}


def accumulate(metrics, loss, anomaly, batch, t0: float, delta_t: int):
    """Add one step's loss and (when given) its anomaly bits [N, V, dt, H,
    W] onto the epoch metrics, in place."""
    metrics["loss_sum"] += loss.detach()
    metrics["n_steps"] += 1
    if anomaly is not None:
        t_index = (batch["timestep"][:, 0] - t0).long()
        _scatter_votes(metrics["vote_sum"], metrics["vote_cnt"], anomaly,
                       t_index, delta_t)
    return metrics


def epoch_results(metrics):
    """(mean loss, majority-vote anomaly [V, T, H, W], vote_cnt) of one
    epoch's metrics, read on the host."""
    m = metrics_to_host(metrics)
    anomaly = majority_vote_from_device(m["vote_sum"], m["vote_cnt"])
    return (float(m["loss_sum"]) / max(int(m["n_steps"]), 1), anomaly,
            m["vote_cnt"])


def evaluate(cfg: Config, logger, name: str, eval_step: Callable, loader,
             ds, device) -> Dict:
    """One pass of ``eval_step`` over ``loader``; the driver scores of the
    majority vote against the dataset's ground truth, the mean loss and
    the vote map."""
    evaluator = EvaluatorAnomalySynthetic(logger, name, cfg.variables)
    metrics = init_vote_metrics(ds.anomaly.shape, device)
    for batch in loader:
        eval_step(metrics, batch)
    mean_loss, anomaly, _ = epoch_results(metrics)
    evaluator(np.swapaxes(anomaly, 0, 1), np.swapaxes(ds.anomaly, 0, 1))
    evaluator.get_results()
    return {"driver_f1_pos": nanmean(evaluator.F1_pos),
            "driver_iou_pos": nanmean(evaluator.iou_pos),
            "mean_loss": mean_loss, "anomaly": anomaly}


def fit(cfg: Config, logger, state, train_step: Callable,
        eval_step: Callable, train_loader, val_loader, train_ds, val_ds,
        device, loss_fmt: str = "%.4f", score_train: bool = False) -> Dict:
    """The baselines' epoch loop (the JAX drivers'): a train epoch, a
    validation pass scored by majority vote, best-loss and latest
    checkpoints. ``score_train`` (the MIL drivers) also scores the train
    epoch's votes and records the validation's predicted-positive rate."""
    ckpt = CheckpointManager(cfg.log_dir)
    eval_train = EvaluatorAnomalySynthetic(logger, "Training", cfg.variables)
    eval_val = EvaluatorAnomalySynthetic(logger, "Validation", cfg.variables)
    keys = ["train_loss", "val_loss", "val_anom_f1", "steps_per_sec"]
    if score_train:
        keys += ["train_anom_f1", "val_pred_rate"]
    history = {k: [] for k in keys}
    best_loss_val = np.inf
    for epoch in range(cfg.n_epochs):
        log_string(logger, "################# Epoch (%s/%s) "
                   "#################" % (epoch + 1, cfg.n_epochs))
        timer = StepTimer()
        metrics = init_vote_metrics(train_ds.anomaly.shape, device)
        for batch in train_loader:
            train_step(state, metrics, batch)
            timer.tick()
        sps = timer.steps_per_sec
        mean_loss_train, anomaly, _ = epoch_results(metrics)
        if score_train:
            eval_train(np.swapaxes(anomaly, 0, 1),
                       np.swapaxes(train_ds.anomaly, 0, 1))
            eval_train.get_results()
        log_string(logger, ("%s mean loss     : " + loss_fmt)
                   % ("Training", mean_loss_train))

        metrics = init_vote_metrics(val_ds.anomaly.shape, device)
        for batch in val_loader:
            eval_step(metrics, batch)
        mean_loss_val, anomaly, vote_cnt = epoch_results(metrics)
        if score_train:
            # predicted-positive rate over voted timesteps: tells "scores
            # never cross 0.5" from poor ranking
            voted = vote_cnt > 0
            history["val_pred_rate"].append(
                float(anomaly[:, voted].mean()) if voted.any()
                else float("nan"))
        eval_val(np.swapaxes(anomaly, 0, 1),
                 np.swapaxes(val_ds.anomaly, 0, 1))
        eval_val.get_results()
        log_string(logger, ("%s mean loss     : " + loss_fmt)
                   % ("Validation", mean_loss_val))

        if mean_loss_val <= best_loss_val:
            best_loss_val = mean_loss_val
            ckpt.save("best_loss_model", state, epoch, mean_loss_train,
                      mean_loss_val)
        ckpt.save("latest", state, epoch, mean_loss_train, mean_loss_val)

        history["train_loss"].append(mean_loss_train)
        history["val_loss"].append(mean_loss_val)
        history["val_anom_f1"].append(nanmean(eval_val.F1_pos))
        history["steps_per_sec"].append(sps)
        if score_train:
            history["train_anom_f1"].append(nanmean(eval_train.F1_pos))
        log_string(logger, "steps/sec: %.3f" % sps)
        eval_train.reset()
        eval_val.reset()
    history["state"] = state
    return history
