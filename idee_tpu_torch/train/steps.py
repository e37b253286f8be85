# ------------------------------------------------------------------
"""Train and eval steps with device-resident epoch metrics (counterpart of
idee_tpu/train/steps.py; reference training and validation loops,
train_synthetic.py:170-282).

Everything the evaluators need accumulates on the device across the epoch:
the extreme-evaluator counters (evaluator_synthetic semantics), the loss
component sums, and the anomaly majority-vote timeline as a [V, T, H, W]
vote-sum buffer plus a [T] coverage counter. Nothing in a step waits for
the device, so the host runs ahead and stages the next batch while the
card works; ``metrics_to_host`` is the one sync per epoch.
"""
# ------------------------------------------------------------------

from typing import Any, Dict, Tuple

import numpy as np
import torch

from idee_tpu_torch import losses
from idee_tpu_torch.config import Config

_LOSS_KEYS = ("loss", "loss_bce", "loss_anomaly", "loss_var", "loss_z_q")
_COUNT_KEYS = ("correct", "seen", "iou_de", "predicted", "seen_all")


def _bce_kwargs(cfg: Config) -> Dict[str, Any]:
    return {"weighting": cfg.bce_weighting, "weight_cap": cfg.bce_weight_cap,
            "focal_gamma": cfg.bce_focal_gamma}


def extreme_counts(pred_c, gt) -> Dict[str, torch.Tensor]:
    """Streaming counters for evaluator_synthetic
    (reference: utils/utils_train.py:339-347). pred_c/gt: [N, 1, H, W]."""
    pred1 = pred_c == 1
    gt1 = gt == 1
    return {
        "correct": (pred1 & gt1).sum(),
        "seen": gt1.sum(),
        "iou_de": (pred1 | gt1).sum(),
        "predicted": pred1.sum(),
        # a host int: a scalar tensor made on the card would sync the host
        "seen_all": gt.numel(),
    }


def init_epoch_metrics(anomaly_shape: Tuple[int, int, int, int],
                       device) -> Dict[str, Any]:
    """Device-resident epoch accumulator; anomaly_shape = [V, T, H, W]
    (the dataset's full timeline)."""
    V, T, H, W = anomaly_shape
    return {
        "counts": {k: torch.zeros((), dtype=torch.int64, device=device)
                   for k in _COUNT_KEYS},
        "loss_sums": {k: torch.zeros((), dtype=torch.float32, device=device)
                      for k in _LOSS_KEYS},
        "n_steps": torch.zeros((), dtype=torch.int64, device=device),
        # each timeline slot is covered by at most delta_t windows per
        # epoch, and delta_t << 255
        "vote_sum": torch.zeros((V, T, H, W), dtype=torch.uint8,
                                device=device),
        "vote_cnt": torch.zeros((T,), dtype=torch.int32, device=device),
    }


def _scatter_votes(vote_sum, vote_cnt, anomaly, t_index, delta_t: int):
    """Add each sample's time-reversed [V, dt, H, W] anomaly bits onto the
    absolute timeline at [t_index - dt + 1, t_index], in place
    (anomaly_collector.__call__ semantics, utils/utils_train.py:547-554).
    anomaly [N, V, dt, H, W]; t_index [N] int64 on the device."""
    if delta_t > 255:
        raise ValueError("uint8 vote_sum would overflow; widen the dtype")
    N, V, dt, H, W = anomaly.shape
    chrono = anomaly.flip(2).to(vote_sum.dtype)  # chronological order
    idx = ((t_index - (delta_t - 1))[:, None]
           + torch.arange(delta_t, device=t_index.device)).reshape(-1)
    vote_sum.index_add_(1, idx, chrono.transpose(0, 1).reshape(
        V, N * dt, H, W))
    vote_cnt.index_add_(0, idx, torch.ones_like(idx, dtype=vote_cnt.dtype))


def _accumulate(metrics, comps, out, batch, t0: float, delta_t: int,
                threshold: float = 0.5):
    """Fold one step's outputs into the epoch metrics, in place; returns
    the extreme probability sigmoid(z) and its prediction, [N, 1, H, W]."""
    pred = torch.sigmoid(out.z)
    pred_c = (pred > threshold).float()
    counts = extreme_counts(pred_c, batch["mask_extreme"][:, None])
    for k in _COUNT_KEYS:
        metrics["counts"][k] += counts[k]
    for k in _LOSS_KEYS:
        metrics["loss_sums"][k] += comps[k]
    metrics["n_steps"] += 1
    t_index = (batch["timestep"][:, 0] - t0).long()
    _scatter_votes(metrics["vote_sum"], metrics["vote_cnt"], out.anomaly,
                   t_index, delta_t)
    return pred, pred_c


def make_train_step(model, cfg: Config, t0: float = 0.0,
                    steps_per_epoch: int = 0):
    """step(state, metrics, batch) -> (state, metrics): forward with
    train=True and the mask, total_loss_synthetic, backward, one optimizer
    step, then the metric updates on detached outputs (JAX
    ``_train_step_body``). Nothing waits for the device. A stateful
    codebook (VQ-EMA, k-means init, expiry) quantizes with the state it
    finds and moves its buffers in the forward, drawing from
    ``state.generator``: JAX's "codebook" collection, kept after the
    update.

    t0: absolute timestep of the dataset's first timeline slot.
    steps_per_epoch enables the anomaly-L1 curriculum
    (cfg.anomaly_warmup_epochs / anomaly_ramp_epochs): lambda_anomaly ramps
    linearly from 0 over the ramp epochs after the warmup ones."""
    warm = cfg.anomaly_warmup_epochs * steps_per_epoch
    ramp = max(cfg.anomaly_ramp_epochs * steps_per_epoch, 1)
    use_ramp = warm > 0 or cfg.anomaly_ramp_epochs > 0
    bce = _bce_kwargs(cfg)

    def step(state, metrics, batch):
        # no module reads .training (train= is explicit); set for clarity
        model.train()
        lam = cfg.lambda_anomaly
        if use_ramp:
            lam = lam * min(max((state.step - warm) / ramp, 0.0), 1.0)
        out = model(batch["x"], train=True,
                    mask_extreme_loss=batch["mask_extreme_loss"],
                    generator=state.generator)
        loss, comps = losses.total_loss_synthetic(
            out, batch["mask_extreme"], batch["mask_extreme_loss"], lam,
            **bce)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.apply_gradients()
        with torch.no_grad():
            _accumulate(metrics, {k: v.detach() for k, v in comps.items()},
                        out, batch, t0, cfg.delta_t)
        return state, metrics

    return step


def make_eval_step(model, cfg: Config, t0: float = 0.0,
                   return_preds: bool = False):
    """step(metrics, batch) -> metrics, or (metrics, preds) with
    ``return_preds`` (preds: the extreme probability "pred" and prediction
    "pred_c" [N, 1, H, W], the anomaly bits [N, V, T, H, W]; JAX's
    make_eval_step(return_preds=True)): one forward of ``model`` in eval
    mode under inference_mode, with the loss and the metric updates on the
    device. t0: absolute timestep of the dataset's first timeline slot."""
    bce = _bce_kwargs(cfg)

    @torch.inference_mode()
    def step(metrics, batch):
        model.eval()
        out = model(batch["x"], train=False,
                    mask_extreme_loss=batch["mask_extreme_loss"])
        _, comps = losses.total_loss_synthetic(
            out, batch["mask_extreme"], batch["mask_extreme_loss"],
            cfg.lambda_anomaly, **bce)
        pred, pred_c = _accumulate(metrics, comps, out, batch, t0,
                                   cfg.delta_t)
        if return_preds:
            return metrics, {"pred": pred, "pred_c": pred_c,
                             "anomaly": out.anomaly}
        return metrics

    return step


def metrics_to_host(metrics) -> Dict[str, Any]:
    """The epoch metrics as numpy (the one device sync per epoch)."""
    if isinstance(metrics, dict):
        return {k: metrics_to_host(v) for k, v in metrics.items()}
    return metrics.cpu().numpy() if isinstance(metrics, torch.Tensor) \
        else np.asarray(metrics)
