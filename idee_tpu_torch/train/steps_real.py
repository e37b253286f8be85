# ------------------------------------------------------------------
"""Train and eval steps of the real-world (CERRA / ERA5-Land) pipelines
(counterpart of idee_tpu/train/steps_real.py; reference
train_CERRA.py:166-282 and train_ERA5_Land.py).

Masked weighted BCE on the joint and per-variable heads, the real-world
anomaly L1 (cold-surface pixels unconstrained), threshold 0.35 for the
metrics, and the 2-class {normal, drought} counters over valid pixels
(utils/utils_train.py:175-266). In training the valid mask is
1 - cold_surface (train_CERRA.py:174-176); at test time sea and
no-vegetation pixels are excluded too (test_CERRA.py:112-113).

As in steps.py, counters and loss sums stay on the device; the host reads
them once per epoch (``steps.metrics_to_host``). With ``device_data`` the
driver runs the fused epochs over a data/device.py::RealDeviceLoader
(``make_train_epoch_real``, ``make_eval_epoch_real``): on a card each step
is one replay of a CUDA graph (steps.py::FusedEpoch).
"""
# ------------------------------------------------------------------

from typing import Any, Dict

import torch

from idee_tpu_torch import losses
from idee_tpu_torch.config import Config
from idee_tpu_torch.train.steps import (_LOSS_KEYS, FusedEpoch,
                                        backward_and_update)
from idee_tpu_torch.utils import spans

THRESHOLD = 0.35  # train_CERRA.py:212-213
_COUNT_KEYS = ("correct", "seen", "iou_de", "predicted")


def drought_counts(pred_c, gt, mask) -> Dict[str, torch.Tensor]:
    """Per-class counters over valid pixels (reference:
    utils/utils_train.py:246-266). pred_c/gt/mask [N, H, W]; the per-class
    counters are [2] (normal, drought)."""
    sel = mask > 0
    per_label = {k: [] for k in _COUNT_KEYS}
    for label in (0, 1):
        p = (pred_c == label) & sel
        g = (gt == label) & sel
        per_label["correct"].append((p & g).sum())
        per_label["seen"].append(g.sum())
        per_label["iou_de"].append((p | g).sum())
        per_label["predicted"].append(p.sum())
    out = {k: torch.stack(v) for k, v in per_label.items()}
    out["correct_all"] = ((pred_c == gt) & sel).sum()
    out["seen_all"] = sel.sum()
    return out


def init_epoch_metrics_real(device) -> Dict[str, Any]:
    """Device-resident epoch accumulator of the real-world steps."""
    def zeros(*shape, dtype=torch.int64):
        return torch.zeros(shape, dtype=dtype, device=device)

    return {
        "counts": {**{k: zeros(2) for k in _COUNT_KEYS},
                   "correct_all": zeros(), "seen_all": zeros()},
        "loss_sums": {k: zeros(dtype=torch.float32) for k in _LOSS_KEYS},
        "n_steps": zeros(),
    }


def total_loss_real(out, batch, lambda_anomaly):
    """Training objective (reference: train_CERRA.py:181-202). Returns
    (loss, components, mask_valid)."""
    mask_valid = torch.clamp(1.0 - batch["mask_cold_surface"], min=0.0)
    drought = batch["mask_extreme"]
    loss_bce = losses.bce_loss(out.z[:, 0], drought, mask_valid)
    if out.loss_anomaly is not None:
        loss_anom = out.loss_anomaly
    else:
        loss_anom = losses.anomaly_l1_loss(
            out.z_q, batch["mask_extreme_loss"],
            batch["mask_cold_surface_loss"], out.vq0)
    loss_var = torch.stack([
        losses.bce_loss(out.y[:, v, 0], drought, mask_valid)
        for v in range(out.y.shape[1])]).sum()
    loss = loss_bce + lambda_anomaly * loss_anom + loss_var + out.loss_z_q
    return loss, {"loss": loss, "loss_bce": loss_bce,
                  "loss_anomaly": loss_anom, "loss_var": loss_var,
                  "loss_z_q": out.loss_z_q}, mask_valid


def _forward(model, batch, train: bool, generator=None):
    return model(batch["x"], train=train,
                 mask_extreme_loss=batch["mask_extreme_loss"],
                 mask_exclude=batch["mask_cold_surface_loss"],
                 generator=generator)


def _accumulate_real(metrics, comps, out, batch, mask_valid):
    """Fold one step into the epoch metrics, in place; returns the drought
    probability and the thresholded prediction [N, H, W] (the
    ``accumulate`` span)."""
    with spans.span("accumulate", out.z.device):
        pred = torch.sigmoid(out.z[:, 0])
        pred_c = (pred > THRESHOLD).float()
        counts = drought_counts(pred_c, batch["mask_extreme"], mask_valid)
        for k, v in counts.items():
            metrics["counts"][k] += v
        for k in _LOSS_KEYS:
            metrics["loss_sums"][k] += comps[k]
        metrics["n_steps"] += 1
    return pred, pred_c


def _train_body_real(model, cfg: Config):
    """body(state, metrics, batch): forward with the extreme-loss and
    cold-surface masks, total_loss_real, backward, under a mesh the
    gradients averaged over the ranks, ``state.update()`` (the
    optimizer step at the lr already set), then the counters on detached
    outputs; no host state moves (steps.py::_train_body)."""

    def body(state, metrics, batch):
        model.train()
        dev = batch["x"].device
        out = _forward(model, batch, True, state.generator)
        with spans.span("loss", dev):
            loss, comps, mask_valid = total_loss_real(out, batch,
                                                      cfg.lambda_anomaly)
        backward_and_update(model, state, loss, dev)
        with torch.no_grad():
            _accumulate_real(metrics, {k: v.detach()
                                       for k, v in comps.items()},
                             out, batch, mask_valid)

    return body


def make_train_step_real(model, cfg: Config):
    """step(state, metrics, batch) -> (state, metrics): forward with the
    extreme-loss and cold-surface masks, total_loss_real, backward, one
    optimizer step, then the counters on detached outputs. Nothing waits
    for the device."""
    body = _train_body_real(model, cfg)

    def step(state, metrics, batch):
        state.set_lr(state.schedule(state.step))
        with spans.span("step", batch["x"].device):
            body(state, metrics, batch)
        state.step += 1
        return state, metrics

    return step


def _eval_body_real(model, cfg: Config):
    def body(metrics, batch):
        model.eval()
        out = _forward(model, batch, False)
        with spans.span("loss", batch["x"].device):
            _, comps, mask_valid = total_loss_real(out, batch,
                                                   cfg.lambda_anomaly)
        _accumulate_real(metrics, comps, out, batch, mask_valid)

    return body


def make_train_epoch_real(model, cfg: Config, loader):
    """Fused real-world train epoch over the RealDeviceLoader ``loader``
    (JAX ``make_train_epoch_real``, idee_tpu/train/steps_real.py:142-172):
    epoch(state) -> metrics, as steps.py::make_train_epoch."""
    body = _train_body_real(model, cfg)
    fused = FusedEpoch(loader, lambda: body(fused.state, fused.metrics,
                                            fused.batch()),
                       init_epoch_metrics_real(loader.device))
    return fused


def make_eval_epoch_real(model, cfg: Config, loader):
    """Fused real-world validation epoch (JAX ``make_eval_epoch_real``,
    idee_tpu/train/steps_real.py:175-191): epoch() -> metrics, under
    inference_mode."""
    body = _eval_body_real(model, cfg)
    fused = FusedEpoch(loader, lambda: body(fused.metrics, fused.batch()),
                       init_epoch_metrics_real(loader.device),
                       inference=True)
    return fused


def make_eval_step_real(model, cfg: Config, test_mode: bool = False,
                        return_preds: bool = False):
    """step(metrics, batch) -> metrics, or (metrics, preds) with
    ``return_preds`` (preds: drought probability "pred" and prediction
    "pred_c" [N, H, W], anomaly bits [N, V, T, H, W]). ``test_mode`` counts
    over the test-time valid mask 1 - sea - cold - no_vegetation
    (test_CERRA.py:112-113)."""

    @torch.inference_mode()
    def step(metrics, batch):
        model.eval()
        out = _forward(model, batch, False)
        _, comps, mask_valid = total_loss_real(out, batch,
                                               cfg.lambda_anomaly)
        if test_mode:
            mask_valid = torch.clamp(
                1.0 - batch["mask_sea"] - batch["mask_cold_surface"]
                - batch["mask_no_vegetation"], min=0.0)
        pred, pred_c = _accumulate_real(metrics, comps, out, batch,
                                        mask_valid)
        if return_preds:
            return metrics, {"pred": pred, "pred_c": pred_c,
                             "anomaly": out.anomaly}
        return metrics

    return step
