# ------------------------------------------------------------------
"""Loss functions (counterpart of idee_tpu/losses.py; reference
models/losses.py).

The inverse-frequency weighting is the reference's
  w = log((hist / sum(hist)) ** -0.5 + 1.1) indexed by the target class
(reference: models/losses.py:82-87,115-120). The anomaly L1 constrains the
quantized features to the 'normal' code vq_0 outside extreme regions.

Under data and spatial parallelism (parallel/mesh.py) the class
histograms, the masked denominators and the means' counts are the global
batch's: a rank's loss is its share of the global loss scaled by the
world size, whatever the size of its share. Without a mesh the
collectives are the identity.
"""
# ------------------------------------------------------------------

import torch

from idee_tpu_torch.parallel.mesh import (batch_mean, mean_over_ranks,
                                          sum_over_ranks)


def bce_with_logits(logits, targets):
    """Elementwise binary cross entropy on logits."""
    return (torch.clamp(logits, min=0.0) - logits * targets
            + torch.log1p(torch.exp(-logits.abs())))


def _inv_freq_weights(hist):
    """log((hist/total)^-0.5 + 1.1); zero-count classes get weight 0 (the
    reference leaves them +inf, but no pixel gathers them)."""
    frac = hist / torch.clamp(hist.sum(), min=1.0)
    pos = frac > 0
    w = torch.log(torch.where(pos, frac, torch.ones_like(frac)) ** -0.5 + 1.1)
    return torch.where(pos, w, torch.zeros_like(w))


def _capped_inv_freq_weights(hist, cap):
    """min(1/frac, cap), zero-count classes weight 0."""
    frac = hist / torch.clamp(hist.sum(), min=1.0)
    pos = frac > 0
    w = torch.clamp(1.0 / torch.where(pos, frac, torch.ones_like(frac)),
                    max=cap)
    return torch.where(pos, w, torch.zeros_like(w))


def class_histogram(target, mask=None):
    """[count of 0s, count of 1s] of ``target`` (over ``mask`` when given)
    in the global batch."""
    if mask is None:
        hist = torch.stack([(target == 0).sum(), (target == 1).sum()])
    else:
        hist = torch.stack([((target == 0) * mask).sum(),
                            ((target == 1) * mask).sum()])
    return sum_over_ranks(hist.float())


def bce_loss_synthetic(pred, target, weighting: str = "reference",
                       weight_cap: float = 100.0, focal_gamma: float = 2.0,
                       hist=None):
    """Frequency-weighted BCE, mean-reduced (reference: losses.py:98-124).
    pred: logits [N, C, H, W]; target: {0,1} [N, C, H, W]. ``weighting``:
    "reference", "capped" or "focal" (see idee_tpu/losses.py). ``hist``:
    ``class_histogram(target)``, when the caller has it."""
    target = target.float()
    if hist is None:
        hist = class_histogram(target)
    if weighting in ("capped", "focal"):
        w = _capped_inv_freq_weights(hist, weight_cap)
    else:
        w = _inv_freq_weights(hist)
    weights = w.detach()[target.long()]
    if weighting == "focal":
        p = torch.sigmoid(pred)
        p_t = p * target + (1.0 - p) * (1.0 - target)
        weights = weights * (1.0 - p_t) ** focal_gamma
    return batch_mean(bce_with_logits(pred, target) * weights)


def bce_loss(pred, target, mask_valid):
    """Masked frequency-weighted BCE for real-world data (reference:
    losses.py:64-95). pred/target/mask_valid [N, H, W]: the class histogram
    counts valid pixels only, invalid pixels get weight 0, and the sum is
    divided by sum(mask_valid)."""
    target = target.float()
    mask = mask_valid.float()
    hist = class_histogram(target, mask)
    weights = _inv_freq_weights(hist).detach()[target.long()] * mask
    return ((bce_with_logits(pred, target) * weights).sum()
            / mean_over_ranks(mask.sum()))


def _anomaly_l1(z_q, mask, vq0):
    weights = 1.0 - torch.clamp(mask.float(), 0.0, 1.0)[:, None, None, None]
    target = vq0.detach()[None, None, :, None, None, None]
    l1 = (z_q.float() - target).abs() * weights
    return l1.sum() / mean_over_ranks(
        torch.broadcast_to(weights, z_q.shape).sum())


def anomaly_l1_loss_synthetic(z_q, mask_extreme_loss, vq0):
    """Driver-supervision L1 (reference: losses.py:127-168).
    z_q [N, V, C, T, H, W]; mask_extreme_loss [N, H, W]; vq0 [C]."""
    return _anomaly_l1(z_q, mask_extreme_loss, vq0)


def anomaly_l1_loss(z_q, mask_extreme_loss, mask_exclude, vq0):
    """Real-world variant (reference: losses.py:15-61): the pixels of
    ``mask_exclude`` [N, H, W] (cold surface) are left unconstrained too.
    The reference calls it mask_valid, but adds it to the extreme mask
    (losses.py:50)."""
    return _anomaly_l1(z_q, mask_extreme_loss.float() + mask_exclude.float(),
                       vq0)


class _AnomalyL1LFQ(torch.autograd.Function):
    """Value and custom backward of idee_tpu/losses.py::anomaly_l1_lfq
    (:162-185): the exact derivatives of the uncollapsed L1 with vq_0 held
    constant, which autograd of the collapsed form would not give (it sees
    no path to s_q through ``s_q > 0``, doubles w_out's and drops
    b_out's)."""

    @staticmethod
    def forward(ctx, s_q, w_pix, w_out, b_out):
        N, T, H, W, V = s_q.shape
        C = w_out.shape[0]
        abs_w = w_out.abs().sum()
        pos = (s_q > 0).float()
        # sum over tokens of w_m * [s_q_m = +1]
        sp = torch.einsum("nthwv,nhw->", pos, w_pix)
        den = C * T * V * mean_over_ranks(w_pix.sum())
        ctx.save_for_backward(pos, w_pix, w_out, sp, abs_w, den)
        return 2.0 * sp * abs_w / den

    @staticmethod
    def backward(ctx, g):
        pos, w_pix, w_out, sp, abs_w, den = ctx.saved_tensors
        # d/ds_q |s_q+1|*abs_w = pos*abs_w  (sign(0) = 0)
        ds_q = (g * abs_w / den) * pos * w_pix[:, None, :, :, None]
        # d/dw_c and d/db_c of |s_q*w_c + b_c - vq0_c| with vq0 constant
        # both reduce to sign(w_c) summed over tokens where s_q = +1
        dwb = (g * sp / den) * torch.sign(w_out)
        return ds_q, None, dwb, dwb


def anomaly_l1_lfq(s_q, w_pix, w_out, b_out):
    """The anomaly L1 on the 1-bit LFQ latent, without building z_q.

    With vq_0 = b_out - w_out and z_q = s_q*w_out + b_out (s_q = +/-1),
    |z_q_c - vq0_c| = |(s_q + 1) * w_c|, so
      loss = sum_m w_m * |s_q_m + 1| * sum_c|w_c| / (C * sum_m w_m).
    s_q [N, T, H, W, V]; w_pix [N, H, W] (1 - mask, no gradient); w_out,
    b_out [C]. Gradients: the JAX package's custom VJP."""
    return _AnomalyL1LFQ.apply(s_q, w_pix, w_out, b_out)


def total_loss_synthetic(out, mask_extreme, mask_extreme_loss,
                         lambda_anomaly, weighting: str = "reference",
                         weight_cap: float = 100.0, focal_gamma: float = 2.0):
    """BCE(joint) + lambda_anomaly * anomaly_L1 + sum_v BCE(head_v) +
    loss_z_q (reference: train_synthetic.py:182-201).
    Returns (loss, dict of components)."""
    target = mask_extreme.float()[:, None]  # [N, 1, H, W]
    hist = class_histogram(target)  # the joint's and every head's
    loss_bce = bce_loss_synthetic(out.z, target, weighting, weight_cap,
                                  focal_gamma, hist)
    if out.loss_anomaly is not None:
        loss_anom = out.loss_anomaly
    else:
        loss_anom = anomaly_l1_loss_synthetic(out.z_q, mask_extreme_loss,
                                              out.vq0)
    loss_var = torch.stack([
        bce_loss_synthetic(out.y[:, v], target, weighting, weight_cap,
                           focal_gamma, hist)
        for v in range(out.y.shape[1])]).sum()
    loss = loss_bce + lambda_anomaly * loss_anom + loss_var + out.loss_z_q
    return loss, {"loss": loss, "loss_bce": loss_bce,
                  "loss_anomaly": loss_anom, "loss_var": loss_var,
                  "loss_z_q": out.loss_z_q}
