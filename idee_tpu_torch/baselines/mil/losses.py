# ------------------------------------------------------------------
"""MIL losses as masked-dense math (counterpart of
idee_tpu/baselines/mil/losses.py; reference Baselines_MIL/models/
losses.py).

Each loss takes one bag pair of dense [P(=H*W), ...] scores / features
and boolean memberships [P]:
* non-members are filled with -1, below any sigmoid score, so top-k never
  picks them while the bag holds >= k members;
* where a bag holds fewer than k members (torch.topk would raise in the
  reference), the invalid top-k slots leave the mean;
* top-k breaks ties by the lower index, as ``jax.lax.top_k`` does (a
  stable descending sort): RTFM and MGFN gather features and scores at
  the top-k indices, and their feature means run over all k slots, so
  with tied slots (members zeroed by the instance drop, or the -1 fill of
  a small bag) the loss depends on which tied index is taken;
* the Bernoulli instance drop (multiplicative, no rescale) draws from
  ``generator``.
Scores arrive sigmoid-activated; logs are clamped at 1e-12.
"""
# ------------------------------------------------------------------

from typing import Optional

import torch

_FILL = -1.0
_EPS = 1e-12


def _bern_keep(shape, drop_rate: float, device,
               generator: Optional[torch.Generator] = None):
    return (torch.rand(shape, generator=generator, device=device)
            < 1.0 - drop_rate).float()


def _log(p):
    return torch.log(torch.clamp(p, _EPS, 1.0))


def _norm2(x, dim: int = -1):
    """L2 norm whose gradient is finite at x == 0 (the JAX package's
    _norm2: torch.norm's subgradient and pairwise_distance's eps keep the
    reference finite on the all-zero rows the instance drop makes)."""
    return torch.sqrt((x * x).sum(dim) + _EPS)


def masked_topk(values, mask, k: int):
    """Top-k of ``values`` [P, ...] along axis 0 restricted to mask [P],
    ties to the lower index. Returns (top [k, ...], idx [k, ...], valid
    [k, ...]); valid marks slots inside the bag."""
    m = mask.reshape(mask.shape + (1,) * (values.dim() - 1))
    filled = torch.where(m, values, torch.full((), _FILL,
                                               dtype=values.dtype,
                                               device=values.device))
    top, idx = torch.sort(filled, dim=0, descending=True, stable=True)
    top, idx = top[:k], idx[:k]
    return top, idx, top > _FILL + 0.5


def _masked_mean(x, w):
    return (x * w).sum() / torch.clamp(w.sum(), min=1.0)


def _dropped(x, drop_rate: float, train: bool, generator, rows: bool):
    """x with the instance drop applied in training: elementwise, or (rows)
    one draw per instance."""
    if not (train and drop_rate > 0):
        return x
    shape = x.shape[:1] if rows else x.shape
    keep = _bern_keep(shape, drop_rate, x.device, generator)
    return x * keep.reshape(shape + (1,) * (x.dim() - len(shape)))


def ranking_loss(scores, mask_p, mask_n, k: int, drop_rate: float = 0.5,
                 train: bool = False, generator=None):
    """DeepMIL margin ranking (reference: losses.py:44-76): scores [P, T];
    relu(1 - topk(z_p) + topk(z_n)).mean(), the elementwise drop before
    top-k in training."""
    s_p = _dropped(scores, drop_rate, train, generator, rows=False)
    s_n = _dropped(scores, drop_rate, train, generator, rows=False)
    p_top, _, p_ok = masked_topk(s_p, mask_p, k)
    n_top, _, n_ok = masked_topk(s_n, mask_n, k)
    return _masked_mean(torch.relu(1.0 - p_top + n_top),
                        (p_ok & n_ok).float())


def dmil_ranking_loss(scores, mask_p, mask_n, k: int,
                      drop_rate: float = 0.5, train: bool = False,
                      generator=None):
    """ARNet DMIL ranking: BCE(topk(z_p), 1) + BCE(topk(z_n), 0)
    (reference: losses.py:105-129; k = t // alpha)."""
    s_p = _dropped(scores, drop_rate, train, generator, rows=False)
    s_n = _dropped(scores, drop_rate, train, generator, rows=False)
    p_top, _, p_ok = masked_topk(s_p, mask_p, k)
    n_top, _, n_ok = masked_topk(s_n, mask_n, k)
    return (_masked_mean(-_log(p_top), p_ok.float())
            + _masked_mean(-_log(1.0 - n_top), n_ok.float()))


def center_loss(scores, mask_n, lambda_c: float = 20.0):
    """MSE of normal-bag scores to their own mean, times lambda_c
    (reference: losses.py:132-142)."""
    w = mask_n[:, None].float() * torch.ones_like(scores)
    mean = _masked_mean(scores, w)
    return _masked_mean((scores - mean) ** 2, w) * lambda_c


def rtfm_loss(scores, features, mask_p, mask_n, k: int,
              margin: float = 100.0, alpha: float = 1e-4,
              drop_rate: float = 0.5, train: bool = False, generator=None):
    """RTFM feature-magnitude loss (reference: losses.py:145-214):
    scores [P, T], features [P, T, C]. Per bag: drop whole instances, rank
    by L2 feature magnitude, BCE the (undropped) scores at the top-k
    indices, pull / push the mean top-k feature magnitudes to margin / 0.
    The gather is per column (score[i, t] = scores[idx[i, t], t]), the
    intended semantics of the reference's fancy indexing (identical at
    T == 1), as in the JAX package."""
    f_p = _dropped(features, drop_rate, train, generator, rows=True)
    f_n = _dropped(features, drop_rate, train, generator, rows=True)
    _, idx_p, ok_p = masked_topk(_norm2(f_p), mask_p, k)   # idx [k, T]
    _, idx_n, ok_n = masked_topk(_norm2(f_n), mask_n, k)
    s_p = torch.gather(scores, 0, idx_p)
    s_n = torch.gather(scores, 0, idx_n)
    loss_p = _masked_mean(-_log(s_p), ok_p.float())
    loss_n = _masked_mean(-_log(1.0 - s_n), ok_n.float())

    def sel_feat(f, idx):  # [P, T, C], [k, T] -> [k, T, C]
        return torch.gather(f, 0, idx[..., None].expand(-1, -1, f.shape[-1]))

    fp_mean = _norm2(sel_feat(f_p, idx_p).mean(0))  # [T]
    fn_mean = _norm2(sel_feat(f_n, idx_n).mean(0))
    loss_rtfm = ((torch.abs(margin - fp_mean) + fn_mean) ** 2).mean()
    return loss_n + loss_p + alpha * loss_rtfm


def contrastive_loss(o1, o2, label: float, margin: float = 100.0):
    """Row-wise euclidean contrastive (reference: losses.py:259-269)."""
    d = _norm2(o1 - o2)[..., None]
    return ((1.0 - label) * d ** 2
            + label * torch.abs(margin - d) ** 2).mean()


def mgfn_loss(scores, features, mask_p, mask_n, k: int = 100,
              lambda_mgfn: float = 1e-4, margin: float = 100.0,
              drop_rate: float = 0.5, train: bool = False, generator=None):
    """MGFN loss of ONE variable over the batch (reference:
    losses.py:319-420): scores [B, P, T], features [B, P, T, C], masks
    [B, P]. Per sample: magnitude top-k -> BCE on the scores; the t=0
    top-k features across the batch feed three contrastive terms on their
    L1 norms."""
    B = scores.shape[0]
    loss_cls = 0.0
    p_stack, n_stack = [], []
    for b in range(B):
        f_p = _dropped(features[b], drop_rate, train, generator, rows=True)
        f_n = _dropped(features[b], drop_rate, train, generator, rows=True)
        _, idx_p, ok_p = masked_topk(_norm2(f_p), mask_p[b], k)
        _, idx_n, ok_n = masked_topk(_norm2(f_n), mask_n[b], k)
        s_p = torch.gather(scores[b], 0, idx_p)
        s_n = torch.gather(scores[b], 0, idx_n)
        loss_cls = loss_cls + (
            _masked_mean(-_log(s_p), ok_p.float())
            + _masked_mean(-_log(1 - s_n), ok_n.float()))
        # t=0 top-k features (reference: losses.py:388-397)
        f0 = features[b][:, 0, :]
        p_stack.append(f0[idx_p[:, 0]])  # [k, C]
        n_stack.append(f0[idx_n[:, 0]])

    p_all = torch.stack(p_stack).abs().sum(2)  # L1 norms [B, k]
    n_all = torch.stack(n_stack).abs().sum(2)
    loss_con = contrastive_loss(p_all, n_all, 1.0, margin)
    loss_con_n = loss_con_a = 0.0
    if B % 2 == 0 and B >= 2:
        h = B // 2
        loss_con_n = contrastive_loss(n_all[:h], n_all[h:], 0.0, margin)
        loss_con_a = contrastive_loss(p_all[:h], p_all[h:], 0.0, margin)
    return loss_cls / B + lambda_mgfn * (loss_con + loss_con_a + loss_con_n)
