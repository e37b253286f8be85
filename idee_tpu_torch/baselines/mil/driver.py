# ------------------------------------------------------------------
"""MIL training / testing drivers for the synthetic benchmark (counterpart
of idee_tpu/baselines/mil/driver.py; reference
Baselines_MIL/train_{deepmil,arnet,rtfm,mgfn}_synthetic.py and
test_mil_synthetic.py): per-epoch loss and the anomaly majority vote
scored by the driver evaluator (the MIL drivers score the drivers, not
the extremes).

The BatchNorm models (RTFM's Aggregate, MGFN's FOCUS) move their running
statistics in the training forward, the buffers the JAX package threads
as its "batch_stats" collection; checkpoints carry them.
"""
# ------------------------------------------------------------------

from typing import Dict, Mapping, Optional

import torch

from idee_tpu_torch import resolve_device
from idee_tpu_torch.baselines import common
from idee_tpu_torch.baselines.config import MILConfig
from idee_tpu_torch.baselines.mil import losses as L
from idee_tpu_torch.baselines.mil.models import VARIANTS, build_mil_model
from idee_tpu_torch.data.loader import DataLoader
from idee_tpu_torch.data.synthetic import SyntheticCube
from idee_tpu_torch.models.vq_model import compute_dtype
from idee_tpu_torch.train.evaluate import load_weights
from idee_tpu_torch.train.state import count_parameters, create_train_state
from idee_tpu_torch.utils.logging import fix_seed, get_logger, log_string

_KEYS = ["x", "mask_extreme_loss", "timestep"]


def mil_total_loss(cfg: MILConfig, variant: str, out, mask, train: bool,
                   generator: Optional[torch.Generator] = None):
    """The reference's per-sample / per-variable loss loops
    (train_deepmil_synthetic.py:176-184). mask: [N, H, W]
    mask_extreme_loss; returns the scalar loss."""
    scores = out.scores                       # [N, V, T, H, W]
    N, V, T, H, W = scores.shape
    s = scores.permute(0, 1, 3, 4, 2).reshape(N, V, H * W, T)
    m = mask.reshape(N, H * W)
    mask_p, mask_n = m != 0, m == 0
    drop = cfg.instance_drop_rate
    total = 0.0

    if variant in ("deepmil", "arnet"):
        # ARNet: k = t // alpha with t = H*W (train_arnet_synthetic.py:
        # 121-122)
        k = (cfg.loss_k_deepmil if variant == "deepmil"
             else max(int(H * W // cfg.loss_alpha_arnet), 1))
        rank = L.ranking_loss if variant == "deepmil" else \
            L.dmil_ranking_loss
        for n in range(N):
            for v in range(V):
                total = total + rank(s[n, v], mask_p[n], mask_n[n], k,
                                     drop, train, generator)
                if variant == "arnet":
                    total = total + L.center_loss(
                        s[n, v], mask_n[n], cfg.loss_lambda_c_arnet)
        return total / N

    feats = out.features                      # [N, V, T, H, W, C]
    f = feats.permute(0, 1, 3, 4, 2, 5).reshape(N, V, H * W, T,
                                                 feats.shape[-1])
    if variant == "rtfm":
        for n in range(N):
            for v in range(V):
                total = total + L.rtfm_loss(
                    s[n, v], f[n, v], mask_p[n], mask_n[n],
                    k=cfg.loss_k_rtfm, margin=cfg.loss_margin_rtfm,
                    alpha=cfg.loss_alpha_rtfm, drop_rate=drop, train=train,
                    generator=generator)
        return total / N
    if variant == "mgfn":
        for v in range(V):  # the reference loops v too
            total = total + L.mgfn_loss(
                s[:, v], f[:, v], mask_p, mask_n, k=cfg.loss_k_mgfn,
                lambda_mgfn=cfg.loss_lambda_mgfn,
                margin=cfg.loss_margin_mgfn, drop_rate=drop, train=train,
                generator=generator)
        return total
    raise NotImplementedError(variant)


def dense_anomaly(cfg: MILConfig, variant: str, scores):
    """Dense scores -> anomaly bits [N, V, delta_t, H, W]
    (train_deepmil_synthetic.py:191-207): > 0.5, except MGFN, whose one
    timestep is broadcast over delta_t and thresholded at >= 0.5
    (train_mgfn_synthetic.py:181-196)."""
    if variant == "mgfn":
        return (scores >= 0.5).to(torch.uint8).expand(
            -1, -1, cfg.delta_t, -1, -1)
    return (scores > 0.5).to(torch.uint8)


init_mil_metrics = common.init_vote_metrics  # the JAX driver's name


def make_mil_train_step(model, cfg: MILConfig, variant: str, t0: float):
    """step(state, metrics, batch) -> (state, metrics): the training
    forward (dropout, drop path and the instance drop from
    ``state.generator``; BatchNorm statistics moved), the loss, backward,
    one optimizer step, then the metric updates on detached outputs."""

    def step(state, metrics, batch):
        model.train()
        out = model(batch["x"], train=True, generator=state.generator)
        loss = mil_total_loss(cfg, variant, out, batch["mask_extreme_loss"],
                              True, state.generator)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.apply_gradients()
        with torch.no_grad():
            common.accumulate(metrics, loss,
                              dense_anomaly(cfg, variant, out.scores),
                              batch, t0, cfg.delta_t)
        return state, metrics

    return step


def make_mil_eval_step(model, cfg: MILConfig, variant: str, t0: float):
    @torch.inference_mode()
    def step(metrics, batch):
        model.eval()
        out = model(batch["x"], train=False)
        loss = mil_total_loss(cfg, variant, out, batch["mask_extreme_loss"],
                              False)
        return common.accumulate(metrics, loss,
                                 dense_anomaly(cfg, variant, out.scores),
                                 batch, t0, cfg.delta_t)

    return step


def train_mil_synthetic(cfg: MILConfig, variant: str,
                        train_cube: Optional[SyntheticCube] = None,
                        val_cube: Optional[SyntheticCube] = None,
                        device=None) -> Dict:
    """Train one MIL baseline; returns the history (the final TrainState
    under "state"). ``device``: cuda unless given."""
    if variant not in VARIANTS:
        raise ValueError(f"MIL variant {variant!r}, not in {VARIANTS}")
    dev = resolve_device(device)
    logger = get_logger(cfg)
    fix_seed(cfg.seed)

    train_ds, val_ds = common.make_datasets(cfg, train_cube, val_cube)
    log_string(logger, "# training samples: %d" % len(train_ds))
    log_string(logger, "# evaluation samples: %d" % len(val_ds))
    # the JAX driver draws item 0 to shape its init, which advances the
    # augmentation stream: drawn here too, both see the same batches
    train_ds[0]
    # x in the compute dtype, cast on the host (JAX mil/driver.py:229)
    kw = dict(device=dev, keys=_KEYS, shuffle=True, drop_last=True,
              seed=cfg.seed, x_dtype=compute_dtype(cfg))
    train_loader = DataLoader(train_ds, cfg.batch_size, **kw)
    val_loader = DataLoader(val_ds, cfg.batch_size, **kw)

    model = build_mil_model(cfg, variant)
    if cfg.en_de_pretrained:
        load_weights(model, cfg, None, logger)
    state = create_train_state(cfg, model, dev,
                               steps_per_epoch=len(train_loader))
    log_string(logger, "all parameters: %d\n" % count_parameters(model))
    return common.fit(
        cfg, logger, state,
        make_mil_train_step(model, cfg, variant, float(train_ds.timestep[0])),
        make_mil_eval_step(model, cfg, variant, float(val_ds.timestep[0])),
        train_loader, val_loader, train_ds, val_ds, dev, "%.4f",
        score_train=True)


def test_mil_synthetic(cfg: MILConfig, variant: str,
                       cube: Optional[SyntheticCube] = None,
                       params: Optional[Mapping] = None,
                       device=None) -> Dict:
    """reference: Baselines_MIL/test_mil_synthetic.py. ``params``: a port
    state_dict or the JAX package's flax params / variables (default
    cfg.en_de_pretrained). Returns driver_f1_pos, driver_iou_pos,
    mean_loss and the majority-vote anomaly map [V, T, H, W]."""
    if variant not in VARIANTS:
        raise ValueError(f"MIL variant {variant!r}, not in {VARIANTS}")
    dev = resolve_device(device)
    logger = get_logger(cfg)
    fix_seed(cfg.seed)
    ds = common.test_dataset(cfg, cube)
    log_string(logger, "# testing samples: %d" % len(ds))
    model = build_mil_model(cfg, variant)
    load_weights(model, cfg, params, logger)
    model.to(dev)
    loader = DataLoader(ds, cfg.batch_size, device=dev, keys=_KEYS,
                        shuffle=False, drop_last=True, seed=cfg.seed,
                        x_dtype=compute_dtype(cfg))
    return common.evaluate(cfg, logger, "Testing",
                           make_mil_eval_step(model, cfg, variant,
                                              float(ds.timestep[0])),
                           loader, ds, dev)
