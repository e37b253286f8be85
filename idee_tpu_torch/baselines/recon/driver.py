# ------------------------------------------------------------------
"""Reconstruction train / test drivers (STEAL, UniAD) for the synthetic
benchmark (counterpart of idee_tpu/baselines/recon/driver.py; reference
Baselines_Reconstruction/{train,test}_{steal,uniad}_synthetic.py).

Both train on the anomaly-replaced cube; at evaluation a pixel is
anomalous where its squared error exceeds the midpoint of the normal and
extreme mean errors (train_steal_synthetic.py:186-200,
train_uniad_synthetic.py:244-254), majority-voted over the timeline.
"""
# ------------------------------------------------------------------

from typing import Dict, Mapping, Optional

import torch

from idee_tpu_torch import resolve_device
from idee_tpu_torch.baselines import common
from idee_tpu_torch.baselines.config import ReconConfig
from idee_tpu_torch.baselines.recon.steal import RecModel, steal_loss
from idee_tpu_torch.baselines.recon.uniad import UniAD
from idee_tpu_torch.data.loader import DataLoader
from idee_tpu_torch.data.synthetic import SyntheticCube
from idee_tpu_torch.train.evaluate import load_weights
from idee_tpu_torch.train.state import count_parameters, create_train_state
from idee_tpu_torch.utils.logging import fix_seed, get_logger, log_string

_KEYS = ["x", "mask_extreme_loss_t", "timestep"]


def midpoint_anomaly(err, mask):
    """anomaly = err > (mean normal err + mean extreme err) / 2
    (reference: train_steal_synthetic.py:186-200). err [N, V, T, H, W];
    mask [N, T, H, W]."""
    sel_p = (mask[:, None] != 0).expand(err.shape)
    sel_n = ~sel_p
    p_n = (err * sel_n).sum() / torch.clamp(sel_n.sum(), min=1)
    p_p = (err * sel_p).sum() / torch.clamp(sel_p.sum(), min=1)
    return (err > (p_n + p_p) / 2.0).to(torch.uint8)


init_recon_metrics = common.init_vote_metrics  # the JAX driver's name


def _train_step(model, run, cfg: ReconConfig, t0: float):
    """step(state, metrics, batch): run(batch, generator) -> (loss,
    anomaly bits or None) in training mode, backward, one optimizer step,
    the metric updates."""

    def step(state, metrics, batch):
        model.train()
        loss, anomaly = run(batch, state.generator)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.apply_gradients()
        with torch.no_grad():
            common.accumulate(metrics, loss, anomaly, batch, t0,
                              cfg.delta_t)
        return state, metrics

    return step


def make_steal_train_step(model, cfg: ReconConfig, t0: float):
    def run(batch, generator):
        x = batch["x"][:, :, 0]                 # [N, V, T, H, W]
        mask = batch["mask_extreme_loss_t"]     # [N, T, H, W]
        pred = model(x, train=True).pred
        with torch.no_grad():
            anomaly = midpoint_anomaly((pred - x) ** 2, mask)
        return steal_loss(pred, x, mask), anomaly

    return _train_step(model, run, cfg, t0)


def make_steal_eval_step(model, cfg: ReconConfig, t0: float):
    @torch.inference_mode()
    def step(metrics, batch):
        model.eval()
        x = batch["x"][:, :, 0]
        mask = batch["mask_extreme_loss_t"]
        pred = model(x, train=False).pred
        return common.accumulate(
            metrics, steal_loss(pred, x, mask),
            midpoint_anomaly((pred - x) ** 2, mask), batch, t0, cfg.delta_t)

    return step


def make_uniad_train_step(model, cfg: ReconConfig, t0: float):
    def run(batch, generator):
        x = batch["x"][:, :, 0, 0]              # [N, V, H, W], delta_t 1
        out = model(x, None, train=True, generator=generator)
        return out.loss_map.mean(), None

    return _train_step(model, run, cfg, t0)


def make_uniad_eval_step(model, cfg: ReconConfig, t0: float):
    @torch.inference_mode()
    def step(metrics, batch):
        model.eval()
        x = batch["x"][:, :, 0, 0]
        mask = batch["mask_extreme_loss_t"][:, 0]   # [N, H, W]
        out = model(x, mask, train=False)
        # the loss map is sign-flipped on extremes: its mean is the val
        # loss, |.| the raw error to threshold
        # (train_uniad_synthetic.py:234-254)
        anomaly = midpoint_anomaly(out.loss_map.abs()[:, :, None],
                                   mask[:, None])
        return common.accumulate(metrics, out.loss_map.mean(), anomaly,
                                 batch, t0, cfg.delta_t)

    return step


def build_recon_model(cfg: ReconConfig, which: str, grid):
    """(model, make_train_step, make_eval_step) of ``which``; ``grid`` is
    the input's (H, W), which fixes UniAD's token grid."""
    g = torch.Generator().manual_seed(cfg.seed)
    if which == "steal":
        model = RecModel(cfg.in_channels_dynamic,
                         list(cfg.en_embed_dim_steal),
                         list(cfg.de_embed_dim_steal), g)
        return model, make_steal_train_step, make_steal_eval_step
    if which == "uniad":
        return (UniAD(cfg, cfg.in_channels_dynamic, grid, g),
                make_uniad_train_step, make_uniad_eval_step)
    raise NotImplementedError(which)


def _grid(ds):
    return tuple(ds.datacube_dynamic.shape[-2:])


def train_recon_synthetic(cfg: ReconConfig, which: str,
                          train_cube: Optional[SyntheticCube] = None,
                          val_cube: Optional[SyntheticCube] = None,
                          device=None) -> Dict:
    """Train STEAL or UniAD; returns the history (the final TrainState
    under "state"). ``device``: cuda unless given."""
    dev = resolve_device(device)
    logger = get_logger(cfg)
    fix_seed(cfg.seed)
    train_ds, val_ds = common.make_datasets(cfg, train_cube, val_cube,
                                            cfg.is_replace_anomaly)
    log_string(logger, "# training samples: %d" % len(train_ds))
    train_ds[0]  # as the JAX driver draws it (the augmentation stream)
    train_loader = DataLoader(train_ds, cfg.batch_size, device=dev,
                              keys=_KEYS, shuffle=True, drop_last=True,
                              seed=cfg.seed)
    val_loader = DataLoader(val_ds, cfg.batch_size, device=dev, keys=_KEYS,
                            shuffle=True, drop_last=True, seed=cfg.seed)

    model, make_train, make_eval = build_recon_model(cfg, which,
                                                     _grid(train_ds))
    if cfg.en_de_pretrained:
        load_weights(model, cfg, None, logger)
    state = create_train_state(cfg, model, dev,
                               steps_per_epoch=len(train_loader))
    log_string(logger, "all parameters: %d\n" % count_parameters(model))
    return common.fit(
        cfg, logger, state,
        make_train(model, cfg, float(train_ds.timestep[0])),
        make_eval(model, cfg, float(val_ds.timestep[0])),
        train_loader, val_loader, train_ds, val_ds, dev, "%.6f")


def test_recon_synthetic(cfg: ReconConfig, which: str,
                         cube: Optional[SyntheticCube] = None,
                         params: Optional[Mapping] = None,
                         device=None) -> Dict:
    """reference: Baselines_Reconstruction/test_{steal,uniad}_synthetic.py.
    Returns driver_f1_pos, driver_iou_pos, mean_loss and the anomaly
    map."""
    dev = resolve_device(device)
    logger = get_logger(cfg)
    fix_seed(cfg.seed)
    ds = common.test_dataset(cfg, cube)
    log_string(logger, "# testing samples: %d" % len(ds))
    model, _, make_eval = build_recon_model(cfg, which, _grid(ds))
    load_weights(model, cfg, params, logger)
    model.to(dev)
    loader = DataLoader(ds, cfg.batch_size, device=dev, keys=_KEYS,
                        shuffle=False, drop_last=True, seed=cfg.seed)
    return common.evaluate(cfg, logger, "Testing",
                           make_eval(model, cfg, float(ds.timestep[0])),
                           loader, ds, dev)
