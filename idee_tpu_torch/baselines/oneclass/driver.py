# ------------------------------------------------------------------
"""SimpleNet train / test drivers for the synthetic benchmark
(counterpart of idee_tpu/baselines/oneclass/driver.py; reference
Baselines_OneClass/{train,test}_simplenet_synthetic.py).

Training data is the anomaly-replaced cube (is_replace_anomaly); the
backbone encoder is frozen: it runs in eval mode under ``torch.no_grad``
(the JAX package's stop_gradient of ``apply(..., train=False)``), so on
the card its kernels' forwards launch and their backwards do not.
Validation and test threshold each variable at the median of its
normal-pixel scores minus 0.001 and score the anomaly map by majority
vote (train_simplenet_synthetic.py:221-247).
"""
# ------------------------------------------------------------------

from typing import Dict, Mapping, Optional

import torch
import torch.nn as nn

from idee_tpu_torch import resolve_device
from idee_tpu_torch.baselines import common
from idee_tpu_torch.baselines.config import OneClassConfig
from idee_tpu_torch.baselines.oneclass.simplenet import SimpleNet, simple_loss
from idee_tpu_torch.data.loader import DataLoader
from idee_tpu_torch.data.synthetic import SyntheticCube
from idee_tpu_torch.models.interop import load_flax_npz, load_flax_params
from idee_tpu_torch.models.vq_model import build_encoder
from idee_tpu_torch.nn.layers import trunc_normal_init
from idee_tpu_torch.train.evaluate import load_weights
from idee_tpu_torch.train.state import count_parameters, create_train_state
from idee_tpu_torch.utils.logging import fix_seed, get_logger, log_string

_KEYS = ["x", "mask_extreme_loss", "timestep"]


class Backbone(nn.Module):
    """The frozen feature extractor: the shared encoder alone (reference:
    Baselines_OneClass/models/build_simplenet.py:86-183). Without a
    checkpoint it keeps the encoder's own trunc_normal(0.02) init."""

    def __init__(self, config: OneClassConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.encoder = build_encoder(
            config, trunc_normal_init(0.02),
            generator or torch.Generator().manual_seed(config.seed))

    def forward(self, x_d, train: bool = False):
        return self.encoder(x_d, train=train)


def load_backbone_params(path: str, backbone: Backbone,
                         cfg: OneClassConfig) -> Dict[str, torch.Tensor]:
    """The encoder of a core VQ-model checkpoint as ``backbone``'s
    state_dict (the reference's filtered non-strict load,
    build_simplenet.py:149-163): a port checkpoint (``.pt``, its model's
    ``encoder.*`` entries) or the JAX package's params as a flax-path
    ``.npz`` (its "encoder" subtree)."""
    if path.endswith(".npz"):
        tree = load_flax_npz(path)
        tree = tree.get("params", tree)
        return load_flax_params(cfg, {"encoder": tree["encoder"]}
                                if "encoder" in tree else tree, backbone)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    sd = sd.get("model", sd)
    enc = {k: v for k, v in sd.items() if k.startswith("encoder.")}
    return enc or sd


def _frozen_backbone(cfg: OneClassConfig, logger, dev,
                     params: Optional[Mapping] = None) -> Backbone:
    backbone = Backbone(cfg)
    if params is not None:
        backbone.load_state_dict(params)
    elif cfg.model_pretrained:
        log_string(logger, f"backbone from {cfg.model_pretrained} ...")
        backbone.load_state_dict(load_backbone_params(
            cfg.model_pretrained, backbone, cfg))
    else:
        log_string(logger, "WARNING: frozen backbone is randomly "
                           "initialized (model_pretrained unset)")
    backbone.requires_grad_(False)
    return backbone.to(dev).eval()


def val_anomaly(z_n_scores, mask):
    """Per-variable median thresholding -> anomaly bits
    (reference: test_simplenet_synthetic.py:116-127). z_n_scores [B, V, T,
    H, W]; mask [B, H, W] (extremes). Returns (anomaly uint8 [B, V, T, H,
    W], signed +-1 scores). The median of an even count is the mean of the
    two middle values (jnp.nanmedian; torch.nanmedian takes the lower)."""
    B, V, T, H, W = z_n_scores.shape
    normal = (mask[:, None, None] == 0).expand(z_n_scores.shape)
    vals = torch.where(normal, z_n_scores, torch.full(
        (), float("inf"), device=z_n_scores.device))
    vals = vals.transpose(0, 1).reshape(V, -1).sort(dim=1).values
    n = normal.transpose(0, 1).reshape(V, -1).sum(1, keepdim=True)
    lo = vals.gather(1, torch.clamp((n - 1) // 2, min=0))
    hi = vals.gather(1, torch.clamp(n // 2, max=vals.shape[1] - 1))
    med = torch.where(n > 0, 0.5 * lo + 0.5 * hi,
                      torch.full((), float("nan"), device=vals.device))
    thr = (med[:, 0] - 0.001)[None, :, None, None, None]
    signed = torch.where(z_n_scores >= thr, 1.0, -1.0)
    return (signed < 0).to(torch.uint8), signed


init_oc_metrics = common.init_vote_metrics  # the JAX driver's name


def make_oc_train_step(backbone, model, cfg: OneClassConfig):
    """step(state, metrics, batch): the frozen backbone's features, the
    head's training forward (noise from ``state.generator``), the hinge
    loss, backward, one optimizer step."""

    def step(state, metrics, batch):
        with torch.no_grad():
            z = backbone(batch["x"], train=False)
        model.train()
        out = model(z, train=True, generator=state.generator)
        loss = simple_loss(out.z_n_scores, out.z_p_scores, cfg.th_n,
                           cfg.th_p, train=True)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.apply_gradients()
        common.accumulate(metrics, loss, None, batch, 0.0, cfg.delta_t)
        return state, metrics

    return step


def make_oc_eval_step(backbone, model, cfg: OneClassConfig, t0: float):
    @torch.inference_mode()
    def step(metrics, batch):
        model.eval()
        z = backbone(batch["x"], train=False)
        scores = model(z, train=False).z_n_scores[..., 0]  # [B,V,T,H,W]
        mask = batch["mask_extreme_loss"]
        anomaly, signed = val_anomaly(scores, mask)
        # eval loss on the signed maps split by the extreme mask
        # (train_simplenet_synthetic.py:237-241)
        m = mask[:, None, None].expand(signed.shape)
        sel_n, sel_p = (m == 0).float(), (m == 1).float()
        tl = torch.clamp(cfg.th_n - signed, min=0.0) * sel_n
        fl = torch.clamp(signed + cfg.th_p, min=0.0) * sel_p
        loss = (tl.sum() + fl.sum()) / torch.clamp(sel_n.sum() + sel_p.sum(),
                                                   min=1.0)
        return common.accumulate(metrics, loss, anomaly, batch, t0,
                                 cfg.delta_t)

    return step


def train_simplenet_synthetic(cfg: OneClassConfig,
                              train_cube: Optional[SyntheticCube] = None,
                              val_cube: Optional[SyntheticCube] = None,
                              device=None) -> Dict:
    """Train the SimpleNet head over the frozen backbone
    (cfg.model_pretrained) from a random initialization; returns
    the history, the final TrainState under "state" and the backbone's
    state_dict under "bb_variables". ``device``: cuda unless given."""
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

    backbone = _frozen_backbone(cfg, logger, dev)
    model = SimpleNet(cfg, in_planes=cfg.en_embed_dim[-1])
    state = create_train_state(cfg, model, dev,
                               steps_per_epoch=len(train_loader))
    log_string(logger, "all parameters: %d\n" % count_parameters(model))
    history = common.fit(
        cfg, logger, state, make_oc_train_step(backbone, model, cfg),
        make_oc_eval_step(backbone, model, cfg, float(val_ds.timestep[0])),
        train_loader, val_loader, train_ds, val_ds, dev, "%.8f")
    history["bb_variables"] = backbone.state_dict()
    return history


def test_simplenet_synthetic(cfg: OneClassConfig,
                             cube: Optional[SyntheticCube] = None,
                             params: Optional[Mapping] = None,
                             bb_variables: Optional[Mapping] = None,
                             device=None) -> Dict:
    """reference: Baselines_OneClass/test_simplenet_synthetic.py. The head
    from ``params`` (else cfg.en_de_pretrained), the backbone from
    ``bb_variables`` (a Backbone state_dict; else cfg.model_pretrained).
    Returns driver_f1_pos, driver_iou_pos, mean_loss and the anomaly
    map."""
    dev = resolve_device(device)
    logger = get_logger(cfg)
    fix_seed(cfg.seed)
    ds = common.test_dataset(cfg, cube)
    log_string(logger, "# testing samples: %d" % len(ds))
    backbone = _frozen_backbone(cfg, logger, dev, bb_variables)
    model = SimpleNet(cfg, in_planes=cfg.en_embed_dim[-1])
    load_weights(model, cfg, params, logger)
    model.to(dev)
    loader = DataLoader(ds, cfg.batch_size, device=dev, keys=_KEYS,
                        shuffle=False, drop_last=True, seed=cfg.seed)
    return common.evaluate(cfg, logger, "Testing",
                           make_oc_eval_step(backbone, model, cfg,
                                             float(ds.timestep[0])),
                           loader, ds, dev)
