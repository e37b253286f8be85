# ------------------------------------------------------------------
"""The composite model: encoder -> 1-bit LFQ bottleneck -> classifier
(counterpart of idee_tpu/models/vq_model.py; reference
models/build.py:130-159). The per-(variable, time, pixel) code index from
the quantizer is the anomaly/driver mask.

forward(x [N,V,C,T,H,W]) ->
  z        [N, n_classes, H, W]   joint extreme logits
  y        [N, V, 1, H, W]        per-variable extreme logits
  anomaly  [N, V, T, H, W]        anomaly bits (code indices)
  z_q      [N, V, C', T, H, W]    quantized features (a view of the packed
                                  codes, float32)
  loss_z_q scalar                 quantizer aux loss
  vq0      [C']                   the 'normal' code vector (detached)
  loss_anomaly                    anomaly L1, when mask_extreme_loss given

Only the packed 1-bit LFQ path is ported; other codebooks raise.
"""
# ------------------------------------------------------------------

from typing import NamedTuple, Optional

import torch
import torch.nn as nn

from idee_tpu_torch import losses
from idee_tpu_torch.config import Config
from idee_tpu_torch.nn.classifier import CNN_3D_Classifier
from idee_tpu_torch.nn.cnn3d import CNN_3D
from idee_tpu_torch.nn.layers import reference_init, trunc_normal_init
from idee_tpu_torch.nn.mamba import Mamba
from idee_tpu_torch.nn.swin3d import Swin_3D
from idee_tpu_torch.quant.lfq import LFQ


def build_encoder(cfg: Config, kernel_init, generator=None) -> nn.Module:
    """Construct the configured backbone (reference: models/build.py:34-84)."""
    if cfg.encoder == "CNN_3D":
        return CNN_3D(in_vars=cfg.in_channels_dynamic,
                      in_channels=cfg.in_channels,
                      out_channels=list(cfg.en_embed_dim),
                      drop_path_rate=cfg.en_drop_path_rate,
                      use_checkpoint=cfg.en_use_checkpoint,
                      kernel_init=kernel_init, generator=generator)
    if cfg.encoder == "Swin_3D":
        return Swin_3D(in_vars=cfg.in_channels_dynamic,
                       in_chans=cfg.in_channels,
                       embed_dim=list(cfg.en_embed_dim),
                       window_size=[tuple(w) for w in cfg.en_window_size],
                       depths=list(cfg.en_depths),
                       num_heads=list(cfg.en_n_heads),
                       mlp_ratio=cfg.en_mlp_ratio,
                       drop_rate=cfg.en_drop_rate,
                       attn_drop_rate=cfg.en_attn_drop_rate,
                       drop_path_rate=cfg.en_drop_path_rate,
                       qkv_bias=cfg.en_qkv_bias, qk_scale=cfg.en_qk_scale,
                       patch_size=tuple(cfg.en_patch_size),
                       use_checkpoint=cfg.en_use_checkpoint,
                       kernel_init=kernel_init, generator=generator)
    if cfg.encoder == "Mamba":
        return Mamba(in_vars=cfg.in_channels_dynamic,
                     in_chans=cfg.in_channels,
                     embed_dim=list(cfg.en_embed_dim),
                     window_size=[tuple(w) for w in cfg.en_window_size],
                     depths=list(cfg.en_depths), mlp_ratio=cfg.en_mlp_ratio,
                     drop_rate=cfg.en_drop_rate,
                     drop_path_rate=cfg.en_drop_path_rate,
                     patch_size=tuple(cfg.en_patch_size),
                     d_state=list(cfg.d_state), d_conv=list(cfg.d_conv),
                     expand=list(cfg.expand),
                     use_checkpoint=cfg.en_use_checkpoint,
                     kernel_init=kernel_init, generator=generator)
    raise NotImplementedError(
        f"Encoder {cfg.encoder} is not ported yet (ROADMAP.md, open items)")


def build_quantizer(cfg: Config, kernel_init=None, generator=None) -> LFQ:
    if cfg.codebook != "LFQ":
        raise NotImplementedError(
            f"Codebook {cfg.codebook} is not ported yet (ROADMAP.md, open "
            "items)")
    return LFQ(dim=cfg.codebook_dim, codebook_size=cfg.codebook_size,
               entropy_loss_weight=cfg.lambda_entropy,
               diversity_gamma=cfg.diversity_gamma,
               commitment_loss_weight=cfg.lambda_commitment,
               freeze_project_out=cfg.codebook_freeze_out,
               inv_temperature=cfg.codebook_inv_temperature,
               kernel_init=kernel_init, generator=generator)


class VQOutput(NamedTuple):
    z: torch.Tensor
    y: torch.Tensor
    anomaly: torch.Tensor
    z_q: torch.Tensor
    loss_z_q: torch.Tensor
    vq0: torch.Tensor
    loss_anomaly: Optional[torch.Tensor] = None


class VQModel(nn.Module):
    """Encoder + codebook + classifier (reference: models/build.py:23-159).
    Parameters are initialized from ``generator`` (default: a CPU generator
    seeded with cfg.seed)."""

    def __init__(self, config: Config,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = self.config = config
        if cfg.dtype != "float32":
            raise NotImplementedError(f"dtype {cfg.dtype}: the port runs "
                                      "float32 only (ROADMAP.md, open items)")
        if generator is None:
            generator = torch.Generator().manual_seed(cfg.seed)
        scheme = cfg.init_scheme
        if scheme == "zero_mean":
            init = trunc_normal_init(0.02)
        elif scheme == "lecun":
            init = None  # per-module fan-in scaled defaults
        else:
            init = reference_init()
        self.encoder = build_encoder(cfg, init, generator)
        self.cls = CNN_3D_Classifier(in_var=cfg.in_channels_dynamic,
                                     embed_dim=cfg.codebook_dim,
                                     dim=cfg.cls_dim,
                                     drop_rate=cfg.cls_drop_rate,
                                     kernel_init=init, generator=generator)
        self.vq = build_quantizer(cfg, kernel_init=init, generator=generator)
        if not (self.vq.codebook_dims == 1 and self.vq.has_projections
                and self.vq.codebook_scale == 1.0):
            raise NotImplementedError("only the 1-bit LFQ path "
                                      "(codebook_size=2) is ported")

    def forward(self, x_d, train: bool = False, mask_extreme_loss=None,
                mask_exclude=None,
                generator: Optional[torch.Generator] = None) -> VQOutput:
        """Packed 1-bit LFQ flow: activations keep [N, T, H, W, V*C]; the
        quantizer works on per-(variable, voxel) scalars and the anomaly
        L1 is the collapsed losses.anomaly_l1_lfq. The L1 leaves the pixels
        of mask_extreme_loss, and of mask_exclude (the real-world cold
        surface) when given, unconstrained."""
        V = self.config.in_channels_dynamic
        zp = self.encoder(x_d.float(), train=train, packed_out=True,
                          generator=generator)
        N, T, H, W, VC = zp.shape
        C = VC // V

        parts = self.vq.quantize_packed(zp, V, train=train)
        s_q = parts.s_q                                    # [N,T,H,W,V]
        anomaly = parts.indices.permute(0, 4, 1, 2, 3)     # [N,V,T,H,W]

        w_out, b_out = self.vq.out_proj_params()
        # zq[.., v*C + c] = s_q[.., v] * w_out[c] + b_out[c]
        zq_packed = (s_q[..., None] * w_out + b_out).reshape(N, T, H, W, VC)
        zc, y = self.cls(zq_packed, train=train, packed=True,
                         generator=generator)

        vq0 = (b_out - w_out).detach()  # project_out(-1)
        loss_anomaly = None
        if mask_extreme_loss is not None:
            w_pix = mask_extreme_loss.float()
            if mask_exclude is not None:
                w_pix = w_pix + mask_exclude.float()
            w_pix = 1.0 - torch.clamp(w_pix, 0.0, 1.0)
            loss_anomaly = losses.anomaly_l1_lfq(s_q, w_pix, w_out, b_out)

        z_q = zq_packed.reshape(N, T, H, W, V, C).permute(0, 4, 5, 1, 2, 3)
        return VQOutput(zc, y, anomaly, z_q, parts.aux_loss, vq0,
                        loss_anomaly)


def build_model(config: Config,
                generator: Optional[torch.Generator] = None) -> VQModel:
    return VQModel(config, generator)
