# ------------------------------------------------------------------
"""The composite model: encoder -> codebook -> classifier (counterpart of
idee_tpu/models/vq_model.py; reference models/build.py:130-159). The
per-(variable, time, pixel) code index from the quantizer is the
anomaly/driver mask.

forward(x [N,V,C,T,H,W]) ->
  z        [N, n_classes, H, W]   joint extreme logits
  y        [N, V, 1, H, W]        per-variable extreme logits
  anomaly  [N, V, T, H, W]        code indices (anomaly bits for LFQ with
                                  codebook_size 2)
  z_q      [N, V, C', T, H, W]    quantized features (float32)
  loss_z_q scalar                 quantizer aux loss
  vq0      [C']                   the 'normal' code vq.indices_to_codes(0)
                                  (detached)
  loss_anomaly                    anomaly L1, when mask_extreme_loss given

Two flows. LFQ with codebook_size 2 (the default) runs the packed 1-bit
path: activations keep [N, T, H, W, V*C] and the quantizer works on one
scalar per (variable, voxel). Every other codebook of ``cfg.codebook``
(VQ, FSQ, LatentQuantize, Random_VQ, LFQ with a larger codebook) runs the
generic path: tokens [N, V*T*H*W, C] through the quantizer, z_q in
float32, the classifier on the unpacked codes.

cfg.dtype is the compute dtype ("float32" or "bfloat16"), as in the JAX
package: parameters stay float32; x_d is cast to it, the encoder and the
classifier compute in it; every quantizer is a float32 island (its input
upcast), z_q and the anomaly L1 stay float32 and z_q is cast to the
compute dtype only at the classifier's input; the logits z and y come back
as float32.
"""
# ------------------------------------------------------------------

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn as nn

from idee_tpu_torch import losses
from idee_tpu_torch.config import Config
from idee_tpu_torch.nn.classifier import CNN_3D_Classifier
from idee_tpu_torch.nn.cnn3d import CNN_3D
from idee_tpu_torch.nn.layers import reference_init, trunc_normal_init
from idee_tpu_torch.nn.mamba import Mamba
from idee_tpu_torch.nn.swin3d import Swin_3D
from idee_tpu_torch.quant import get_quantizer
from idee_tpu_torch.quant.lfq import LFQ
from idee_tpu_torch.utils import spans


# cfg.dtype -> the compute dtype
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(cfg: Config) -> torch.dtype:
    if cfg.dtype not in DTYPES:
        raise ValueError(f"dtype {cfg.dtype!r}: the port computes in "
                         f"{sorted(DTYPES)}")
    return DTYPES[cfg.dtype]


def model_input_size(cfg: Config) -> Tuple[int, int, int]:
    """(T, H, W) of the model's input under cfg: delta_t weeks of the
    [y_min, y_max) x [x_min, x_max) crop reduced by cfg.window_size. A
    dataset's own ``input_size`` is exact where its grid is smaller than
    the crop."""
    return (cfg.delta_t, (cfg.y_max - cfg.y_min) // cfg.window_size,
            (cfg.x_max - cfg.x_min) // cfg.window_size)


def build_encoder(cfg: Config, kernel_init, generator=None,
                  input_size: Optional[Tuple[int, int, int]] = None
                  ) -> nn.Module:
    """Construct the configured backbone (reference: models/build.py:34-84),
    computing in cfg.dtype. ``input_size``: the input's (T, H, W), default
    ``model_input_size(cfg)``; Swin_3D shrinks its windows to it, as JAX
    does at init."""
    dtype = compute_dtype(cfg)
    if cfg.encoder == "CNN_3D":
        return CNN_3D(in_vars=cfg.in_channels_dynamic,
                      in_channels=cfg.in_channels,
                      out_channels=list(cfg.en_embed_dim),
                      drop_path_rate=cfg.en_drop_path_rate,
                      use_checkpoint=cfg.en_use_checkpoint,
                      kernel_init=kernel_init, generator=generator,
                      dtype=dtype)
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
                       kernel_init=kernel_init, generator=generator,
                       dtype=dtype,
                       input_size=input_size or model_input_size(cfg))
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
                     kernel_init=kernel_init, generator=generator,
                     dtype=dtype)
    raise NotImplementedError(
        f"Encoder {cfg.encoder} is not ported yet (ROADMAP.md, open items)")


def build_quantizer(cfg: Config, kernel_init=None,
                    generator=None) -> nn.Module:
    """The codebook ``cfg.codebook`` names, with the JAX package's keyword
    mapping (idee_tpu/models/vq_model.py:114-168; the reference hard-codes
    LFQ, models/build.py:86-91). ``kernel_init`` reaches LFQ's projections
    only: the other codebooks initialise theirs N(0.02, 0.02), as in the
    JAX package."""
    cls = get_quantizer(cfg.codebook)
    name = cfg.codebook
    if name == "LFQ":
        return cls(dim=cfg.codebook_dim, codebook_size=cfg.codebook_size,
                   entropy_loss_weight=cfg.lambda_entropy,
                   diversity_gamma=cfg.diversity_gamma,
                   commitment_loss_weight=cfg.lambda_commitment,
                   freeze_project_out=cfg.codebook_freeze_out,
                   inv_temperature=cfg.codebook_inv_temperature,
                   kernel_init=kernel_init, generator=generator)
    if name == "VQ":
        ema = cfg.vq_ema_update
        return cls(dim=cfg.codebook_dim, codebook_size=cfg.codebook_size,
                   codebook_dim=cfg.codebook_dim,
                   commitment_weight=cfg.lambda_commitment,
                   orthogonal_reg_weight=cfg.lambda_ortho,
                   sync_axis=cfg.codebook_sync_axis,
                   ema_update=ema, learnable_codebook=not ema,
                   decay=cfg.vq_decay, kmeans_init=cfg.vq_kmeans_init,
                   kmeans_iters=cfg.vq_kmeans_iters,
                   threshold_ema_dead_code=cfg.vq_threshold_ema_dead_code,
                   use_cosine_sim=cfg.vq_use_cosine_sim,
                   generator=generator)
    if name == "FSQ":
        return cls(dim=cfg.codebook_dim, levels=(cfg.codebook_size,),
                   generator=generator)
    if name == "LatentQuantize":
        return cls(dim=cfg.codebook_dim, levels=(cfg.codebook_size,),
                   commitment_loss_weight=cfg.lambda_commitment,
                   generator=generator)
    # Random_VQ
    return cls(dim=cfg.codebook_dim, codebook_size=cfg.codebook_size,
               codebook_dim=cfg.codebook_dim,
               sync_axis=cfg.codebook_sync_axis, generator=generator)


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
                 generator: Optional[torch.Generator] = None,
                 input_size: Optional[Tuple[int, int, int]] = None):
        super().__init__()
        cfg = self.config = config
        self.dtype = compute_dtype(cfg)
        if generator is None:
            generator = torch.Generator().manual_seed(cfg.seed)
        scheme = cfg.init_scheme
        if scheme == "zero_mean":
            init = trunc_normal_init(0.02)
        elif scheme == "lecun":
            init = None  # per-module fan-in scaled defaults
        else:
            init = reference_init()
        self.encoder = build_encoder(cfg, init, generator, input_size)
        self.cls = CNN_3D_Classifier(in_var=cfg.in_channels_dynamic,
                                     embed_dim=cfg.codebook_dim,
                                     dim=cfg.cls_dim,
                                     drop_rate=cfg.cls_drop_rate,
                                     kernel_init=init, generator=generator,
                                     dtype=self.dtype)
        self.vq = build_quantizer(cfg, kernel_init=init, generator=generator)

    def normal_code(self, device=None) -> torch.Tensor:
        """vq.indices_to_codes(0): the feature-space 'normal' code."""
        return self.vq.indices_to_codes(
            torch.zeros((1,), dtype=torch.long, device=device))[0]

    def _scalar_lfq(self) -> bool:
        """True when the quantizer takes the packed 1-bit path."""
        return (isinstance(self.vq, LFQ) and self.vq.codebook_dims == 1
                and self.vq.has_projections
                and self.vq.codebook_scale == 1.0)

    def forward(self, x_d, train: bool = False, mask_extreme_loss=None,
                mask_exclude=None,
                generator: Optional[torch.Generator] = None) -> VQOutput:
        """The anomaly L1 leaves the pixels of mask_extreme_loss, and of
        mask_exclude (the real-world cold surface) when given,
        unconstrained. ``generator`` draws dropout and drop-path masks and
        the codebook's random draws. The ``encoder``, ``quantizer``,
        ``classifier`` and ``loss`` spans (utils/spans.py); where the
        encoder's output takes a gradient, ``encoder_backward`` begins
        when the backward reaches it."""
        V = self.config.in_channels_dynamic
        dev = x_d.device
        with spans.span("encoder", dev):
            zp = self.encoder(x_d.to(self.dtype), train=train,
                              packed_out=True, generator=generator)
        spans.begin_on_grad(zp, "encoder_backward")
        if self._scalar_lfq():
            return self._forward_packed(zp, V, train, mask_extreme_loss,
                                        mask_exclude, generator)

        # generic path (idee_tpu/models/vq_model.py:248-277): tokens in
        # (V, T, H, W) order (build.py:149-150)
        N, T, H, W, VC = zp.shape
        C = VC // V
        with spans.span("quantizer", dev):
            tokens = zp.reshape(N, T, H, W, V, C) \
                .permute(0, 4, 1, 2, 3, 5).reshape(N, V * T * H * W, C)
            # VQ samples rows of the global batch: the tokens' layout
            # around H (the other codebooks read no rows)
            z_q, indices, loss_z_q = self.vq(tokens, train=train,
                                             generator=generator,
                                             grid=(V * T, W))
            z_q = z_q.reshape(N, V, T, H, W, C).permute(0, 1, 5, 2, 3, 4)
            anomaly = indices.reshape(N, V, T, H, W)
            vq0 = self.normal_code(z_q.device).detach()
        # classify on the quantized codes only (build.py:157)
        with spans.span("classifier", dev):
            zc, y = self.cls(z_q.to(self.dtype), train=train,
                             generator=generator)
            zc, y = zc.float(), y.float()
        loss_anomaly = None
        if mask_extreme_loss is not None:
            with spans.span("loss", dev):
                if mask_exclude is not None:
                    loss_anomaly = losses.anomaly_l1_loss(
                        z_q, mask_extreme_loss, mask_exclude, vq0)
                else:
                    loss_anomaly = losses.anomaly_l1_loss_synthetic(
                        z_q, mask_extreme_loss, vq0)
        return VQOutput(zc, y, anomaly, z_q, loss_z_q, vq0, loss_anomaly)

    def _forward_packed(self, zp, V: int, train: bool, mask_extreme_loss,
                        mask_exclude, generator) -> VQOutput:
        """Packed 1-bit LFQ flow: activations keep [N, T, H, W, V*C]; the
        quantizer works on per-(variable, voxel) scalars and the anomaly
        L1 is the collapsed losses.anomaly_l1_lfq."""
        N, T, H, W, VC = zp.shape
        C = VC // V
        dev = zp.device

        with spans.span("quantizer", dev):
            parts = self.vq.quantize_packed(zp, V, train=train)
            s_q = parts.s_q                                # [N,T,H,W,V]
            anomaly = parts.indices.permute(0, 4, 1, 2, 3)  # [N,V,T,H,W]

            w_out, b_out = self.vq.out_proj_params()
            # zq[.., v*C + c] = s_q[.., v] * w_out[c] + b_out[c]
            zq_packed = (s_q[..., None] * w_out + b_out) \
                .reshape(N, T, H, W, VC)
            vq0 = (b_out - w_out).detach()  # project_out(-1)
        with spans.span("classifier", dev):
            zc, y = self.cls(zq_packed.to(self.dtype), train=train,
                             packed=True, generator=generator)
            zc, y = zc.float(), y.float()

        loss_anomaly = None
        if mask_extreme_loss is not None:
            with spans.span("loss", dev):
                w_pix = mask_extreme_loss.float()
                if mask_exclude is not None:
                    w_pix = w_pix + mask_exclude.float()
                w_pix = 1.0 - torch.clamp(w_pix, 0.0, 1.0)
                loss_anomaly = losses.anomaly_l1_lfq(s_q, w_pix, w_out,
                                                     b_out)

        z_q = zq_packed.reshape(N, T, H, W, V, C).permute(0, 4, 5, 1, 2, 3)
        return VQOutput(zc, y, anomaly, z_q, parts.aux_loss, vq0,
                        loss_anomaly)


def build_model(config: Config,
                generator: Optional[torch.Generator] = None,
                input_size: Optional[Tuple[int, int, int]] = None
                ) -> VQModel:
    """The VQModel of ``config`` for inputs of (T, H, W) ``input_size``
    (default ``model_input_size(config)``)."""
    return VQModel(config, generator, input_size)
