# ------------------------------------------------------------------
"""MIL composite models: DeepMIL, ARNet, RTFM, MGFN (counterpart of
idee_tpu/baselines/mil/models.py; reference
Baselines_MIL/models/build_{deepmil,arnet,rtfm,mgfn}.py).

encoder -> (agent + Aggregate, or agent + temporal mean) -> a per-pixel
instance classifier. The classifier scores every pixel densely (it is
pointwise over instances); bag selection happens in the masked top-k
losses. Outputs: MILOutput(scores [N, V, T, H, W] in [0, 1], features
[N, V, T, H, W, C'] or None); for MGFN T == 1 after the temporal mean
(build_mgfn.py:161). Every Conv / Dense starts N(0, 0.02) and the norms
0.02 / 0 (the MIL init sweep, build_deepmil.py:90-111).

Compute dtype: the encoder, the agent, Aggregate and the DeepMIL / ARNet /
RTFM heads compute in cfg.dtype, as JAX builds them (models.py:54-88);
MGFN, which JAX builds without a dtype, promotes its input to float32.
Scores and features leave in float32.
"""
# ------------------------------------------------------------------

from typing import NamedTuple, Optional

import torch
import torch.nn as nn

from idee_tpu_torch.baselines.config import MILConfig
from idee_tpu_torch.baselines.mil.agent import AgentSwin
from idee_tpu_torch.baselines.mil.classifiers import (ARNet, DeepMIL, RTFM,
                                                      normal_init)
from idee_tpu_torch.baselines.mil.mgfn import MGFN
from idee_tpu_torch.baselines.mil.rtfm_net import Aggregate
from idee_tpu_torch.models.vq_model import build_encoder, compute_dtype

VARIANTS = ("deepmil", "arnet", "rtfm", "mgfn")


class MILOutput(NamedTuple):
    scores: torch.Tensor              # [N, V, T, H, W]
    features: Optional[torch.Tensor]  # [N, V, T, H, W, C'] or None


def _instances(z):
    """[N, V, C, T, H, W] -> channels-last [N, V, T, H, W, C]."""
    return z.permute(0, 1, 3, 4, 5, 2)


class MILModel(nn.Module):
    """variant in {'deepmil', 'arnet', 'rtfm', 'mgfn'}; parameters from
    ``generator`` (default: a CPU generator seeded with cfg.seed)."""

    def __init__(self, config: MILConfig, variant: str = "deepmil",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if variant not in VARIANTS:
            raise NotImplementedError(f"MIL variant {variant!r}")
        cfg = self.config = config
        self.variant = variant
        dtype = self.dtype = compute_dtype(cfg)
        g = generator or torch.Generator().manual_seed(cfg.seed)
        init = normal_init(0.02)  # MIL sweep: N(0, 0.02)
        self.encoder = build_encoder(cfg, init, g)
        emb = cfg.en_embed_dim[-1]

        if variant in ("rtfm", "mgfn"):
            self.agent = AgentSwin(
                in_vars=cfg.in_channels_dynamic, in_chans=emb,
                embed_dim=list(cfg.agent_embed_dim),
                depths=list(cfg.agent_depths),
                num_heads=list(cfg.agent_n_heads),
                window_size=[tuple(w) for w in cfg.agent_window_size],
                mlp_ratio=cfg.agent_mlp_ratio, qkv_bias=cfg.agent_qkv_bias,
                qk_scale=cfg.agent_qk_scale, drop_rate=cfg.agent_drop_rate,
                attn_drop_rate=cfg.agent_attn_drop_rate,
                drop_path_rate=cfg.agent_drop_path_rate, kernel_init=init,
                generator=g, dtype=dtype)
        if variant == "deepmil":
            self.classifier = DeepMIL(emb, list(cfg.cls_dim),
                                      cfg.cls_drop_rate, init, g, dtype)
        elif variant == "arnet":
            self.classifier = ARNet(emb, list(cfg.cls_dim),
                                    cfg.cls_drop_rate, init, g, dtype)
        elif variant == "rtfm":
            self.Aggregate = Aggregate(emb, cfg.dim_mtn_rtfm, init, g, dtype)
            self.classifier = RTFM(emb, list(cfg.cls_dim), cfg.cls_drop_rate,
                                   init, g, dtype)
        else:
            self.classifier = MGFN(
                embed_dim=cfg.agent_embed_dim[-1], drop_rate=0.0,
                alpha=cfg.alpha_mgfn, depths=list(cfg.depths_mgfn),
                mgfn_types=list(cfg.types_mgfn), lokernel=cfg.lokernel_mgfn,
                ff_repe=cfg.ff_repe_mgfn, dim_head=list(cfg.dim_head_mgfn),
                kernel_init=init, generator=g)

    def forward(self, x_d, train: bool = False,
                generator: Optional[torch.Generator] = None) -> MILOutput:
        """``generator`` draws the dropout and drop-path masks."""
        z = self.encoder(x_d.to(self.dtype), train=train,
                         generator=generator)

        if self.variant == "deepmil":
            s = self.classifier(_instances(z), train, generator)
            return MILOutput(s[..., 0].float(), None)
        if self.variant == "arnet":
            feat, s = self.classifier(_instances(z), train, generator)
            return MILOutput(s[..., 0].float(), feat.float())
        z = self.agent(z, train, generator)
        if self.variant == "rtfm":
            z = self.Aggregate(z, train)
            feat, s = self.classifier(_instances(z), train, generator)
            return MILOutput(s[..., 0].float(), feat.float())

        # mgfn: temporal mean -> per-pixel T=1 sequences
        # (build_mgfn.py:155-161); MGFN promotes them to float32
        inst = _instances(z.mean(3, keepdim=True))   # [N, V, 1, H, W, C]
        N, V, T, H, W, C = inst.shape
        flat = inst.permute(0, 3, 4, 1, 2, 5).reshape(N * H * W, V, T, C)
        feat, s = self.classifier(flat.float(), train, generator)
        feat = feat.reshape(N, H, W, V, T, -1).permute(0, 3, 4, 1, 2, 5)
        s = s.reshape(N, H, W, V, T).permute(0, 3, 4, 1, 2)
        return MILOutput(s, feat)


def build_mil_model(cfg: MILConfig, variant: str,
                    generator: Optional[torch.Generator] = None) -> MILModel:
    return MILModel(cfg, variant, generator)
