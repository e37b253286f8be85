# ------------------------------------------------------------------
"""Configs for the three baseline packages (the port's copy of
idee_tpu/baselines/config.py): each family a dataclass extending the
port's Config with the reference's extra flags, the same names and
defaults, so ``config.read_arguments(..., defaults=mil_config())`` takes
them as flags.
"""
# ------------------------------------------------------------------

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from idee_tpu_torch.config import SYNTHETIC_VARIABLES, Config


def _synth_base(kw):
    kw.setdefault("variables", list(SYNTHETIC_VARIABLES))
    kw.setdefault("in_channels", 1)
    kw.setdefault("encoder", "CNN_3D")
    return kw


@dataclass
class MILConfig(Config):
    """Baselines_MIL/config.py flags."""

    # the MIL classifier is an MLP with a dim list (reference:
    # Baselines_MIL/config.py:91), unlike the core CNN classifier's int
    cls_dim: List[int] = field(default_factory=lambda: [512, 256, 1])
    cls_drop_rate: float = 0.5
    instance_drop_rate: float = 0.5

    # agent (cross-attention Swin; reference: Baselines_MIL/config.py:72-88)
    agent: str = "Swin_3D"
    agent_embed_dim: List[int] = field(default_factory=lambda: [16])
    agent_depths: List[int] = field(default_factory=lambda: [1])
    agent_patch_size: Tuple[int, int, int] = (1, 1, 1)
    agent_n_heads: List[int] = field(default_factory=lambda: [2])
    agent_window_size: List[Tuple[int, int, int]] = field(
        default_factory=lambda: [(1, 1, 1)])
    agent_mlp_ratio: float = 4.0
    agent_drop_rate: float = 0.1
    agent_attn_drop_rate: float = 0.0
    agent_drop_path_rate: float = 0.1
    agent_qkv_bias: bool = True
    agent_qk_scale: Optional[float] = None
    agent_patch_norm: bool = False
    agent_use_checkpoint: bool = False

    # per-baseline loss knobs (reference: Baselines_MIL/config.py:130-154)
    loss_lambda1: float = 8e-5
    loss_lambda2: float = 8e-5
    loss_k_deepmil: int = 100
    loss_alpha_arnet: float = 400.0
    loss_lambda_c_arnet: float = 20.0
    dim_mtn_rtfm: int = 32
    loss_alpha_rtfm: float = 1e-4
    loss_margin_rtfm: float = 100.0
    loss_k_rtfm: int = 100
    loss_k_mgfn: int = 100
    loss_lambda_mgfn: float = 1e-4
    loss_margin_mgfn: float = 100.0
    alpha_mgfn: float = 0.1
    dim_head_mgfn: List[int] = field(default_factory=lambda: [16, 96])
    depths_mgfn: List[int] = field(default_factory=lambda: [1, 1])
    types_mgfn: List[str] = field(default_factory=lambda: ["fb", "fb"])
    lokernel_mgfn: int = 5
    ff_repe_mgfn: int = 4
    attention_drop_rate_mgfn: float = 0.0


@dataclass
class OneClassConfig(Config):
    """Baselines_OneClass/config.py flags (SimpleNet knobs, :80,118-126)."""

    dim: int = 512                 # projection output dim
    pre_proj: int = 1              # projection layer count
    proj_layer_type: int = 0
    dsc_layers: int = 2
    dsc_hidden: int = 96
    mix_noise: int = 1
    noise_std: float = 1.5
    th_n: float = 1.0
    th_p: float = 1.0
    model_pretrained: Optional[str] = None  # frozen backbone checkpoint
    is_replace_anomaly: bool = True


@dataclass
class ReconConfig(Config):
    """Baselines_Reconstruction/config.py flags (:38-85)."""

    en_embed_dim_steal: List[int] = field(
        default_factory=lambda: [96, 128, 256])
    de_embed_dim_steal: List[int] = field(
        default_factory=lambda: [256, 128, 96])

    inplanes: int = 6
    instrides: int = 2
    feature_size: Tuple[int, int] = (100, 100)
    feature_jitter_scale: float = 0.01
    feature_jitter_prob: float = 0.0
    neighbor_size: Tuple[int, int] = (9, 9)
    neighbor_mask: List[bool] = field(default_factory=lambda: [True, True,
                                                               True])
    hidden_dim: int = 96
    pos_embed_type: str = "learned"
    initializer: str = "xavier_uniform"
    nhead: int = 3
    num_encoder_layers: int = 3
    num_decoder_layers: int = 3
    dim_feedforward: int = 96 * 4
    dropout: float = 0.1
    activation: str = "relu"
    normalize_before: bool = False
    return_intermediate_dec: bool = False

    delta_t: int = 1  # UniAD works on single timesteps (reference: :71)
    is_replace_anomaly: bool = True


def mil_config(**overrides) -> MILConfig:
    return MILConfig(**_synth_base(overrides))


def oneclass_config(**overrides) -> OneClassConfig:
    return OneClassConfig(**_synth_base(overrides))


def recon_config(**overrides) -> ReconConfig:
    return ReconConfig(**_synth_base(overrides))

