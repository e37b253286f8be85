# ------------------------------------------------------------------
"""Agent: cross-attention Swin over variables (counterpart of
idee_tpu/baselines/mil/agent.py; reference
Baselines_MIL/models/agent/Swin_3D.py).

One tower per variable: q from the variable's own features, k and v from
every variable's input at the same location, the variable's own key
masked out with -1e9 (not -inf) before the softmax, as the JAX package
does (agent.py:84-88). Defined for window (1, 1, 1), the reference's only
shipped configuration, where a window is one location, so the attention
is a batched einsum over the variables.

Layout: the towers' parameters are stacked on axis 0 ([V, ...], the JAX
package's vmapped towers), and activations are packed channels-last
[B, T, H, W, V*C] as in the port's encoders: the per-tower Dense, LayerNorm
and Conv3d are ``GroupedDense``, ``GroupedLayerNorm3d`` and
``GroupedConv3d``. The conditioning set, all variables seen by every
tower, is [B, T, H, W, V_tower, V, C].

Init: Dense and Conv N(0, 0.02), affine LayerNorms scale 0.02 / bias 0
(the MIL init sweep, build_rtfm.py:283-305); the rel-pos table keeps
trunc_normal(0.02).

Compute dtype (the JAX module's ``dtype``): the Dense and Conv layers
compute in ``dtype``; what JAX builds without one promotes as flax
promotes. The LayerNorms (flax nn.LayerNorm, no dtype) normalise in
float32 and return float32 with a scale and bias, the input's dtype
without; the rel-pos table (float32) makes the logits, the softmax and
the attention-weighted sum float32 (agent.py:84-94).
"""
# ------------------------------------------------------------------

from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from idee_tpu_torch.baselines.mil.classifiers import normal_init
from idee_tpu_torch.nn.layers import (GroupedConv3d, GroupedDense,
                                      GroupedLayerNorm3d, Init, dropout,
                                      trunc_normal_init)

_LN_EPS = 1e-6  # flax nn.LayerNorm's


class _FlaxLayerNorm(GroupedLayerNorm3d):
    """flax nn.LayerNorm without a dtype over each tower's C channels: the
    statistics and the arithmetic in float32, the result float32 with a
    scale and bias (promoted with them), else in the input's dtype."""

    def forward(self, x):
        y = super().forward(x.float())
        return y if self.scale is not None else y.to(x.dtype)


def _affine_ln(V: int, C: int) -> GroupedLayerNorm3d:
    """Per-tower affine LayerNorm with the MIL sweep's init."""
    ln = _FlaxLayerNorm(V, C, eps=_LN_EPS)
    with torch.no_grad():
        ln.scale.fill_(0.02)
    return ln


def _tower_drop_path(x, rate: float, train: bool, V: int, generator=None):
    """Stochastic depth per sample and tower on packed [B, ..., V*C]."""
    if rate == 0.0 or not train:
        return x
    keep = 1.0 - rate
    B, C = x.shape[0], x.shape[-1] // V
    shape = (B,) + (1,) * (x.dim() - 2) + (V, 1)
    mask = torch.rand(shape, generator=generator, device=x.device) < keep
    xv = x.reshape(*x.shape[:-1], V, C)
    return torch.where(mask, xv / keep, torch.zeros((), dtype=x.dtype,
                                                    device=x.device)) \
        .reshape(x.shape)


class TowerConditioningNorm(nn.Module):
    """Each tower's affine LayerNorm of every variable's input:
    [..., V, C] -> [..., V_tower, V, C] in float32 (flax nn.LayerNorm
    without a dtype); scale and bias [V, C]."""

    def __init__(self, V: int, C: int):
        super().__init__()
        self.scale = nn.Parameter(torch.full((V, C), 0.02))
        self.bias = nn.Parameter(torch.zeros(V, C))

    def forward(self, xv):
        xv = xv.float()
        mu = xv.mean(-1, keepdim=True)
        d = xv - mu
        y = d * torch.rsqrt((d * d).mean(-1, keepdim=True) + _LN_EPS)
        return y.unsqueeze(-3) * self.scale[:, None] + self.bias[:, None]


class CrossVariableAttention(nn.Module):
    """Per-location attention: q from the tower's own variable, k and v
    from all variables, its own masked out
    (reference: agent/Swin_3D.py:105-186 with window (1,1,1))."""

    def __init__(self, V: int, dim: int, con_dim: int, num_heads: int,
                 qkv_bias: bool = True, qk_scale: Optional[float] = None,
                 attn_drop: float = 0.0, proj_drop: float = 0.0,
                 kernel_init: Init = normal_init(), generator=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.V, self.dim, self.heads = V, dim, num_heads
        self.dtype = dtype
        hd = dim // num_heads
        self.scale = qk_scale or hd ** -0.5
        self.attn_drop, self.proj_drop = attn_drop, proj_drop
        self.q = GroupedDense(V, dim, dim, use_bias=qkv_bias,
                              kernel_init=kernel_init, generator=generator,
                              dtype=dtype)
        self.kv = GroupedDense(V, con_dim, 2 * dim, use_bias=qkv_bias,
                               kernel_init=kernel_init, generator=generator,
                               dtype=dtype)
        # rel-pos bias table for a (1,1,1) window: one scalar per head
        self.relative_position_bias_table = nn.Parameter(
            torch.empty(V, 1, num_heads))
        trunc_normal_init(0.02)(self.relative_position_bias_table, generator)
        self.proj = GroupedDense(V, dim, dim, kernel_init=kernel_init,
                                 generator=generator, dtype=dtype)
        # the tower's own variable leaves its conditioning set (reference:
        # agent/Swin_3D.py:671-673): [V_tower, 1, V]
        self.register_buffer("self_mask", torch.eye(V, dtype=torch.bool)
                             [:, None, :], persistent=False)

    def forward(self, y, con, train: bool = False, generator=None):
        """y: packed [B, T, H, W, V*dim]; con: [B, T, H, W, V_tower, V,
        C_con]."""
        V, h, dt = self.V, self.heads, self.dtype
        hd = self.dim // h
        lead = y.shape[:-1]
        q = self.q(y).reshape(*lead, V, h, hd) * self.scale
        kv = torch.einsum("...avc,acd->...avd", con.to(dt),
                          self.kv.kernel.to(dt))
        if self.kv.bias is not None:
            kv = kv + self.kv.bias[:, None].to(dt)
        k = kv[..., :self.dim].reshape(*lead, V, V, h, hd)
        v = kv[..., self.dim:].reshape(*lead, V, V, h, hd)
        logits = torch.einsum("...ahd,...avhd->...ahv", q, k)
        # the float32 table promotes the logits (and so the softmax and
        # the weighted sum) to float32
        logits = logits + self.relative_position_bias_table[:, 0, :, None]
        logits = torch.where(self.self_mask, torch.full(
            (), -1e9, dtype=logits.dtype, device=logits.device), logits)
        attn = dropout(torch.softmax(logits, dim=-1), self.attn_drop, train,
                       generator)
        out = torch.einsum("...ahv,...avhd->...ahd", attn,
                           v.to(attn.dtype))
        out = self.proj(out.reshape(*lead, V * self.dim))
        return dropout(out, self.proj_drop, train, generator)


class AgentBlock(nn.Module):
    """LN -> cross attention -> residual; LN -> MLP -> residual
    (reference: agent/Swin_3D.py:206-310)."""

    def __init__(self, V: int, dim: int, con_dim: int, num_heads: int,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None, drop: float = 0.0,
                 attn_drop: float = 0.0, drop_path: float = 0.0,
                 kernel_init: Init = normal_init(), generator=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.V, self.drop, self.drop_path = V, drop, drop_path
        hidden = int(dim * mlp_ratio)
        self.norm1 = _affine_ln(V, dim)
        self.norm1_con = TowerConditioningNorm(V, con_dim)
        self.attn = CrossVariableAttention(V, dim, con_dim, num_heads,
                                           qkv_bias, qk_scale, attn_drop,
                                           drop, kernel_init, generator,
                                           dtype)
        self.norm2 = _affine_ln(V, dim)
        self.Dense_0 = GroupedDense(V, dim, hidden, kernel_init=kernel_init,
                                    generator=generator, dtype=dtype)
        self.Dense_1 = GroupedDense(V, hidden, dim, kernel_init=kernel_init,
                                    generator=generator, dtype=dtype)

    def forward(self, x, x_all, train: bool = False, generator=None):
        """x: packed [B, T, H, W, V*dim]; x_all: [B, T, H, W, V, C_con]."""
        V = self.V
        y = self.attn(self.norm1(x), self.norm1_con(x_all), train,
                      generator)
        x = x + _tower_drop_path(y, self.drop_path, train, V, generator)
        z = dropout(F.gelu(self.Dense_0(self.norm2(x))), self.drop, train,
                    generator)
        z = dropout(self.Dense_1(z), self.drop, train, generator)
        return x + _tower_drop_path(z, self.drop_path, train, V, generator)


class _ConvHead(nn.Module):
    """The name level of the JAX package's Conv3d wrapper (its nn.Conv is
    "Conv_0")."""

    def __init__(self, conv: nn.Module):
        super().__init__()
        self.Conv_0 = conv

    def forward(self, x):
        return self.Conv_0(x)


class AgentTower(nn.Module):
    """The towers, one per variable, parameters stacked on axis 0: a
    pointwise embed where a stage changes width, the blocks, and the conv
    head (reference: agent/Swin_3D.py:596-634)."""

    def __init__(self, V: int, in_chans: int, embed_dim: List[int],
                 depths: List[int], num_heads: List[int],
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None, drop_rate: float = 0.1,
                 attn_drop_rate: float = 0.0, drop_path_rate: float = 0.1,
                 kernel_init: Init = normal_init(), generator=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.V, self.embed_dim, self.depths = V, embed_dim, depths
        self.in_chans = in_chans
        dpr = [float(r) for r in np.linspace(0, drop_path_rate,
                                             sum(depths))]
        for i, (dim, depth, heads) in enumerate(zip(embed_dim, depths,
                                                    num_heads)):
            in_dim = embed_dim[i - 1] if i > 0 else in_chans
            # pointwise embed + non-affine LN iff the stage changes width
            # (agent/Swin_3D.py:447-450)
            if in_dim != dim:
                self.add_module(f"embed{i}", GroupedConv3d(
                    V, in_dim, dim, (1, 1, 1), padding=((0, 0),) * 3,
                    kernel_init=kernel_init, generator=generator,
                    dtype=dtype))
                self.add_module(f"embed_norm{i}", _FlaxLayerNorm(
                    V, dim, affine=False, eps=_LN_EPS))
            lo = sum(depths[:i])
            for d in range(depth):
                # the conditioning set is always the towers' input
                self.add_module(f"stage{i}_block{d}", AgentBlock(
                    V, dim, in_chans, heads, mlp_ratio, qkv_bias, qk_scale,
                    drop_rate, attn_drop_rate, dpr[lo + d], kernel_init,
                    generator, dtype))
        E = embed_dim[-1]
        for j in range(2):  # Conv3d-ReLU-Conv3d-ReLU (:624-634)
            self.add_module(f"proj{j}", _ConvHead(GroupedConv3d(
                V, E, E, (3, 3, 3), padding_mode="replicate",
                kernel_init=kernel_init, generator=generator, dtype=dtype)))

    def forward(self, x, train: bool = False, generator=None):
        """x: packed [B, T, H, W, V*C_in] -> [B, T, H, W, V*E]."""
        x_all = x.reshape(*x.shape[:-1], self.V, self.in_chans)
        for i, depth in enumerate(self.depths):
            if hasattr(self, f"embed{i}"):
                x = getattr(self, f"embed_norm{i}")(
                    getattr(self, f"embed{i}")(x))
            for d in range(depth):
                x = getattr(self, f"stage{i}_block{d}")(x, x_all, train,
                                                        generator)
        for j in range(2):
            x = F.relu(getattr(self, f"proj{j}")(x))
        return x


class AgentSwin(nn.Module):
    """Multi-variable cross-attention agent
    (reference: agent/Swin_3D.py:529-687):
    [B, V, C, T, H, W] -> [B, V, E, T, H, W]."""

    def __init__(self, in_vars: int = 6, in_chans: int = 16,
                 embed_dim: Optional[List[int]] = None,
                 depths: Optional[List[int]] = None,
                 num_heads: Optional[List[int]] = None,
                 window_size: Optional[List[Tuple[int, int, int]]] = None,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None, drop_rate: float = 0.1,
                 attn_drop_rate: float = 0.0, drop_path_rate: float = 0.1,
                 kernel_init: Init = normal_init(), generator=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        window_size = window_size or [(1, 1, 1)]
        if not all(tuple(w) == (1, 1, 1) for w in window_size):
            raise ValueError("the agent is defined for window_size (1,1,1) "
                             "(the reference default and only shipped "
                             "config, Baselines_MIL/config.py:77)")
        self.in_vars = in_vars
        self.towers = AgentTower(
            in_vars, in_chans, list(embed_dim or [16]), list(depths or [1]),
            list(num_heads or [2]), mlp_ratio, qkv_bias, qk_scale,
            drop_rate, attn_drop_rate, drop_path_rate, kernel_init,
            generator, dtype)

    def forward(self, x, train: bool = False, generator=None):
        B, V, C, T, H, W = x.shape
        y = self.towers(x.permute(0, 3, 4, 5, 1, 2).reshape(B, T, H, W,
                                                            V * C),
                        train, generator)
        return y.reshape(B, T, H, W, V, -1).permute(0, 4, 5, 1, 2, 3)
