# ------------------------------------------------------------------
"""MGFN classifier: glance / focus blocks with a magnitude embedding
(counterpart of idee_tpu/baselines/mil/mgfn.py; reference
Baselines_MIL/models/classifier/MGFN.py).

Instances [N, V, T, C] run as N*V sequences of length T: the magnitude
embedding x + alpha * conv(||x||_2), stages of blocks (shortcut conv +
GLANCE temporal self-attention or FOCUS grouped local conv over heads +
feedforward, all residual), LayerNorm + Dense + Sigmoid scoring; returns
(features [N, V, T, dim[-2]], scores [N, V, T, 1]). As in the JAX
package the stage-0 dim is embed_dim (the reference __main__'s
dim=[16, 96, 1], MGFN.py:326). Channels-last [B, T, C]; Conv1d is
``nn/layers.py::Conv`` with kernel (k,).
"""
# ------------------------------------------------------------------

from typing import List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from idee_tpu_torch.baselines.mil.classifiers import normal_init
from idee_tpu_torch.nn.layers import (BatchNorm, Conv, Dense, Init,
                                      LayerNorm, dropout)


class ChannelLayerNorm(nn.Module):
    """The MGFN LayerNorm: (x - mean) / (std + eps) * g + b over the
    channel axis, eps outside the root (MGFN.py:34-44); g starts 0.02 (the
    MIL init sweep), b 0."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.g = nn.Parameter(torch.full((dim,), 0.02))
        self.b = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        mean = x.mean(-1, keepdim=True)
        std = torch.sqrt(((x - mean) ** 2).mean(-1, keepdim=True))
        return (x - mean) / (std + self.eps) * self.g + self.b


def _conv1d(cin, feat, k, kernel_init, generator, use_bias=True, groups=1):
    pad = k // 2
    return Conv(cin, feat, (k,), padding=((pad, pad),), groups=groups,
                use_bias=use_bias, kernel_init=kernel_init,
                generator=generator)


class Focus(nn.Module):
    """Local branch: BN -> v -> grouped conv over heads -> out
    (reference: MGFN.py:65-88)."""

    def __init__(self, dim: int, heads: int, dim_head: int = 16,
                 local_aggr_kernel: int = 5,
                 kernel_init: Init = normal_init(), generator=None):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        inner = dim_head * heads
        self.norm = BatchNorm(dim, scale_init=0.02)
        self.to_v = _conv1d(dim, inner, 1, kernel_init, generator,
                            use_bias=False)
        self.rel_pos = _conv1d(heads, heads, local_aggr_kernel, kernel_init,
                               generator, groups=heads)
        self.to_out = _conv1d(inner, dim, 1, kernel_init, generator)

    def forward(self, x, train: bool = False):
        B, T, _ = x.shape
        h, d = self.heads, self.dim_head
        v = self.to_v(self.norm(x, train))
        # channel layout (c h): the head index is the fast axis
        # (rearrange 'b (c h) t -> (b c) h t', MGFN.py:85)
        v = v.reshape(B, T, d, h).transpose(1, 2).reshape(B * d, T, h)
        v = self.rel_pos(v).reshape(B, d, T, h).transpose(1, 2)
        return self.to_out(v.reshape(B, T, d * h))


class Glance(nn.Module):
    """Temporal self-attention branch (reference: MGFN.py:91-121)."""

    def __init__(self, dim: int, heads: int, dim_head: int = 16,
                 kernel_init: Init = normal_init(), generator=None):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        inner = dim_head * heads
        self.norm = ChannelLayerNorm(dim)
        self.to_qkv = _conv1d(dim, inner * 3, 1, kernel_init, generator,
                              use_bias=False)
        self.to_out = _conv1d(inner, dim, 1, kernel_init, generator)

    def forward(self, x, train: bool = False):
        B, T, _ = x.shape
        h, hd = self.heads, self.dim_head
        q, k, v = (t.reshape(B, T, h, hd).transpose(1, 2) for t in
                   self.to_qkv(self.norm(x)).chunk(3, dim=-1))
        attn = torch.softmax(
            torch.einsum("bhtd,bhsd->bhts", q * hd ** -0.5, k), dim=-1)
        out = torch.einsum("bhts,bhsd->bhtd", attn, v)
        return self.to_out(out.transpose(1, 2).reshape(B, T, h * hd))


class MGFNBackbone(nn.Module):
    """depth x (shortcut conv + attention + feedforward), all residual
    (reference: MGFN.py:124-162)."""

    def __init__(self, dim: int, depth: int, heads: int,
                 mgfn_type: str = "gb", kernel: int = 5, dim_head: int = 64,
                 ff_repe: int = 4, dropout: float = 0.0,
                 kernel_init: Init = normal_init(), generator=None):
        super().__init__()
        self.depth, self.dropout = depth, dropout
        for i in range(depth):
            self.add_module(f"scc{i}", _conv1d(dim, dim, 3, kernel_init,
                                               generator))
            if mgfn_type == "fb":
                att = Focus(dim, heads, dim_head, kernel, kernel_init,
                            generator)
            elif mgfn_type == "gb":
                att = Glance(dim, heads, dim_head, kernel_init, generator)
            else:
                raise ValueError(f"unknown mgfn type {mgfn_type!r}")
            self.add_module(f"attn{i}", att)
            # FeedForward (reference: MGFN.py:54-61)
            self.add_module(f"ff_norm{i}", ChannelLayerNorm(dim))
            self.add_module(f"ff_in{i}", _conv1d(dim, dim * ff_repe, 1,
                                                 kernel_init, generator))
            self.add_module(f"ff_out{i}", _conv1d(dim * ff_repe, dim, 1,
                                                  kernel_init, generator))

    def forward(self, x, train: bool = False, generator=None):
        for i in range(self.depth):
            x = getattr(self, f"scc{i}")(x) + x
            x = getattr(self, f"attn{i}")(x, train) + x
            y = getattr(self, f"ff_in{i}")(getattr(self, f"ff_norm{i}")(x))
            y = dropout(F.gelu(y), self.dropout, train, generator)
            x = getattr(self, f"ff_out{i}")(y) + x
        return x


class MGFN(nn.Module):
    """reference: MGFN.py:165-248. [N, V, T, C] ->
    (features [N, V, T, dim[-2]], scores [N, V, T, 1])."""

    def __init__(self, embed_dim: int = 16, dim: Optional[List[int]] = None,
                 drop_rate: float = 0.0, alpha: float = 0.1,
                 depths: Optional[List[int]] = None,
                 mgfn_types: Optional[List[str]] = None, lokernel: int = 5,
                 ff_repe: int = 4, dim_head: Optional[List[int]] = None,
                 kernel_init: Init = normal_init(), generator=None):
        super().__init__()
        dim = list(dim or [embed_dim, 96, 1])
        depths = list(depths or [1, 1])
        types = list(mgfn_types or ["fb", "fb"])
        dim_head = list(dim_head or [16, 96])
        self.alpha, self.n_stages = alpha, len(depths)
        self.to_mag = _conv1d(1, embed_dim, 3, kernel_init, generator)
        for ind, (depth, mtype) in enumerate(zip(depths, types)):
            self.add_module(f"stage{ind}", MGFNBackbone(
                dim[ind], depth, max(dim[ind] // dim_head[ind], 1), mtype,
                lokernel, dim_head[ind], ff_repe, drop_rate, kernel_init,
                generator))
            if ind != len(depths) - 1:
                self.add_module(f"trans_norm{ind}",
                                ChannelLayerNorm(dim[ind]))
                self.add_module(f"trans_conv{ind}", _conv1d(
                    dim[ind], dim[ind + 1], 1, kernel_init, generator))
        last = dim[len(depths) - 1]
        # torch LayerNorm (affine); the MIL sweep sets weight 0.02
        self.to_logits = LayerNorm(last, scale_init=0.02)
        self.fc = Dense(last, 1, kernel_init=kernel_init, generator=generator)

    def forward(self, x, train: bool = False, generator=None):
        N, V, T, C = x.shape
        x = x.reshape(N * V, T, C)
        # magnitude embedding (reference: MGFN.py:231-232)
        mag = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
        x = x + self.alpha * self.to_mag(mag)
        for ind in range(self.n_stages):
            x = getattr(self, f"stage{ind}")(x, train, generator)
            if ind != self.n_stages - 1:
                x = getattr(self, f"trans_conv{ind}")(
                    getattr(self, f"trans_norm{ind}")(x))
        x = self.to_logits(x)
        scores = torch.sigmoid(self.fc(x))
        return x.reshape(N, V, T, -1), scores.reshape(N, V, T, 1)
