# ------------------------------------------------------------------
"""STEALNET: a 3D convolutional autoencoder
(https://arxiv.org/abs/2110.09768; counterpart of
idee_tpu/baselines/recon/steal.py; reference
Baselines_Reconstruction/models/build_steal.py).

Encoder: 4 x (Conv3d with strides (1,2,2) / (2,2,2) / (2,2,2) / (2,1,1),
BatchNorm, LeakyReLU 0.2); the decoder mirrors it with transposed
convolutions and ends with Tanh * 10, the clipped data range (:18-84).
Input [N, V, T, H, W], the V variables as channels; H and W divisible by
8, T by 4. Channels-last inside, flax's "SAME" padding on both (the
transposed convolution gives out = in * stride; ``nn/layers.py::
ConvTranspose``). Kernels start with torch's default U(+-1/sqrt(fan_in))
(the reference's init sweep is commented out, :102-124).

Loss: + MSE on normal pixels - MSE on extreme pixels (models/
losses.py:16-32).
"""
# ------------------------------------------------------------------

import math
from typing import List, NamedTuple, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from idee_tpu_torch.nn.layers import (BatchNorm, Conv, ConvTranspose,
                                      uniform_init)


def torch_conv_init(fan_in: int):
    """torch's Conv default, kaiming_uniform(a=sqrt(5)):
    U(+-sqrt(1/fan_in))."""
    b = math.sqrt(1.0 / fan_in)
    return uniform_init(-b, b)


class Reconstruction3DEncoder(nn.Module):
    """reference: build_steal.py:18-47. [N, T, H, W, V] ->
    [N, T/4, H/8, W/8, E]."""

    def __init__(self, chnum_in: int = 6,
                 embed_dim: Optional[List[int]] = None, generator=None):
        super().__init__()
        dims = list(embed_dim or [96, 128, 256])
        strides = [(1, 2, 2), (2, 2, 2), (2, 2, 2), (2, 1, 1)]
        cin = chnum_in
        for i, (f, s) in enumerate(zip(dims + dims[-1:], strides)):
            self.add_module(f"conv{i}", Conv(
                cin, f, (3, 3, 3), s, "SAME", use_bias=False,
                kernel_init=torch_conv_init(27 * cin), generator=generator))
            self.add_module(f"bn{i}", BatchNorm(f))
            cin = f

    def forward(self, x, train: bool = False):
        for i in range(4):
            x = getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x), train)
            x = F.leaky_relu(x, 0.2)
        return x


class Reconstruction3DDecoder(nn.Module):
    """reference: build_steal.py:50-84. Mirrors the encoder; Tanh * 10."""

    def __init__(self, chnum_in: int = 6,
                 embed_dim: Optional[List[int]] = None, in_features=None,
                 generator=None):
        super().__init__()
        dims = list(embed_dim or [256, 128, 96])
        strides = [(2, 1, 1), (2, 2, 2), (2, 2, 2), (1, 2, 2)]
        cin = in_features or dims[0]
        for i, (f, s) in enumerate(zip(dims + [chnum_in], strides)):
            last = i == 3
            self.add_module(f"deconv{i}", ConvTranspose(
                cin, f, (3, 3, 3), s, use_bias=last,
                kernel_init=torch_conv_init(27 * cin), generator=generator))
            if not last:
                self.add_module(f"bn{i}", BatchNorm(f))
            cin = f

    def forward(self, x, train: bool = False):
        for i in range(4):
            x = getattr(self, f"deconv{i}")(x)
            if i < 3:
                x = F.leaky_relu(getattr(self, f"bn{i}")(x, train), 0.2)
        return torch.tanh(x) * 10.0


class RecOutput(NamedTuple):
    pred: torch.Tensor  # [N, V, T, H, W]


class RecModel(nn.Module):
    """reference: build_steal.py:87-157. forward [N,V,T,H,W] -> same."""

    def __init__(self, chnum_in: int = 6,
                 en_embed_dim: Optional[List[int]] = None,
                 de_embed_dim: Optional[List[int]] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator or torch.Generator().manual_seed(0)
        en = list(en_embed_dim or [96, 128, 256])
        self.encoder = Reconstruction3DEncoder(chnum_in, en, g)
        self.decoder = Reconstruction3DDecoder(chnum_in, de_embed_dim,
                                               en[-1], g)

    def forward(self, x, train: bool = False) -> RecOutput:
        T, H, W = x.shape[-3:]
        if T % 4 or H % 8 or W % 8:
            # the decoder gives back T rounded up to 4 and H, W to 8 (the
            # JAX package broadcasts a mismatch silently)
            raise ValueError(f"STEAL needs T % 4 == 0 and H, W % 8 == 0 "
                             f"(delta_t 8 in the config); got {(T, H, W)}")
        y = self.encoder(x.permute(0, 2, 3, 4, 1), train)  # channels-last
        return RecOutput(self.decoder(y, train).permute(0, 4, 1, 2, 3))


def steal_loss(pred, target, mask):
    """Signed MSE (reference: Baselines_Reconstruction/models/
    losses.py:16-32): + MSE on normal pixels, - MSE on extreme pixels.
    pred / target [N, V, T, H, W]; mask [N, T, H, W] (the per-week
    extremes of the window)."""
    err = (pred - target) ** 2
    sel_p = (mask[:, None] != 0).expand(err.shape)
    sel_n = ~sel_p
    loss_n = (err * sel_n).sum() / torch.clamp(sel_n.sum(), min=1)
    loss_p = -(err * sel_p).sum() / torch.clamp(sel_p.sum(), min=1)
    return loss_n + loss_p
