# ------------------------------------------------------------------
"""SimpleNet (https://arxiv.org/abs/2303.15140) one-class head
(counterpart of idee_tpu/baselines/oneclass/simplenet.py; reference
Baselines_OneClass/models/build_simplenet.py).

Features of a frozen encoder are scaled by 0.01 (:235), projected by a
bias-free Dense stack (:55-83); negatives are the features plus
N(0, noise_std) noise (:243-253); a Dense-BatchNorm-LeakyReLU
discriminator scores both (:31-52). In training the discriminator runs on
the noisy copy first and then on the clean one, as in the JAX package:
each call moves the BatchNorm statistics, so the order matters. The
frozen backbone is not part of this module (``oneclass/driver.py``; it
computes in cfg.dtype, this head in float32, as JAX builds them).
Dense kernels start xavier_normal (:23-27).
"""
# ------------------------------------------------------------------

from typing import NamedTuple, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from idee_tpu_torch.baselines.config import OneClassConfig
from idee_tpu_torch.nn.layers import BatchNorm, Dense, xavier_init


def _dense(fin, fout, use_bias, generator):
    return Dense(fin, fout, use_bias=use_bias,
                 kernel_init=xavier_init(fin, fout), generator=generator)


class Projection(nn.Module):
    """Bias-free Dense stack (reference: build_simplenet.py:55-83)."""

    def __init__(self, in_planes: int, out_planes: int, n_layers: int = 1,
                 layer_type: int = 0, generator=None):
        super().__init__()
        self.n_layers, self.layer_type = n_layers, layer_type
        for i in range(n_layers):
            self.add_module(f"{i}fc", _dense(in_planes if i == 0
                                             else out_planes, out_planes,
                                             False, generator))

    def forward(self, x):
        for i in range(self.n_layers):
            x = getattr(self, f"{i}fc")(x)
            if i < self.n_layers - 1 and self.layer_type > 1:
                x = F.leaky_relu(x, 0.2)
        return x


class Discriminator(nn.Module):
    """Dense-BN-LeakyReLU body + bias-free Dense tail
    (reference: build_simplenet.py:31-52)."""

    def __init__(self, in_planes: int, n_layers: int = 1,
                 hidden: Optional[int] = None, generator=None):
        super().__init__()
        self.n_body = n_layers - 1
        width = in_planes
        for i in range(self.n_body):
            out = int(width // 1.5) if hidden is None else hidden
            self.add_module(f"block{i + 1}_fc", _dense(width, out, True,
                                                       generator))
            self.add_module(f"block{i + 1}_bn", BatchNorm(out))
            width = out
        self.tail = _dense(width, 1, False, generator)

    def forward(self, x, train: bool = False):
        for i in range(1, self.n_body + 1):
            x = getattr(self, f"block{i}_fc")(x)
            x = F.leaky_relu(getattr(self, f"block{i}_bn")(x, train), 0.2)
        return self.tail(x)


def gaussian_noise(shape, generator=None, device=None):
    """Unit Gaussian draws for the synthetic negatives."""
    return torch.randn(shape, generator=generator, device=device)


class SimpleNetOutput(NamedTuple):
    z_n_scores: torch.Tensor            # [B, V, T, H, W, 1]
    z_p_scores: Optional[torch.Tensor]  # same, only in training


class SimpleNet(nn.Module):
    """forward(z [B, V, C, T, H, W]) -> scores (reference:
    build_simplenet.py:225-265)."""

    def __init__(self, config: OneClassConfig, in_planes: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = self.config = config
        g = generator or torch.Generator().manual_seed(cfg.seed)
        self.pre_projection = Projection(in_planes, cfg.dim, cfg.pre_proj,
                                         cfg.proj_layer_type, g)
        self.discriminator = Discriminator(cfg.dim, cfg.dsc_layers,
                                           cfg.dsc_hidden, g)

    def forward(self, z, train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> SimpleNetOutput:
        """``generator`` draws the training noise."""
        z = z.float() * 0.01  # (reference: :235)
        B, V, C, T, H, W = z.shape
        z = self.pre_projection(z.permute(0, 1, 3, 4, 5, 2).reshape(-1, C))
        z_p_scores = None
        if train:
            noise = self.config.noise_std * gaussian_noise(
                z.shape, generator, z.device)
            z_p_scores = self.discriminator(z + noise, train) \
                .reshape(B, V, T, H, W, 1)
        z_n_scores = self.discriminator(z, train).reshape(B, V, T, H, W, 1)
        return SimpleNetOutput(z_n_scores, z_p_scores)


def simple_loss(z_n_scores, z_p_scores, th_n: float, th_p: float,
                train: bool = True):
    """Hinge loss (reference: Baselines_OneClass/models/losses.py:16-35).
    Train: mean(clip(th_n - s_n, 0)) + mean(clip(s_p + th_p, 0)); eval:
    the joint sum over both terms' elements."""
    true_loss = torch.clamp(th_n - z_n_scores, min=0.0)
    fake_loss = torch.clamp(z_p_scores + th_p, min=0.0)
    if train:
        return true_loss.mean() + fake_loss.mean()
    return (true_loss.sum() + fake_loss.sum()) / (true_loss.numel()
                                                  + fake_loss.numel())
