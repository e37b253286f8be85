# ------------------------------------------------------------------
"""RTFM multi-scale temporal network: Aggregate and the non-local block
(counterpart of idee_tpu/baselines/mil/rtfm_net.py; reference
Baselines_MIL/models/build_rtfm.py:24-195).

Aggregate runs three dilated 3x3 convolutions (dilation 1/2/4) and a 1x1
branch over each [H, W, C] slice, fuses them with a 3x3 convolution and
adds the residual. NonLocalBlock1D is kept for inventory parity; as in the
reference it is not wired into Aggregate. Channels-last; every BatchNorm
has flax's semantics (``nn/layers.py::BatchNorm``): momentum 0.9 (torch
0.1), eps 1e-5, the biased variance in the running statistics, scale
initialised 0.02 (the MIL init sweep) and, in NonLocalBlock1D's W_bn, 0.
The convolutions compute in ``dtype``; the BatchNorms, which flax builds
without one, promote to float32 (their statistics are float32), so at
bf16 Aggregate returns float32.
"""
# ------------------------------------------------------------------

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from idee_tpu_torch.baselines.mil.classifiers import normal_init
from idee_tpu_torch.nn.layers import BatchNorm, Conv, Init


class Aggregate(nn.Module):
    """[B, V, C, T, H, W] -> same shape (reference: build_rtfm.py:120-194)."""

    def __init__(self, len_feature: int = 16, dim: int = 32,
                 kernel_init: Init = normal_init(),
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        C = len_feature

        def conv(cin, feat, k, dil, use_bias=True):
            pad = dil * (k - 1) // 2
            return Conv(cin, feat, (k, k), padding=((pad, pad), (pad, pad)),
                        kernel_dilation=(dil, dil), use_bias=use_bias,
                        kernel_init=kernel_init, generator=generator,
                        dtype=dtype)

        self.conv_1 = conv(C, dim, 3, 1)
        self.conv_2 = conv(C, dim, 3, 2)
        self.conv_3 = conv(C, dim, 3, 4)
        self.conv_4 = conv(C, dim, 1, 1, use_bias=False)
        self.conv_5 = conv(4 * dim, len_feature, 3, 1, use_bias=False)
        for name in ("bn1", "bn2", "bn3"):
            self.add_module(name, BatchNorm(dim, scale_init=0.02))
        self.bn5 = BatchNorm(len_feature, scale_init=0.02)

    def forward(self, x, train: bool = False):
        B, V, C, T, H, W = x.shape
        out = x.permute(0, 1, 3, 4, 5, 2).reshape(B * V * T, H, W, C)
        out1 = self.bn1(F.relu(self.conv_1(out)), train)
        out2 = self.bn2(F.relu(self.conv_2(out)), train)
        out3 = self.bn3(F.relu(self.conv_3(out)), train)
        out4 = F.relu(self.conv_4(out))
        # the concatenation promotes the unnormalised branch to float32
        fused = torch.cat([out1, out2, out3, out4.to(out1.dtype)], dim=-1)
        fused = self.bn5(F.relu(self.conv_5(fused)), train) + out
        return fused.reshape(B, V, T, H, W, C).permute(0, 1, 5, 2, 3, 4)


class NonLocalBlock1D(nn.Module):
    """1D non-local self-attention block (reference: build_rtfm.py:24-117,
    dimension=1). x: [B, L, C] channels-last."""

    def __init__(self, in_channels: int, inter_channels: Optional[int] = None,
                 sub_sample: bool = True, bn_layer: bool = True,
                 kernel_init: Init = normal_init(),
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        inter = inter_channels or max(in_channels // 2, 1)
        self.sub_sample = sub_sample
        for name in ("g", "theta", "phi"):
            self.add_module(name, Conv(in_channels, inter, (1,),
                                       kernel_init=kernel_init,
                                       generator=generator, dtype=dtype))
        # W starts at zero so the block starts as the identity
        # (reference: build_rtfm.py:63-69)
        self.W = Conv(inter, in_channels, (1,),
                      kernel_init=lambda t, g=None: nn.init.zeros_(t),
                      dtype=dtype)
        self.W_bn = (BatchNorm(in_channels, scale_init=0.0) if bn_layer
                     else None)

    def forward(self, x, train: bool = False):
        g, theta, phi = self.g(x), self.theta(x), self.phi(x)
        if self.sub_sample:
            g = F.max_pool1d(g.transpose(1, 2), 2).transpose(1, 2)
            phi = F.max_pool1d(phi.transpose(1, 2), 2).transpose(1, 2)
        f = torch.einsum("bic,bjc->bij", theta, phi)
        f = f / f.shape[-1]
        w = self.W(torch.einsum("bij,bjc->bic", f, g))
        if self.W_bn is not None:
            w = self.W_bn(w, train)
        return w + x
