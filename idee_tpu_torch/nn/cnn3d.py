# ------------------------------------------------------------------
"""3D-CNN encoder: residual Conv3d towers, one per input variable, run as
one packed grouped-convolution program on [N, T, H, W, V*C]. ``dtype``
is the compute dtype of every convolution and norm (nn/layers.py).

Counterpart of idee_tpu/nn/cnn3d.py (reference models/encoder/CNN_3D.py);
module and parameter names follow the JAX package's so its weights load
by path.
"""
# ------------------------------------------------------------------

from typing import List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from idee_tpu_torch.nn.layers import (GroupedConv3d, GroupedLayerNorm3d,
                                      Init, checkpointed, drop_path,
                                      reference_init)


def pack_variables(x):
    """[N, V, C, T, H, W] -> packed [N, T, H, W, V*C]."""
    N, V, C, T, H, W = x.shape
    return x.permute(0, 3, 4, 5, 1, 2).reshape(N, T, H, W, V * C)


def unpack_variables(x, n_vars: int):
    """Packed [N, T, H, W, V*C] -> [N, V, C, T, H, W]."""
    N, T, H, W, VC = x.shape
    x = x.reshape(N, T, H, W, n_vars, VC // n_vars)
    return x.permute(0, 4, 5, 1, 2, 3)


class GroupedConvBlock3d(nn.Module):
    """Residual 3D conv block, grouped per variable
    (reference: models/encoder/CNN_3D.py:74-144)."""

    def __init__(self, n_groups: int, in_features: int, features: int,
                 drop_path: float = 0.0,
                 kernel_init: Optional[Init] = reference_init(),
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        V = n_groups
        self.drop_path = drop_path
        if in_features != features:
            # PatchEmbed3D: 1x1x1 projection + non-affine LayerNorm
            self.down_proj = GroupedConv3d(
                V, in_features, features, kernel_size=(1, 1, 1),
                padding=((0, 0), (0, 0), (0, 0)), use_bias=False,
                kernel_init=kernel_init, generator=generator, dtype=dtype)
            self.down_norm = GroupedLayerNorm3d(V, features, affine=False,
                                                dtype=dtype)
        else:
            self.down_proj = None
        self.conv1 = GroupedConv3d(V, features, features, (3, 3, 3),
                                   padding_mode="replicate", use_bias=False,
                                   kernel_init=kernel_init,
                                   generator=generator, dtype=dtype)
        self.norm1 = GroupedLayerNorm3d(V, features, affine=True, dtype=dtype)
        self.conv2 = GroupedConv3d(V, features, features, (3, 3, 3),
                                   padding_mode="replicate", use_bias=False,
                                   kernel_init=kernel_init,
                                   generator=generator, dtype=dtype)
        self.norm2 = GroupedLayerNorm3d(V, features, affine=True, dtype=dtype)

    def forward(self, x, train: bool = False,
                generator: Optional[torch.Generator] = None):
        if self.down_proj is not None:
            x = self.down_norm(self.down_proj(x))
        y = F.relu(self.norm1(self.conv1(x)))
        x = x + drop_path(y, self.drop_path, train, generator)
        y = F.relu(self.norm2(self.conv2(x)))
        return x + drop_path(y, self.drop_path, train, generator)


class GroupedProjHead(nn.Module):
    """Final 2-conv projection head shared by all backbone towers
    (reference: models/encoder/CNN_3D.py:185-192), grouped per variable."""

    def __init__(self, n_groups: int, features: int,
                 kernel_init: Optional[Init] = reference_init(),
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        V, E = n_groups, features
        self.proj1 = GroupedConv3d(V, E, E, (3, 3, 3),
                                   padding_mode="replicate", use_bias=True,
                                   kernel_init=kernel_init,
                                   generator=generator, dtype=dtype)
        self.proj2 = GroupedConv3d(V, E, E, (3, 3, 3),
                                   padding_mode="replicate", use_bias=True,
                                   kernel_init=kernel_init,
                                   generator=generator, dtype=dtype)

    def forward(self, x):
        return self.proj2(F.relu(self.proj1(x)))


class CNN_3D(nn.Module):
    """Multi-variable 3D-CNN encoder: [N, V, C, T, H, W] -> [N, V, E, T, H,
    W] (``packed_out=True``: packed [N, T, H, W, V*E])."""

    supports_packed_out = True

    def __init__(self, in_vars: int = 6, in_channels: int = 1,
                 out_channels: Optional[List[int]] = None,
                 drop_path_rate: float = 0.0, use_checkpoint: bool = False,
                 kernel_init: Optional[Init] = reference_init(),
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.in_vars = in_vars
        self.use_checkpoint = use_checkpoint
        out_channels = list(out_channels or [16, 16])
        chans = [in_channels] + out_channels[:-1]
        self.n_blocks = len(out_channels)
        for i, out in enumerate(out_channels):
            self.add_module(f"block{i}", GroupedConvBlock3d(
                in_vars, chans[i], out, drop_path=drop_path_rate,
                kernel_init=kernel_init, generator=generator, dtype=dtype))
        self.proj_head = GroupedProjHead(in_vars, out_channels[-1],
                                         kernel_init=kernel_init,
                                         generator=generator, dtype=dtype)

    def forward(self, x, train: bool = False, packed_out: bool = False,
                generator: Optional[torch.Generator] = None):
        x = pack_variables(x)
        for i in range(self.n_blocks):
            blk = getattr(self, f"block{i}")
            if self.use_checkpoint:
                x = checkpointed(blk, x, train, generator)
            else:
                x = blk(x, train, generator)
        x = self.proj_head(x)
        return x if packed_out else unpack_variables(x, self.in_vars)
