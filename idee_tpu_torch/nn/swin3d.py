# ------------------------------------------------------------------
"""Window helpers shared by the windowed encoders (counterpart of the
helpers in idee_tpu/nn/swin3d.py; reference models/encoder/Swin_3D.py).

Only what the Mamba encoder reuses is here: the window-size shrink, window
partition/reverse and the packed patch embedding. The Swin_3D encoder and
its attention kernels come with a later slice of the port.
"""
# ------------------------------------------------------------------

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from idee_tpu_torch.nn.layers import (GroupedConv3d, GroupedLayerNorm3d,
                                      Init, reference_init)


def get_window_size(x_size, window_size, shift_size=None):
    """Shrink window dims to the input size; zero the shift there
    (reference: Swin_3D.py:77-90)."""
    use_ws = list(window_size)
    use_ss = list(shift_size) if shift_size is not None else None
    for i in range(len(x_size)):
        if x_size[i] <= window_size[i]:
            use_ws[i] = x_size[i]
            if use_ss is not None:
                use_ss[i] = 0
    if shift_size is None:
        return tuple(use_ws)
    return tuple(use_ws), tuple(use_ss)


def window_partition(x, ws):
    """[B, D, H, W, C] -> [B*nW, wd*wh*ww, C] (reference: Swin_3D.py:45-57)."""
    B, D, H, W, C = x.shape
    x = x.reshape(B, D // ws[0], ws[0], H // ws[1], ws[1], W // ws[2], ws[2],
                  C)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(-1, math.prod(ws), C)


def window_reverse(windows, ws, B, D, H, W):
    """Inverse of window_partition (reference: Swin_3D.py:60-74)."""
    x = windows.reshape(B, D // ws[0], H // ws[1], W // ws[2],
                        ws[0], ws[1], ws[2], -1)
    x = x.permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(B, D, H, W, -1)


class PackedPatchEmbed3D(nn.Module):
    """Per-variable Conv3d patchify with pad-to-multiple
    (reference: Swin_3D.py:449-491) on [N, D, H, W, V*Cin]."""

    def __init__(self, n_groups: int, in_features: int,
                 patch_size: Tuple[int, int, int] = (2, 4, 4),
                 embed_dim: int = 64, patch_norm: bool = False,
                 kernel_init: Optional[Init] = reference_init(),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.patch_size = tuple(patch_size)
        self.proj = GroupedConv3d(n_groups, in_features, embed_dim,
                                  kernel_size=self.patch_size,
                                  strides=self.patch_size,
                                  padding=((0, 0), (0, 0), (0, 0)),
                                  use_bias=True, kernel_init=kernel_init,
                                  generator=generator)
        self.norm = (GroupedLayerNorm3d(n_groups, embed_dim, affine=False)
                     if patch_norm else None)

    def forward(self, x):
        _, D, H, W, _ = x.shape
        p = self.patch_size
        hi = [(p[i] - s % p[i]) % p[i] for i, s in enumerate((D, H, W))]
        if any(hi):
            x = F.pad(x, (0, 0, 0, hi[2], 0, hi[1], 0, hi[0]))
        x = self.proj(x)
        return self.norm(x) if self.norm is not None else x
