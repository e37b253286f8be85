# ------------------------------------------------------------------
"""3D-CNN classifier heads: a joint extreme-event head over all variables
plus V per-variable heads (counterpart of idee_tpu/nn/classifier.py;
reference models/classifier/CNN_3D.py).

Each head is three Conv3d layers with kernel (2,3,3), stride (2,1,1),
padding (0,1,1) that collapse the temporal axis delta_t=8 -> 1. The V
per-variable heads run as one grouped-convolution program on the packed
[N, T, H, W, V*C] layout; the joint head is a plain conv over all V*C
channels. ``dtype`` is the compute dtype of every conv (nn/layers.py).
Under the ``space`` axis the convs pad H with the neighbours' rows and
the dropout keeps the rank's rows of the global draw (nn/layers.py).
"""
# ------------------------------------------------------------------

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from idee_tpu_torch.nn.layers import (Conv, GroupedConv3d, Init, dropout,
                                      rank_rows, reference_init)

_KSIZE = (2, 3, 3)
_STRIDE = (2, 1, 1)
_PAD = ((0, 0), (1, 1), (1, 1))


class ClassifierHead(nn.Module):
    """One classification head [N, T, H, W, C] -> [N, H, W, n_classes]."""

    def __init__(self, in_features: int, dim: int, n_classes: int = 1,
                 drop_rate: float = 0.0,
                 kernel_init: Optional[Init] = reference_init(),
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.drop_rate = drop_rate
        kw = dict(kernel_init=kernel_init, generator=generator, dtype=dtype)
        self.conv1 = Conv(in_features, dim, _KSIZE, _STRIDE, _PAD, **kw)
        self.conv2 = Conv(dim, dim, _KSIZE, _STRIDE, _PAD, **kw)
        self.conv3 = Conv(dim, n_classes, _KSIZE, _STRIDE, _PAD, **kw)

    def forward(self, x, train: bool = False,
                generator: Optional[torch.Generator] = None):
        x = dropout(F.relu(self.conv1(x)), self.drop_rate, train, generator,
                    rank_rows(2))
        x = F.relu(self.conv2(x))
        return self.conv3(x).squeeze(1)  # T collapsed to 1


class GroupedClassifierHead(nn.Module):
    """V per-variable heads as one grouped-conv program:
    packed [N, T, H, W, V*C] -> [N, H, W, V*n_classes]."""

    def __init__(self, n_groups: int, in_features: int, dim: int,
                 n_classes: int = 1, drop_rate: float = 0.0,
                 kernel_init: Optional[Init] = reference_init(),
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        V = n_groups
        self.drop_rate = drop_rate
        kw = dict(kernel_init=kernel_init, generator=generator, dtype=dtype)
        self.conv1 = GroupedConv3d(V, in_features, dim, _KSIZE, _STRIDE,
                                   _PAD, **kw)
        self.conv2 = GroupedConv3d(V, dim, dim, _KSIZE, _STRIDE, _PAD, **kw)
        self.conv3 = GroupedConv3d(V, dim, n_classes, _KSIZE, _STRIDE, _PAD,
                                   **kw)

    def forward(self, x, train: bool = False,
                generator: Optional[torch.Generator] = None):
        x = dropout(F.relu(self.conv1(x)), self.drop_rate, train, generator,
                    rank_rows(2))
        x = F.relu(self.conv2(x))
        return self.conv3(x).squeeze(1)  # T collapsed to 1


class CNN_3D_Classifier(nn.Module):
    """Joint + multi-head classifier (reference: CNN_3D.py:61-139).

    Input  [N, V, C, T, H, W] quantized codes, or (packed=True) the packed
           layout [N, T, H, W, V*C] directly.
    Output z [N, n_classes, H, W] from the joint head over V*C channels,
           y [N, V, 1, H, W] from the grouped per-variable heads.
    """

    def __init__(self, in_var: int = 6, embed_dim: int = 16, dim: int = 16,
                 n_classes: int = 1, drop_rate: float = 0.0,
                 kernel_init: Optional[Init] = reference_init(),
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        V, C = self.in_var, self.embed_dim = in_var, embed_dim
        self.heads_var = GroupedClassifierHead(
            V, C, dim, n_classes=1, drop_rate=drop_rate,
            kernel_init=kernel_init, generator=generator, dtype=dtype)
        self.head_joint = ClassifierHead(
            V * C, dim * V, n_classes=n_classes, drop_rate=drop_rate,
            kernel_init=kernel_init, generator=generator, dtype=dtype)

    def forward(self, x, train: bool = False, packed: bool = False,
                generator: Optional[torch.Generator] = None):
        V, C = self.in_var, self.embed_dim
        if not packed:
            N, _, _, T, H, W = x.shape
            x = x.permute(0, 3, 4, 5, 1, 2).reshape(N, T, H, W, V * C)
        y = self.heads_var(x, train, generator)        # [N, H, W, V]
        y = y.permute(0, 3, 1, 2)[:, :, None]          # [N, V, 1, H, W]
        z = self.head_joint(x, train, generator)       # [N, H, W, n_cls]
        return z.permute(0, 3, 1, 2), y
