# ------------------------------------------------------------------
"""MIL MLP classifiers: DeepMIL, ARNet, RTFM (counterpart of
idee_tpu/baselines/mil/classifiers.py; reference
Baselines_MIL/models/classifier/{DeepMIL,ARNet,RTFM}.py).

Dense stacks over the channel dim of [..., C] pixel-instance features,
ReLU between layers, Sigmoid on the head, dropout after every non-final
layer. DeepMIL returns scores; ARNet (first-layer features, scores); RTFM
(input features, scores). Every Dense starts N(0, 0.02) (the MIL init
sweep, build_deepmil.py:90-111), passed in by ``models.build_mil_model``.
Every Dense computes in ``dtype`` (the model's compute dtype; parameters
float32), so the scores come out in it.
"""
# ------------------------------------------------------------------

from typing import List, Optional

import torch
import torch.nn as nn

from idee_tpu_torch.nn.layers import Dense, Init, dropout, reference_init


def normal_init(std: float = 0.02) -> Init:
    """N(0, std) (the MIL init sweep, build_deepmil.py:101-109)."""
    return reference_init(0.0, std)


class _MLPStack(nn.Module):
    def __init__(self, in_features: int, dim: List[int],
                 drop_rate: float = 0.6, kernel_init: Init = normal_init(),
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.n, self.drop_rate = len(dim), drop_rate
        for i, d in enumerate(dim):
            self.add_module(f"Dense_{i}", Dense(
                in_features, d, kernel_init=kernel_init,
                generator=generator, dtype=dtype))
            in_features = d

    def forward(self, x, train: bool = False, return_first: bool = False,
                generator: Optional[torch.Generator] = None):
        first = None
        for i in range(self.n):
            x = getattr(self, f"Dense_{i}")(x)
            x = torch.sigmoid(x) if i == self.n - 1 else torch.relu(x)
            if i == 0:
                first = x
            if i != self.n - 1:
                x = dropout(x, self.drop_rate, train, generator)
        return (first, x) if return_first else x


class DeepMIL(nn.Module):
    """reference: classifier/DeepMIL.py:18-51. [..., C] -> scores [..., 1]."""

    def __init__(self, embed_dim: int = 16, dim: Optional[List[int]] = None,
                 drop_rate: float = 0.6, kernel_init: Init = normal_init(),
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.mlp = _MLPStack(embed_dim, list(dim or [512, 32, 1]),
                             drop_rate, kernel_init, generator, dtype)

    def forward(self, x, train: bool = False, generator=None):
        return self.mlp(x, train, generator=generator)


class ARNet(DeepMIL):
    """reference: classifier/ARNet.py:102-141 -> (features, scores)."""

    def forward(self, x, train: bool = False, generator=None):
        return self.mlp(x, train, return_first=True, generator=generator)


class RTFM(DeepMIL):
    """reference: classifier/RTFM.py:18-55 -> (input features, scores)."""

    def __init__(self, embed_dim: int = 16, dim: Optional[List[int]] = None,
                 drop_rate: float = 0.7, kernel_init: Init = normal_init(),
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(embed_dim, dim, drop_rate, kernel_init, generator,
                         dtype)

    def forward(self, x, train: bool = False, generator=None):
        return x, self.mlp(x, train, generator=generator)
