# ------------------------------------------------------------------
"""Finite Scalar Quantization (FSQ, https://arxiv.org/abs/2309.15505;
counterpart of idee_tpu/quant/fsq.py, reference models/codebook/FSQ.py).

Each latent dim is bounded with tanh onto ``levels[d]`` bins and rounded
with a straight-through estimator; the mixed-radix digit vector is the code
index. No auxiliary loss (the reference returns (out, indices) only); the
common return carries aux_loss = 0. The quantizer runs in float32.
"""
# ------------------------------------------------------------------

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from idee_tpu_torch.nn.layers import reference_init
from idee_tpu_torch.quant.lfq import LFQReturn, zero_loss, projection


def round_ste(z):
    """Round (half to even, as jnp.round) with straight-through gradients
    (reference: FSQ.py:44-47)."""
    return z + (torch.round(z) - z).detach()


def mixed_radix_basis(levels: Sequence[int]) -> torch.Tensor:
    """cumprod([1] + levels[:-1]) as int64 (reference: FSQ.py:66)."""
    return torch.from_numpy(np.concatenate(
        [[1], np.cumprod(levels)[:-1]]).astype(np.int64))


class FSQ(nn.Module):
    """Finite scalar quantizer: x [B, N, dim] -> (quantized, indices, 0).
    project_in / project_out (torch layout) when dim differs from
    len(levels) * num_codebooks, initialised N(0.02, 0.02) as in the JAX
    package."""

    def __init__(self, levels: Sequence[int] = (2,),
                 dim: Optional[int] = None, num_codebooks: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.levels = tuple(int(v) for v in levels)
        self.num_codebooks = num_codebooks
        self.codebook_dim = len(self.levels)
        self.effective_codebook_dim = self.codebook_dim * num_codebooks
        self.codebook_size = int(np.prod(self.levels))
        self.out_dim = dim if dim is not None else self.effective_codebook_dim
        lv = torch.tensor(self.levels, dtype=torch.int64)
        self.register_buffer("_levels", lv, persistent=False)
        self.register_buffer("_basis", mixed_radix_basis(self.levels),
                             persistent=False)
        if self.has_projections:
            self.project_in = projection(self.out_dim,
                                         self.effective_codebook_dim,
                                         reference_init(), generator)
            self.project_out = projection(self.effective_codebook_dim,
                                          self.out_dim, reference_init(),
                                          generator)

    @property
    def has_projections(self) -> bool:
        return self.out_dim != self.effective_codebook_dim

    def _half_width(self):
        return (self._levels // 2).float()

    def bound(self, z, eps: float = 1e-3):
        """Bound z into the representable range per dim (reference:
        FSQ.py:96-101)."""
        half_l = (self._levels.float() - 1.0) * (1.0 + eps) / 2.0
        offset = torch.where(self._levels % 2 == 0, 0.5, 0.0)
        shift = torch.atanh(offset / half_l)
        return torch.tanh(z + shift) * half_l - offset

    def quantize(self, z):
        """z -> zhat in [-1, 1] per dim (reference: FSQ.py:103-107)."""
        return round_ste(self.bound(z)) / self._half_width()

    def codes_to_indices(self, zhat):
        """zhat [..., codebook_dim] in [-1, 1] -> flat index (reference:
        FSQ.py:117-121)."""
        hw = self._half_width()
        digits = zhat * hw + hw
        return (digits * self._basis.float()).sum(-1).to(torch.int32)

    def indices_to_codes(self, indices, project_out: bool = True):
        """Inverse of codes_to_indices (reference: FSQ.py:123-145)."""
        idx = torch.as_tensor(indices, device=self._levels.device).long()
        digits = (idx[..., None] // self._basis) % self._levels
        hw = self._half_width()
        codes = (digits.float() - hw) / hw
        if self.num_codebooks > 1:
            codes = codes.reshape(*codes.shape[:-2], -1)
        if project_out and self.has_projections:
            codes = self.project_out(codes)
        return codes

    def forward(self, x, train: bool = False,
                generator: Optional[torch.Generator] = None,
                grid: Optional[Tuple[int, int]] = None) -> LFQReturn:
        x = x.float()
        if x.shape[-1] != self.out_dim:
            raise ValueError(f"expected dim {self.out_dim}, got "
                             f"{x.shape[-1]}")
        if self.has_projections:
            x = self.project_in(x)
        B, N = x.shape[0], x.shape[1]
        codes = self.quantize(x.reshape(B, N, self.num_codebooks,
                                        self.codebook_dim))
        indices = self.codes_to_indices(codes)  # [B, N, c]
        out = codes.reshape(B, N, self.effective_codebook_dim)
        if self.has_projections:
            out = self.project_out(out)
        if self.num_codebooks == 1:
            indices = indices[..., 0]
        return LFQReturn(out, indices, zero_loss(x.device))
