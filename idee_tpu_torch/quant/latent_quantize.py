# ------------------------------------------------------------------
"""Latent Quantization (https://arxiv.org/abs/2305.18378; counterpart of
idee_tpu/quant/latent_quantize.py, reference
models/codebook/LatentQuantize.py).

Each latent dim has ``levels[d]`` learnable scalar values (init
linspace(-0.5, 0.5, L) for odd L, arange(L)/L - 0.5 for even L); a dim
snaps to its nearest value with a straight-through estimator. Training
loss = commitment_weight * mse(stop_grad(x), out) + quantization_weight *
mse(x, stop_grad(out)), both against the original (pre-projection) input.

As in the JAX package, the index is the argmin level index (identical to
the reference's scale-shift-truncate at init, and the intended mixed-radix
semantics once the values move), not the reference's truncation.
"""
# ------------------------------------------------------------------

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from idee_tpu_torch.nn.layers import reference_init
from idee_tpu_torch.parallel.mesh import batch_mean
from idee_tpu_torch.quant.fsq import mixed_radix_basis
from idee_tpu_torch.quant.lfq import LFQReturn, zero_loss, projection


def init_values(levels: Sequence[int]) -> List[np.ndarray]:
    """Per-dim level values, zero-centred, starting at -0.5 (reference:
    LatentQuantize.py:115-116)."""
    out = []
    for level in levels:
        if level % 2 == 1:
            out.append(np.linspace(-0.5, 0.5, level, dtype=np.float32))
        else:
            out.append((np.arange(level) / level - 0.5).astype(np.float32))
    return out


class LatentQuantize(nn.Module):
    """Per-dim learnable-level quantizer: x [B, N, dim] -> (quantized,
    indices, loss). Parameters: ``values_per_latent`` [D, L] when every dim
    has the same number of levels, else ``values_{i}`` [L_i]."""

    def __init__(self, levels: Sequence[int] = (2,),
                 dim: Optional[int] = None,
                 commitment_loss_weight: float = 1.0,
                 quantization_loss_weight: float = 1.0,
                 num_codebooks: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.levels = tuple(int(v) for v in levels)
        self.commitment_loss_weight = commitment_loss_weight
        self.quantization_loss_weight = quantization_loss_weight
        self.num_codebooks = num_codebooks
        self.codebook_dim = len(self.levels)
        self.effective_codebook_dim = self.codebook_dim * num_codebooks
        self.codebook_size = int(np.prod(self.levels))
        self.out_dim = dim if dim is not None else self.effective_codebook_dim
        self.register_buffer("_levels", torch.tensor(self.levels),
                             persistent=False)
        self.register_buffer("_basis", mixed_radix_basis(self.levels),
                             persistent=False)
        init = [torch.from_numpy(v) for v in init_values(self.levels)]
        self.equal_levels = len(set(self.levels)) == 1
        named = ([("values_per_latent", torch.stack(init))]
                 if self.equal_levels else
                 [(f"values_{i}", v) for i, v in enumerate(init)])
        for name, value in named:
            self.register_parameter(name, nn.Parameter(value))
        self._value_names = [name for name, _ in named]
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

    def _values(self) -> List[torch.Tensor]:
        return [getattr(self, n) for n in self._value_names]

    def quantize(self, z):
        """Snap each dim to its nearest value with STE; also the level index
        per dim (reference: LatentQuantize.py:141-160)."""
        if self.equal_levels:
            vals = self.values_per_latent                        # [D, L]
            index = (z[..., None] - vals).abs().argmin(-1)       # [..., D]
            quant = torch.gather(vals.expand(*index.shape, vals.shape[-1]),
                                 -1, index[..., None])[..., 0]
        else:
            idxs, quants = [], []
            for i, vals in enumerate(self._values()):
                ind = (z[..., i, None] - vals).abs().argmin(-1)
                idxs.append(ind)
                quants.append(vals[ind])
            index, quant = torch.stack(idxs, -1), torch.stack(quants, -1)
        return z + (quant - z).detach(), index

    def digits_to_indices(self, digits):
        """Mixed-radix digit vector -> flat code index."""
        return (digits.long() * self._basis).sum(-1).to(torch.int32)

    def indices_to_codes(self, indices, project_out: bool = True):
        """Flat index -> code vector of learned values (reference:
        LatentQuantize.py:179-200)."""
        idx = torch.as_tensor(indices, device=self._levels.device).long()
        digits = (idx[..., None] // self._basis) % self._levels
        if self.equal_levels:
            vals = self.values_per_latent
            codes = torch.gather(vals.expand(*digits.shape, vals.shape[-1]),
                                 -1, digits[..., None])[..., 0]
        else:
            codes = torch.stack([v[digits[..., i]]
                                 for i, v in enumerate(self._values())], -1)
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
        original = x
        if self.has_projections:
            x = self.project_in(x)
        B, N = x.shape[0], x.shape[1]
        codes, digits = self.quantize(x.reshape(B, N, self.num_codebooks,
                                                self.codebook_dim))
        indices = self.digits_to_indices(digits)  # [B, N, c]
        out = codes.reshape(B, N, self.effective_codebook_dim)
        if self.has_projections:
            out = self.project_out(out)
        if self.num_codebooks == 1:
            indices = indices[..., 0]
        if train:
            # both against the original input (LatentQuantize.py:286-293)
            commit = batch_mean((original.detach() - out) ** 2)
            quant = batch_mean((original - out.detach()) ** 2)
            loss = (self.commitment_loss_weight * commit
                    + self.quantization_loss_weight * quant)
        else:
            loss = zero_loss(x.device)
        return LFQReturn(out, indices, loss)
