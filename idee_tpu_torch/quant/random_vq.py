# ------------------------------------------------------------------
"""Random-projection quantizer (BEST-RQ, https://arxiv.org/abs/2202.01855;
counterpart of idee_tpu/quant/random_vq.py, reference
models/codebook/Random_VQ.py): frozen Xavier random projections followed by
a frozen VQ codebook. Both are buffers (the JAX package's "codebook"
collection), so the optimizer never sees them; the output carries no
gradient and the aux loss is 0. The JAX module's ``norm`` option creates
its LayerNorm outside ``setup`` and raises in flax, so it is left out.
"""
# ------------------------------------------------------------------

from typing import Optional, Tuple

import torch
import torch.nn as nn

from idee_tpu_torch.quant.lfq import LFQReturn, zero_loss
from idee_tpu_torch.quant.vq import VQ


class Random_VQ(nn.Module):
    """x [B, N, dim] -> (z_q [B, N, num_codebooks * codebook_dim], indices,
    0)."""

    def __init__(self, dim: int = 16, codebook_size: int = 2,
                 codebook_dim: int = 16, num_codebooks: int = 1,
                 sync_axis: Optional[str] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dim = dim
        # torch xavier_normal_ on [H, in, out]: std = sqrt(2 / (in + out))
        std = (2.0 / (dim + codebook_dim)) ** 0.5
        projs = torch.empty(num_codebooks, dim, codebook_dim)
        projs.normal_(0.0, std, generator=generator)
        self.register_buffer("rand_projs", projs)
        self.vq = VQ(dim=codebook_dim * num_codebooks, heads=num_codebooks,
                     codebook_dim=codebook_dim, codebook_size=codebook_size,
                     use_cosine_sim=False, learnable_codebook=False,
                     separate_codebook_per_head=False, freeze_codebook=True,
                     sync_axis=sync_axis, generator=generator)

    def indices_to_codes(self, indices, project_out: bool = True):
        return self.vq.indices_to_codes(indices, project_out=project_out)

    def forward(self, x, train: bool = False,
                generator: Optional[torch.Generator] = None,
                grid: Optional[Tuple[int, int]] = None) -> LFQReturn:
        """``grid``: the tokens' layout around H, as VQ takes it."""
        x = x.float()
        # [B, N, D] x [H, D, E] -> [B, N, H*E] (reference: Random_VQ.py:67)
        z = torch.einsum("bnd,hde->bnhe", x, self.rand_projs)
        z = z.reshape(x.shape[0], x.shape[1], -1)
        out, indices, _ = self.vq(z, train=train, generator=generator,
                                  grid=grid)
        return LFQReturn(out.detach(), indices, zero_loss(x.device))
