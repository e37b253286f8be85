# ------------------------------------------------------------------
"""Lookup-Free Quantization, 1-bit packed path (counterpart of
idee_tpu/quant/lfq.py; reference models/codebook/LFQ.py).

With the default codebook_size=2 the 16-dim feature of each (variable,
time, pixel) is projected to one scalar s, and sign(s) is the code: the
index in {0, 1} is the anomaly bit. The quantizer runs in float32.

Only the 1-bit path the composite model uses is ported: ``quantize_packed``
with the eval branch and the training branch (straight-through sign,
entropy and commitment losses, all under autograd).
``freeze_project_out`` detaches the output projection exactly where the JAX
package stops its gradient: in ``out_proj_params``.
"""
# ------------------------------------------------------------------

import math
from typing import NamedTuple, Optional

import torch
import torch.nn as nn

from idee_tpu_torch.nn.layers import Init, flax_default_init


class LFQScalarParts(NamedTuple):
    """Result of the 1-bit path: s_q is exactly +/-codebook_scale (with the
    straight-through gradient in training); z_q = s_q * w_out + b_out."""

    s_q: torch.Tensor      # [..., V] float32
    indices: torch.Tensor  # [..., V] int32 in {0, 1}
    aux_loss: torch.Tensor  # scalar


def _log(t, eps=1e-5):
    # clamp-then-log (reference: models/codebook/LFQ.py:52-53)
    return torch.log(torch.clamp(t, min=eps))


class LFQ(nn.Module):
    """Lookup-free quantizer with project_in / project_out (torch Linear
    layout: weight [out, in])."""

    def __init__(self, dim: int = 16, codebook_size: int = 2,
                 entropy_loss_weight: float = 0.1,
                 commitment_loss_weight: float = 1.5,
                 diversity_gamma: float = 1.0, num_codebooks: int = 1,
                 codebook_scale: float = 1.0, inv_temperature: float = 100.0,
                 kernel_init: Optional[Init] = None,
                 freeze_project_out: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dim = dim
        self.codebook_size = codebook_size
        self.entropy_loss_weight = entropy_loss_weight
        self.commitment_loss_weight = commitment_loss_weight
        self.diversity_gamma = diversity_gamma
        self.num_codebooks = num_codebooks
        self.codebook_scale = codebook_scale
        self.inv_temperature = inv_temperature
        self.freeze_project_out = freeze_project_out
        cd = int(math.log2(codebook_size))
        if 2 ** cd != codebook_size:
            raise ValueError("codebook_size must be a power of 2")
        self.codebook_dims = cd * num_codebooks
        if self.has_projections:
            self.project_in = nn.Linear(dim, self.codebook_dims)
            self.project_out = nn.Linear(self.codebook_dims, dim)
            for lin, fan_in in ((self.project_in, dim),
                                (self.project_out, self.codebook_dims)):
                (kernel_init or flax_default_init(fan_in))(lin.weight,
                                                           generator)
                nn.init.zeros_(lin.bias)

    @property
    def has_projections(self) -> bool:
        return self.dim != self.codebook_dims

    def _check_scalar(self):
        if not (self.codebook_dims == 1 and self.has_projections):
            raise NotImplementedError("only the 1-bit LFQ path (codebook_size"
                                      "=2, one codebook) is ported")

    def in_proj_params(self):
        """(kernel [dim], bias scalar) of project_in."""
        self._check_scalar()
        return self.project_in.weight[0], self.project_in.bias[0]

    def out_proj_params(self):
        """(w [dim], b [dim]) such that project_out(s) = s * w + b; note
        project_out(-scale) = b - w*scale is vq_0, the 'normal' code."""
        self._check_scalar()
        w, b = self.project_out.weight[:, 0], self.project_out.bias
        if self.freeze_project_out:
            w, b = w.detach(), b.detach()
        return w, b

    def quantize_packed(self, zp, n_vars: int,
                        train: bool = False) -> LFQScalarParts:
        """zp: packed [..., V*dim] -> s_q / indices shaped [..., V]."""
        self._check_scalar()
        V, d = int(n_vars), self.dim
        if zp.shape[-1] != V * d:
            raise ValueError(f"expected last dim {V * d}, got {zp.shape[-1]}")
        k_in, b_in = self.in_proj_params()
        s = zp.float().reshape(*zp.shape[:-1], V, d) @ k_in + b_in
        return self._scalar_core(s, train)

    def _scalar_core(self, s, train: bool) -> LFQScalarParts:
        """Sign quantize + STE, entropy and commitment losses."""
        scale = self.codebook_scale
        q = torch.where(s > 0, scale, -scale)
        s_q = s + (q - s).detach() if train else q
        indices = (s_q > 0).to(torch.int32)
        if train:
            # softmax over the 2-code implicit codebook == sigmoid of the
            # logit difference
            p1 = torch.sigmoid(4.0 * scale * self.inv_temperature * s)
            p0 = 1.0 - p1
            per_sample_entropy = torch.mean(-p0 * _log(p0) - p1 * _log(p1))
            q0, q1 = p0.mean(), p1.mean()
            codebook_entropy = -q0 * _log(q0) - q1 * _log(q1)
            entropy_aux = (self.entropy_loss_weight * per_sample_entropy
                           - self.diversity_gamma * codebook_entropy)
            commit = torch.mean((s - q.detach()) ** 2)
            aux = commit * self.commitment_loss_weight + entropy_aux
        else:
            aux = torch.zeros((), dtype=torch.float32, device=s.device)
        return LFQScalarParts(s_q, indices, aux)
