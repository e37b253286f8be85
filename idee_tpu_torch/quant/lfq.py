# ------------------------------------------------------------------
"""Lookup-Free Quantization (counterpart of idee_tpu/quant/lfq.py;
reference models/codebook/LFQ.py).

Each latent dim is sign-binarized to +/-codebook_scale with a
straight-through estimator; the bit-packed sign pattern (MSB first) is the
code index. With the default codebook_size=2 the 16-dim feature of each
(variable, time, pixel) is projected to one scalar s, and sign(s) is the
code: the index in {0, 1} is the anomaly bit. The quantizer runs in
float32. Under data and spatial parallelism (parallel/mesh.py) the
codebook entropy is the global batch's, and every batch mean the global
sum over the global count.

Two paths: ``forward`` over tokens [B, N, dim] for any power-of-two
codebook_size (the generic VQModel path), and ``quantize_packed``, the
1-bit path the composite model runs on packed activations. Both carry the
training aux loss: entropy_weight * per-sample entropy - diversity_gamma *
codebook entropy + commitment_weight * mse(x, quantized), with
probabilities softmax(2 x . codebook * inv_temperature) over the implicit
codebook. ``freeze_project_out`` detaches the 1-bit output projection
exactly where the JAX package stops its gradient: in ``out_proj_params``.
"""
# ------------------------------------------------------------------

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn as nn

from idee_tpu_torch.nn.layers import Init, flax_default_init
from idee_tpu_torch.parallel.mesh import batch_mean, grad_batch_mean


class LFQReturn(NamedTuple):
    """What every quantizer returns (idee_tpu/quant/lfq.py::LFQReturn)."""

    quantized: torch.Tensor  # [B, N, dim] float32
    indices: torch.Tensor    # [B, N] int32
    aux_loss: torch.Tensor   # scalar


class LFQScalarParts(NamedTuple):
    """Result of the 1-bit path: s_q is exactly +/-codebook_scale (with the
    straight-through gradient in training); z_q = s_q * w_out + b_out."""

    s_q: torch.Tensor      # [..., V] float32
    indices: torch.Tensor  # [..., V] int32 in {0, 1}
    aux_loss: torch.Tensor  # scalar


def _log(t, eps=1e-5):
    # clamp-then-log (reference: models/codebook/LFQ.py:52-53)
    return torch.log(torch.clamp(t, min=eps))


def _entropy(prob):
    return (-prob * _log(prob)).sum(-1)


def projection(in_features: int, out_features: int,
               kernel_init: Optional[Init],
               generator: Optional[torch.Generator]) -> nn.Linear:
    """A quantizer's project_in / project_out: torch layout (weight [out,
    in]), weight from ``kernel_init`` (flax's default when None), bias 0."""
    lin = nn.Linear(in_features, out_features)
    (kernel_init or flax_default_init(in_features))(lin.weight, generator)
    nn.init.zeros_(lin.bias)
    return lin


def zero_loss(device) -> torch.Tensor:
    """The aux loss of an eval forward (or of a codebook without one)."""
    return torch.zeros((), dtype=torch.float32, device=device)


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
        cd = self.codebook_dim = int(math.log2(codebook_size))
        if 2 ** cd != codebook_size:
            raise ValueError("codebook_size must be a power of 2")
        self.codebook_dims = cd * num_codebooks
        if self.has_projections:
            self.project_in = projection(dim, self.codebook_dims,
                                         kernel_init, generator)
            self.project_out = projection(self.codebook_dims, dim,
                                          kernel_init, generator)
        # bit weights, MSB first (reference: LFQ.py:134)
        self.register_buffer("mask", 2 ** torch.arange(cd - 1, -1, -1),
                             persistent=False)

    @property
    def has_projections(self) -> bool:
        return self.dim != self.codebook_dims

    def _check_scalar(self):
        if not (self.codebook_dims == 1 and self.has_projections):
            raise ValueError("the 1-bit path needs codebook_size=2, one "
                             "codebook and the projections")

    def bits_to_codes(self, bits):
        return bits * self.codebook_scale * 2 - self.codebook_scale

    def _bits(self, indices):
        return ((indices[..., None] & self.mask) != 0).float()

    def _codebook(self) -> torch.Tensor:
        """Implicit codebook [codebook_size, codebook_dim] of +/-scale codes
        (reference: LFQ.py:139-146)."""
        return self.bits_to_codes(self._bits(torch.arange(
            self.codebook_size, device=self.mask.device)))

    def indices_to_codes(self, indices, project_out: bool = True):
        """Index -> code vector in feature space (reference: LFQ.py:152-181);
        the model's normal code vq0 is indices_to_codes(0)."""
        codes = self.bits_to_codes(self._bits(
            torch.as_tensor(indices, device=self.mask.device).long()))
        if project_out and self.has_projections:
            codes = self.project_out(codes)
        return codes

    def forward(self, x, train: bool = False,
                generator: Optional[torch.Generator] = None,
                grid: Optional[Tuple[int, int]] = None) -> LFQReturn:
        """x [B, N, dim] -> (quantized [B, N, dim], indices [B, N] (or [B,
        N, num_codebooks]), aux_loss); any codebook_size
        (idee_tpu/quant/lfq.py::LFQ.__call__). No randomness and no rows
        read: ``generator`` and ``grid`` are accepted for the quantizers'
        common signature."""
        x = x.float()
        if x.shape[-1] != self.dim:
            raise ValueError(f"expected dim {self.dim}, got {x.shape[-1]}")
        if self.has_projections:
            x = self.project_in(x)
        B, N = x.shape[0], x.shape[1]
        c, d = self.num_codebooks, self.codebook_dim
        original = x = x.reshape(B, N, c, d)
        scale = self.codebook_scale
        quantized = torch.where(x > 0, scale, -scale)
        # straight-through estimator (reference: LFQ.py:227-228)
        x = x + (quantized - x).detach() if train else quantized
        indices = ((x > 0).long() * self.mask).sum(-1).to(torch.int32)

        if train:
            # logits = 2 x . codebook * inv_temperature (LFQ.py:239-240)
            logits = 2.0 * torch.einsum("bncd,jd->bncj", original,
                                        self._codebook())
            prob = torch.softmax(logits * self.inv_temperature, dim=-1)
            flat = prob.reshape(-1, c, self.codebook_size)
            per_sample_entropy = batch_mean(_entropy(flat))
            # the batch mean over the global batch under a mesh
            codebook_entropy = _entropy(grad_batch_mean(flat, dim=0)[0]
                                        ).mean()
            commit = batch_mean((original - quantized.detach()) ** 2)
            aux = (commit * self.commitment_loss_weight
                   + self.entropy_loss_weight * per_sample_entropy
                   - self.diversity_gamma * codebook_entropy)
        else:
            aux = zero_loss(x.device)

        x = x.reshape(B, N, c * d)
        if self.has_projections:
            if self.freeze_project_out and self.codebook_dims == 1:
                w, b = self.out_proj_params()  # detached inside
                x = x * w + b
            else:
                x = self.project_out(x)
        if self.num_codebooks == 1:
            indices = indices[..., 0]
        return LFQReturn(x, indices, aux)

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
            per_sample_entropy = batch_mean(-p0 * _log(p0) - p1 * _log(p1))
            # the global batch's means under a mesh
            q0, q1 = grad_batch_mean(p0, p1).unbind()
            codebook_entropy = -q0 * _log(q0) - q1 * _log(q1)
            entropy_aux = (self.entropy_loss_weight * per_sample_entropy
                           - self.diversity_gamma * codebook_entropy)
            commit = batch_mean((s - q.detach()) ** 2)
            aux = commit * self.commitment_loss_weight + entropy_aux
        else:
            aux = zero_loss(s.device)
        return LFQScalarParts(s_q, indices, aux)
