# ------------------------------------------------------------------
"""Vector quantization with a learnable or an EMA codebook (counterpart of
idee_tpu/quant/vq.py; reference models/codebook/VQ.py, a
vector-quantize-pytorch port).

Modes (reference defaults at VQ.py:736-772):
* learnable codebook (default: learnable_codebook=True, ema_update=False):
  ``embed`` [H, K, D] is a parameter, trained by the commitment MSE;
* EMA codebook (ema_update=True): ``embed`` is a buffer, moved by decayed
  cluster averages with Laplace smoothing (VQ.py:524-548);
* cosine-similarity codebook (use_cosine_sim), gumbel code sampling
  (stochastic_sample_codes), lazy k-means init on the first training batch
  (kmeans_init), dead-code expiry (threshold_ema_dead_code), the orthogonal
  regularizer, multi-head codebooks.

State. The JAX package keeps ``cluster_size``, ``embed_avg`` and
``initted`` in its "codebook" variable collection in every mode, and
``embed`` there too whenever the codebook is not a trainable parameter;
here the same names are registered buffers in the same modes, so the
state_dict maps one to one onto the JAX variables
(``models/interop.py``). A training forward quantizes with the state it
found (after the k-means init, when that fires) and writes the new state
into the buffers under no_grad at its end; nothing the backward reads is
changed in place. The eval forward never touches the buffers.

Randomness (k-means seeds, expiry samples, gumbel noise) is drawn in one
place, ``draw``, from the caller's generator; the arithmetic takes the
drawn values, so a test can feed it another framework's draws.

Whether the k-means init has run is the ``initted`` buffer; the module
also keeps it as a host flag, read when it is built or loaded, so that a
training step never waits on the device to decide.

Data parallelism (parallel/mesh.py): the JAX package's step sees the
global batch (GSPMD), or sums over its ``sync_axis`` with ``psum``. Here
each rank holds its rows of the global batch, so ``_all_reduce`` sums the
k-means bins and sums, the EMA's counts and sums and the active-code
mask over the ranks, and rows sampled from the batch (the k-means seeds,
the dead-code replacements) are drawn by rank 0 over the global batch's
tokens, broadcast, and gathered from the rank that holds each
(``_sample_rows``): every rank ends the step with the world-1 codebook
state. Under the space axis a rank holds its H rows of its data rows'
tokens: the caller passes the tokens' ``grid`` around H, from which a
global token index finds its rank (parallel/spatial.py::token_rows).
Without a mesh the sum is the identity.

Not carried over, as in the JAX package: the cross-entropy-on-passed-
indices path (VQ.py:994-1013) and in-place codebook optimizers.
"""
# ------------------------------------------------------------------

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from idee_tpu_torch.nn.layers import reference_init
from idee_tpu_torch.parallel import spatial
from idee_tpu_torch.parallel.mesh import (batch_mean, broadcast, data_rows,
                                          sum_over_ranks, world_size)
from idee_tpu_torch.quant.lfq import LFQReturn, zero_loss, projection


def l2norm(t, eps: float = 1e-12):
    return t / torch.clamp(torch.linalg.vector_norm(t, dim=-1, keepdim=True),
                           min=eps)


def cdist(x, y):
    """Pairwise euclidean distance [H, M, D] x [H, K, D] -> [H, M, K] as
    sqrt(max(x^2 + y^2 - 2xy, 0)), the JAX package's formula (reference:
    VQ.py:44-48); not torch.cdist, whose algorithm changes with size."""
    x2 = (x ** 2).sum(-1, keepdim=True)
    y2 = (y ** 2).sum(-1)[:, None, :]
    xy = torch.einsum("hmd,hkd->hmk", x, y)
    return torch.sqrt(torch.clamp(x2 + y2 - 2 * xy, min=0.0))


def laplace_smoothing(x, n_categories: int, eps: float = 1e-5):
    """(x + eps) / (sum + K eps) (reference: VQ.py:124-126)."""
    return (x + eps) / (x.sum(-1, keepdim=True) + n_categories * eps)


def orthogonal_loss_fn(t, active_mask=None):
    """Mean of (cos_sim(codebook, codebook) - I)^2 (reference:
    VQ.py:265-270). active_mask [H, K] restricts the penalty to the codes
    used this batch (the masked-dense form of the reference's gather of
    unique indices)."""
    k = t.shape[1]
    normed = l2norm(t)
    cos = torch.einsum("hkd,hjd->hkj", normed, normed)
    err = (cos - torch.eye(k, device=t.device)[None]) ** 2
    if active_mask is not None:
        pair = active_mask[:, :, None] * active_mask[:, None, :]
        return (err * pair).sum() / torch.clamp(pair.sum(), min=1.0)
    return err.mean()


def gather_rows(z, idx):
    """z [H, M, D], idx [H, K] -> z[h, idx[h, k]] as [H, K, D]."""
    return torch.gather(z, 1, idx[..., None].expand(-1, -1, z.shape[-1]))


class VQ(nn.Module):
    """Vector quantizer: x [B, N, dim] -> (quantized, indices, loss)."""

    def __init__(self, dim: int = 16, codebook_size: int = 2,
                 codebook_dim: Optional[int] = 16, heads: int = 1,
                 separate_codebook_per_head: bool = False,
                 decay: float = 0.8, eps: float = 1e-5,
                 commitment_weight: float = 1.0,
                 orthogonal_reg_weight: float = 0.0,
                 orthogonal_reg_active_codes_only: bool = False,
                 kmeans_init: bool = False, kmeans_iters: int = 10,
                 use_cosine_sim: bool = False,
                 threshold_ema_dead_code: float = 0.0,
                 reset_cluster_size: Optional[float] = None,
                 stochastic_sample_codes: bool = False,
                 sample_codebook_temp: float = 1.0,
                 ema_update: bool = False, learnable_codebook: bool = True,
                 freeze_codebook: bool = False,
                 sync_axis: Optional[str] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if ema_update and learnable_codebook:
            raise ValueError("learnable codebook not compatible with EMA "
                             "update")
        if kmeans_init and learnable_codebook:
            raise ValueError("k-means init requires a non-learnable "
                             "(buffer) codebook")
        self.dim = dim
        self.codebook_size = codebook_size
        self.codebook_dim = codebook_dim if codebook_dim is not None else dim
        self.heads = heads
        self.separate_codebook_per_head = separate_codebook_per_head
        self.decay, self.eps = decay, eps
        self.commitment_weight = commitment_weight
        self.orthogonal_reg_weight = orthogonal_reg_weight
        self.orthogonal_reg_active_codes_only = \
            orthogonal_reg_active_codes_only
        self.kmeans_init, self.kmeans_iters = kmeans_init, kmeans_iters
        self.use_cosine_sim = use_cosine_sim
        self.threshold_ema_dead_code = threshold_ema_dead_code
        self.reset_cluster_size = (reset_cluster_size
                                   if reset_cluster_size is not None
                                   else threshold_ema_dead_code)
        self.stochastic_sample_codes = stochastic_sample_codes
        self.sample_codebook_temp = sample_codebook_temp
        self.ema_update = ema_update
        self.learnable_codebook = learnable_codebook
        self.freeze_codebook = freeze_codebook
        self.sync_axis = sync_axis

        H = self.num_codebooks = heads if separate_codebook_per_head else 1
        K, D = codebook_size, self.codebook_dim
        if self.has_projections:
            self.project_in = projection(dim, D * heads, reference_init(),
                                         generator)
            self.project_out = projection(D * heads, dim, reference_init(),
                                          generator)
        # kaiming-uniform over [H, K, D] (reference: VQ.py:72-75); zeros
        # while awaiting the k-means init (reference: :304)
        embed = torch.zeros(H, K, D)
        if not kmeans_init:
            bound = 1.0 / (K ** 0.5)
            embed.uniform_(-bound, bound, generator=generator)
        if learnable_codebook and not freeze_codebook:
            self.embed = nn.Parameter(embed)
        else:
            self.register_buffer("embed", embed)
        self.register_buffer("cluster_size", torch.zeros(H, K))
        self.register_buffer("embed_avg", embed.clone())
        self.register_buffer("initted", torch.tensor(
            0.0 if kmeans_init else 1.0))
        self._initted = not kmeans_init

    @property
    def has_projections(self) -> bool:
        return self.codebook_dim * self.heads != self.dim

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)
        key = prefix + "initted"
        if key in state_dict:  # the host flag follows the loaded buffer
            self._initted = bool(float(state_dict[key]) > 0)

    def _all_reduce(self, t):
        """Sum over the data-parallel ranks: the identity on one
        device."""
        return sum_over_ranks(t)

    def _sample_rows(self, z, idx, rows=None):
        """z[h, idx[h, k]] of the global batch's tokens, ``idx`` [H, K]
        global token indices; each rank holds z [H, M, D], the tokens of
        its ``rows`` (B, outer, h, inner): its B batch rows' tokens laid
        out [outer, h, inner], h its rows of H (all of them without the
        space axis). The rank that holds a row gives it, the others 0."""
        if world_size() == 1:
            return gather_rows(z, idx)
        B, outer, h, inner = rows
        local, own = spatial.token_rows(idx, outer, h, inner, B,
                                        data_rows(B).start)
        rows = gather_rows(z, local) * own[..., None]
        return sum_over_ranks(rows)

    def draw(self, generator: Optional[torch.Generator], M: int,
             dist_shape, device, train: bool) -> Dict[str, torch.Tensor]:
        """This step's random draws: ``kmeans`` [H, K] seed rows (when the
        init is due), ``gumbel`` uniforms in [1e-20, 1) of the distance
        shape, ``expire`` [H, K] replacement rows. ``M``: the tokens of
        the global batch, from which the rows are drawn."""
        H, K = self.num_codebooks, self.codebook_size
        out = {}
        if not train:
            return out

        def rows():
            return torch.randint(0, M, (H, K), device=device,
                                 generator=generator)

        if self.kmeans_init and not self._initted:
            out["kmeans"] = rows()
        if self.stochastic_sample_codes:
            u = torch.rand(dist_shape, device=device, generator=generator)
            out["gumbel"] = u * (1.0 - 1e-20) + 1e-20
        if (self.ema_update and self._updatable(train)
                and self.threshold_ema_dead_code > 0):
            out["expire"] = rows()
        return out

    def _updatable(self, train: bool) -> bool:
        return (train and not self.freeze_codebook
                and not self.learnable_codebook)

    def _assign(self, z, means):
        if self.use_cosine_sim:
            return torch.einsum("hmd,hkd->hmk", z, l2norm(means)).argmax(-1)
        return cdist(z, means).argmin(-1)

    @torch.no_grad()
    def kmeans(self, z, idx, rows=None):
        """Lloyd's k-means with ``kmeans_iters`` fixed iterations from the
        seed rows z[h, idx[h]]: z [H, M, D], idx [H, K] -> (means [H, K, D],
        bins [H, K]) (reference: VQ.py:213-253)."""
        K = self.codebook_size
        means = self._sample_rows(z, idx, rows)
        for _ in range(self.kmeans_iters):
            onehot = F.one_hot(self._assign(z, means), K).float()
            bins = self._all_reduce(onehot.sum(1))                   # [H, K]
            sums = self._all_reduce(torch.einsum("hmd,hmk->hkd", z, onehot))
            new = sums / torch.clamp(bins[..., None], min=1.0)
            means = torch.where(bins[..., None] > 0, new, means)
            if self.use_cosine_sim:
                means = l2norm(means)
        onehot = F.one_hot(self._assign(z, means), K).float()
        return means, self._all_reduce(onehot.sum(1))

    def indices_to_codes(self, indices, project_out: bool = True):
        """Code index -> feature-space vector (reference: VQ.py:871-895),
        from the first head's codebook."""
        embed = self.embed[0]
        codes = embed[torch.as_tensor(indices, device=embed.device).long()]
        if project_out and self.has_projections:
            codes = self.project_out(codes)
        return codes

    def forward(self, x, train: bool = False,
                generator: Optional[torch.Generator] = None,
                draws: Optional[Dict[str, torch.Tensor]] = None,
                grid: Optional[Tuple[int, int]] = None) -> LFQReturn:
        """x [B, N, dim]; with ``train`` the codebook state moves (EMA,
        k-means init, expiry) and the loss is returned. ``draws`` replaces
        ``draw(generator, ...)``'s values. ``grid`` (outer, inner): each
        sample's N tokens laid out [outer, H, inner] (needed under the
        space axis, where x holds the rank's H rows; without it the N
        tokens are one row)."""
        x = x.float()
        if x.shape[-1] != self.dim:
            raise ValueError(f"expected dim {self.dim}, got {x.shape[-1]}")
        B, N = x.shape[0], x.shape[1]
        H, K, D = self.num_codebooks, self.codebook_size, self.codebook_dim

        v = self.project_in(x) if self.has_projections else x
        if self.separate_codebook_per_head:
            z = v.reshape(B, N, H, D).permute(2, 0, 1, 3).reshape(H, B * N, D)
        else:
            z = v.reshape(1, B * N * self.heads, D)
        M = z.shape[1]
        zd = z.detach()
        ctx = spatial.active()
        if grid is None:
            if ctx is not None:
                raise ValueError("VQ under the space axis needs the tokens'"
                                 " grid around H (grid=)")
            grid = (1, N)  # one row of N tokens
        heads = 1 if self.separate_codebook_per_head else self.heads
        h = N // (grid[0] * grid[1])  # the rank's rows of H
        rows = (B, grid[0], h, grid[1] * heads)
        M_global = (M // h * (h if ctx is None else ctx.H)
                    * (world_size() // (1 if ctx is None else ctx.S)))
        if draws is None:
            draws = self.draw(generator, M_global, (H, M, K), z.device,
                              train)
            # rank 0's rows of the global batch (parallel/mesh.py)
            draws.update({k: broadcast(draws[k]) for k in ("kmeans",
                                                            "expire")
                          if k in draws})
        updatable = self._updatable(train)

        embed, cluster_size = self.embed, self.cluster_size
        state = {}
        # lazy k-means init on the first training batch (reference:
        # VQ.py:356-377, 499); the JAX package rewrites the state from the
        # (possibly just initialised) codebook at every training step
        if self.kmeans_init and train:
            if not self._initted:
                embed, cluster_size = self.kmeans(zd, draws["kmeans"], rows)
            state = {"embed": embed, "cluster_size": cluster_size,
                     "embed_avg": embed * cluster_size[..., None],
                     "initted": torch.ones_like(self.initted)}

        trainable = self.learnable_codebook and not self.freeze_codebook
        codebook = embed if trainable else embed.detach()

        with torch.no_grad():  # the distances only pick codes
            if self.use_cosine_sim:
                dist = torch.einsum("hmd,hkd->hmk", l2norm(zd),
                                    l2norm(codebook.detach()))
            else:
                dist = -cdist(zd, codebook.detach())
            if self.stochastic_sample_codes and train:
                # gumbel sampling (reference: VQ.py:83-121)
                g = -torch.log(-torch.log(draws["gumbel"]) + 1e-20)
                ind = (dist / self.sample_codebook_temp + g).argmax(-1)
            else:
                ind = dist.argmax(-1)                                # [H, M]
            onehot = F.one_hot(ind, K).float()
        zq_in = l2norm(z) if self.use_cosine_sim else z
        quantize = torch.einsum("hmk,hkd->hmd", onehot, codebook)

        # EMA codebook update (reference: VQ.py:524-548)
        if self.ema_update and updatable:
            with torch.no_grad():
                bins = self._all_reduce(onehot.sum(1))               # [H, K]
                embed_sum = self._all_reduce(
                    torch.einsum("hmd,hmk->hkd", zd, onehot))
                new_cs = cluster_size * self.decay + bins * (1 - self.decay)
                new_avg = (state.get("embed_avg", self.embed_avg)
                           * self.decay + embed_sum * (1 - self.decay))
                smoothed = laplace_smoothing(new_cs, K, self.eps) \
                    * new_cs.sum(-1, keepdim=True)
                new_embed = new_avg / smoothed[..., None]
                if self.use_cosine_sim:
                    new_embed = l2norm(new_embed)
                # dead-code expiry (reference: VQ.py:451-475)
                if self.threshold_ema_dead_code > 0:
                    expired = new_cs < self.threshold_ema_dead_code  # [H, K]
                    samples = self._sample_rows(zd, draws["expire"], rows)
                    reset = self.reset_cluster_size
                    new_embed = torch.where(expired[..., None], samples,
                                            new_embed)
                    new_cs = torch.where(expired, reset, new_cs)
                    new_avg = torch.where(expired[..., None],
                                          samples * reset, new_avg)
                state.update(cluster_size=new_cs, embed_avg=new_avg,
                             embed=new_embed)

        # losses (reference: VQ.py:978-1058)
        if train:
            target = quantize if trainable else quantize.detach()
            loss = self.commitment_weight * batch_mean((target - zq_in) ** 2)
            if self.orthogonal_reg_weight > 0:
                mask = ((self._all_reduce(onehot.sum(1)) > 0).float()
                        if self.orthogonal_reg_active_codes_only else None)
                loss = loss + self.orthogonal_reg_weight \
                    * orthogonal_loss_fn(embed, mask)
            # straight-through (reference: VQ.py:986)
            quantize = zq_in + (quantize - zq_in).detach()
        else:
            loss = zero_loss(x.device)

        with torch.no_grad():
            for name, value in state.items():
                getattr(self, name).copy_(value)
        if "initted" in state:
            self._initted = True

        if self.separate_codebook_per_head:
            out = quantize.reshape(H, B, N, D).permute(1, 2, 0, 3)
            out = out.reshape(B, N, H * D)
            indices = ind.reshape(H, B, N).permute(1, 2, 0)
        else:
            out = quantize.reshape(B, N, self.heads * D)
            indices = ind.reshape(B, N, self.heads)
        if self.heads == 1:
            indices = indices[..., 0]
        if self.has_projections:
            out = self.project_out(out)
        return LFQReturn(out, indices.to(torch.int32), loss)
