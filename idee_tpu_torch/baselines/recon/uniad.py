# ------------------------------------------------------------------
"""UniAD: a DETR-style feature-reconstruction transformer
(https://arxiv.org/abs/2206.03687; counterpart of
idee_tpu/baselines/recon/uniad.py; reference
Baselines_Reconstruction/models/build_uniad.py).

One timestep [B, V, H, W] is bilinearly downsampled by ``instrides``
(with jax.image.resize's antialiasing: ``resize_bilinear``), tokenised
over the feature grid, optionally feature-jittered (:705-714), projected,
run through an encoder and a decoder whose attentions may be restricted to
a spatial neighborhood (:149-173), reconstructed, and scored as a
per-pixel squared error upsampled back to the input grid, its sign
flipped on extreme pixels (:763-776). Attention is plain einsum + masked
softmax over all token pairs, as in the JAX package: at a 100x100 grid
one attention's scores are [B, nhead, 10^4, 10^4].

Init: xavier_uniform Dense kernels (:71-97); the decoder's learned
queries N(0, 1); the learned position embeddings U[0, 1) (:576-578).
It computes in float32 whatever cfg.dtype says, as JAX builds it without
a dtype.
"""
# ------------------------------------------------------------------

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from idee_tpu_torch.baselines.config import ReconConfig
from idee_tpu_torch.nn.layers import (Dense, LayerNorm, dropout,
                                      reference_init, uniform_init,
                                      xavier_init)


def neighbor_mask(feature_size: Tuple[int, int],
                  neighbor_size: Tuple[int, int]) -> np.ndarray:
    """Boolean [N, N] allowed-attention mask: token (h1, w1) may attend to
    (h2, w2) iff |h1 - h2| <= hm // 2 and |w1 - w2| <= wm // 2
    (reference: build_uniad.py:149-173)."""
    h, w = feature_size
    hm, wm = neighbor_size
    dh = np.abs(np.arange(h)[:, None] - np.arange(h)[None, :]) <= hm // 2
    dw = np.abs(np.arange(w)[:, None] - np.arange(w)[None, :]) <= wm // 2
    return (dh[:, None, :, None] & dw[None, :, None, :]).reshape(h * w,
                                                                 h * w)


def sine_pos_embed(feature_size, num_pos_feats,
                   normalize: bool = True) -> np.ndarray:
    """[N, 2 * num_pos_feats] sine position embedding
    (reference: build_uniad.py:515-561)."""
    h, w = feature_size
    y = np.cumsum(np.ones((h, w)), axis=0)
    x = np.cumsum(np.ones((h, w)), axis=1)
    if normalize:
        y = y / (y[-1:, :] + 1e-6) * 2 * math.pi
        x = x / (x[:, -1:] + 1e-6) * 2 * math.pi
    dim_t = np.arange(num_pos_feats, dtype=np.float64)
    dim_t = 10000.0 ** (2 * (dim_t // 2) / num_pos_feats)
    px = x[:, :, None] / dim_t
    py = y[:, :, None] / dim_t
    px = np.stack([np.sin(px[:, :, 0::2]), np.cos(px[:, :, 1::2])],
                  axis=3).reshape(h, w, -1)
    py = np.stack([np.sin(py[:, :, 0::2]), np.cos(py[:, :, 1::2])],
                  axis=3).reshape(h, w, -1)
    return np.concatenate([py, px], axis=2).reshape(h * w, -1).astype(
        np.float32)


def resize_bilinear(x, size: Tuple[int, int]):
    """jax.image.resize(x, (..., *size), "bilinear") of x [B, C, H, W]:
    when downsampling, the triangle filter widened by the scale
    (antialiased; without antialias F.interpolate's bilinear reads 2 of
    every 4 inputs at a 2x downsample); when upsampling, bilinear
    interpolation with half-pixel centers."""
    return F.interpolate(x, size=tuple(size), mode="bilinear",
                         align_corners=False, antialias=True)


class LearnedPosEmbed(nn.Module):
    """Row + column learned embeddings (reference: build_uniad.py:564-598;
    torch init U[0, 1), :576-578)."""

    def __init__(self, feature_size, num_pos_feats: int, generator=None):
        super().__init__()
        h, w = feature_size
        self.row_embed = nn.Parameter(torch.empty(h, num_pos_feats))
        self.col_embed = nn.Parameter(torch.empty(w, num_pos_feats))
        for p in (self.row_embed, self.col_embed):
            uniform_init(0.0, 1.0)(p, generator)

    def forward(self):
        h, w = self.row_embed.shape[0], self.col_embed.shape[0]
        npf = self.row_embed.shape[1]
        pos = torch.cat([self.col_embed[None].expand(h, w, npf),
                         self.row_embed[:, None].expand(h, w, npf)], -1)
        return pos.reshape(h * w, 2 * npf)


def _xavier_dense(fin, fout, generator):
    return Dense(fin, fout, kernel_init=xavier_init(fin, fout, uniform=True),
                 generator=generator)


class MHA(nn.Module):
    """Multi-head attention with an optional boolean mask (torch
    nn.MultiheadAttention's math: in-projections, out-projection,
    attention-weight dropout)."""

    def __init__(self, dim: int, nhead: int, dropout: float = 0.1,
                 generator=None):
        super().__init__()
        self.dim, self.nhead, self.dropout = dim, nhead, dropout
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            self.add_module(name, _xavier_dense(dim, dim, generator))

    def forward(self, q, k, v, mask=None, train: bool = False,
                generator=None):
        """q [B, Nq, C]; k / v [B, Nk, C]; mask [Nq, Nk] boolean allowed."""
        h = self.nhead
        hd = self.dim // h
        qh = self.q_proj(q).reshape(*q.shape[:-1], h, hd)
        kh = self.k_proj(k).reshape(*k.shape[:-1], h, hd)
        vh = self.v_proj(v).reshape(*k.shape[:-1], h, hd)
        logits = torch.einsum("bqhd,bkhd->bhqk", qh * hd ** -0.5, kh)
        if mask is not None:
            logits = logits.masked_fill(~mask, float("-inf"))
        attn = dropout(torch.softmax(logits, dim=-1), self.dropout, train,
                       generator)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, vh)
        return self.out_proj(out.reshape(*q.shape[:-1], self.dim))


class EncoderLayer(nn.Module):
    """Post-norm transformer encoder layer
    (reference: build_uniad.py:280-353)."""

    def __init__(self, dim: int, nhead: int, dim_feedforward: int,
                 dropout: float = 0.1, generator=None):
        super().__init__()
        self.dropout = dropout
        self.self_attn = MHA(dim, nhead, dropout, generator)
        self.norm1 = LayerNorm(dim)
        self.linear1 = _xavier_dense(dim, dim_feedforward, generator)
        self.linear2 = _xavier_dense(dim_feedforward, dim, generator)
        self.norm2 = LayerNorm(dim)

    def forward(self, src, pos, mask, train: bool = False, generator=None):
        def drop(t):
            return dropout(t, self.dropout, train, generator)

        q = src + pos
        y = self.self_attn(q, q, src, mask, train, generator)
        src = self.norm1(src + drop(y))
        y = self.linear2(drop(F.relu(self.linear1(src))))
        return self.norm2(src + drop(y))


class DecoderLayer(nn.Module):
    """Post-norm DETR-style decoder layer with a learned query embedding
    per layer (reference: build_uniad.py:356-429)."""

    def __init__(self, dim: int, nhead: int, num_queries: int,
                 dim_feedforward: int, dropout: float = 0.1,
                 generator=None):
        super().__init__()
        self.dropout = dropout
        self.learned_embed = nn.Parameter(torch.empty(num_queries, dim))
        reference_init(0.0, 1.0)(self.learned_embed, generator)
        self.self_attn = MHA(dim, nhead, dropout, generator)
        self.norm1 = LayerNorm(dim)
        self.multihead_attn = MHA(dim, nhead, dropout, generator)
        self.norm2 = LayerNorm(dim)
        self.linear1 = _xavier_dense(dim, dim_feedforward, generator)
        self.linear2 = _xavier_dense(dim_feedforward, dim, generator)
        self.norm3 = LayerNorm(dim)

    def forward(self, out, memory, pos, tgt_mask, memory_mask,
                train: bool = False, generator=None):
        def drop(t):
            return dropout(t, self.dropout, train, generator)

        tgt = self.learned_embed[None].expand(memory.shape[0], -1, -1)
        y = self.self_attn(tgt + pos, memory + pos, memory, tgt_mask, train,
                           generator)
        tgt = self.norm1(tgt + drop(y))
        y = self.multihead_attn(tgt + pos, out + pos, out, memory_mask,
                                train, generator)
        tgt = self.norm2(tgt + drop(y))
        y = self.linear2(drop(F.relu(self.linear1(tgt))))
        return self.norm3(tgt + drop(y))


class UniADOutput(NamedTuple):
    loss_map: torch.Tensor  # [B, V, H, W] signed squared error


class UniAD(nn.Module):
    """reference: build_uniad.py:612-776. forward(x [B, V, H, W],
    mask_extreme_loss [B, H, W] or None) -> the per-pixel signed squared
    error at the input grid. The token grid is (H, W) // instrides, fixed
    at construction."""

    def __init__(self, config: ReconConfig, in_vars: int,
                 grid: Tuple[int, int],
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = self.config = config
        g = generator or torch.Generator().manual_seed(cfg.seed)
        fh, fw = grid[0] // cfg.instrides, grid[1] // cfg.instrides
        self.feat = (fh, fw)
        n, C = fh * fw, cfg.hidden_dim
        self.input_proj = _xavier_dense(in_vars, C, g)
        if cfg.pos_embed_type in ("v3", "learned"):
            self.pos_embed = LearnedPosEmbed((fh, fw), C // 2, g)
        elif cfg.pos_embed_type in ("v2", "sine"):
            self.register_buffer("pos_sine", torch.from_numpy(
                sine_pos_embed((fh, fw), C // 2)), persistent=False)
        else:
            raise ValueError(f"not supported {cfg.pos_embed_type}")
        if any(cfg.neighbor_mask):
            self.register_buffer("nbr_mask", torch.from_numpy(neighbor_mask(
                (fh, fw), tuple(cfg.neighbor_size))), persistent=False)
        for i in range(cfg.num_encoder_layers):
            self.add_module(f"encoder_layer{i}", EncoderLayer(
                C, cfg.nhead, cfg.dim_feedforward, cfg.dropout, g))
        for i in range(cfg.num_decoder_layers):
            self.add_module(f"decoder_layer{i}", DecoderLayer(
                C, cfg.nhead, n, cfg.dim_feedforward, cfg.dropout, g))
        self.decoder_norm = LayerNorm(C)
        self.output_proj = _xavier_dense(C, in_vars, g)

    def forward(self, x, mask_extreme_loss=None, train: bool = False,
                generator: Optional[torch.Generator] = None) -> UniADOutput:
        """``generator`` draws the jitter coin, its noise and the dropout
        masks."""
        cfg = self.config
        B, V, H, W = x.shape
        fh, fw = self.feat
        feat = resize_bilinear(x, (fh, fw))        # (reference: :717)
        tokens = feat.reshape(B, V, fh * fw).transpose(1, 2)  # [B, n, V]

        if train and cfg.feature_jitter_scale:
            # jitter with probability feature_jitter_prob, one coin per
            # batch (reference: :705-714)
            coin = torch.rand((), generator=generator, device=x.device)
            norms = torch.linalg.vector_norm(tokens, dim=2,
                                             keepdim=True) / V
            noise = torch.randn(tokens.shape, generator=generator,
                                device=x.device)
            tokens = torch.where(
                coin <= cfg.feature_jitter_prob,
                tokens + noise * norms * cfg.feature_jitter_scale, tokens)

        tokens = self.input_proj(tokens)
        pos = (self.pos_embed() if hasattr(self, "pos_embed")
               else self.pos_sine)[None]
        masks = [self.nbr_mask if use else None for use in cfg.neighbor_mask]

        out = tokens
        for i in range(cfg.num_encoder_layers):
            out = getattr(self, f"encoder_layer{i}")(out, pos, masks[0],
                                                     train, generator)
        memory = dec = out
        for i in range(cfg.num_decoder_layers):
            dec = getattr(self, f"decoder_layer{i}")(
                dec, memory, pos, masks[1], masks[2], train, generator)
        rec = self.output_proj(self.decoder_norm(dec))        # [B, n, V]
        rec = rec.transpose(1, 2).reshape(B, V, fh, fw)

        # upsample the loss map and flip its sign on extreme pixels
        # (reference: :763-776)
        loss = resize_bilinear((rec - feat) ** 2, (H, W))
        if mask_extreme_loss is not None:
            loss = loss * torch.where(mask_extreme_loss[:, None] == 1, -1.0,
                                      1.0)
        return UniADOutput(loss)
