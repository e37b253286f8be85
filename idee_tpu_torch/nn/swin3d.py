# ------------------------------------------------------------------
"""Video Swin-3D encoder: 3D shifted-window attention towers per variable,
run as one packed program on [N, T, H, W, V*C], and the window helpers
that the Mamba encoder shares.

Counterpart of idee_tpu/nn/swin3d.py (reference models/encoder/
Swin_3D.py). The V unshared attentions fold (variable, head) into the head
axis G = V*h of one window-attention call (kernels/window_attention.py:
the hand-written CUDA kernels on a card). The shifted-window mask and the
relative-position gather index are numpy constants, built once per
geometry and moved to each device once (the reference rebuilds the mask on
every forward, Swin_3D.py:438). ``dtype`` is the compute dtype of every
projection and norm (nn/layers.py); the attention's q, k, v come out of
the qkv projection in it, its bias stays float32.

Geometry: JAX builds each block's attention inside the block's call, at
the window shrunk to the input (``get_window_size``), so an input no
larger than a window gets a smaller bias table. Here the blocks, stages
and Swin_3D take that input geometry ``input_size`` (D, H, W) when they
are built and make the table at the shrunk window; without one they
build at the configured window. A forward whose shrunk window differs
from the built one raises, as JAX's apply would on the parameter shapes.

Under the ``space`` axis (parallel/spatial.py) a block holds the rank's H
rows, which start on a window row (``window_geometry``): the window, the
shift and the shifted-window mask are the global grid's (the mask's
window index cut to the rank's window rows), the last rank alone pads H,
the cyclic shift of H is a ring exchange (``cyclic_shift``), the
attention kernels run on the rank's windows, and dropout in the window
layout draws the global windows' mask and keeps the rank's.
"""
# ------------------------------------------------------------------

import functools
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from idee_tpu_torch.kernels.window_attention import window_attention
from idee_tpu_torch.nn.cnn3d import (GroupedProjHead, pack_variables,
                                     unpack_variables)
from idee_tpu_torch.nn.layers import (Conv, GroupedConv3d, GroupedDense,
                                      GroupedLayerNorm3d, Init, LayerNorm,
                                      checkpointed, drop_path, dropout,
                                      rank_rows, reference_init,
                                      trunc_normal_init)
from idee_tpu_torch.parallel import spatial


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


def window_geometry(size, window_size, shift_size):
    """(ws, ss, pad, Hp) of a windowed block's input of (D, H, W) ``size``:
    the window and shift shrunk to the input (``get_window_size``), the
    end padding of D, H and W to window multiples, and the padded H. Under
    the space axis ``size`` holds the rank's rows: the window, shift and
    ``Hp`` are the global grid's, only the last rank pads H, and raises
    (on every rank) unless every rank's rows start on a window row."""
    D, H, W = size
    ctx = spatial.active()
    Hg = H if ctx is None else ctx.H
    ws, ss = get_window_size((D, Hg, W), window_size, shift_size)
    pad = [(ws[i] - s % ws[i]) % ws[i] for i, s in enumerate((D, Hg, W))]
    Hp = Hg + pad[1]
    if ctx is not None:
        if H != ctx.rows or any(lo % ws[1] for lo, _ in ctx.splits):
            raise ValueError(
                f"the rank's rows [{ctx.lo}, {ctx.hi}) of H {Hg} ({H} in "
                f"the input) do not start on a row of windows {ws} "
                f"(H over {ctx.S} ranks of the space axis: "
                f"{list(ctx.splits)})")
        if not ctx.last:
            pad[1] = 0
    return ws, ss, pad, Hp


def cyclic_shift(x, shifts, Hp: int):
    """``torch.roll`` of [B, D, H, W, C] by ``shifts`` over (D, H, W); H,
    of ``Hp`` rows in all, by a ring exchange under the space axis."""
    if spatial.active() is None:
        return torch.roll(x, shifts=tuple(shifts), dims=(1, 2, 3))
    x = torch.roll(x, shifts=(shifts[0], shifts[2]), dims=(1, 3))
    return spatial.roll_h(x, 2, shifts[1], Hp)


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


def relative_position_index(ws: Tuple[int, int, int]) -> np.ndarray:
    """Pairwise relative-position gather indices [n, n] for a 3D window
    (reference: Swin_3D.py:120-135)."""
    coords = np.stack(np.meshgrid(
        np.arange(ws[0]), np.arange(ws[1]), np.arange(ws[2]),
        indexing="ij"))  # [3, wd, wh, ww]
    flat = coords.reshape(3, -1)
    rel = flat[:, :, None] - flat[:, None, :]  # [3, n, n]
    rel = rel.transpose(1, 2, 0)
    rel[:, :, 0] += ws[0] - 1
    rel[:, :, 1] += ws[1] - 1
    rel[:, :, 2] += ws[2] - 1
    rel[:, :, 0] *= (2 * ws[1] - 1) * (2 * ws[2] - 1)
    rel[:, :, 1] *= (2 * ws[2] - 1)
    return rel.sum(-1)


def compute_shift_mask(Dp: int, Hp: int, Wp: int, ws, ss
                       ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Additive attention mask (0 / -100) for shifted windows (reference:
    Swin_3D.py:340-352): None when nothing is shifted, else the
    deduplicated (bank [K, n, n] float32, idx [nW] int32) pair, window w
    using bank[idx[w]]. Only windows on the cyclic-wrap boundary differ, so
    K <= 8 while nW grows with the grid."""
    if not any(s > 0 for s in ss):
        return None
    img = np.zeros((1, Dp, Hp, Wp, 1), np.float32)
    cnt = 0
    for d in (slice(-ws[0]), slice(-ws[0], -ss[0]),
              slice(-ss[0], None)) if ss[0] else (slice(None),):
        for h in (slice(-ws[1]), slice(-ws[1], -ss[1]),
                  slice(-ss[1], None)) if ss[1] else (slice(None),):
            for w in (slice(-ws[2]), slice(-ws[2], -ss[2]),
                      slice(-ss[2], None)) if ss[2] else (slice(None),):
                img[:, d, h, w, :] = cnt
                cnt += 1
    B, D, H, W, C = img.shape
    x = img.reshape(B, D // ws[0], ws[0], H // ws[1], ws[1], W // ws[2],
                    ws[2], C)
    x = x.transpose(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, math.prod(ws))
    # the windows' label rows deduplicated first: n labels a window, not
    # its n x n mask (at 512x832 the dense masks are 436 MB)
    labels, of_window = np.unique(x, axis=0, return_inverse=True)
    mask = labels[:, None, :] - labels[:, :, None]
    mask = np.where(mask != 0, -100.0, 0.0).astype(np.float32)
    n = mask.shape[-1]
    bank, of_label = np.unique(mask.reshape(mask.shape[0], -1), axis=0,
                               return_inverse=True)
    idx = of_label.reshape(-1)[of_window.reshape(-1)]
    return bank.reshape(-1, n, n), idx.astype(np.int32)


def mask_bank_to_full(mask):
    """(bank, idx) -> the dense [nW, n, n] mask (None and a dense tensor
    pass through)."""
    if mask is None or not isinstance(mask, tuple):
        return mask
    bank, idx = mask
    return bank[idx.long()]


@functools.lru_cache(maxsize=None)
def shift_mask_on(Dp: int, Hp: int, Wp: int, ws, ss, device: str,
                  rows: Optional[Tuple[int, int]] = None):
    """compute_shift_mask's (bank, idx) as tensors on ``device``, made and
    copied to it once per geometry (outside inference mode, so a first call
    under evaluation leaves tensors that training can save for backward).
    ``rows`` (a, b): idx of the window rows [a, b) only (a rank's windows
    under the space axis; ``Hp`` the global grid's)."""
    parts = compute_shift_mask(Dp, Hp, Wp, ws, ss)
    if parts is None:
        return None
    bank, idx = parts
    if rows is not None:
        idx = idx.reshape(Dp // ws[0], Hp // ws[1], Wp // ws[2])[
            :, rows[0]:rows[1]].reshape(-1)
    with torch.inference_mode(False):
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                     for a in (bank, idx))


@functools.lru_cache(maxsize=None)
def relative_position_index_on(ws, n: int, device: str) -> torch.Tensor:
    """relative_position_index(ws)[:n, :n], flat [n*n] int64, on
    ``device``, once per window (outside inference mode, as above)."""
    rpi = relative_position_index(ws)[:n, :n].reshape(-1)
    with torch.inference_mode(False):
        return torch.from_numpy(rpi.astype(np.int64)).to(device)


def _pad_to_patches(x, p):
    """[N, D, H, W, C] zero-padded at the end of D, H and W to multiples of
    the patch ``p``."""
    _, D, H, W, _ = x.shape
    hi = [(p[i] - s % p[i]) % p[i] for i, s in enumerate((D, H, W))]
    if any(hi):
        x = F.pad(x, (0, 0, 0, hi[2], 0, hi[1], 0, hi[0]))
    return x


def patched_size(size, patch_size) -> Tuple[int, int, int]:
    """The (D, H, W) after a pad-to-multiple patchify of ``size``."""
    return tuple(-(-s // p) for s, p in zip(size, patch_size))


class PatchEmbed3D(nn.Module):
    """One tower's Conv3d patchify with pad-to-multiple (reference:
    Swin_3D.py:449-491; JAX idee_tpu/nn/swin3d.py:282-308) on
    [N, D, H, W, C]: the flax ``Conv_0`` (weight in torch's layout, as
    nn/layers.py::Conv keeps it) and, with ``patch_norm``, the non-affine
    flax LayerNorm (epsilon 1e-5, flax's moments). The packed Swin path
    uses PackedPatchEmbed3D; nothing calls this module, in JAX either."""

    def __init__(self, in_features: int,
                 patch_size: Tuple[int, int, int] = (2, 4, 4),
                 embed_dim: int = 64, patch_norm: bool = False,
                 kernel_init: Optional[Init] = reference_init(),
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.patch_size = tuple(patch_size)
        self.add_module("Conv_0", Conv(
            in_features, embed_dim, self.patch_size, strides=self.patch_size,
            padding=((0, 0),) * 3, kernel_init=kernel_init,
            generator=generator, dtype=dtype))
        self.norm = (LayerNorm(embed_dim, eps=1e-5, affine=False)
                     if patch_norm else None)

    def forward(self, x):
        x = getattr(self, "Conv_0")(_pad_to_patches(x, self.patch_size))
        return self.norm(x).to(x.dtype) if self.norm is not None else x


class PackedPatchEmbed3D(nn.Module):
    """Per-variable Conv3d patchify with pad-to-multiple
    (reference: Swin_3D.py:449-491) on [N, D, H, W, V*Cin]."""

    def __init__(self, n_groups: int, in_features: int,
                 patch_size: Tuple[int, int, int] = (2, 4, 4),
                 embed_dim: int = 64, patch_norm: bool = False,
                 kernel_init: Optional[Init] = reference_init(),
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.patch_size = tuple(patch_size)
        self.proj = GroupedConv3d(n_groups, in_features, embed_dim,
                                  kernel_size=self.patch_size,
                                  strides=self.patch_size,
                                  padding=((0, 0), (0, 0), (0, 0)),
                                  use_bias=True, kernel_init=kernel_init,
                                  generator=generator, dtype=dtype)
        self.norm = (GroupedLayerNorm3d(n_groups, embed_dim, affine=False,
                                        dtype=dtype)
                     if patch_norm else None)

    def forward(self, x):
        x = self.proj(_pad_to_patches(x, self.patch_size))
        return self.norm(x) if self.norm is not None else x


class PackedPatchMerging(nn.Module):
    """2x spatial (and 2x temporal when D > 1) patch merging per variable
    on [N, D, H, W, V*C] (reference: Swin_3D.py:290-335; JAX
    idee_tpu/nn/swin3d.py:342-378): H and W padded to even (and D when
    D > 1), the 2x2 (D == 1) or the reference's four (D > 1) neighbours
    concatenated per variable, then the affine GroupedLayerNorm3d(4C) and
    GroupedDense(4C -> 2C, no bias). Nothing calls it, in JAX either."""

    def __init__(self, n_groups: int, dim: int,
                 kernel_init: Optional[Init] = reference_init(),
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_groups, self.dim = n_groups, dim
        self.norm = GroupedLayerNorm3d(n_groups, 4 * dim, affine=True,
                                       dtype=dtype)
        self.reduction = GroupedDense(n_groups, 4 * dim, 2 * dim,
                                      use_bias=False, kernel_init=kernel_init,
                                      generator=generator, dtype=dtype)

    def forward(self, x):
        _, D, H, W, _ = x.shape
        V, C = self.n_groups, self.dim
        if H % 2 or W % 2:
            x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
        if D % 2 and D != 1:
            x = F.pad(x, (0, 0, 0, 0, 0, 0, 0, D % 2))
        if D == 1:
            parts = [x[:, :, 0::2, 0::2], x[:, :, 1::2, 0::2],
                     x[:, :, 0::2, 1::2], x[:, :, 1::2, 1::2]]
        else:
            parts = [x[:, 0::2, 0::2, 0::2], x[:, 1::2, 1::2, 0::2],
                     x[:, 0::2, 0::2, 1::2], x[:, 1::2, 1::2, 1::2]]
        # the four parts side by side within each variable: [..., V, 4C]
        y = torch.stack(parts, dim=-1)                    # [..., V*C, 4]
        lead = y.shape[:-2]
        y = y.reshape(*lead, V, C, 4).transpose(-1, -2)
        return self.reduction(self.norm(y.reshape(*lead, V * 4 * C)))


class PackedWindowAttention3D(nn.Module):
    """W-MSA with 3D relative position bias, all variables in one call
    (reference: Swin_3D.py:93-178): [B_, n, V*C] windows -> [B_, n, V*C].
    The V unshared attentions ride the head axis of window_attention:
    G = V*heads bias planes [G, n, n], V-major."""

    def __init__(self, n_groups: int, dim: int,
                 window_size: Tuple[int, int, int], num_heads: int,
                 qkv_bias: bool = True, qk_scale: Optional[float] = None,
                 attn_drop: float = 0.0, proj_drop: float = 0.0,
                 kernel_init: Optional[Init] = reference_init(),
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        V, C, h = n_groups, dim, num_heads
        self.n_groups, self.num_heads = V, h
        self.window_size = tuple(window_size)
        self.scale = qk_scale or (C // h) ** -0.5
        self.attn_drop, self.proj_drop = attn_drop, proj_drop
        table_size = math.prod(2 * w - 1 for w in self.window_size)
        # a bare nn.Parameter in the reference: untouched by the composite
        # init, trunc_normal(.02) whatever the model's init scheme
        self.relative_position_bias_table = nn.Parameter(
            torch.empty(V, table_size, h))
        trunc_normal_init(0.02)(self.relative_position_bias_table, generator)
        self.qkv = GroupedDense(V, C, 3 * C, use_bias=qkv_bias,
                                kernel_init=kernel_init, generator=generator,
                                dtype=dtype)
        self.proj = GroupedDense(V, C, C, kernel_init=kernel_init,
                                 generator=generator, dtype=dtype)

    @staticmethod
    def _dropout(t, rate, train, generator, grid):
        """dropout of [B_, ...] windows; ``grid`` (B, nD, nH, nW, a):
        the rank's windows are rows [a, a + their count) of the ``nH``
        window rows of the global grid (space axis)."""
        if grid is None:
            return dropout(t, rate, train, generator)
        B, nD, nH, nW, a = grid
        v = t.reshape(B, nD, -1, nW, *t.shape[1:])
        return dropout(v, rate, train, generator,
                       (2, nH, a)).reshape(t.shape)

    def forward(self, x, mask=None, train: bool = False,
                generator: Optional[torch.Generator] = None, grid=None):
        B_, n, VC = x.shape
        V, h = self.n_groups, self.num_heads
        hd = VC // V // h
        qkv = self.qkv(x).reshape(B_, n, V, 3, h, hd)
        # fold (V, h) into the head axis, V-major == packed C order
        q, k, v = (qkv[:, :, :, i].reshape(B_, n, V * h, hd)
                   for i in range(3))
        rpi = relative_position_index_on(self.window_size, n, str(x.device))
        bias = self.relative_position_bias_table[:, rpi].reshape(V, n, n, h)
        bias = bias.permute(0, 3, 1, 2).reshape(V * h, n, n)

        if self.attn_drop > 0 and train:
            # attention-probability dropout needs the explicit chain, in
            # q's dtype with the float32 bias and mask cast to it (flax's
            # promotion, idee_tpu/nn/swin3d.py:182-194)
            attn = torch.einsum("bngd,bmgd->bgnm", q * self.scale, k)
            attn = attn + bias[None].to(attn.dtype)
            if mask is not None:
                full = mask_bank_to_full(mask).to(attn.dtype)
                nW = full.shape[0]
                attn = (attn.reshape(B_ // nW, nW, V * h, n, n)
                        + full[None, :, None]).reshape(B_, V * h, n, n)
            attn = self._dropout(torch.softmax(attn, dim=-1),
                                 self.attn_drop, train, generator, grid)
            out = torch.einsum("bgnm,bmgd->bngd", attn, v)
        else:
            # q, k, v in the compute dtype, the bias float32 (gathered from
            # the float32 table): the kernels of that dtype
            out = window_attention(q, k, v, bias, mask, self.scale)
        out = self.proj(out.reshape(B_, n, VC))
        return self._dropout(out, self.proj_drop, train, generator, grid)


class PackedSwinBlock3D(nn.Module):
    """One Swin block on the packed layout (reference: Swin_3D.py:181-287):
    LN -> pad -> cyclic shift -> window partition -> attention -> reverse
    -> un-shift -> crop -> residual; then LN -> MLP -> residual."""

    def __init__(self, n_groups: int, dim: int, num_heads: int,
                 window_size: Tuple[int, int, int] = (2, 7, 7),
                 shift_size: Tuple[int, int, int] = (0, 0, 0),
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None, drop: float = 0.0,
                 attn_drop: float = 0.0, drop_path: float = 0.0,
                 kernel_init: Optional[Init] = reference_init(),
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32,
                 input_size: Optional[Tuple[int, int, int]] = None):
        super().__init__()
        V = n_groups
        self.window_size = tuple(window_size)
        self.shift_size = tuple(shift_size)
        self.drop, self.drop_path = drop, drop_path
        self.norm1 = GroupedLayerNorm3d(V, dim, affine=False, dtype=dtype)
        # the attention at the window shrunk to the input, as JAX builds it
        ws = (self.window_size if input_size is None
              else get_window_size(tuple(input_size), self.window_size))
        self.attn = PackedWindowAttention3D(
            V, dim, ws, num_heads, qkv_bias=qkv_bias,
            qk_scale=qk_scale, attn_drop=attn_drop, proj_drop=drop,
            kernel_init=kernel_init, generator=generator, dtype=dtype)
        self.norm2 = GroupedLayerNorm3d(V, dim, affine=False, dtype=dtype)
        hidden = int(dim * mlp_ratio)
        self.mlp_fc1 = GroupedDense(V, dim, hidden, kernel_init=kernel_init,
                                    generator=generator, dtype=dtype)
        self.mlp_fc2 = GroupedDense(V, hidden, dim, kernel_init=kernel_init,
                                    generator=generator, dtype=dtype)

    def forward(self, x, train: bool = False,
                generator: Optional[torch.Generator] = None):
        B, D, H, W, _ = x.shape
        ws, ss, pad, Hp_global = window_geometry(
            (D, H, W), self.window_size, self.shift_size)
        if ws != self.attn.window_size:
            ctx = spatial.active()
            size = (D, H if ctx is None else ctx.H, W)
            raise ValueError(
                f"input {size} shrinks the window {self.window_size} "
                f"to {ws}, but the block was built for "
                f"{self.attn.window_size}: build it with input_size="
                f"{size}")

        shortcut = x
        y = self.norm1(x)
        if any(pad):
            y = F.pad(y, (0, 0, 0, pad[2], 0, pad[1], 0, pad[0]))
        _, Dp, Hp, Wp, _ = y.shape

        ctx = spatial.active()
        # under the space axis: the rank's window rows [a, a + Hp / wh)
        # of the global grid's Hp_global / wh
        grid = None if ctx is None else (
            B, Dp // ws[0], Hp_global // ws[1], Wp // ws[2],
            ctx.lo // ws[1])
        shifted = any(s > 0 for s in ss)
        mask = None
        if shifted:
            y = cyclic_shift(y, [-s for s in ss], Hp_global)
            rows = None if ctx is None else (grid[4],
                                             grid[4] + Hp // ws[1])
            mask = shift_mask_on(Dp, Hp_global, Wp, ws, ss, str(y.device),
                                 rows)
        windows = self.attn(window_partition(y, ws), mask, train, generator,
                            grid)
        y = window_reverse(windows, ws, B, Dp, Hp, Wp)
        if shifted:
            y = cyclic_shift(y, ss, Hp_global)
        if any(pad):
            y = y[:, :D, :H, :W, :]

        x = shortcut + drop_path(y, self.drop_path, train, generator)

        z = F.gelu(self.mlp_fc1(self.norm2(x)))
        z = dropout(z, self.drop, train, generator, rank_rows(2))
        z = dropout(self.mlp_fc2(z), self.drop, train, generator, rank_rows(2))
        return x + drop_path(z, self.drop_path, train, generator)


class PackedSwinStage(nn.Module):
    """BasicLayer (reference: Swin_3D.py:355-446): the patch-embed
    downsample iff the stage changes dims or patchifies (its non-affine LN
    always on: the reference hardcodes norm_layer at Swin_3D.py:418), then
    ``depth`` blocks, every second one shifted by half a window."""

    def __init__(self, n_groups: int, in_dim: int, dim: int, depth: int,
                 num_heads: int,
                 patch_size: Tuple[int, int, int] = (1, 1, 1),
                 window_size: Tuple[int, int, int] = (4, 4, 4),
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None, drop: float = 0.0,
                 attn_drop: float = 0.0, drop_path: Sequence[float] = (0.0,),
                 use_checkpoint: bool = False,
                 kernel_init: Optional[Init] = reference_init(),
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32,
                 input_size: Optional[Tuple[int, int, int]] = None):
        super().__init__()
        # the blocks' geometry: the stage's input after the patchify
        self.output_size = (None if input_size is None
                            else patched_size(input_size, patch_size))
        if in_dim != dim or tuple(patch_size) != (1, 1, 1):
            self.downsample = PackedPatchEmbed3D(
                n_groups, in_dim, patch_size=tuple(patch_size),
                embed_dim=dim, patch_norm=True, kernel_init=kernel_init,
                generator=generator, dtype=dtype)
        else:
            self.downsample = None
        self.depth, self.use_checkpoint = depth, use_checkpoint
        shift = tuple(w // 2 for w in window_size)
        for i in range(depth):
            self.add_module(f"block{i}", PackedSwinBlock3D(
                n_groups, dim, num_heads, window_size=tuple(window_size),
                shift_size=(0, 0, 0) if i % 2 == 0 else shift,
                mlp_ratio=mlp_ratio, qkv_bias=qkv_bias, qk_scale=qk_scale,
                drop=drop, attn_drop=attn_drop,
                drop_path=drop_path[i] if i < len(drop_path) else 0.0,
                kernel_init=kernel_init, generator=generator, dtype=dtype,
                input_size=self.output_size))

    def forward(self, x, train: bool = False,
                generator: Optional[torch.Generator] = None):
        if self.downsample is not None:
            x = self.downsample(x)
        for i in range(self.depth):
            blk = getattr(self, f"block{i}")
            if self.use_checkpoint:
                x = checkpointed(blk, x, train, generator)
            else:
                x = blk(x, train, generator)
        return x


class Swin_3D(nn.Module):
    """Multi-variable Video Swin-3D encoder (reference: Swin_3D.py:494-636).
    [N, V, C, T, H, W] -> [N, V, E, T, H, W] (``packed_out=True`` returns
    [N, T, H, W, V*E]). ``input_size``: the input's (T, H, W), from which
    each stage's windows shrink as JAX shrinks them at init; None builds
    the configured windows."""

    supports_packed_out = True

    def __init__(self, in_vars: int = 6, in_chans: int = 1,
                 embed_dim: Optional[List[int]] = None,
                 window_size: Optional[List[Tuple[int, int, int]]] = None,
                 depths: Optional[List[int]] = None,
                 num_heads: Optional[List[int]] = None,
                 mlp_ratio: float = 4.0, drop_rate: float = 0.0,
                 attn_drop_rate: float = 0.0, drop_path_rate: float = 0.0,
                 qkv_bias: bool = True, qk_scale: Optional[float] = None,
                 patch_size: Tuple[int, int, int] = (1, 1, 1),
                 use_checkpoint: bool = False,
                 kernel_init: Optional[Init] = reference_init(),
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32,
                 input_size: Optional[Tuple[int, int, int]] = None):
        super().__init__()
        V = self.in_vars = in_vars
        embed_dim = embed_dim or [16, 16]
        window_size = window_size or [(2, 4, 4), (8, 1, 1)]
        depths = depths or [2, 1]
        num_heads = num_heads or [2, 2]
        self.n_layers = len(embed_dim)
        dpr = [float(v) for v in np.linspace(0, drop_path_rate, sum(depths))]
        size = None if input_size is None else tuple(input_size)
        for i in range(self.n_layers):
            lo = sum(depths[:i])
            stage = PackedSwinStage(
                V, in_dim=embed_dim[i - 1] if i > 0 else in_chans,
                dim=embed_dim[i], depth=depths[i], num_heads=num_heads[i],
                patch_size=tuple(patch_size) if i == 0 else (1, 1, 1),
                window_size=tuple(window_size[i]), mlp_ratio=mlp_ratio,
                qkv_bias=qkv_bias, qk_scale=qk_scale, drop=drop_rate,
                attn_drop=attn_drop_rate, drop_path=dpr[lo:lo + depths[i]],
                use_checkpoint=use_checkpoint, kernel_init=kernel_init,
                generator=generator, dtype=dtype, input_size=size)
            self.add_module(f"stage{i}", stage)
            size = stage.output_size
        self.proj = GroupedProjHead(V, embed_dim[-1], kernel_init=kernel_init,
                                    generator=generator, dtype=dtype)

    def forward(self, x, train: bool = False, packed_out: bool = False,
                generator: Optional[torch.Generator] = None):
        x = pack_variables(x)
        for i in range(self.n_layers):
            x = getattr(self, f"stage{i}")(x, train, generator)
        x = self.proj(x)
        return x if packed_out else unpack_variables(x, self.in_vars)
