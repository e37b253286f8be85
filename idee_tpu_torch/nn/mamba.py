# ------------------------------------------------------------------
"""Vision Mamba encoder: windowed selective-scan (SSM) towers per variable,
run as one packed program on [N, T, H, W, V*C].

Counterpart of idee_tpu/nn/mamba.py (reference models/encoder/Mamba.py).
Each window's flattened token sequence goes through a mamba_ssm.Mamba
v1-style block: in_proj -> causal depthwise conv1d -> silu -> x_proj
(dt/B/C) -> softplus(dt_proj) -> selective scan with A = -exp(A_log), skip
D, silu(z) gating -> out_proj. With d_state=1 the scan is the fused CUDA
kernel of kernels/selective_scan.py; a larger d_state goes through its
linear-scan kernel. ``dtype`` is the compute dtype of the projections, the
conv and the norms (nn/layers.py); the scan takes float32 inputs whatever
it is, as in the JAX package.

Under the ``space`` axis (parallel/spatial.py) a block holds the rank's H
rows, which start on a window row: the window geometry is the global
grid's, the last rank alone pads H to a window multiple, the cyclic
shift of H is a ring exchange (``roll_h``), and the scan runs over the
rank's windows.
"""
# ------------------------------------------------------------------

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from idee_tpu_torch.kernels.selective_scan import (fused_selective_scan_n1,
                                                   linear_scan)
from idee_tpu_torch.nn.cnn3d import (GroupedProjHead, pack_variables,
                                     unpack_variables)
from idee_tpu_torch.nn.layers import (GroupedDense, GroupedLayerNorm3d, Init,
                                      checkpointed, drop_path, dropout,
                                      rank_rows, lecun_normal_init,
                                      reference_init)
from idee_tpu_torch.nn.swin3d import (PackedPatchEmbed3D, cyclic_shift,
                                      window_geometry, window_partition,
                                      window_reverse)


def selective_scan(u, delta, A, B, C, D, z):
    """Selective scan of a single tower through the linear-scan kernel.

    u, delta, z: [B, L, d]; A: [d, n]; B, C: [B, L, n]; D: [d]
    h_t = exp(delta_t A) h_{t-1} + delta_t B_t u_t;  y_t = C_t . h_t + D u_t
    """
    dA = torch.exp(delta[..., None] * A)                     # [B, L, d, n]
    dBu = (delta * u)[..., None] * B[:, :, None, :]          # [B, L, d, n]
    h = linear_scan(dA, dBu, axis=1)
    y = torch.einsum("bldn,bln->bld", h, C) + u * D
    return y * F.silu(z)


def selective_scan_packed(u, delta, A, B, C, D, z, n_groups: int):
    """Selective scan over packed channels.

    u, delta, z: [B_, L, V*d]; A: [V*d, n]; B, C: [B_, L, V, n]
    (per-variable SSM inputs); D: [V*d]. Returns [B_, L, V*d].
    """
    B_, L, M = u.shape
    d = M // n_groups
    n = A.shape[-1]

    if n == 1:
        # fused path over [L, B_*M]: the huge windows*channels axis is
        # minor, which is what the kernel's coalesced loads need
        def fold(t):  # [B_, L, M] -> [L, B_*M]
            return t.transpose(0, 1).reshape(L, B_ * M)

        B_rep = fold(B[..., 0].repeat_interleave(d, dim=2))
        C_rep = fold(C[..., 0].repeat_interleave(d, dim=2))
        y = fused_selective_scan_n1(fold(delta), fold(u), B_rep, C_rep,
                                    fold(z), A[:, 0].repeat(B_),
                                    D.repeat(B_))
        return y.reshape(L, B_, M).transpose(0, 1)

    # general d_state: per-variable B/C broadcast over that variable's
    # d_inner channels, scan with a trailing state axis
    B_rep = B.repeat_interleave(d, dim=2)                    # [B_, L, M, n]
    dA = torch.exp(delta[..., None] * A)                     # [B_, L, M, n]
    dBu = (delta * u)[..., None] * B_rep
    h = linear_scan(dA, dBu, axis=1)                         # [B_, L, M, n]
    C_rep = C.repeat_interleave(d, dim=2)
    y = torch.sum(h * C_rep, dim=-1) + u * D
    return y * F.silu(z)


class PackedMambaSSM(nn.Module):
    """mamba_ssm.Mamba v1-equivalent block over all variables at once:
    [B_, L, V*d_model] -> [B_, L, V*d_model], unshared per-variable params
    stacked on axis 0 of every kernel."""

    def __init__(self, n_groups: int, d_model: int, d_state: int = 1,
                 d_conv: int = 3, expand: int = 1,
                 kernel_init: Optional[Init] = reference_init(),
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        V = n_groups
        self.n_groups, self.d_state, self.d_conv = V, d_state, d_conv
        self.dtype = dtype
        self.d_inner = d_inner = expand * d_model
        self.dt_rank = dt_rank = math.ceil(d_model / 16)
        n = d_state
        self.in_proj = GroupedDense(V, d_model, 2 * d_inner, use_bias=False,
                                    kernel_init=kernel_init,
                                    generator=generator, dtype=dtype)
        self.conv1d_kernel = nn.Parameter(torch.empty(V, d_conv, 1, d_inner))
        (kernel_init or lecun_normal_init(d_conv))(self.conv1d_kernel,
                                                   generator)
        self.conv1d_bias = nn.Parameter(torch.zeros(V, d_inner))
        self.x_proj = GroupedDense(V, d_inner, dt_rank + 2 * n,
                                   use_bias=False, kernel_init=kernel_init,
                                   generator=generator, dtype=dtype)
        # the composite init zeroes dt_proj.bias (reference
        # models/build.py:96-118), so the effective dt at init is softplus(0)
        self.dt_proj = GroupedDense(V, dt_rank, d_inner, use_bias=True,
                                    kernel_init=kernel_init,
                                    generator=generator, dtype=dtype)
        self.A_log = nn.Parameter(
            torch.log(torch.arange(1, n + 1, dtype=torch.float32))
            .repeat(V, d_inner, 1))
        self.D = nn.Parameter(torch.ones(V, d_inner))
        self.out_proj = GroupedDense(V, d_inner, d_model, use_bias=False,
                                     kernel_init=kernel_init,
                                     generator=generator, dtype=dtype)

    def forward(self, x):
        V, d_inner, n, dt_rank = (self.n_groups, self.d_inner, self.d_state,
                                  self.dt_rank)
        B_, L, _ = x.shape

        xz = self.in_proj(x).reshape(B_, L, V, 2, d_inner)
        u = xz[:, :, :, 0].reshape(B_, L, V * d_inner)
        z = xz[:, :, :, 1].reshape(B_, L, V * d_inner)

        # causal depthwise conv over the token axis (pad d_conv-1 in front,
        # mamba_ssm semantics) as d_conv shifted multiply-adds, in u's dtype
        taps = self.conv1d_kernel.permute(1, 2, 0, 3).reshape(
            self.d_conv, V * d_inner).to(u.dtype)
        u_pad = F.pad(u, (0, 0, self.d_conv - 1, 0))
        acc = sum(u_pad[:, i:i + L] * taps[i] for i in range(self.d_conv))
        u = F.silu(acc + self.conv1d_bias.reshape(V * d_inner).to(u.dtype))

        x_dbl = self.x_proj(u).reshape(B_, L, V, dt_rank + 2 * n)
        dt = x_dbl[..., :dt_rank].reshape(B_, L, V * dt_rank)
        Bssm = x_dbl[..., dt_rank:dt_rank + n]      # [B_, L, V, n]
        Cssm = x_dbl[..., dt_rank + n:]             # [B_, L, V, n]
        delta = F.softplus(self.dt_proj(dt))

        A = -torch.exp(self.A_log).reshape(V * d_inner, n)
        # the scan runs in float32 whatever the compute dtype
        # (idee_tpu/nn/mamba.py:181-185): the float32 kernels
        y = selective_scan_packed(u.float(), delta.float(), A, Bssm.float(),
                                  Cssm.float(), self.D.reshape(V * d_inner),
                                  z.float(), V)
        y = y.to(self.dtype)
        return self.out_proj(y)


class PackedMambaBlock(nn.Module):
    """Windowed Mamba block (reference: Mamba.py:98-196) on the packed
    layout: LN -> pad -> cyclic shift -> window partition -> SSM over window
    tokens -> reverse -> residual; then LN -> MLP -> residual."""

    def __init__(self, n_groups: int, dim: int,
                 window_size: Tuple[int, int, int] = (2, 7, 7),
                 shift_size: Tuple[int, int, int] = (0, 0, 0),
                 mlp_ratio: float = 4.0, d_state: int = 1, d_conv: int = 3,
                 expand: int = 1, drop: float = 0.0, drop_path: float = 0.0,
                 kernel_init: Optional[Init] = reference_init(),
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        V = n_groups
        self.window_size = tuple(window_size)
        self.shift_size = tuple(shift_size)
        self.drop, self.drop_path = drop, drop_path
        self.norm1 = GroupedLayerNorm3d(V, dim, affine=False, dtype=dtype)
        self.ssm = PackedMambaSSM(V, dim, d_state=d_state, d_conv=d_conv,
                                  expand=expand, kernel_init=kernel_init,
                                  generator=generator, dtype=dtype)
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

        shortcut = x
        y = self.norm1(x)
        if any(pad):
            y = F.pad(y, (0, 0, 0, pad[2], 0, pad[1], 0, pad[0]))
        _, Dp, Hp, Wp, _ = y.shape

        shifted = any(s > 0 for s in ss)
        if shifted:
            y = cyclic_shift(y, [-s for s in ss], Hp_global)
        windows = self.ssm(window_partition(y, ws))
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


class PackedMambaStage(nn.Module):
    """BasicLayer (reference: Mamba.py:247-336)."""

    def __init__(self, n_groups: int, in_dim: int, dim: int, depth: int,
                 d_state: int = 1, d_conv: int = 3, expand: int = 1,
                 patch_size: Tuple[int, int, int] = (1, 1, 1),
                 window_size: Tuple[int, int, int] = (4, 4, 4),
                 mlp_ratio: float = 4.0, drop: float = 0.0,
                 drop_path: Sequence[float] = (0.0,),
                 use_checkpoint: bool = False,
                 kernel_init: Optional[Init] = reference_init(),
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        # patch-embed downsample iff the stage changes dims or patchifies,
        # with its non-affine LN always on (reference: Mamba.py:313-316)
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
            self.add_module(f"block{i}", PackedMambaBlock(
                n_groups, dim, window_size=tuple(window_size),
                shift_size=(0, 0, 0) if i % 2 == 0 else shift,
                mlp_ratio=mlp_ratio, d_state=d_state, d_conv=d_conv,
                expand=expand, drop=drop,
                drop_path=drop_path[i] if i < len(drop_path) else 0.0,
                kernel_init=kernel_init, generator=generator, dtype=dtype))

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


class Mamba(nn.Module):
    """Multi-variable Vision Mamba encoder (reference: Mamba.py:384-531).
    [N, V, C, T, H, W] -> [N, V, E, T, H, W] (``packed_out=True`` returns
    [N, T, H, W, V*E])."""

    supports_packed_out = True

    def __init__(self, in_vars: int = 6, in_chans: int = 1,
                 embed_dim: Optional[List[int]] = None,
                 window_size: Optional[List[Tuple[int, int, int]]] = None,
                 depths: Optional[List[int]] = None, mlp_ratio: float = 4.0,
                 drop_rate: float = 0.0, drop_path_rate: float = 0.0,
                 patch_size: Tuple[int, int, int] = (1, 1, 1),
                 d_state: Optional[List[int]] = None,
                 d_conv: Optional[List[int]] = None,
                 expand: Optional[List[int]] = None,
                 use_checkpoint: bool = False,
                 kernel_init: Optional[Init] = reference_init(),
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        V = self.in_vars = in_vars
        embed_dim = embed_dim or [16, 16]
        window_size = window_size or [(2, 4, 4), (8, 1, 1)]
        depths = depths or [2, 1]
        d_state = d_state or [1, 1]
        d_conv = d_conv or [3, 3]
        expand = expand or [1, 1]
        self.n_layers = len(embed_dim)
        dpr = [float(v) for v in np.linspace(0, drop_path_rate, sum(depths))]
        for i in range(self.n_layers):
            lo = sum(depths[:i])
            self.add_module(f"stage{i}", PackedMambaStage(
                V, in_dim=embed_dim[i - 1] if i > 0 else in_chans,
                dim=embed_dim[i], depth=depths[i], d_state=d_state[i],
                d_conv=d_conv[i], expand=expand[i],
                patch_size=tuple(patch_size) if i == 0 else (1, 1, 1),
                window_size=tuple(window_size[i]), mlp_ratio=mlp_ratio,
                drop=drop_rate, drop_path=dpr[lo:lo + depths[i]],
                use_checkpoint=use_checkpoint, kernel_init=kernel_init,
                generator=generator, dtype=dtype))
        self.proj = GroupedProjHead(V, embed_dim[-1],
                                    kernel_init=kernel_init,
                                    generator=generator, dtype=dtype)

    def forward(self, x, train: bool = False, packed_out: bool = False,
                generator: Optional[torch.Generator] = None):
        x = pack_variables(x)
        for i in range(self.n_layers):
            x = getattr(self, f"stage{i}")(x, train, generator)
        x = self.proj(x)
        return x if packed_out else unpack_variables(x, self.in_vars)
