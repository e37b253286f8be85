# ------------------------------------------------------------------
"""Shared layers: per-variable (grouped) 3D convolution, dense and
LayerNorm on packed activations, flax's plain Dense / Conv /
ConvTranspose / LayerNorm / BatchNorm on channels-last tensors, DropPath,
dropout, the encoders' block recompute (``checkpointed``), and the
weight-init schemes.

Counterpart of idee_tpu/nn/layers.py. Layout at every module boundary is
the JAX package's: channels-last ``[N, D, H, W, C]``, and for the grouped
modules the packed ``[..., V*C]`` with variable v owning channels
``[v*C, (v+1)*C)``. Parameter shapes are the JAX package's too (per-variable
weights stacked on axis 0, e.g. ``GroupedConv3d.kernel [V, kd, kh, kw, Cin,
Cout]``), so its weights carry across unchanged. Inside, the grouped
modules are grouped ``F.conv3d`` / batched ``einsum`` over ``[..., V, C]``:
the block-diagonal dense forms of the JAX package answer the TPU's tiling
and are not ported.

Initializers fill a tensor in place from an explicit ``torch.Generator``
(``init(tensor, generator)``); modules are built on the CPU and moved.

Compute dtype (the JAX modules' ``dtype`` attribute): parameters stay
float32 and are cast to the compute dtype where they are used. A module
computes in its ``dtype``, float32 unless the model passes
``compute_dtype(cfg)`` (models/vq_model.py), which it always does.
``GroupedLayerNorm3d`` keeps the JAX package's bf16 roundings.

Under the ``space`` axis (parallel/spatial.py) the convolutions pad H
with the neighbouring ranks' rows (``halo_pad_h``: zeros or replicated
rows at the global edges only; D and W pad locally), and dropout draws
its mask at the global shape and keeps the rank's rows (``rows``), so a
rank draws what the single-device run draws there.
"""
# ------------------------------------------------------------------

import math
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from idee_tpu_torch.kernels.grouped_dense import grouped_dense
from idee_tpu_torch.parallel import spatial

Init = Callable[[torch.Tensor, Optional[torch.Generator]], None]

# stddev of a unit normal truncated at +/-2 (flax variance_scaling's
# correction for its truncated_normal distribution)
_TRUNC_STD = 0.87962566103423978


def reference_init(mean: float = 0.02, std: float = 0.02) -> Init:
    """Normal(mean, std) (reference: models/build.py:110)."""

    def init(t, generator=None):
        with torch.no_grad():
            t.normal_(mean, std, generator=generator)

    return init


def lecun_normal_init(fan_in: int) -> Init:
    """Normal(0, 1/sqrt(fan_in)) with the per-group fan-in of the stacked
    [V, ...] parameter shapes."""
    return reference_init(0.0, fan_in ** -0.5)


def trunc_normal_init(std: float = 0.02) -> Init:
    """Truncated normal at +/-2 std (timm trunc_normal_ semantics)."""

    def init(t, generator=None):
        with torch.no_grad():
            nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=generator)

    return init


def flax_default_init(fan_in: int) -> Init:
    """flax's default kernel init (lecun_normal: variance_scaling(1, fan_in,
    truncated_normal)), used by plain Conv/Dense layers when the model's
    init scheme leaves kernel_init unset."""
    return trunc_normal_init(math.sqrt(1.0 / fan_in) / _TRUNC_STD)


def rank_rows(dim: int) -> Optional[Tuple[int, int, int]]:
    """``dropout``'s ``rows`` for a tensor whose ``dim`` is the rank's H
    rows under the space axis: (dim, global H, first row); None without
    one."""
    ctx = spatial.active()
    return None if ctx is None else (dim, ctx.H, ctx.lo)


def dropout(x, rate: float, train: bool,
            generator: Optional[torch.Generator] = None,
            rows: Optional[Tuple[int, int, int]] = None):
    """Elementwise dropout drawing its mask from ``generator``. ``rows``
    (dim, total, lo): ``x`` holds rows [lo, lo + x.shape[dim]) of an axis
    of ``total``; the mask is drawn at that global shape and cut to them
    (the space axis: the single-device draws)."""
    if rate == 0.0 or not train:
        return x
    keep = 1.0 - rate
    shape = list(x.shape)
    if rows is not None:
        shape[rows[0]] = rows[1]
    mask = torch.rand(shape, generator=generator, device=x.device) < keep
    if rows is not None:
        mask = mask.narrow(rows[0], rows[2], x.shape[rows[0]])
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


def drop_path(x, rate: float, train: bool,
              generator: Optional[torch.Generator] = None):
    """Stochastic depth per sample (timm DropPath semantics)."""
    if rate == 0.0 or not train:
        return x
    keep = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    mask = torch.rand(shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


def checkpointed(block, x, train: bool = False,
                 generator: Optional[torch.Generator] = None):
    """block(x, train, generator) with its activations recomputed in the
    backward instead of kept (``torch.utils.checkpoint``; the JAX package's
    ``nn.remat`` of the encoders' blocks). The recompute draws the same
    dropout and drop-path masks: it restarts ``generator`` from its state at
    the first call and puts it back afterwards."""
    if not torch.is_grad_enabled():
        return block(x, train, generator)
    start = generator.get_state() if generator is not None else None
    calls = []

    def run(x):
        if not calls or generator is None:
            calls.append(1)
            return block(x, train, generator)
        resume = generator.get_state()
        generator.set_state(start)
        try:
            return block(x, train, generator)
        finally:
            generator.set_state(resume)

    return checkpoint(run, x, use_reentrant=False)


def check_h_conv(k: int, stride: int, lo: int, hi: int, what: str) -> None:
    """Under the space axis a convolution keeps H row for row: stride 1
    and ``lo + hi`` halo rows for a kernel of ``k`` rows (dilated)."""
    if spatial.active() is not None and (stride != 1 or lo + hi != k - 1):
        raise ValueError(
            f"{what}: kernel {k} rows, stride {stride}, H padding "
            f"({lo}, {hi}) under the space axis: only an H that keeps its "
            "rows (stride 1, 'same' padding) splits over ranks")


def _pad_channels_first(x, padding, mode: str):
    """x [N, C, D, H, W]; padding ((dlo, dhi), (hlo, hhi), (wlo, whi)).
    Under the space axis H takes the neighbours' rows (halo_pad_h)."""
    (dl, dh), (hl, hh), (wl, wh) = (tuple(p) for p in padding)
    mode = "replicate" if mode == "replicate" else "zeros"
    if spatial.active() is not None:
        x = spatial.halo_pad_h(x, 3, hl, hh, mode)
        hl = hh = 0
    pad = (wl, wh, hl, hh, dl, dh)
    if not any(pad):
        return x
    return F.pad(x, pad, mode="replicate" if mode == "replicate"
                 else "constant")


class GroupedConv3d(nn.Module):
    """Per-variable (grouped) 3D convolution on packed activations:
    [N, D, H, W, V*in_features] -> [N, D', H', W', V*features].
    Parameters kernel [V, kd, kh, kw, Cin, Cout], bias [V, Cout]."""

    def __init__(self, n_groups: int, in_features: int, features: int,
                 kernel_size: Tuple[int, int, int] = (3, 3, 3),
                 strides: Tuple[int, int, int] = (1, 1, 1),
                 padding: Sequence[Tuple[int, int]] = ((1, 1), (1, 1),
                                                       (1, 1)),
                 padding_mode: str = "zeros", use_bias: bool = True,
                 kernel_init: Optional[Init] = reference_init(),
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        kd, kh, kw = kernel_size
        self.n_groups = n_groups
        self.dtype = dtype
        self.strides = tuple(strides)
        self.padding = tuple(tuple(p) for p in padding)
        self.padding_mode = padding_mode
        self.kernel = nn.Parameter(torch.empty(n_groups, kd, kh, kw,
                                               in_features, features))
        init = kernel_init or lecun_normal_init(kd * kh * kw * in_features)
        init(self.kernel, generator)
        self.bias = (nn.Parameter(torch.zeros(n_groups, features))
                     if use_bias else None)

    def forward(self, x):
        V, kd, kh, kw, cin, cout = self.kernel.shape
        dt = self.dtype
        check_h_conv(kh, self.strides[1], *self.padding[1], "GroupedConv3d")
        xc = _pad_channels_first(x.to(dt).permute(0, 4, 1, 2, 3),
                                 self.padding, self.padding_mode)
        # [V, kd, kh, kw, Cin, Cout] -> grouped-conv weight [V*Cout, Cin, ...]
        w = self.kernel.permute(0, 5, 4, 1, 2, 3).reshape(V * cout, cin,
                                                          kd, kh, kw)
        b = (self.bias.reshape(V * cout).to(dt) if self.bias is not None
             else None)
        y = F.conv3d(xc, w.to(dt), b, stride=self.strides, groups=V)
        return y.permute(0, 2, 3, 4, 1).contiguous()


class GroupedDense(nn.Module):
    """Per-variable (unshared) Dense on packed [..., V*in] -> [..., V*out].
    Parameters kernel [V, in, out], bias [V, out]. The einsum of
    ``kernels/grouped_dense.py``; its weight and bias gradients on a card
    are that module's CUDA kernel."""

    def __init__(self, n_groups: int, in_features: int, features: int,
                 use_bias: bool = True,
                 kernel_init: Optional[Init] = reference_init(),
                 bias_init: Optional[Init] = None,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(n_groups, in_features,
                                               features))
        (kernel_init or lecun_normal_init(in_features))(self.kernel,
                                                        generator)
        if use_bias:
            self.bias = nn.Parameter(torch.zeros(n_groups, features))
            if bias_init is not None:
                bias_init(self.bias, generator)
        else:
            self.bias = None

    def forward(self, x):
        V, _, fout = self.kernel.shape
        dt = self.dtype
        b = (self.bias.reshape(V * fout).to(dt) if self.bias is not None
             else None)
        return grouped_dense(x.to(dt), self.kernel.to(dt), b)


class GroupedLayerNorm3d(nn.Module):
    """LayerNorm over each C-sized group of a packed [..., V*C] activation
    (torch nn.LayerNorm(C) per variable); affine scale/bias [V, C].

    Computes in its input's dtype and returns ``dtype``, with the JAX
    module's roundings (idee_tpu/nn/layers.py:243-281): the moments
    accumulate in float32, the mean is rounded to the input dtype
    before d = x - mu, the rsqrt is taken in float32 and rounded, and the
    affine runs in the input dtype. For float32 input every cast is the
    identity."""

    def __init__(self, n_groups: int, features: int, affine: bool = True,
                 eps: float = 1e-5, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_groups, self.features, self.eps = n_groups, features, eps
        self.dtype = dtype
        if affine:
            self.scale = nn.Parameter(torch.ones(n_groups, features))
            self.bias = nn.Parameter(torch.zeros(n_groups, features))
        else:
            self.scale = self.bias = None

    def forward(self, x):
        V, C = self.n_groups, self.features
        lead = x.shape[:-1]
        xv = x.reshape(*lead, V, C)
        f32 = torch.float32
        mu = xv.mean(-1, keepdim=True, dtype=f32).to(x.dtype)
        d = xv - mu
        # two-pass moments: no E[x^2]-mu^2 cancellation
        var = (d * d).mean(-1, keepdim=True, dtype=f32)
        y = d * torch.rsqrt(var + self.eps).to(x.dtype)
        if self.scale is not None:
            y = y * self.scale.to(x.dtype) + self.bias.to(x.dtype)
        return y.reshape(*lead, V * C).to(self.dtype)


# ------------------------------------------------------------------
# flax's plain layers, for the baselines (idee_tpu/baselines/): Dense,
# Conv, ConvTranspose, LayerNorm and BatchNorm on channels-last
# activations with flax's semantics and parameter names


def xavier_init(fan_in: int, fan_out: int, uniform: bool = False) -> Init:
    """flax xavier_normal (truncated) or xavier_uniform: variance
    2 / (fan_in + fan_out)."""
    var = 2.0 / (fan_in + fan_out)
    if not uniform:
        return trunc_normal_init(math.sqrt(var) / _TRUNC_STD)
    return uniform_init(-math.sqrt(3.0 * var), math.sqrt(3.0 * var))


def uniform_init(low: float, high: float) -> Init:
    def init(t, generator=None):
        with torch.no_grad():
            t.uniform_(low, high, generator=generator)

    return init


class Dense(nn.Module):
    """flax nn.Dense: y = x @ kernel + bias, kernel [in, out] (the JAX
    layout, no transpose across). With a ``dtype`` x, kernel and bias are
    cast to it (flax's ``dtype=``); without one the float32 parameters
    meet x as it comes (the caller promotes a bf16 x, as flax does)."""

    def __init__(self, in_features: int, features: int,
                 use_bias: bool = True, kernel_init: Optional[Init] = None,
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(in_features, features))
        (kernel_init or flax_default_init(in_features))(self.kernel,
                                                        generator)
        self.bias = (nn.Parameter(torch.zeros(features)) if use_bias
                     else None)

    def forward(self, x):
        dt = self.dtype
        if dt is None:
            y = x @ self.kernel
            return y + self.bias if self.bias is not None else y
        y = x.to(dt) @ self.kernel.to(dt)
        return y + self.bias.to(dt) if self.bias is not None else y


def same_padding(size: int, k: int, stride: int, dilation: int = 1):
    """flax/lax "SAME" padding of one spatial dim: (lo, hi)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + (k - 1) * dilation + 1 - size, 0)
    return total // 2, total - total // 2


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


class Conv(nn.Module):
    """flax nn.Conv on channels-last [N, *spatial, Cin] with 1-3 spatial
    dims: strides, kernel_dilation, feature_group_count and padding
    "SAME" or explicit (lo, hi) pairs, computed in ``dtype``. Weight in
    torch's layout [Cout, Cin/groups, *k] (flax's kernel [*k, Cin/groups,
    Cout] transposed, ``models/interop.py``)."""

    def __init__(self, in_features: int, features: int, kernel_size,
                 strides=None, padding="SAME", kernel_dilation=None,
                 groups: int = 1, use_bias: bool = True,
                 kernel_init: Optional[Init] = None,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        k = tuple(kernel_size)
        nd = len(k)
        self.kernel_size = k
        self.strides = tuple(strides or (1,) * nd)
        self.dilation = tuple(kernel_dilation or (1,) * nd)
        self.padding = padding
        self.groups = groups
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features,
                                               in_features // groups, *k))
        (kernel_init or flax_default_init(
            math.prod(k) * in_features // groups))(self.weight, generator)
        self.bias = (nn.Parameter(torch.zeros(features)) if use_bias
                     else None)

    def _pads(self, sizes):
        if self.padding == "SAME":
            return [same_padding(n, k, s, d) for n, k, s, d in zip(
                sizes, self.kernel_size, self.strides, self.dilation)]
        return [tuple(p) for p in self.padding]

    def forward(self, x):
        nd, dt = len(self.kernel_size), self.dtype
        xc = x.to(dt).movedim(-1, 1)
        pads = self._pads(x.shape[1:-1])
        if spatial.active() is not None and nd >= 2:
            # H, the second-to-last spatial dim, takes the neighbours'
            # rows
            h = nd - 2
            check_h_conv((self.kernel_size[h] - 1) * self.dilation[h] + 1,
                         self.strides[h], *pads[h], "Conv")
            xc = spatial.halo_pad_h(xc, 2 + h, *pads[h])
            pads[h] = (0, 0)
        pad = [p for lo_hi in reversed(pads) for p in lo_hi]
        if any(pad):
            xc = F.pad(xc, pad)
        b = self.bias.to(dt) if self.bias is not None else None
        y = _CONV[nd](xc, self.weight.to(dt), b, stride=self.strides,
                      dilation=self.dilation, groups=self.groups)
        return y.movedim(1, -1).contiguous()


class ConvTranspose(nn.Module):
    """flax nn.ConvTranspose (transpose_kernel=False, padding "SAME") on
    channels-last [N, *spatial, Cin]: the input dilated by the strides,
    padded as lax.conv_transpose pads it, then correlated with the kernel
    (no flip); out = in * stride. Weight [Cout, Cin, *k] (flax's kernel
    [*k, Cin, Cout] transposed); torch's conv_transpose runs it with the
    kernel flipped and the extra trailing rows cropped."""

    def __init__(self, in_features: int, features: int, kernel_size,
                 strides=None, use_bias: bool = True,
                 kernel_init: Optional[Init] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        k = tuple(kernel_size)
        self.kernel_size = k
        self.strides = tuple(strides or (1,) * len(k))
        self.weight = nn.Parameter(torch.empty(features, in_features, *k))
        (kernel_init or flax_default_init(math.prod(k) * in_features))(
            self.weight, generator)
        self.bias = (nn.Parameter(torch.zeros(features)) if use_bias
                     else None)

    def forward(self, x):
        nd = len(self.kernel_size)
        pad_lo = []
        for k, s in zip(self.kernel_size, self.strides):
            # lax _conv_transpose_padding, "SAME"
            pad_lo.append(k - 1 if s > k - 1 else -(-(k + s - 2) // 2))
        w = self.weight.transpose(0, 1).flip(list(range(2, 2 + nd)))
        y = _CONV_T[nd](x.movedim(-1, 1), w, self.bias, stride=self.strides,
                        padding=[k - 1 - p for k, p in
                                 zip(self.kernel_size, pad_lo)])
        out = [n * s for n, s in zip(x.shape[1:-1], self.strides)]
        y = y[(slice(None), slice(None)) + tuple(slice(0, n) for n in out)]
        return y.movedim(1, -1)


def _fast_moments(x, dims):
    """flax's float32 moments: mean and E[x^2] - mean^2 clamped at 0."""
    xf = x.float()
    mean = xf.mean(dims)
    var = torch.clamp((xf * xf).mean(dims) - mean * mean, min=0.0)
    return mean, var


class LayerNorm(nn.Module):
    """flax nn.LayerNorm over the last axis (epsilon 1e-6 unless given, the
    moments as flax takes them); parameters ``scale`` and ``bias``, none
    without ``affine``."""

    EPS = 1e-6

    def __init__(self, features: int, scale_init: float = 1.0,
                 eps: float = EPS, affine: bool = True):
        super().__init__()
        self.eps = eps
        if affine:
            self.scale = nn.Parameter(torch.full((features,), scale_init))
            self.bias = nn.Parameter(torch.zeros(features))
        else:
            self.scale = self.bias = None

    def forward(self, x):
        mean, var = _fast_moments(x, -1)
        mul = torch.rsqrt(var + self.eps)[..., None]
        if self.scale is None:
            return (x - mean[..., None]) * mul
        return (x - mean[..., None]) * (mul * self.scale) + self.bias


class BatchNorm(nn.Module):
    """flax nn.BatchNorm over every axis but the last (the features).

    In training it normalises with the batch's float32 moments, the
    variance E[x^2] - E[x]^2 (biased, clamped at 0), and moves the running
    statistics as flax does: mean <- m * mean + (1 - m) * batch mean,
    var <- m * var + (1 - m) * batch var, with flax's momentum m (0.9 is
    torch's 0.1) and the biased variance, where torch's BatchNorm keeps
    the unbiased one. In evaluation it normalises with the running
    statistics. y = (x - mean) * (rsqrt(var + eps) * scale) + bias, eps
    1e-5.
    Parameters ``scale`` and ``bias``, buffers ``mean`` and ``var`` (the
    "batch_stats" collection)."""

    MOMENTUM, EPS = 0.9, 1e-5  # every baseline's nn.BatchNorm

    def __init__(self, features: int, scale_init: float = 1.0):
        super().__init__()
        self.scale = nn.Parameter(torch.full((features,), scale_init))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x, train: bool = False):
        if train:
            mean, var = _fast_moments(x, tuple(range(x.dim() - 1)))
            m = self.MOMENTUM
            with torch.no_grad():
                self.mean.copy_(m * self.mean + (1.0 - m) * mean)
                self.var.copy_(m * self.var + (1.0 - m) * var)
        else:
            mean, var = self.mean, self.var
        return (x - mean) * (torch.rsqrt(var + self.EPS) * self.scale) \
            + self.bias
