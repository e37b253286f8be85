# ------------------------------------------------------------------
"""The per-variable Dense layer (``nn/layers.py::GroupedDense``) with its
weight and bias gradients as a hand-written CUDA kernel.

``grouped_dense(x, w, b)`` is the layer's einsum, ``[..., V*I] x [V, I,
O] -> [..., V*O]`` plus the bias, on every device. On a CUDA tensor whose
gradient is wanted it runs as ``GroupedDenseFunction``: the same einsum
forward, bit for bit; in the backward, dx by the einsum (cuBLAS, as
autograd of the einsum computes it) and dW and db by
``csrc/grouped_wgrad.cu`` (two launches: per-chunk float32 partials, then
their ordered sum). On a CPU tensor the layer stays the plain einsum under
autograd; the Function itself computes dW and db there with the plain
version (``grouped_wgrad_plain``: float64 sums rounded once), for the
tests. ``grouped_dense_reference`` takes that plain weight gradient on
every device: the plain side that a whole step's gradients are held to.

The kernel's splits come from ``wgrad_plan``, a function of the shape
alone, so one shape always sums in one order: the gradient is the same
bits from run to run and a CUDA graph can capture the launches.
"""
# ------------------------------------------------------------------

import ctypes
from dataclasses import dataclass
from typing import Dict, Optional

import torch

from idee_tpu_torch.kernels import build
from idee_tpu_torch.kernels.window_attention import dbias_sum_shape

GROUPED_WGRAD = "grouped_wgrad"
GROUPED_WGRAD_SUM = "grouped_wgrad_sum"
SOURCES = {GROUPED_WGRAD: "grouped_wgrad", GROUPED_WGRAD_SUM: "grouped_wgrad"}

# launches of each CUDA kernel in this process; the plain CPU versions do
# not count. A step captured in a CUDA graph counts once per replay, not at
# its capture (train/steps.py::FusedEpoch)
launches: Dict[str, int] = {GROUPED_WGRAD: 0, GROUPED_WGRAD_SUM: 0}

# input dtypes whose weight gradient runs on the kernel
KERNEL_DTYPES = (torch.float32, torch.bfloat16)

# the plan's constants (csrc/grouped_wgrad.cu: kStages, kMaxThreads): the
# H100's SMs and the blocks a chunk split aims to put on each, the bytes of
# one shared-memory tile of x and dy rows, the most token groups
_SMS = 132
_BLOCKS_PER_SM = 2
_STAGES = 3
_STAGE_BYTES = 32 * 1024
_MAX_TILE = 128
_MAX_THREADS = 512
_MAX_GROUPS = 16
_SMEM_LIMIT = 232_448
_RED_STRIDE = 17

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SIGNATURES = {
    GROUPED_WGRAD: ("idee_grouped_wgrad",
                    [_P, _P, _P, _I64, _I, _I, _I, _I, _I, _I, _I, _I64, _I,
                     _I, _I, _P]),
    GROUPED_WGRAD_SUM: ("idee_grouped_wgrad_sum",
                        [_P, _P, _P, _I, _I64, _I64, _I, _I, _I, _P]),
}


@dataclass(frozen=True)
class WgradPlan:
    """How the kernel splits one weight gradient. Pass 1: ``n_chunks`` x
    ``y_groups`` blocks of ``threads``; block (c, y) sums tokens [c
    chunk_len, (c + 1) chunk_len) in tiles of ``tile`` tokens (the last one
    of a chunk may be short), ``groups``
    threads per block of outputs taking every groups-th token of a tile;
    ``units`` 4x4 output blocks (then bias quads) a block. Pass 2: blocks
    of ``sum_out`` outputs x ``sum_runs`` ordered runs of the chunks."""
    tile: int
    groups: int
    units: int
    y_groups: int
    chunk_len: int
    n_chunks: int
    threads: int
    smem_bytes: int
    sum_out: int
    sum_runs: int
    E: int


def _align16(n: int) -> int:
    return -(-n // 16) * 16


def wgrad_plan(M: int, V: int, I: int, O: int, has_bias: bool,
               elem_bytes: int) -> WgradPlan:
    """The kernel's splits for x [M, V*I] and dy [M, V*O] of
    ``elem_bytes`` bytes an element: a pure function of the shape."""
    if min(M, V, I, O) < 1:
        raise ValueError(f"grouped_wgrad: empty shape M={M}, V={V}, I={I}, "
                         f"O={O}")
    nb = -(-O // 4)
    n_units = V * -(-I // 4) * nb + (V * nb if has_bias else 0)
    units = min(n_units, _MAX_THREADS)
    y_groups = -(-n_units // units)
    groups = 1
    while units * 2 * groups <= _MAX_THREADS and 2 * groups <= _MAX_GROUPS:
        groups *= 2
    row_bytes = V * (I + O) * elem_bytes
    tile = max(8, min(_MAX_TILE, _STAGE_BYTES // row_bytes // 8 * 8))
    stage = (_align16(tile * V * I * elem_bytes)
             + _align16(tile * V * O * elem_bytes))
    red = groups * units * _RED_STRIDE * 4 if groups > 1 else 0
    smem = max(_STAGES * stage, red)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"grouped_wgrad: rows of V*(I+O) = {V * (I + O)} "
                         f"elements need {smem} B of shared memory, over "
                         f"{_SMEM_LIMIT}")
    # chunks start on multiples of 8 tokens (16-byte aligned rows); the
    # last tile of a chunk may be short
    target = max(1, -(-_SMS * _BLOCKS_PER_SM // y_groups))
    chunk_len = -(-(-(-M // target)) // 8) * 8
    n_chunks = -(-M // chunk_len)
    E = V * I * O + (V * O if has_bias else 0)
    # pass 2 is the dbias sum's design, on the chunks' partials
    sum_out, runs = dbias_sum_shape(n_chunks, E)
    return WgradPlan(tile=tile, groups=groups, units=units,
                     y_groups=y_groups, chunk_len=chunk_len,
                     n_chunks=n_chunks,
                     threads=-(-units * groups // 32) * 32, smem_bytes=smem,
                     sum_out=sum_out, sum_runs=runs, E=E)


# ---------------------------------------------------------------- plain

def grouped_dense_plain(x, w, b=None):
    """The layer's einsum: x [..., V*I], w [V, I, O], b [V*O] or None ->
    [..., V*O], in the inputs' dtype."""
    V, fin, fout = w.shape
    lead = x.shape[:-1]
    y = torch.einsum("...vi,vio->...vo", x.reshape(*lead, V, fin),
                     w).reshape(*lead, V * fout)
    if b is not None:
        y = y + b
    return y


def grouped_wgrad_plain(x, gy, V: int, has_bias: bool):
    """Plain PyTorch weight (and bias) gradient: x [..., V*I], gy [...,
    V*O] -> (dW [V, I, O], db [V*O] or None), float64 sums rounded once to
    the inputs' dtype: the exact sums that the kernel's float32 sums
    approach."""
    x3 = x.double().reshape(-1, V, x.shape[-1] // V)
    g3 = gy.double().reshape(-1, V, gy.shape[-1] // V)
    dw = torch.einsum("mvi,mvo->vio", x3, g3).to(x.dtype)
    db = g3.sum(0).reshape(-1).to(x.dtype) if has_bias else None
    return dw, db


# ---------------------------------------------------------------- kernel

def _launch(kernel: str, device: torch.device, *args):
    fn = build.c_function(SOURCES[kernel], *_SIGNATURES[kernel])
    build.call(fn, kernel, device, args)
    launches[kernel] += 1


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t contiguous, its data on a 16-byte boundary (the kernel's vector
    copies need it)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def grouped_wgrad(x, gy, V: int, has_bias: bool):
    """dW [V, I, O] (and db [V*O] with a bias, else None) of the layer
    y = grouped_dense(x, w[, b]) for x [..., V*I] and the output gradient
    gy [..., V*O]: the CUDA kernel on a card, the plain version on the CPU.
    The gradients have the inputs' dtype (float32 sums, rounded once)."""
    if x.shape[:-1] != gy.shape[:-1]:
        raise ValueError(f"x {tuple(x.shape)} and gy {tuple(gy.shape)} "
                         f"differ in their leading axes")
    if x.shape[-1] % V or gy.shape[-1] % V:
        raise ValueError(f"x {tuple(x.shape)}, gy {tuple(gy.shape)}: the "
                         f"last axes are not V = {V} groups")
    if x.dtype != gy.dtype or x.device != gy.device:
        raise ValueError(f"x ({x.dtype}, {x.device}) and gy ({gy.dtype}, "
                         f"{gy.device}) differ")
    I, O = x.shape[-1] // V, gy.shape[-1] // V
    x2 = x.reshape(-1, V * I)
    g2 = gy.reshape(-1, V * O)
    if x.device.type == "cpu":
        return grouped_wgrad_plain(x2, g2, V, has_bias)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if x.dtype not in KERNEL_DTYPES:
        raise ValueError(f"grouped_wgrad: no kernel for {x.dtype}")
    M = x2.shape[0]
    p = wgrad_plan(M, V, I, O, has_bias, x.element_size())
    dw = torch.empty(V, I, O, dtype=x.dtype, device=x.device)
    db = (torch.empty(V * O, dtype=x.dtype, device=x.device) if has_bias
          else None)
    part = torch.empty(p.n_chunks, p.E, dtype=torch.float32,
                       device=x.device)
    bf16 = int(x.dtype == torch.bfloat16)
    _launch(GROUPED_WGRAD, x.device, _aligned(x2), _aligned(g2), part, M,
            V, I, O, int(has_bias), p.tile, p.groups, p.units, p.chunk_len,
            p.n_chunks, p.y_groups, bf16)
    _launch(GROUPED_WGRAD_SUM, x.device, part, dw, db, p.n_chunks, p.E,
            V * I * O, p.sum_out, p.sum_runs, bf16)
    return dw, db


# ---------------------------------------------------------------- layer

def _dense_backward(ctx, gy, wgrad):
    x, w = ctx.saved_tensors
    need_x, need_w, need_b = ctx.needs_input_grad
    dx = dw = db = None
    if need_x:
        dx = grouped_dense_plain(gy, w.transpose(1, 2))
    if need_w or need_b:
        dw, db = wgrad(x, gy, w.shape[0], ctx.has_bias)
    return dx, (dw if need_w else None), (db if need_b else None)


class GroupedDenseFunction(torch.autograd.Function):
    """grouped_dense_plain with the weight gradient of the kernel: saves x
    and w, as autograd of the einsum does."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        ctx.has_bias = b is not None
        return grouped_dense_plain(x, w, b)

    @staticmethod
    def backward(ctx, gy):
        return _dense_backward(ctx, gy, grouped_wgrad)


class PlainGroupedDenseFunction(GroupedDenseFunction):
    """GroupedDenseFunction with the plain weight gradient on every device
    (``grouped_wgrad_plain``): the plain side that a step's gradients with
    the kernel are held to. Autograd of the einsum is no such yardstick at
    the bench's 320,000 tokens: cuBLAS's blocks each walk all the tokens in
    one float32 sum, whose rounding outweighs the kernel's."""

    @staticmethod
    def backward(ctx, gy):
        return _dense_backward(ctx, gy, grouped_wgrad_plain)


def grouped_dense(x, w, b: Optional[torch.Tensor] = None):
    """y [..., V*O] = the per-variable product of x [..., V*I] with w [V,
    I, O], plus b [V*O]: the einsum, whose weight gradient on a card is
    the kernel (``GroupedDenseFunction``); on the CPU, or with no gradient
    wanted, the einsum under autograd."""
    wants_grad = torch.is_grad_enabled() and (
        x.requires_grad or w.requires_grad
        or (b is not None and b.requires_grad))
    if (wants_grad and x.device.type == "cuda"
            and x.dtype in KERNEL_DTYPES):
        return GroupedDenseFunction.apply(x, w, b)
    return grouped_dense_plain(x, w, b)


def grouped_dense_reference(x, w, b: Optional[torch.Tensor] = None):
    """grouped_dense with the plain weight gradient wherever a gradient is
    wanted, on every device (``PlainGroupedDenseFunction``)."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, w, b)):
        return PlainGroupedDenseFunction.apply(x, w, b)
    return grouped_dense_plain(x, w, b)
