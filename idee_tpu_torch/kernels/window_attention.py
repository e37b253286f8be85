# ------------------------------------------------------------------
"""Window attention of the Swin_3D encoder, with its gradient.

Counterpart of idee_tpu/kernels/window_attention.py. Per window and head,
softmax(q k^T * scale + bias[g] + mask[w mod nW]) v, as hand-written CUDA
kernels built by ``kernels/build.py``: for float32 q, k, v in
``csrc/window_attention.cu``

  * the forward (``_fwd_kernel`` of the TPU package);
  * the backward (``_bwd_kernel``): dq, dk, dv and per-block partial sums of
    the bias gradient;
  * the sum of those partials, in a fixed order, into dbias: a launch of
    its own, so the bias gradient takes no float atomics and two runs give
    the same bits (``dbias_sum``; ``dbias_sum_plain`` adds in the same
    order);

and for bfloat16 q, k, v (the compute dtype "bfloat16") a forward and a
backward on the tensor cores in ``csrc/window_attention_bf16.cu``
(``window_attention_fwd_bf16``, ``window_attention_bwd_bf16``: mma.sync of
bf16 operands with float32 sums; the forward's p as hi + lo bf16 pairs,
the backward's p and ds as hi + mid + lo, all 24 bits of their float32
values), whose dbias partials go through the same float32 sum.

``window_attention`` is a ``torch.autograd.Function``: its forward saves q,
k, v, bias and the output, its backward is the backward kernels; bias gets
a gradient, the mask is a constant. On a CUDA tensor it launches the
kernels or raises; on a CPU tensor it runs the plain versions
(``window_attention_fwd_plain``, the JAX package's ``_xla_impl`` in torch,
and ``window_attention_bwd_plain``, the backward's formulas in torch ops),
which are also what the tests and ``chip_smoke.py`` hold the kernels
against.

Layout: q, k, v [BW, n, G, hd] with the window index batch-major then
window-minor (``nn/swin3d.py::window_partition``), G = variables x heads
(V-major), bias [G, n, n] float32. The mask is None, a (bank [K, n, n],
idx [nW]) pair (window w uses bank[idx[w % nW]]; ``nn/swin3d.py::
compute_shift_mask``), or a dense [nW, n, n] float32 tensor.

q, k, v are float32, or bfloat16 with a float32 bias, as the TPU kernels
take the input dtype. Their dtype picks the kernels; each output is
rounded once to q's dtype, and dbias and the dbias sum stay float32. At
bf16 the plain versions upcast, run the float32 math and round the
outputs, and the backward's D_i = sum_j p_ij dp_ij is formed from the
recomputed scores (JAX's ``_bwd_kernel``), not from the rounded output.
"""
# ------------------------------------------------------------------

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from idee_tpu_torch.kernels import build

ATTN_FWD = "window_attention_fwd"
ATTN_BWD = "window_attention_bwd"
ATTN_FWD_BF16 = "window_attention_fwd_bf16"
ATTN_BWD_BF16 = "window_attention_bwd_bf16"
DBIAS_SUM = "window_attention_dbias_sum"
# the csrc/<source>.cu of each kernel
SOURCES = {ATTN_FWD: "window_attention", ATTN_BWD: "window_attention",
           DBIAS_SUM: "window_attention",
           ATTN_FWD_BF16: "window_attention_bf16",
           ATTN_BWD_BF16: "window_attention_bf16"}

# launches of each CUDA kernel in this process; the plain CPU versions do
# not count. A step captured in a CUDA graph counts once per replay, not at
# its capture (train/steps.py::FusedEpoch)
launches: Dict[str, int] = {name: 0 for name in SOURCES}

# the forward and backward kernels by the dtype of q, k and v
KERNELS = {torch.float32: (ATTN_FWD, ATTN_BWD),
           torch.bfloat16: (ATTN_FWD_BF16, ATTN_BWD_BF16)}

# head widths the kernels are instantiated for, and the largest window
HEAD_DIMS = (4, 8, 16)
MAX_TOKENS = 128
# blocks per head of the backward: each writes one [n, n] partial of dbias
# per head, so this bounds the partials' memory (~2,000 blocks in all keep
# every SM busy at the bench width)
_BWD_BLOCKS = 2048
# the dbias sum's grid (dbias_sum_shape): the H100's SMs, the threads it
# aims to keep in flight, the fewest partials a chunk sums
_SMS = 132
_SUM_THREADS = 65_536
_SUM_MIN_CHUNK = 8

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # symbol, argtypes
    ATTN_FWD: ("idee_window_attention_fwd",
               [_P] * 7 + [_I] * 5 + [_F, _P]),
    ATTN_BWD: ("idee_window_attention_bwd",
               [_P] * 12 + [_I] * 6 + [_F, _P]),
    ATTN_FWD_BF16: ("idee_window_attention_fwd_bf16",
                    [_P] * 7 + [_I] * 5 + [_F, _P]),
    # no saved output: the bf16 backward forms D from the scores
    ATTN_BWD_BF16: ("idee_window_attention_bwd_bf16",
                    [_P] * 11 + [_I] * 6 + [_F, _P]),
    DBIAS_SUM: ("idee_window_attention_dbias_sum",
                [_P, _P, _I, ctypes.c_int64, _I, _I, _P]),
}

Mask = Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]


def _launch(kernel: str, device: torch.device, *args):
    fn = build.c_function(SOURCES[kernel], *_SIGNATURES[kernel])
    build.call(fn, kernel, device, args)
    launches[kernel] += 1


def _mask_parts(mask, BW: int, n: int, device) -> Mask:
    """(bank [K, n, n] float32, idx [nW] int32), or (None, None)."""
    if mask is None:
        return None, None
    if isinstance(mask, (tuple, list)):
        bank, idx = mask
    else:  # dense [nW, n, n]: every window its own bank row
        bank = mask
        idx = torch.arange(mask.shape[0], device=mask.device)
    if bank.dim() != 3 or tuple(bank.shape[1:]) != (n, n):
        raise ValueError(f"mask bank must be [K, {n}, {n}], got "
                         f"{tuple(bank.shape)}")
    if bank.dtype != torch.float32:
        raise ValueError(f"mask bank: expected float32, got {bank.dtype}")
    if idx.dim() != 1 or idx.dtype not in (torch.int32, torch.int64):
        raise ValueError("mask idx must be a 1-D integer tensor")
    if bank.device != device or idx.device != device:
        raise ValueError(f"the mask must lie on {device}")
    if BW % idx.shape[0] != 0:
        raise ValueError(f"{BW} windows are not a multiple of the mask's "
                         f"{idx.shape[0]}")
    return bank.contiguous(), idx.to(torch.int32).contiguous()


def _check(q, k, v, bias):
    if q.dim() != 4:
        raise ValueError(f"q must be [BW, n, G, hd], got {tuple(q.shape)}")
    if q.dtype not in KERNELS:
        raise ValueError(f"q: expected float32 or bfloat16, got {q.dtype}")
    BW, n, G, hd = q.shape
    for name, t, shape, dtype in (
            ("q", q, q.shape, q.dtype), ("k", k, q.shape, q.dtype),
            ("v", v, q.shape, q.dtype),
            ("bias", bias, (G, n, n), torch.float32)):
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                             f"{tuple(t.shape)}")
        if t.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype} (q is {q.dtype}), "
                             f"got {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, not {q.device}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {q.device}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head width {hd}: the kernels take {HEAD_DIMS}")
    if not 1 <= n <= MAX_TOKENS:
        raise ValueError(f"{n} tokens per window: the kernels take 1 to "
                         f"{MAX_TOKENS}")
    if BW * n * G * hd >= 2 ** 31 or G > 65535:
        raise ValueError(f"shape {tuple(q.shape)} is too large for the "
                         "kernels' 32-bit window and head indices")


# ---------------------------------------------------------------- plain

def _scores(q, k, bias, bank, idx, scale):
    """[BW, G, n, n] softmax input."""
    BW, n, G, _ = q.shape
    s = torch.einsum("bngd,bmgd->bgnm", q * scale, k) + bias[None]
    if bank is not None:
        m = bank[idx.long()]                                # [nW, n, n]
        nW = m.shape[0]
        s = (s.reshape(BW // nW, nW, G, n, n) + m[None, :, None]).reshape(
            BW, G, n, n)
    return s


def window_attention_fwd_plain(q, k, v, bias, mask, scale: float):
    """Plain PyTorch version of the forward kernel (the JAX package's
    ``_xla_impl``): [BW, n, G, hd] in q's dtype. At bfloat16 the inputs
    are upcast, the float32 math runs, and the output is rounded once."""
    bank, idx = _mask_parts(mask, q.shape[0], q.shape[1], q.device)
    dtype = q.dtype
    q, k, v = (t.float() for t in (q, k, v))
    p = torch.softmax(_scores(q, k, bias, bank, idx, scale), dim=-1)
    return torch.einsum("bgnm,bmgd->bngd", p, v).to(dtype)


def window_attention_bwd_plain(q, k, v, bias, mask, scale: float, o, g):
    """Plain PyTorch version of the backward kernels: (dq, dk, dv, dbias)
    from the output ``o`` and its gradient ``g``, by the explicit formulas
    dp = g v^T, ds = p (dp - D), dq = scale ds k, dk = scale ds^T q,
    dv = p^T g, dbias = sum over windows of ds, with D = rowsum(g o). At
    bfloat16 the inputs are upcast, D = rowsum(dp p) in float32 (``o`` is
    not read: its rounding would enter every ds, then dbias), and dq, dk,
    dv are rounded once; dbias stays float32."""
    bank, idx = _mask_parts(mask, q.shape[0], q.shape[1], q.device)
    dtype = q.dtype
    q, k, v, g = (t.float() for t in (q, k, v, g))
    p = torch.softmax(_scores(q, k, bias, bank, idx, scale), dim=-1)
    dp = torch.einsum("bngd,bmgd->bgnm", g, v)
    if dtype == torch.float32:
        delta = (g * o).sum(-1).permute(0, 2, 1)[..., None]  # [BW, G, n, 1]
    else:
        delta = (dp * p).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    dq = scale * torch.einsum("bgnm,bmgd->bngd", ds, k)
    dk = scale * torch.einsum("bgnm,bngd->bmgd", ds, q)
    dv = torch.einsum("bgnm,bngd->bmgd", p, g)
    return dq.to(dtype), dk.to(dtype), dv.to(dtype), ds.sum(0)


@functools.lru_cache(maxsize=64)
def dbias_sum_shape(n_blocks: int, E: int) -> Tuple[int, int]:
    """(outputs per block, chunks) of the dbias sum over part [n_blocks,
    E]: a pure function of the shape, so a sum always adds in the same
    order. Outputs per block halve from 32 (a warp's 128-byte row) while
    the blocks would not cover the SMs; chunks of the partial axis double
    while the grid stays under _SUM_THREADS threads and each chunk keeps
    _SUM_MIN_CHUNK partials."""
    out = 32
    while out > 4 and -(-E // out) < _SMS:
        out //= 2
    chunks = 1
    while (out * chunks < 1024 and E * chunks < _SUM_THREADS
           and n_blocks // (2 * chunks) >= _SUM_MIN_CHUNK):
        chunks *= 2
    return out, chunks


def dbias_sum_plain(part):
    """Plain PyTorch version of the dbias sum, [n_blocks, ...] -> [...],
    adding in the kernel's order: the partials split into ``chunks`` runs
    of ceil(n_blocks / chunks), each summed from 0 in partial order, then
    the run sums added in run order."""
    n_blocks = part.shape[0]
    _, chunks = dbias_sum_shape(n_blocks, part.numel() // n_blocks)
    run = -(-n_blocks // chunks)
    total = None
    for c in range(chunks):
        s = torch.zeros_like(part[0])
        for b in range(c * run, min((c + 1) * run, n_blocks)):
            s = s + part[b]
        total = s if total is None else total + s
    return total


# ---------------------------------------------------------------- dispatch

def bwd_blocks(BW: int, n: int, G: int) -> int:
    """Blocks per head of the backward kernel, hence partials of dbias: at
    most one per group of MAX_TOKENS // n windows (the kernel's windows per
    block), and about _BWD_BLOCKS over all heads."""
    return max(1, min(-(-BW // (MAX_TOKENS // n)), -(-_BWD_BLOCKS // G)))


def _forward(q, k, v, bias, bank, idx, scale: float):
    """The output, no gradient: the kernel on a card, the plain version on
    the CPU."""
    if q.device.type == "cpu":
        with torch.no_grad():
            return window_attention_fwd_plain(q, k, v, bias, (bank, idx)
                                              if bank is not None else None,
                                              scale)
    BW, n, G, hd = q.shape
    o = torch.empty_like(q)
    nW = idx.shape[0] if idx is not None else 1
    _launch(KERNELS[q.dtype][0], q.device, q, k, v, bias, bank, idx, o, BW,
            n, G, hd, nW, float(scale))
    return o


def _backward(q, k, v, bias, bank, idx, scale: float, o, g):
    if q.device.type == "cpu":
        return window_attention_bwd_plain(
            q, k, v, bias, (bank, idx) if bank is not None else None, scale,
            o, g)
    BW, n, G, hd = q.shape
    g = _aligned(g)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    n_blocks = bwd_blocks(BW, n, G)
    part = torch.empty((n_blocks, G, n, n), device=q.device)
    nW = idx.shape[0] if idx is not None else 1
    saved = (o,) if q.dtype == torch.float32 else ()
    _launch(KERNELS[q.dtype][1], q.device, q, k, v, bias, bank, idx, *saved,
            g, dq, dk, dv, part, BW, n, G, hd, nW, n_blocks, float(scale))
    return dq, dk, dv, dbias_sum(part)


def dbias_sum(part):
    """The sum of part [n_blocks, ...] over its first axis, in
    dbias_sum_plain's order: the kernel on a card, the plain version on
    the CPU."""
    if part.device.type == "cpu":
        return dbias_sum_plain(part)
    if part.device.type != "cuda" or part.dtype != torch.float32:
        raise ValueError(f"dbias sum: no kernel for {part.dtype} on "
                         f"{part.device}")
    n_blocks = part.shape[0]
    E = part.numel() // n_blocks
    dbias = part.new_empty(part.shape[1:])
    _launch(DBIAS_SUM, part.device, part, dbias, n_blocks, E,
            *dbias_sum_shape(n_blocks, E))
    return dbias


def _occupancy(kernel: str, n: int, hd: int,
               masked: bool) -> Tuple[int, int]:
    fn = build.c_function(
        SOURCES[kernel], f"{_SIGNATURES[kernel][0]}_occupancy",
        [_I, _I, _I, ctypes.POINTER(_I), ctypes.POINTER(_I)])
    smem, blocks = _I(), _I()
    torch.cuda.current_device()  # initialises the card's context
    err = fn(n, hd, int(masked), ctypes.byref(smem), ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"occupancy query failed: cudaError {err}")
    return smem.value, blocks.value


def fwd_occupancy(n: int, hd: int, masked: bool,
                  dtype: torch.dtype = torch.float32) -> Tuple[int, int]:
    """(shared-memory bytes per block, resident blocks per SM) of the
    forward kernel for q, k, v of ``dtype`` at window n and head width hd,
    as the current card's occupancy calculator gives them (the bf16 one:
    for G >= the heads of its work item, 12 at the stage shapes; the mask
    changes neither). Launches nothing."""
    return _occupancy(KERNELS[dtype][0], n, hd, masked)


def bwd_occupancy(n: int, hd: int, masked: bool,
                  dtype: torch.dtype = torch.float32) -> Tuple[int, int]:
    """The same for the backward kernel."""
    return _occupancy(KERNELS[dtype][1], n, hd, masked)


def bf16_registers(n: int, hd: int) -> Tuple[int, int]:
    """Registers per thread of the bf16 forward and backward kernels at
    window n and head width hd, as cudaFuncGetAttributes reads them from
    the built library. Launches nothing."""
    out = []
    for kernel in (ATTN_FWD_BF16, ATTN_BWD_BF16):
        fn = build.c_function(
            SOURCES[kernel], f"{_SIGNATURES[kernel][0]}_registers",
            [_I, _I, ctypes.POINTER(_I)])
        regs = _I()
        torch.cuda.current_device()  # initialises the card's context
        err = fn(n, hd, ctypes.byref(regs))
        if err != 0:
            raise RuntimeError(f"register query failed: cudaError {err}")
        out.append(regs.value)
    return out[0], out[1]


class _WindowAttention(torch.autograd.Function):
    """window_attention with the backward kernels as its VJP (JAX's
    custom_vjp around ``_fwd_pallas`` / ``_bwd_pallas``)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, bank, idx, scale):
        o = _forward(q, k, v, bias, bank, idx, scale)
        # only the float32 backward reads o (D = rowsum(g o)); the bf16 one
        # forms D from the scores
        ctx.save_for_backward(q, k, v, bias,
                              o if q.dtype == torch.float32 else None,
                              bank, idx)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, o, bank, idx = ctx.saved_tensors
        dq, dk, dv, dbias = _backward(q, k, v, bias, bank, idx, ctx.scale,
                                      o, g.contiguous())
        return dq, dk, dv, dbias, None, None, None


def _aligned(t):
    """``t`` contiguous, starting 16-byte aligned on a card (the kernels
    move rows as a float4, or bf16 rows in 16-byte pieces, 8 at hd = 4,
    and a row starts at a multiple of hd >= 4 elements): a misaligned view
    is copied."""
    t = t.contiguous()
    if t.device.type == "cuda" and t.data_ptr() % 16 != 0:
        t = t.clone()
    return t


def window_attention(q, k, v, bias, mask, scale: float):
    """softmax(q k^T * scale + bias [+ mask]) v per window and head.

    q/k/v: [BW, n, G, hd] float32 or bfloat16; bias: [G, n, n] float32;
    mask: None, a (bank [K, n, n], idx [nW]) pair or a dense [nW, n, n]
    tensor, a constant on q's device. Returns [BW, n, G, hd] in q's dtype.
    Differentiable in q, k, v and bias when one of them requires a
    gradient."""
    _check(q, k, v, bias)
    bank, idx = _mask_parts(mask, q.shape[0], q.shape[1], q.device)
    q, k, v, bias = (_aligned(t) for t in (q, k, v, bias))
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (q, k, v, bias)):
        return _WindowAttention.apply(q, k, v, bias, bank, idx, float(scale))
    return _forward(q, k, v, bias, bank, idx, float(scale))
