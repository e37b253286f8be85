# ------------------------------------------------------------------
"""Selective-scan kernels of the Mamba encoder, with their gradients.

Counterpart of idee_tpu/kernels/selective_scan.py. Three hand-written CUDA
kernels, built by ``kernels/build.py``:

  * ``csrc/selective_scan.cu``: the fused d_state=1 scan forward
    (``fused_selective_scan_n1``), producers, recurrence and consumers in
    one pass; and its backward (``fused_scan_n1_bwd``), the JAX package's
    custom VJP ``_fused_bwd`` in one reverse pass;
  * ``csrc/linear_scan.cu``: the linear recurrence h_t = a_t h_{t-1} + b_t,
    forward or reverse in time (``linear_scan``, and its backward).

Both public ops are ``torch.autograd.Function``s whose backward is the JAX
package's custom VJP term by term. The fused scan's backward is one kernel
launch; ``linear_scan``'s is the linear-scan kernel run in reverse plus
two PyTorch products (the JAX package leaves them to XLA).

On a CUDA tensor a wrapper launches its kernel or raises; on a CPU tensor it
runs the plain version (``fused_selective_scan_n1_plain``,
``fused_selective_scan_n1_bwd_plain``, ``linear_scan_plain``: PyTorch ops
and loops over t of the same elementwise math), which is also what the
tests and ``chip_smoke.py`` hold the kernels against. So CPU and card
differ only in which scan runs.

Layout: the scanned tensors are [L, M] float32, contiguous, with the huge
M axis (windows x variables x channels) minor; A and D are [M].
"""
# ------------------------------------------------------------------

import ctypes
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from idee_tpu_torch.kernels import build

FUSED_FWD = "selective_scan_fused_n1_fwd"
FUSED_BWD = "selective_scan_fused_n1_bwd"
LINEAR_SCAN = "linear_scan"
# the csrc/<source>.cu of each kernel
SOURCES = {FUSED_FWD: "selective_scan", FUSED_BWD: "selective_scan",
           LINEAR_SCAN: "linear_scan"}

# launches of each CUDA kernel in this process; the plain CPU versions do
# not count. A step captured in a CUDA graph counts once per replay, not at
# its capture (train/steps.py::FusedEpoch)
launches: Dict[str, int] = {FUSED_FWD: 0, FUSED_BWD: 0, LINEAR_SCAN: 0}

_P, _I64 = ctypes.c_void_p, ctypes.c_int64
_SIGNATURES = {
    # symbol, argtypes
    FUSED_FWD: ("idee_fused_scan_n1_fwd", [_P] * 9 + [_I64, _I64, _P]),
    FUSED_BWD: ("idee_fused_scan_n1_bwd", [_P] * 16 + [_I64, _I64, _P]),
    LINEAR_SCAN: ("idee_linear_scan", [_P] * 3 + [_I64, _I64, ctypes.c_int,
                                                  _P]),
}


def _launch(kernel: str, tensors, *scalars):
    """Run ``kernel`` on the current stream of the tensors' card; count the
    launch. ``tensors``: the kernel's pointer arguments in order (None
    passes NULL), then ``scalars``."""
    dev = next(t.device for t in tensors if t is not None)
    fn = build.c_function(SOURCES[kernel], *_SIGNATURES[kernel])
    build.call(fn, kernel, dev, [*tensors, *scalars])
    launches[kernel] += 1


def _check(shapes, tensors, like: torch.Tensor):
    for (name, shape), t in zip(shapes, tensors):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got "
                             f"{tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: expected float32, got {t.dtype}")
        if t.device != like.device:
            raise ValueError(f"{name} is on {t.device}, not {like.device}")
    if like.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {like.device}")


# ---------------------------------------------------------------- linear scan

def linear_scan_plain(a, b, reverse: bool = False):
    """Plain PyTorch version of the linear-scan kernel: h [L, M] with
    h_t = a_t h_{t-1} + b_t (reverse: h_t = a_t h_{t+1} + b_t), zero
    initial state."""
    L = a.shape[0]
    h = torch.zeros_like(a[0])
    hs = [None] * L
    for t in (range(L - 1, -1, -1) if reverse else range(L)):
        h = a[t] * h + b[t]
        hs[t] = h
    return torch.stack(hs)


def linear_scan_2d(a, b, reverse: bool = False):
    """The linear recurrence over [L, M] float32 a, b along axis 0 (no
    gradient): the CUDA kernel on a card, the plain version on the CPU."""
    if a.dim() != 2:
        raise ValueError(f"a must be [L, M], got {tuple(a.shape)}")
    _check([("a", tuple(a.shape)), ("b", tuple(a.shape))], [a, b], a)
    if a.device.type == "cpu":
        return linear_scan_plain(a, b, reverse)
    h = torch.empty_like(a)
    L, M = a.shape
    _launch(LINEAR_SCAN, [a, b, h], L, M, int(reverse))
    return h


def _shift_left(a):
    """[a_1, ..., a_{L-1}, 0]: the coefficient of the reverse-time
    recurrence G_t = g_t + a_{t+1} G_{t+1}."""
    return torch.cat([a[1:], torch.zeros_like(a[:1])]).contiguous()


def _shift_right(h):
    """[0, h_0, ..., h_{L-2}]."""
    return torch.cat([torch.zeros_like(h[:1]), h[:-1]])


class _LinearScan(torch.autograd.Function):
    """linear_scan_2d with JAX's custom VJP (``_linear_scan_2d``)."""

    @staticmethod
    def forward(ctx, a, b):
        h = linear_scan_2d(a, b)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, g):
        a, h = ctx.saved_tensors
        G = linear_scan_2d(_shift_left(a), g.contiguous(), reverse=True)
        return G * _shift_right(h), G


def linear_scan(a, b, axis: int):
    """h_t = a_t * h_{t-1} + b_t along ``axis`` (h_{-1} = 0), float32,
    differentiable: the kernel forward and, for the gradient, in reverse."""
    a = a.float()
    b = b.float()
    axis = axis % a.dim()
    a = a.movedim(axis, 0)
    b = b.movedim(axis, 0)
    shape = a.shape
    L = shape[0]
    a2 = a.reshape(L, -1).contiguous()
    b2 = b.reshape(L, -1).contiguous()
    if torch.is_grad_enabled() and (a2.requires_grad or b2.requires_grad):
        h = _LinearScan.apply(a2, b2)
    else:
        h = linear_scan_2d(a2, b2)
    return h.reshape(shape).movedim(0, axis)


# ---------------------------------------------------------------- fused scan

def _check_fused(delta, u, B, C, z, A, D) -> Tuple[int, int]:
    if delta.dim() != 2:
        raise ValueError(f"delta must be [L, M], got {tuple(delta.shape)}")
    L, M = delta.shape
    _check([("delta", (L, M)), ("u", (L, M)), ("B", (L, M)), ("C", (L, M)),
            ("z", (L, M)), ("A", (M,)), ("D", (M,))],
           [delta, u, B, C, z, A, D], delta)
    return L, M


def fused_selective_scan_n1_plain(delta, u, B, C, z, A, D):
    """Plain PyTorch version: (y, h), both [L, M]."""
    h = torch.zeros_like(A)
    hs, ys = [], []
    for t in range(delta.shape[0]):
        h = torch.exp(delta[t] * A) * h + delta[t] * u[t] * B[t]
        hs.append(h)
        ys.append(C[t] * h + D * u[t])
    return torch.stack(ys) * F.silu(z), torch.stack(hs)


def _fused_fwd(delta, u, B, C, z, A, D, return_h: bool):
    """(y, h or None), no gradient: the kernel on a card, the plain version
    on the CPU."""
    if delta.device.type == "cpu":
        with torch.no_grad():
            y, h = fused_selective_scan_n1_plain(delta, u, B, C, z, A, D)
        return y, (h if return_h else None)
    L, M = delta.shape
    y = torch.empty_like(delta)
    h = torch.empty_like(delta) if return_h else None
    _launch(FUSED_FWD, [delta, u, B, C, z, A, D, y, h], L, M)
    return y, h


def fused_selective_scan_n1_bwd_plain(delta, u, B, C, z, A, D, h, g):
    """Plain PyTorch version of the backward kernel, JAX's ``_fused_bwd``
    (idee_tpu/kernels/selective_scan.py:288-310) term by term: from the
    saved inputs, h and the output gradient g [L, M], returns (ddelta, du,
    dB, dC, dz) [L, M] and (dA, dD) [M]. The reverse-time recurrence
    G_t = a_{t+1} G_{t+1} + dh_t runs through ``linear_scan_plain``."""
    sig = torch.sigmoid(z)
    sz = z * sig
    y_lin = C * h + D * u
    dy = g * sz
    dz = g * y_lin * (sig * (1.0 + z * (1.0 - sig)))
    dC = dy * h
    dD = torch.sum(dy * u, dim=0)
    du = dy * D
    dh = dy * C

    a = torch.exp(delta * A)
    G = linear_scan_plain(_shift_left(a), dh, reverse=True)
    da = G * _shift_right(h)
    ddelta = da * a * A + G * u * B
    du = du + G * delta * B
    dB = G * delta * u
    dA = torch.sum(da * a * delta, dim=0)
    return ddelta, du, dB, dC, dz, dA, dD


def fused_scan_n1_bwd(delta, u, B, C, z, A, D, h, g):
    """The fused scan's gradients (ddelta, du, dB, dC, dz, dA, dD) from the
    saved inputs, h and the output gradient g: the backward kernel on a
    card, the plain version on the CPU."""
    L, M = _check_fused(delta, u, B, C, z, A, D)
    _check([("h", (L, M)), ("g", (L, M))], [h, g], delta)
    if delta.device.type == "cpu":
        return fused_selective_scan_n1_bwd_plain(delta, u, B, C, z, A, D, h,
                                                 g)
    grads = [torch.empty_like(delta) for _ in range(5)]
    dA, dD = torch.empty_like(A), torch.empty_like(D)
    _launch(FUSED_BWD, [delta, u, B, C, z, A, D, h, g, *grads, dA, dD], L,
            M)
    return (*grads, dA, dD)


class _FusedScanN1(torch.autograd.Function):
    """fused_selective_scan_n1 with JAX's custom VJP (``_fused_fwd`` /
    ``_fused_bwd``, idee_tpu/kernels/selective_scan.py:283-310): the forward
    keeps h, the backward is one launch of the backward kernel."""

    @staticmethod
    def forward(ctx, delta, u, B, C, z, A, D):
        y, h = _fused_fwd(delta, u, B, C, z, A, D, return_h=True)
        ctx.save_for_backward(delta, u, B, C, z, A, D, h)
        return y

    @staticmethod
    def backward(ctx, g):
        return fused_scan_n1_bwd(*ctx.saved_tensors, g.contiguous())


def fused_selective_scan_n1(delta, u, B, C, z, A, D, return_h: bool = False):
    """y = silu(z) * (C*h + D*u) with h_t = exp(delta_t A) h_{t-1} +
    delta_t u_t B_t along axis 0 (h_{-1} = 0).

    Differentiable when an input requires a gradient (the forward then also
    writes h for the backward); under no_grad / inference_mode the kernel
    writes y alone. ``return_h`` returns (y, h) with no gradient."""
    args = (delta, u, B, C, z, A, D)
    _check_fused(*args)
    if return_h:
        return _fused_fwd(*args, return_h=True)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _FusedScanN1.apply(*args)
    return _fused_fwd(*args, return_h=False)[0]
