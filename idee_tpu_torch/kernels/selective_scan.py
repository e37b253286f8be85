# ------------------------------------------------------------------
"""Fused d_state=1 selective scan (forward) for the Mamba encoder.

Counterpart of idee_tpu/kernels/selective_scan.py::fused_selective_scan_n1.
On a CUDA tensor the wrapper launches the hand-written kernel in
``csrc/selective_scan.cu`` (built by ``kernels/build.py``) or raises; on a
CPU tensor it runs ``fused_selective_scan_n1_plain``, a PyTorch loop over t
of the same elementwise math, which is also what the tests and
``chip_smoke.py`` hold the kernel against.

Layout: all of delta, u, B, C, z are [L, M] float32, contiguous, with the
huge M axis (windows x variables x channels) minor; A and D are [M].
"""
# ------------------------------------------------------------------

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

KERNEL_NAME = "selective_scan_fused_n1_fwd"
SOURCE = "selective_scan"

# launches of the CUDA kernel by fused_selective_scan_n1 in this process;
# the plain CPU version does not count
launches = 0

_fn = None


def _kernel_fn():
    global _fn
    if _fn is None:
        from idee_tpu_torch.kernels import build

        fn = build.load(SOURCE).idee_fused_scan_n1_fwd
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int64,
                                               ctypes.c_int64,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(delta, u, B, C, z, A, D) -> Tuple[int, int]:
    if delta.dim() != 2:
        raise ValueError(f"delta must be [L, M], got {tuple(delta.shape)}")
    L, M = delta.shape
    for name, t, shape in (("delta", delta, (L, M)), ("u", u, (L, M)),
                           ("B", B, (L, M)), ("C", C, (L, M)),
                           ("z", z, (L, M)), ("A", A, (M,)), ("D", D, (M,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got "
                             f"{tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: expected float32, got {t.dtype}")
        if t.device != delta.device:
            raise ValueError(f"{name} is on {t.device}, delta on "
                             f"{delta.device}")
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


def fused_selective_scan_n1(delta, u, B, C, z, A, D, return_h: bool = False):
    """y = silu(z) * (C*h + D*u) with h_t = exp(delta_t A) h_{t-1} +
    delta_t u_t B_t along axis 0 (h_{-1} = 0). Returns y, or (y, h) when
    ``return_h``."""
    _check(delta, u, B, C, z, A, D)
    if delta.device.type == "cpu":
        y, h = fused_selective_scan_n1_plain(delta, u, B, C, z, A, D)
        return (y, h) if return_h else y
    if delta.device.type != "cuda":
        raise ValueError(f"no kernel for device {delta.device}")
    return _launch(delta, u, B, C, z, A, D, return_h)


def _launch(delta, u, B, C, z, A, D, return_h: bool):
    global launches
    for name, t in (("delta", delta), ("u", u), ("B", B), ("C", C),
                    ("z", z), ("A", A), ("D", D)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    L, M = delta.shape
    y = torch.empty_like(delta)
    h: Optional[torch.Tensor] = torch.empty_like(delta) if return_h else None
    with torch.cuda.device(delta.device):
        stream = torch.cuda.current_stream(delta.device).cuda_stream
        err = _kernel_fn()(
            delta.data_ptr(), u.data_ptr(), B.data_ptr(), C.data_ptr(),
            z.data_ptr(), A.data_ptr(), D.data_ptr(), y.data_ptr(),
            h.data_ptr() if h is not None else None, L, M, stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL_NAME} launch failed: cudaError {err}")
    launches += 1
    return (y, h) if return_h else y
