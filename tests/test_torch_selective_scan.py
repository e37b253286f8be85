# ------------------------------------------------------------------
"""The port's fused d_state=1 selective scan against the JAX op.

CPU: the port's plain version (what the wrapper runs on CPU tensors) is
held against the JAX op run as the JAX package's own tests run it (the
Pallas kernel in interpret mode, tests/test_kernels.py) and against its
XLA composition, at rtol 1e-5 / atol 1e-6 (float32; the two sides round
exp and the recurrence in the same order, so only last-bit differences
remain). The plain backward is held against JAX's ``_fused_bwd`` term by
term on the residuals of the Pallas forward, at rtol 1e-5 / atol 1e-5 (the
reverse recurrence and the column sums add up to L products, so the
absolute error grows with the gradient's size). Card: the forward and
backward kernels against their plain versions at the two shapes of the
Mamba encoder's main path and at odd L and ragged M, same tolerances, and
two backward runs bit for bit.

The JAX side is imported inside the CPU tests (fixture ``ref``), so the
card-only tests also collect where JAX is not installed:
``python -m pytest --noconftest tests/test_torch_*.py -m gpu``.
"""
# ------------------------------------------------------------------

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from idee_tpu_torch.kernels import selective_scan as ss
from idee_tpu_torch.nn.mamba import selective_scan_packed

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
GRAD_ATOL = 1e-5
GRAD_NAMES = ("ddelta", "du", "dB", "dC", "dz", "dA", "dD")


def _inputs(L, M, seed=0):
    rng = np.random.default_rng(seed)
    delta = (np.abs(rng.normal(size=(L, M))) * 0.1 + 0.01).astype(np.float32)
    u, B, C, z = (rng.normal(size=(L, M)).astype(np.float32)
                  for _ in range(4))
    A = (-np.abs(rng.normal(size=(M,))) - 0.1).astype(np.float32)
    D = rng.normal(size=(M,)).astype(np.float32)
    return delta, u, B, C, z, A, D


@pytest.fixture(scope="module")
def ref():
    import jax.numpy as jnp

    from idee_tpu.kernels import runtime
    from idee_tpu.kernels.selective_scan import (_fused_bwd, _fused_fwd,
                                                 _fused_fwd_impl, _fused_xla)
    from idee_tpu.nn.mamba import selective_scan_packed

    return SimpleNamespace(jnp=jnp, runtime=runtime,
                           fused_fwd_impl=_fused_fwd_impl,
                           fused_fwd=_fused_fwd, fused_bwd=_fused_bwd,
                           fused_xla=_fused_xla,
                           selective_scan_packed=selective_scan_packed)


def _torch(args, device="cpu"):
    return [torch.from_numpy(a).to(device) for a in args]


# M is not a multiple of the TPU kernel's 1024-wide tile
SHAPES = [(8, 1500), (32, 2100)]


@pytest.mark.parametrize("L,M", SHAPES)
def test_plain_matches_pallas_interpret(ref, L, M):
    args = _inputs(L, M, seed=L)
    ref.runtime.set_force_pallas(True)
    try:
        y_ref, h_ref = ref.fused_fwd_impl(*map(ref.jnp.asarray, args))
    finally:
        ref.runtime.set_force_pallas(False)
    y, h = ss.fused_selective_scan_n1(*_torch(args), return_h=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("L,M", SHAPES)
def test_plain_matches_xla_composition(ref, L, M):
    args = _inputs(L, M, seed=L + 1)
    y_ref, h_ref = ref.fused_xla(*map(ref.jnp.asarray, args))
    y, h = ss.fused_selective_scan_n1_plain(*_torch(args))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), rtol=RTOL,
                               atol=ATOL)


def test_cpu_wrapper_runs_plain_and_counts_no_launch():
    args = _torch(_inputs(8, 300))
    before = ss.launches[ss.FUSED_FWD]
    y = ss.fused_selective_scan_n1(*args)
    y_plain, _ = ss.fused_selective_scan_n1_plain(*args)
    assert torch.equal(y, y_plain)
    assert ss.launches[ss.FUSED_FWD] == before


@pytest.mark.parametrize("bad", ["dtype", "shape", "A_shape"])
def test_wrapper_rejects_bad_inputs(bad):
    args = _torch(_inputs(8, 64))
    if bad == "dtype":
        args[1] = args[1].double()
    elif bad == "shape":
        args[2] = args[2][:4]
    else:
        args[5] = args[5][:10]
    with pytest.raises(ValueError):
        ss.fused_selective_scan_n1(*args)


def _output_gradient(L, M, seed):
    return np.random.default_rng(seed).normal(size=(L, M)).astype(np.float32)


# L = 1; L = 7, not a multiple of the kernel's unroll of 4; L = 32, the
# stage-0 window; M a multiple neither of the TPU's 1024-wide tile nor of
# the kernel's 256-thread block
BWD_SHAPES = [(1, 300), (7, 1500), (32, 2100)]


@pytest.mark.parametrize("L,M", BWD_SHAPES)
def test_plain_backward_matches_jax_fused_bwd(ref, L, M):
    """fused_selective_scan_n1_bwd_plain against JAX's custom VJP rule
    ``_fused_bwd(res, g)``, term by term, on the residuals (with h) of the
    Pallas forward in interpret mode."""
    args = _inputs(L, M, seed=40 + L)
    g = _output_gradient(L, M, seed=50 + L)
    ref.runtime.set_force_pallas(True)
    try:
        _, res = ref.fused_fwd(*map(ref.jnp.asarray, args))
        want = ref.fused_bwd(res, ref.jnp.asarray(g))
    finally:
        ref.runtime.set_force_pallas(False)
    h = np.array(res[-1])
    got = ss.fused_selective_scan_n1_bwd_plain(*_torch((*args, h, g)))
    for name, a, b in zip(GRAD_NAMES, got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=GRAD_ATOL, err_msg=name)


def test_cpu_backward_runs_plain_and_counts_no_launch():
    args = _torch(_inputs(7, 300, seed=9))
    _, h = ss.fused_selective_scan_n1_plain(*args)
    g = torch.from_numpy(_output_gradient(7, 300, seed=10))
    before = dict(ss.launches)
    got = ss.fused_scan_n1_bwd(*args, h, g)
    want = ss.fused_selective_scan_n1_bwd_plain(*args, h, g)
    for name, a, b in zip(GRAD_NAMES, got, want):
        assert torch.equal(a, b), name
    # and through autograd: the Function's backward is the dispatcher
    ts = [t.clone().requires_grad_() for t in args]
    via_autograd = torch.autograd.grad(ss.fused_selective_scan_n1(*ts), ts,
                                       g)
    for name, a, b in zip(GRAD_NAMES, via_autograd, want):
        assert torch.equal(a, b), name
    assert ss.launches == before


@pytest.mark.parametrize("bad", ["dtype", "h_shape", "g_shape", "A_shape",
                                 "g_device", "device"])
def test_backward_dispatcher_rejects_bad_inputs(bad):
    args = _torch(_inputs(8, 64, seed=11))
    _, h = ss.fused_selective_scan_n1_plain(*args)
    g = torch.from_numpy(_output_gradient(8, 64, seed=12))
    if bad == "dtype":
        g = g.double()
    elif bad == "h_shape":
        h = h[:4]
    elif bad == "g_shape":
        g = g[:, :32]
    elif bad == "A_shape":
        args[5] = args[5][:10]
    elif bad == "g_device":
        g = torch.empty(8, 64, device="meta")
    else:  # every tensor on a device with no kernel
        args = [t.to("meta") for t in args]
        h, g = h.to("meta"), g.to("meta")
    with pytest.raises(ValueError):
        ss.fused_scan_n1_bwd(*args, h, g)


def test_selective_scan_packed_matches_jax(ref):
    """The fold / per-channel repeat around the op, n = 1."""
    rng = np.random.default_rng(3)
    B_, L, V, d = 5, 8, 3, 4
    M = V * d
    u, z = (rng.normal(size=(B_, L, M)).astype(np.float32) for _ in range(2))
    delta = (np.abs(rng.normal(size=(B_, L, M))) * 0.2 + 0.01).astype(
        np.float32)
    A = (-np.abs(rng.normal(size=(M, 1))) - 0.1).astype(np.float32)
    Bs, Cs = (rng.normal(size=(B_, L, V, 1)).astype(np.float32)
              for _ in range(2))
    D = rng.normal(size=(M,)).astype(np.float32)
    want = ref.selective_scan_packed(
        *map(ref.jnp.asarray, (u, delta, A, Bs, Cs, D, z)), V)
    got = selective_scan_packed(*_torch((u, delta, A, Bs, Cs, D, z)), V)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


# ---------------------------------------------------------------- card only

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("return_h", [False, True])
@pytest.mark.parametrize("L,M", [(32, 960_000), (8, 3_840_000)])
def test_kernel_matches_plain_on_card(cuda, L, M, return_h):
    args = _torch(_inputs(L, M, seed=7), cuda)
    before = ss.launches[ss.FUSED_FWD]
    got = ss.fused_selective_scan_n1(*args, return_h=return_h)
    torch.cuda.synchronize()
    assert ss.launches[ss.FUSED_FWD] == before + 1
    y_ref, h_ref = ss.fused_selective_scan_n1_plain(*args)
    y = got[0] if return_h else got
    torch.testing.assert_close(y, y_ref, rtol=RTOL, atol=ATOL)
    if return_h:
        torch.testing.assert_close(got[1], h_ref, rtol=RTOL, atol=ATOL)


# the two stage shapes of the main path, then L = 1, 7 and 33 (not a
# multiple of the unroll) with M a multiple of no block
CARD_BWD_SHAPES = [(32, 960_000), (8, 3_840_000), (1, 1001), (7, 4099),
                   (33, 100_003)]


def _card_backward_case(L, M, cuda, seed):
    args = _torch(_inputs(L, M, seed=seed), cuda)
    _, h = ss.fused_selective_scan_n1(*args, return_h=True)
    g = torch.from_numpy(_output_gradient(L, M, seed=seed + 1)).to(cuda)
    return args, h, g


@pytest.mark.gpu
@pytest.mark.parametrize("L,M", CARD_BWD_SHAPES)
def test_backward_kernel_matches_plain_on_card(cuda, L, M):
    args, h, g = _card_backward_case(L, M, cuda, seed=13)
    before = dict(ss.launches)
    got = ss.fused_scan_n1_bwd(*args, h, g)
    torch.cuda.synchronize()
    assert ss.launches[ss.FUSED_BWD] == before[ss.FUSED_BWD] + 1
    assert ss.launches[ss.LINEAR_SCAN] == before[ss.LINEAR_SCAN]
    want = ss.fused_selective_scan_n1_bwd_plain(*args, h, g)
    for name, a, b in zip(GRAD_NAMES, got, want):
        torch.testing.assert_close(a, b, rtol=RTOL, atol=GRAD_ATOL,
                                   msg=lambda m: f"{name}: {m}")


@pytest.mark.gpu
@pytest.mark.parametrize("L,M", CARD_BWD_SHAPES[:2])
def test_backward_kernel_is_bitwise_deterministic_on_card(cuda, L, M):
    args, h, g = _card_backward_case(L, M, cuda, seed=14)
    runs = [ss.fused_scan_n1_bwd(*args, h, g) for _ in range(2)]
    for name, a, b in zip(GRAD_NAMES, *runs):
        assert torch.equal(a, b), name
