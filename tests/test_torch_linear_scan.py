# ------------------------------------------------------------------
"""The port's linear scan and the gradients of both scan ops, against the
JAX package.

CPU: the port's ops (on CPU tensors they run the plain versions) are held
against the JAX ops run as the JAX package's own tests run them, with the
Pallas kernels in interpret mode (``runtime.set_force_pallas``):
  * ``linear_scan`` forward and ``jax.vjp`` gradients at L in {8, 32, 100}
    (L=100 reaches the two-level ``_scan_pallas_2d``), along an axis that
    is not 0, with M not a multiple of the TPU's 1024-wide tile: rtol 1e-5
    / atol 1e-6 (float32; the TPU's chunked scan and blocked carry round
    in another order than one sequential pass);
  * ``fused_selective_scan_n1``'s seven gradients against ``jax.vjp``:
    rtol 1e-5 / atol 1e-5 (the reverse recurrence sums up to L products,
    so its absolute error grows with the gradient's size);
  * ``selective_scan_packed`` at d_state=2 and the single-tower
    ``selective_scan``, values and gradients, at the same tolerances.
Card: the linear-scan kernel against its plain version, forward and
reverse, and the fused scan's backward on the card (one launch of its
backward kernel, no linear scan) against the CPU one.

The JAX side is imported inside fixtures, so the card-only tests also
collect where JAX is not installed
(``python -m pytest --noconftest tests/test_torch_linear_scan.py -m gpu``).
"""
# ------------------------------------------------------------------

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from idee_tpu_torch.kernels import selective_scan as ss
from idee_tpu_torch.nn.mamba import selective_scan, selective_scan_packed

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
GRAD_ATOL = 1e-5


@pytest.fixture(scope="module")
def ref():
    import jax
    import jax.numpy as jnp

    from idee_tpu.kernels import runtime
    from idee_tpu.kernels import selective_scan as jss
    from idee_tpu.nn import mamba as jmamba

    return SimpleNamespace(jax=jax, jnp=jnp, runtime=runtime, ss=jss,
                           mamba=jmamba)


def _vjp(ref, fn, args, g, force_pallas=True):
    """Value and cotangent-gradients of the JAX ``fn`` at numpy ``args``."""
    ref.runtime.set_force_pallas(force_pallas)
    try:
        y, pull = ref.jax.vjp(fn, *map(ref.jnp.asarray, args))
        grads = pull(ref.jnp.asarray(g))
    finally:
        ref.runtime.set_force_pallas(False)
    return np.asarray(y), [np.asarray(t) for t in grads]


def _torch_vjp(fn, args, g):
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    y = fn(*ts)
    grads = torch.autograd.grad(y, ts, torch.from_numpy(g))
    return y.detach().numpy(), [t.numpy() for t in grads]


def _close(got, want, atol):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol)


def _scan_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    a = (rng.random(shape) * 0.9 + 0.05).astype(np.float32)
    b = rng.normal(size=shape).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    return a, b, g


# ---------------------------------------------------------------- linear scan

@pytest.mark.parametrize("L", [8, 32, 100])
def test_linear_scan_matches_jax(ref, L):
    # scan along axis 1 of [3, L, 350]: M = 1050, not a multiple of 1024
    a, b, g = _scan_inputs((3, L, 350), seed=L)
    want, want_grads = _vjp(
        ref, lambda x, y: ref.ss.linear_scan(x, y, axis=1), (a, b), g)
    got, got_grads = _torch_vjp(lambda x, y: ss.linear_scan(x, y, axis=1),
                                (a, b), g)
    _close(got, want, ATOL)
    for name, gg, wg in zip(("da", "db"), got_grads, want_grads):
        np.testing.assert_allclose(gg, wg, rtol=RTOL, atol=ATOL,
                                   err_msg=name)


def test_reverse_scan_is_the_flipped_forward_scan():
    a, b, _ = (torch.from_numpy(t) for t in _scan_inputs((20, 64), seed=1))
    rev = ss.linear_scan_plain(a, b, reverse=True)
    flipped = ss.linear_scan_plain(a.flip(0), b.flip(0)).flip(0)
    assert torch.equal(rev, flipped)
    assert torch.equal(ss.linear_scan_2d(a, b, reverse=True), rev)


def test_linear_scan_gradient_matches_autograd_of_plain():
    a, b, g = _scan_inputs((16, 40), seed=2)
    got, got_grads = _torch_vjp(lambda x, y: ss.linear_scan(x, y, axis=0),
                                (a, b), g)
    want, want_grads = _torch_vjp(ss.linear_scan_plain, (a, b), g)
    _close(got, want, ATOL)
    for gg, wg in zip(got_grads, want_grads):
        _close(gg, wg, ATOL)


def test_cpu_wrappers_run_plain_and_count_no_launch():
    a, b, _ = (torch.from_numpy(t) for t in _scan_inputs((8, 300), seed=3))
    before = dict(ss.launches)
    assert torch.equal(ss.linear_scan_2d(a, b), ss.linear_scan_plain(a, b))
    assert torch.equal(ss.linear_scan(a, b, axis=0),
                       ss.linear_scan_plain(a, b))
    assert ss.launches == before


@pytest.mark.parametrize("bad", ["dtype", "shape", "ndim"])
def test_linear_scan_rejects_bad_inputs(bad):
    a, b, _ = (torch.from_numpy(t) for t in _scan_inputs((8, 64), seed=4))
    if bad == "dtype":
        b = b.double()
    elif bad == "shape":
        b = b[:4]
    else:
        a, b = a[None], b[None]
    with pytest.raises(ValueError):
        ss.linear_scan_2d(a, b)


# ---------------------------------------------------------------- fused scan

def _fused_inputs(L, M, seed):
    rng = np.random.default_rng(seed)
    delta = (np.abs(rng.normal(size=(L, M))) * 0.1 + 0.01).astype(np.float32)
    u, B, C, z = (rng.normal(size=(L, M)).astype(np.float32)
                  for _ in range(4))
    A = (-np.abs(rng.normal(size=(M,))) - 0.1).astype(np.float32)
    D = rng.normal(size=(M,)).astype(np.float32)
    g = rng.normal(size=(L, M)).astype(np.float32)
    return (delta, u, B, C, z, A, D), g


GRAD_NAMES = ("ddelta", "du", "dB", "dC", "dz", "dA", "dD")


@pytest.mark.parametrize("L,M", [(8, 1500), (32, 2100)])
def test_fused_scan_gradients_match_jax(ref, L, M):
    args, g = _fused_inputs(L, M, seed=L)
    want, want_grads = _vjp(ref, ref.ss.fused_selective_scan_n1, args, g)
    got, got_grads = _torch_vjp(ss.fused_selective_scan_n1, args, g)
    _close(got, want, ATOL)
    for name, gg, wg in zip(GRAD_NAMES, got_grads, want_grads):
        np.testing.assert_allclose(gg, wg, rtol=RTOL, atol=GRAD_ATOL,
                                   err_msg=name)


def test_fused_scan_gradients_match_autograd_of_plain():
    args, g = _fused_inputs(16, 500, seed=5)
    _, got = _torch_vjp(ss.fused_selective_scan_n1, args, g)
    _, want = _torch_vjp(lambda *t: ss.fused_selective_scan_n1_plain(*t)[0],
                         args, g)
    for name, gg, wg in zip(GRAD_NAMES, got, want):
        np.testing.assert_allclose(gg, wg, rtol=RTOL, atol=GRAD_ATOL,
                                   err_msg=name)


def test_fused_scan_output_carries_a_gradient_only_when_asked():
    args = [torch.from_numpy(t) for t in _fused_inputs(8, 64, seed=6)[0]]
    assert ss.fused_selective_scan_n1(*args).grad_fn is None
    args[0].requires_grad_()
    assert ss.fused_selective_scan_n1(*args).grad_fn is not None
    with torch.no_grad():
        assert ss.fused_selective_scan_n1(*args).grad_fn is None
    y, h = ss.fused_selective_scan_n1(*args, return_h=True)
    assert y.grad_fn is None and h.grad_fn is None


# ---------------------------------------------------------------- d_state > 1

def _packed_inputs(B_, L, V, d, n, seed):
    rng = np.random.default_rng(seed)
    M = V * d
    u, z = (rng.normal(size=(B_, L, M)).astype(np.float32) for _ in range(2))
    delta = (np.abs(rng.normal(size=(B_, L, M))) * 0.2 + 0.01).astype(
        np.float32)
    A = (-np.abs(rng.normal(size=(M, n))) - 0.1).astype(np.float32)
    Bs, Cs = (rng.normal(size=(B_, L, V, n)).astype(np.float32)
              for _ in range(2))
    D = rng.normal(size=(M,)).astype(np.float32)
    g = rng.normal(size=(B_, L, M)).astype(np.float32)
    return (u, delta, A, Bs, Cs, D, z), g


def test_selective_scan_packed_d_state_2_matches_jax(ref):
    V = 3
    args, g = _packed_inputs(5, 8, V, 4, 2, seed=7)
    want, want_grads = _vjp(
        ref, lambda *t: ref.mamba.selective_scan_packed(*t, V), args, g)
    got, got_grads = _torch_vjp(lambda *t: selective_scan_packed(*t, V),
                                args, g)
    _close(got, want, ATOL)
    for name, gg, wg in zip(("du", "ddelta", "dA", "dB", "dC", "dD", "dz"),
                            got_grads, want_grads):
        np.testing.assert_allclose(gg, wg, rtol=RTOL, atol=GRAD_ATOL,
                                   err_msg=name)


def test_selective_scan_single_tower_matches_jax(ref):
    rng = np.random.default_rng(8)
    Bt, L, d, n = 2, 12, 6, 3
    u, z = (rng.normal(size=(Bt, L, d)).astype(np.float32) for _ in range(2))
    delta = (np.abs(rng.normal(size=(Bt, L, d))) * 0.2 + 0.01).astype(
        np.float32)
    A = (-np.abs(rng.normal(size=(d, n))) - 0.1).astype(np.float32)
    Bs, Cs = (rng.normal(size=(Bt, L, n)).astype(np.float32)
              for _ in range(2))
    D = rng.normal(size=(d,)).astype(np.float32)
    g = rng.normal(size=(Bt, L, d)).astype(np.float32)
    args = (u, delta, A, Bs, Cs, D, z)
    want, want_grads = _vjp(ref, ref.mamba.selective_scan, args, g)
    got, got_grads = _torch_vjp(selective_scan, args, g)
    _close(got, want, ATOL)
    for gg, wg in zip(got_grads, want_grads):
        np.testing.assert_allclose(gg, wg, rtol=RTOL, atol=GRAD_ATOL)


# ---------------------------------------------------------------- card only

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the scan kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("L,M", [(32, 960_000), (200, 1_000_000)])
def test_linear_scan_kernel_matches_plain_on_card(cuda, L, M, reverse):
    a, b = (torch.from_numpy(t).to(cuda)
            for t in _scan_inputs((L, M), seed=9)[:2])
    before = ss.launches[ss.LINEAR_SCAN]
    h = ss.linear_scan_2d(a, b, reverse=reverse)
    torch.cuda.synchronize()
    assert ss.launches[ss.LINEAR_SCAN] == before + 1
    torch.testing.assert_close(h, ss.linear_scan_plain(a, b, reverse),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.gpu
def test_fused_scan_backward_on_card_matches_cpu(cuda):
    """The Function on the card (fused forward kernel keeping h, one launch
    of the backward kernel) against the same Function on the CPU (the
    plain versions)."""
    args, g = _fused_inputs(32, 100_000, seed=10)
    _, want = _torch_vjp(ss.fused_selective_scan_n1, args, g)
    ts = [torch.from_numpy(a).to(cuda).requires_grad_() for a in args]
    before = dict(ss.launches)
    y = ss.fused_selective_scan_n1(*ts)
    got = torch.autograd.grad(y, ts, torch.from_numpy(g).to(cuda))
    torch.cuda.synchronize()
    assert ss.launches[ss.FUSED_FWD] == before[ss.FUSED_FWD] + 1
    assert ss.launches[ss.FUSED_BWD] == before[ss.FUSED_BWD] + 1
    assert ss.launches[ss.LINEAR_SCAN] == before[ss.LINEAR_SCAN]
    for name, gg, wg in zip(GRAD_NAMES, got, want):
        np.testing.assert_allclose(gg.cpu().numpy(), wg, rtol=RTOL,
                                   atol=GRAD_ATOL, err_msg=name)
