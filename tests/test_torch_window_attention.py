# ------------------------------------------------------------------
"""The port's window attention (kernels/window_attention.py) against the
JAX package.

CPU: the op on CPU tensors runs its plain versions, which are held
against the JAX functions run as the JAX package's own tests run them:
  * the forward against ``_xla_impl`` and against ``_fused_fwd`` (the
    Pallas forward kernel in interpret mode) at atol 1e-5 (the JAX tests'
    own tolerance for the fused kernel, tests/test_kernels.py:133). Cases:
    n=32 with G=12; n=8 with a shift mask; a padded tail of the TPU's pair
    tiling (BW=10, G=3); a dense mask and the same mask as (bank, idx);
    batch 2, where window w takes mask row idx[w % nW]; and n=18, a window
    that does not divide 128 (``_xla_impl`` only: the Pallas path takes
    only n dividing 128);
  * the gradients (dq, dk, dv, dbias) against ``jax.vjp`` of
    ``window_attention`` under ``runtime.set_force_pallas(True)`` (its
    ``_bwd_pallas`` in interpret mode) and against autograd through the
    plain forward, at rtol 1e-4 / atol 1e-5 (dbias sums ds over every
    window in another order).
Card (``gpu`` marker): both kernels against their plain versions at the
bench stage shapes and odd shapes, at the same tolerances except dbias,
whose absolute tolerance is 1e-5 x max |dbias| (a sum over up to 40,000
windows whose entries can cancel to near 0 carries rounding of the size
of the whole sum); the forward alone at every window size with several
heads and a ragged last window group, at rtol 1e-5 / atol 1e-5; bit-equal
outputs and gradients over two runs; misaligned views copied, not
refused.

The JAX side is imported inside a fixture, so the card-only tests also
collect where JAX is not installed
(``python -m pytest --noconftest tests/test_torch_window_attention.py
-m gpu``).
"""
# ------------------------------------------------------------------

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from idee_tpu_torch.kernels import window_attention as wa
from idee_tpu_torch.nn.swin3d import compute_shift_mask

torch.set_num_threads(1)

ATOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
DBIAS_REL = 1e-5  # card: dbias's absolute tolerance over its max |entry|


@pytest.fixture(scope="module")
def ref():
    import jax
    import jax.numpy as jnp

    from idee_tpu.kernels import runtime
    from idee_tpu.kernels import window_attention as jwa

    return SimpleNamespace(jax=jax, jnp=jnp, runtime=runtime, wa=jwa)


def _case(BW, n, G, hd, mask_geom=None, batch=1, dense=False, seed=0):
    """numpy q, k, v, g [BW, n, G, hd], bias [G, n, n] and the mask as a
    (bank, idx) pair, a dense [nW, n, n] array or None. ``mask_geom``:
    (Dp, Hp, Wp, ws, ss) of compute_shift_mask; BW = batch * nW then."""
    mask = None
    if mask_geom is not None:
        mask = compute_shift_mask(*mask_geom)
        BW = batch * mask[1].shape[0]
        if dense:
            mask = mask[0][mask[1]]
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.normal(size=(BW, n, G, hd)).astype(np.float32)
                  for _ in range(4))
    bias = (0.5 * rng.normal(size=(G, n, n))).astype(np.float32)
    return q, k, v, g, bias, mask


def _torch_mask(mask, device="cpu"):
    if mask is None:
        return None
    if isinstance(mask, tuple):
        return tuple(torch.from_numpy(a).to(device) for a in mask)
    return torch.from_numpy(mask).to(device)


# the mask geometries: stage 0's window (2,4,4) shifted by (1,2,2) on a
# 4x8x8 grid (8 windows of 32 tokens), and a (2,2,2) window shifted by
# (1,1,1) on a 4x4x4 grid (8 windows of 8)
GEOM_32 = (4, 8, 8, (2, 4, 4), (1, 2, 2))
GEOM_8 = (4, 4, 4, (2, 2, 2), (1, 1, 1))

FWD_CASES = {
    "n32_G12": dict(BW=6, n=32, G=12, hd=8),
    "n8_mask": dict(BW=None, n=8, G=4, hd=8, mask_geom=GEOM_8),
    "padded_tail_BW10_G3": dict(BW=10, n=8, G=3, hd=4),
    "n32_bank_idx_mask": dict(BW=None, n=32, G=3, hd=8, mask_geom=GEOM_32),
    "n32_dense_mask": dict(BW=None, n=32, G=3, hd=8, mask_geom=GEOM_32,
                           dense=True),
    "batch2_mask": dict(BW=None, n=8, G=2, hd=16, mask_geom=GEOM_8,
                        batch=2),
}


def _jax_mask(ref, mask):
    return mask if isinstance(mask, tuple) or mask is None else \
        ref.jnp.asarray(mask)


@pytest.mark.parametrize("case", sorted(FWD_CASES))
def test_plain_forward_matches_jax(ref, case):
    q, k, v, _, bias, mask = _case(**FWD_CASES[case])
    scale = q.shape[-1] ** -0.5
    jargs = [ref.jnp.asarray(t) for t in (q, k, v, bias)]
    want_xla = ref.wa._xla_impl(*jargs, _jax_mask(ref, mask), scale)
    want_pallas = ref.wa._fused_fwd(*jargs, _jax_mask(ref, mask), scale)
    got = wa.window_attention(*(torch.from_numpy(t) for t in (q, k, v, bias)),
                              _torch_mask(mask), scale).numpy()
    np.testing.assert_allclose(got, np.asarray(want_xla), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, np.asarray(want_pallas), atol=ATOL,
                               rtol=0)


def test_masked_row_maximum_and_window_not_dividing_128(ref):
    """n=18 (window (2,3,3)) with a shift mask, batch 2: rows whose
    largest unmasked score is masked occur, and the plain forward still
    matches ``_xla_impl``."""
    q, k, v, _, bias, mask = _case(None, 18, 3, 8, batch=2, seed=3,
                                   mask_geom=(4, 6, 6, (2, 3, 3), (1, 1, 1)))
    scale = 8 ** -0.5
    want = ref.wa._xla_impl(*(ref.jnp.asarray(t) for t in (q, k, v, bias)),
                            mask, scale)
    got = wa.window_attention(*(torch.from_numpy(t) for t in (q, k, v, bias)),
                              _torch_mask(mask), scale).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0)
    # the raw score's argmax per row lands on a masked key somewhere
    s = np.einsum("bngd,bmgd->bgnm", q * scale, k) + bias[None]
    bank, idx = mask
    full = np.tile(bank[idx], (2, 1, 1))                   # [BW, n, n]
    top = s.argmax(-1)                                     # [BW, G, n]
    hit = np.take_along_axis(np.broadcast_to(full[:, None], s.shape),
                             top[..., None], -1)
    assert (hit == -100.0).any()


def _jax_grads(ref, q, k, v, bias, mask, g, scale):
    ref.runtime.set_force_pallas(True)
    try:
        _, pull = ref.jax.vjp(
            lambda *a: ref.wa.window_attention(*a, mask, scale),
            *(ref.jnp.asarray(t) for t in (q, k, v, bias)))
        return [np.asarray(t) for t in pull(ref.jnp.asarray(g))]
    finally:
        ref.runtime.set_force_pallas(False)


@pytest.mark.parametrize("case", ["n32_G12", "n8_mask", "batch2_mask",
                                  "n32_bank_idx_mask"])
def test_gradients_match_jax_pallas_backward(ref, case):
    q, k, v, g, bias, mask = _case(**FWD_CASES[case], seed=1)
    scale = q.shape[-1] ** -0.5
    want = _jax_grads(ref, q, k, v, bias, mask, g, scale)
    ts = [torch.from_numpy(t).requires_grad_() for t in (q, k, v, bias)]
    o = wa.window_attention(*ts, _torch_mask(mask), scale)
    got = torch.autograd.grad(o, ts, torch.from_numpy(g))
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, want):
        np.testing.assert_allclose(a.numpy(), b, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=name)


@pytest.mark.parametrize("case", ["padded_tail_BW10_G3", "n32_dense_mask",
                                  "batch2_mask"])
def test_gradients_match_autograd_of_plain_forward(case):
    q, k, v, g, bias, mask = _case(**FWD_CASES[case], seed=2)
    scale = 0.3
    ts = [torch.from_numpy(t).requires_grad_() for t in (q, k, v, bias)]
    got = torch.autograd.grad(
        wa.window_attention(*ts, _torch_mask(mask), scale), ts,
        torch.from_numpy(g))
    want = torch.autograd.grad(
        wa.window_attention_fwd_plain(*ts, _torch_mask(mask), scale), ts,
        torch.from_numpy(g))
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, want):
        torch.testing.assert_close(a, b, rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   msg=lambda m: f"{name}: {m}")


def test_cpu_call_counts_no_launch_and_grads_only_when_asked():
    q, k, v, g, bias, mask = _case(**FWD_CASES["n8_mask"])
    before = dict(wa.launches)
    ts = [torch.from_numpy(t) for t in (q, k, v, bias)]
    o = wa.window_attention(*ts, _torch_mask(mask), 0.35)
    assert not o.requires_grad
    ts[3].requires_grad_()
    o = wa.window_attention(*ts, _torch_mask(mask), 0.35)
    assert o.requires_grad
    o.sum().backward()
    assert ts[3].grad is not None
    assert wa.launches == before


def test_takes_non_contiguous_views():
    """Views that are not contiguous (a strided head slice) give what
    their contiguous copies give, values and gradients."""
    q, k, v, g, bias, mask = _case(**FWD_CASES["n8_mask"], seed=7)
    wide = [np.concatenate([t, t[..., :1]], axis=-1) for t in (q, k, v)]
    leaves = [torch.from_numpy(t).requires_grad_() for t in wide]
    views = [t[..., 1:] for t in leaves]
    assert not any(t.is_contiguous() for t in views)
    copies = [t.detach().contiguous().requires_grad_() for t in views]
    b = torch.from_numpy(bias)
    o = wa.window_attention(*views, b, _torch_mask(mask), 0.35)
    o_c = wa.window_attention(*copies, b, _torch_mask(mask), 0.35)
    assert torch.equal(o, o_c)
    gt = torch.from_numpy(g)
    got = torch.autograd.grad(o, leaves, gt)
    want = torch.autograd.grad(o_c, copies, gt)
    for a, c in zip(got, want):
        assert torch.equal(a[..., 1:], c)
        assert not a[..., :1].any()


BAD = {
    "float64": lambda q, k, v, b, m: (q.double(), k, v, b, m),
    "k_shape": lambda q, k, v, b, m: (q, k[:, :4], v, b, m),
    "bias_shape": lambda q, k, v, b, m: (q, k, v, b[:, :4], m),
    "hd_6": lambda q, k, v, b, m: (q[..., :6], k[..., :6], v[..., :6], b, m),
    "not_4d": lambda q, k, v, b, m: (q[0], k[0], v[0], b, m),
    "n_above_max": lambda q, k, v, b, m: tuple(
        t.repeat(1, 17, 1, 1) for t in (q, k, v)) + (
            torch.zeros(b.shape[0], 136, 136), None),
    "mask_windows_not_dividing": lambda q, k, v, b, m: (
        q[:5], k[:5], v[:5], b, m),
    "mask_bank_shape": lambda q, k, v, b, m: (
        q, k, v, b, (m[0][:, :4, :4], m[1])),
    "mask_idx_float": lambda q, k, v, b, m: (
        q, k, v, b, (m[0], m[1].float())),
}


@pytest.mark.parametrize("bad", sorted(BAD))
def test_rejects_bad_inputs(bad):
    q, k, v, _, bias, mask = _case(**FWD_CASES["n8_mask"])
    args = BAD[bad](*(torch.from_numpy(t) for t in (q, k, v, bias)),
                    _torch_mask(mask))
    with pytest.raises(ValueError):
        wa.window_attention(*args, 0.35)


# partials [n_blocks, G, n, n] of the dbias sum: the backward's at the bench
# stage shapes (171 blocks per head at G = 12), and a ragged one (E = 3 x 7
# x 7 = 147 outputs, not a multiple of 32; 45 partials, not a multiple of
# its 4 chunks)
SUM_SHAPES = {"stage0": (171, 12, 32), "stage1": (171, 12, 8),
              "ragged": (45, 3, 7)}


def _partials(n_blocks, G, n, seed=6):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        rng.normal(size=(n_blocks, G, n, n)).astype(np.float32))


@pytest.mark.parametrize("shape", ["stage0", "ragged"])
def test_dbias_sum_plain_matches_torch_sum(shape):
    part = _partials(*SUM_SHAPES[shape])
    n_blocks, E = part.shape[0], part[0].numel()
    out, chunks = wa.dbias_sum_shape(n_blocks, E)
    if shape == "ragged":
        assert E % 32 != 0 and n_blocks % chunks != 0
    assert out * chunks <= 1024 and 1 <= chunks <= n_blocks
    want = part.sum(0)
    # float32 sums of 45-171 unit normals in two orders: rounding of ~1e-6
    # of the largest sum
    torch.testing.assert_close(wa.dbias_sum_plain(part), want, rtol=1e-6,
                               atol=1e-6 * want.abs().max().item())


def test_dbias_sum_on_cpu_runs_the_plain_version_and_counts_no_launch():
    part = _partials(*SUM_SHAPES["ragged"])
    before = dict(wa.launches)
    assert torch.equal(wa.dbias_sum(part), wa.dbias_sum_plain(part))
    assert wa.launches == before


def test_dbias_sum_shape_spreads_every_stage_over_the_card():
    """Each stage's sum takes at least one block per SM, chunks of at least
    _SUM_MIN_CHUNK partials, and a pure function of the shape."""
    for n_blocks, G, n in SUM_SHAPES.values():
        E = G * n * n
        out, chunks = wa.dbias_sum_shape(n_blocks, E)
        assert wa.dbias_sum_shape(n_blocks, E) == (out, chunks)
        assert n_blocks // chunks >= wa._SUM_MIN_CHUNK
        if E >= 4 * wa._SMS:
            assert -(-E // out) >= wa._SMS
    assert wa.dbias_sum_shape(171, 12 * 32 * 32) == (32, 8)
    assert wa.dbias_sum_shape(171, 12 * 8 * 8) == (4, 16)


# ---------------------------------------------------------------- card only

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the window-attention kernels have "
                    "no CPU mode)")
    return torch.device("cuda")


CARD_CASES = {
    # the bench stage shapes: stage 0 unshifted and shifted (the real mask
    # of the 8x200x200 grid), stage 1
    "stage0": dict(BW=10_000, n=32, G=12, hd=8),
    "stage0_shifted": dict(BW=None, n=32, G=12, hd=8,
                           mask_geom=(8, 200, 200, (2, 4, 4), (1, 2, 2))),
    "stage1": dict(BW=40_000, n=8, G=12, hd=8),
    # odd shapes: n=18, a ragged last window group, both other widths
    "n18_hd4_batch2": dict(BW=None, n=18, G=3, hd=4, batch=2,
                           mask_geom=(4, 6, 6, (2, 3, 3), (1, 1, 1))),
    "n128_hd16": dict(BW=5, n=128, G=2, hd=16),
    "n8_hd16_ragged": dict(BW=37, n=8, G=5, hd=16),
    # the backward's largest shared-memory footprint (231,488 B): n=128,
    # hd=16 with a mask, window (2,8,8) shifted by (1,4,4), 8 windows
    "n128_hd16_masked": dict(BW=None, n=128, G=2, hd=16,
                             mask_geom=(4, 16, 16, (2, 8, 8), (1, 4, 4))),
}


def _check_against_plain(ts, m, gt, scale, what="", fwd_rtol=0.0,
                         dbias_atol_floor=0.0):
    """One forward and backward through the kernels (one launch each)
    against the plain versions."""
    before = dict(wa.launches)
    o = wa.window_attention(*ts, m, scale)
    got = torch.autograd.grad(o, ts, gt)
    torch.cuda.synchronize()
    assert wa.launches[wa.ATTN_FWD] == before[wa.ATTN_FWD] + 1
    assert wa.launches[wa.ATTN_BWD] == before[wa.ATTN_BWD] + 1
    assert wa.launches[wa.DBIAS_SUM] == before[wa.DBIAS_SUM] + 1
    plain = [t.detach() for t in ts]
    o_p = wa.window_attention_fwd_plain(*plain, m, scale)
    want = wa.window_attention_bwd_plain(*plain, m, scale, o_p, gt)
    torch.testing.assert_close(o, o_p, rtol=fwd_rtol, atol=ATOL,
                               msg=lambda msg: f"{what} o: {msg}")
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, want):
        # dbias sums ds over up to 40,000 windows of both signs: its
        # rounding error scales with the sum's size, not with an entry
        # that cancels to near 0
        atol = (max(DBIAS_REL * b.abs().max().item(), dbias_atol_floor)
                if name == "dbias" else GRAD_ATOL)
        torch.testing.assert_close(a, b, rtol=GRAD_RTOL, atol=atol,
                                   msg=lambda msg: f"{what} {name}: {msg}")


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_kernels_match_plain_on_card(cuda, case):
    q, k, v, g, bias, mask = _case(**CARD_CASES[case], seed=4)
    scale = q.shape[-1] ** -0.5
    ts = [torch.from_numpy(t).to(cuda).requires_grad_()
          for t in (q, k, v, bias)]
    m = _torch_mask(mask, cuda)
    gt = torch.from_numpy(g).to(cuda)
    _check_against_plain(ts, m, gt, scale)


@pytest.mark.gpu
@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
@pytest.mark.parametrize("hd", wa.HEAD_DIMS)
def test_backward_matches_plain_at_every_window_size_on_card(cuda, hd,
                                                             masked):
    """n = 1 .. 128 with BW = 2 (128 // n) windows (two window groups of
    the kernel's blocks) and G = 1; masked: a random 0 / -100 mask per
    window of two (bank, idx). The forward is held at chip_smoke.py's
    rtol 1e-5 / atol 1e-5 (hd = 16 rows of unit normals reach 1.1e-5
    absolute at |o| ~ 1.5). dbias's absolute tolerance has dq's 1e-5 as its
    floor: at n = 1 (p = 1, so ds = 0) every entry is rounding noise of
    ~1e-7, and 1e-5 x max |dbias| would ask for 1e-12."""
    for n in range(1, wa.MAX_TOKENS + 1):
        BW = 2 * (wa.MAX_TOKENS // n)
        q, k, v, g, bias, _ = _case(BW, n, 1, hd, seed=n)
        m = None
        if masked:
            rng = np.random.default_rng(1000 + n)
            bank = np.where(rng.random((2, n, n)) < 0.3, -100.0,
                            0.0).astype(np.float32)
            m = (torch.from_numpy(bank).to(cuda),
                 torch.tensor([0, 1], dtype=torch.int32, device=cuda))
        ts = [torch.from_numpy(t).to(cuda).requires_grad_()
              for t in (q, k, v, bias)]
        _check_against_plain(ts, m, torch.from_numpy(g).to(cuda),
                             hd ** -0.5, what=f"n={n}", fwd_rtol=1e-5,
                             dbias_atol_floor=GRAD_ATOL)


@pytest.mark.gpu
@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
@pytest.mark.parametrize("hd", wa.HEAD_DIMS)
def test_forward_matches_plain_at_every_window_size_on_card(cuda, hd,
                                                            masked):
    """The forward alone, n = 1 .. 128, with G = 3 heads (the kernel walks
    the heads of its windows in a loop) and BW = 2 (128 // n) + 1 windows
    (a ragged last window group); masked: a random 0 / -100 mask per window
    of three (bank, idx). One launch each, within chip_smoke.py's rtol 1e-5
    / atol 1e-5."""
    for n in range(1, wa.MAX_TOKENS + 1):
        BW = 2 * (wa.MAX_TOKENS // n) + 1
        q, k, v, _, bias, _ = _case(BW, n, 3, hd, seed=200 + n)
        m = None
        if masked:
            BW -= BW % 3
            q, k, v = q[:BW], k[:BW], v[:BW]
            rng = np.random.default_rng(2000 + n)
            bank = np.where(rng.random((2, n, n)) < 0.3, -100.0,
                            0.0).astype(np.float32)
            m = (torch.from_numpy(bank).to(cuda),
                 torch.tensor([0, 1, 1], dtype=torch.int32, device=cuda))
        ts = [torch.from_numpy(np.ascontiguousarray(t)).to(cuda)
              for t in (q, k, v, bias)]
        before = wa.launches[wa.ATTN_FWD]
        o = wa.window_attention(*ts, m, hd ** -0.5)
        torch.cuda.synchronize()
        assert wa.launches[wa.ATTN_FWD] == before + 1
        torch.testing.assert_close(
            o, wa.window_attention_fwd_plain(*ts, m, hd ** -0.5), rtol=1e-5,
            atol=ATOL, msg=lambda msg: f"n={n}: {msg}")


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["stage0", "stage0_shifted", "stage1"])
def test_forward_is_bitwise_deterministic_on_card(cuda, case):
    q, k, v, _, bias, mask = _case(**CARD_CASES[case], seed=8)
    ts = [torch.from_numpy(t).to(cuda) for t in (q, k, v, bias)]
    m = _torch_mask(mask, cuda)
    runs = [wa.window_attention(*ts, m, 0.35) for _ in range(2)]
    assert torch.equal(*runs)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["stage0", "stage0_shifted", "stage1"])
def test_backward_is_bitwise_deterministic_on_card(cuda, case):
    q, k, v, g, bias, mask = _case(**CARD_CASES[case], seed=5)
    ts = [torch.from_numpy(t).to(cuda).requires_grad_()
          for t in (q, k, v, bias)]
    m = _torch_mask(mask, cuda)
    gt = torch.from_numpy(g).to(cuda)
    runs = [torch.autograd.grad(wa.window_attention(*ts, m, 0.35), ts, gt)
            for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", sorted(SUM_SHAPES))
def test_dbias_sum_kernel_is_bit_equal_to_plain_on_card(cuda, shape):
    """The stage shapes (stage 0 shifted sums partials of stage 0's shape)
    and the ragged one."""
    part = _partials(*SUM_SHAPES[shape]).to(cuda)
    before = wa.launches[wa.DBIAS_SUM]
    got = wa.dbias_sum(part)
    torch.cuda.synchronize()
    assert wa.launches[wa.DBIAS_SUM] == before + 1
    assert torch.equal(got, wa.dbias_sum_plain(part))


@pytest.mark.gpu
def test_misaligned_cuda_view_matches_plain(cuda):
    """The kernels move rows as float4. A contiguous q view that starts 4
    bytes into its storage, and a k view that is neither contiguous nor
    aligned, are copied to aligned storage: the output and the gradients
    match the plain version's on the same views."""
    q, k, v, g, bias, _ = _case(6, 8, 2, 8)
    q_base = torch.zeros(q.size + 1, device=cuda)
    q_base[1:] = torch.from_numpy(q).reshape(-1).to(cuda)
    k_wide = torch.zeros(*k.shape[:-1], k.shape[-1] + 1, device=cuda)
    k_wide[..., 1:] = torch.from_numpy(k).to(cuda)
    v_t, bias_t = (torch.from_numpy(t).to(cuda) for t in (v, bias))
    leaves = [t.requires_grad_() for t in (q_base, k_wide, v_t, bias_t)]
    q_view = q_base[1:].view(q.shape)
    k_view = k_wide[..., 1:]
    assert q_view.is_contiguous() and q_view.data_ptr() % 16 != 0
    assert not k_view.is_contiguous() and k_view.data_ptr() % 16 != 0
    args = (q_view, k_view, v_t, bias_t, None, 0.35)
    gt = torch.from_numpy(g).to(cuda)
    o = wa.window_attention(*args)
    got = torch.autograd.grad(o, leaves, gt)
    o_p = wa.window_attention_fwd_plain(*args)
    want = torch.autograd.grad(o_p, leaves, gt)
    torch.testing.assert_close(o, o_p, rtol=1e-5, atol=ATOL)
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, want):
        torch.testing.assert_close(a, b, rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   msg=lambda msg: f"{name}: {msg}")
