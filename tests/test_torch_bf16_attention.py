# ------------------------------------------------------------------
"""The window attention at bfloat16 (kernels/window_attention.py) against
the JAX package's Pallas kernels at bfloat16.

q, k, v (and the output gradient) are bf16, the bias and the mask float32,
as the Swin block's bf16 qkv projection and float32 bias table give them.
The JAX side runs ``_fwd_pallas`` / ``_bwd_pallas`` in interpret mode
(``runtime.set_force_pallas(True)``), as the JAX package's own tests run
them: both load bf16, compute in float32 and round each output once.
Tolerances, written in the tests:
  * outputs and dq, dk, dv within one bf16 ulp of JAX's:
    |err| <= ulp(ref) + 1e-6, ulp(x) = 2^(floor(log2 |x|) - 7) (the two
    float32 results differ in their last bits, which moves a rounding to
    the neighbouring bf16 value where the float32 value lies within those
    bits of a tie: measured, 1 entry in 18,432 at n = 32, G = 12, off by
    exactly one ulp, 0.0053 of its value; 2^-8 |ref| is half an ulp just
    above a power of two and would refuse it);
  * dbias (float32, summed over every window in another order) at
    rtol 1e-4 / atol 1e-6 x max |dbias|.
The bf16 backward forms D_i = sum_j p_ij dp_ij in float32 from the
recomputed scores, as JAX's ``_bwd_kernel`` does; a test shows that the
float32 path's D_i = go_i . o_i taken from the rounded bf16 output moves
dbias well outside that tolerance.

Card (``gpu`` marker): the bf16 kernels against the plain bf16 versions
at the bench stage shapes and odd shapes, every window size n = 1 .. 128
for hd 4, 8 and 16, masked and not, misaligned views, and bit-equal
reruns, within one bf16 ulp (|err| <= ulp(ref) + 1e-5: both round float32
values that sum in other orders) and dbias as in the float32 card tests.

The JAX side is imported inside a fixture, so the card-only tests also
collect where JAX is not installed (``python -m pytest --noconftest
tests/test_torch_bf16_attention.py -m gpu``).
"""
# ------------------------------------------------------------------

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from idee_tpu_torch.kernels import window_attention as wa
from test_torch_window_attention import (CARD_CASES, FWD_CASES, GEOM_8,
                                         GEOM_32, GRAD_ATOL, GRAD_RTOL,
                                         DBIAS_REL, _case, _torch_mask)

torch.set_num_threads(1)

BF16 = torch.bfloat16
# one bf16 ulp of the reference plus these: JAX's on the CPU, the plain
# version's on the card
ULP_ATOL, CARD_ATOL = 1e-6, 1e-5
DBIAS_RTOL, DBIAS_ATOL_REL = 1e-4, 1e-6


@pytest.fixture(scope="module")
def ref():
    import jax
    import jax.numpy as jnp

    from idee_tpu.kernels import runtime
    from idee_tpu.kernels import window_attention as jwa

    return SimpleNamespace(jax=jax, jnp=jnp, runtime=runtime, wa=jwa)


def _bf16_case(seed=0, **kw):
    """_case's inputs with q, k, v, g rounded to bf16 (as torch tensors);
    bias float32; the mask as _case gives it."""
    q, k, v, g, bias, mask = _case(**kw, seed=seed)
    q, k, v, g = (torch.from_numpy(t).to(BF16) for t in (q, k, v, g))
    return q, k, v, g, torch.from_numpy(bias), mask


def bf16_ulp(x):
    """The spacing of bf16 values (8 significant bits) at |x|; 0 at 0."""
    m, e = np.frexp(np.abs(np.asarray(x, np.float32)))
    return np.where(m == 0, 0.0, np.ldexp(1.0, e - 8)).astype(np.float32)


def _within(got, want, atol, what):
    """|got - want| <= one bf16 ulp of want + atol, entry by entry."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    excess = np.abs(got - want) - (bf16_ulp(want) + atol)
    assert (excess <= 0).all(), (
        f"{what}: {int((excess > 0).sum())} of {excess.size} entries off, "
        f"worst by {excess.max()}")


def _np(t):
    return t.detach().float().cpu().numpy()


def _jax_bf16(ref, t):
    return ref.jnp.asarray(_np(t)).astype(ref.jnp.bfloat16)


def _jax_mask(ref, mask):
    return mask if isinstance(mask, tuple) or mask is None else \
        ref.jnp.asarray(mask)


@pytest.mark.parametrize("case", sorted(FWD_CASES))
def test_plain_forward_matches_jax_pallas_at_bf16(ref, case):
    q, k, v, _, bias, mask = _bf16_case(**FWD_CASES[case])
    scale = q.shape[-1] ** -0.5
    want = ref.wa._fused_fwd(*(_jax_bf16(ref, t) for t in (q, k, v)),
                             ref.jnp.asarray(bias.numpy()),
                             _jax_mask(ref, mask), scale)
    assert want.dtype == ref.jnp.bfloat16
    got = wa.window_attention(q, k, v, bias, _torch_mask(mask), scale)
    assert got.dtype == BF16
    _within(_np(got), np.asarray(want).astype(np.float32), ULP_ATOL, case)


def _jax_grads(ref, q, k, v, bias, mask, g, scale):
    ref.runtime.set_force_pallas(True)
    try:
        _, pull = ref.jax.vjp(
            lambda *a: ref.wa.window_attention(*a, mask, scale),
            *(_jax_bf16(ref, t) for t in (q, k, v)),
            ref.jnp.asarray(bias.numpy()))
        return [np.asarray(t).astype(np.float32)
                for t in pull(_jax_bf16(ref, g))]
    finally:
        ref.runtime.set_force_pallas(False)


def _port_grads(q, k, v, bias, mask, g, scale):
    ts = [t.clone().requires_grad_() for t in (q, k, v, bias)]
    o = wa.window_attention(*ts, _torch_mask(mask), scale)
    return torch.autograd.grad(o, ts, g)


GRAD_CASES = ["n32_G12", "n8_mask", "batch2_mask", "n32_bank_idx_mask"]


@pytest.mark.parametrize("case", GRAD_CASES)
def test_gradients_match_jax_pallas_backward_at_bf16(ref, case):
    q, k, v, g, bias, mask = _bf16_case(**FWD_CASES[case], seed=1)
    scale = q.shape[-1] ** -0.5
    want = _jax_grads(ref, q, k, v, bias, mask, g, scale)
    got = _port_grads(q, k, v, bias, mask, g, scale)
    for name, a, b in zip(("dq", "dk", "dv"), got[:3], want[:3]):
        assert a.dtype == BF16, name
        _within(_np(a), b, ULP_ATOL, f"{case} {name}")
    assert got[3].dtype == torch.float32
    np.testing.assert_allclose(
        _np(got[3]), want[3], rtol=DBIAS_RTOL,
        atol=DBIAS_ATOL_REL * np.abs(want[3]).max(), err_msg="dbias")


def test_bf16_d_term_comes_from_the_scores_not_the_rounded_output(ref):
    """dbias sums ds = p (dp - D) over every window. With D_i = go_i . o_i
    from the bf16 output (the float32 path's formula) its error against
    JAX's _bwd_pallas is many times the tolerance the port meets with D_i
    = sum_j p_ij dp_ij."""
    q, k, v, g, bias, mask = _bf16_case(BW=64, n=32, G=2, hd=8, seed=9)
    scale = 8 ** -0.5
    want = _jax_grads(ref, q, k, v, bias, mask, g, scale)[3]
    got = _port_grads(q, k, v, bias, mask, g, scale)[3]
    o = wa.window_attention_fwd_plain(q, k, v, bias, None, scale)
    from_o = wa.window_attention_bwd_plain(
        *(t.float() for t in (q, k, v)), bias, None, scale, o.float(),
        g.float())[3]
    tol = DBIAS_ATOL_REL * np.abs(want).max()
    err_port = np.abs(_np(got) - want).max()
    err_from_o = np.abs(_np(from_o) - want).max()
    assert err_port <= DBIAS_RTOL * np.abs(want).max() + tol
    assert err_from_o > 10 * err_port, (err_from_o, err_port)


def test_plain_bf16_is_the_float32_math_rounded_once():
    q, k, v, g, bias, mask = _bf16_case(**FWD_CASES["n8_mask"], seed=4)
    m = _torch_mask(mask)
    o = wa.window_attention_fwd_plain(q, k, v, bias, m, 0.35)
    o32 = wa.window_attention_fwd_plain(q.float(), k.float(), v.float(),
                                        bias, m, 0.35)
    assert o.dtype == BF16 and torch.equal(o, o32.to(BF16))
    d = wa.window_attention_bwd_plain(q, k, v, bias, m, 0.35, o, g)
    assert [t.dtype for t in d] == [BF16] * 3 + [torch.float32]


def test_cpu_bf16_call_counts_no_launch():
    q, k, v, g, bias, mask = _bf16_case(**FWD_CASES["n8_mask"])
    before = dict(wa.launches)
    ts = [q, k, v, bias.requires_grad_()]
    o = wa.window_attention(*ts, _torch_mask(mask), 0.35)
    o.float().sum().backward()
    assert bias.grad is not None and bias.grad.dtype == torch.float32
    assert wa.launches == before


def _bf16_parts(x, terms: int):
    """x float32 as the tensor-core operands the kernels give it: ``terms``
    bf16 values that sum to it, each the bf16 rounding of what the ones
    before leave (3: hi + mid + lo, all 24 bits of x; 2: hi + lo, about
    16; 1: one rounding)."""
    parts = []
    for _ in range(terms):
        parts.append(x.to(BF16).float())
        x = x - parts[-1]
    return tuple(parts)


def _kernel_rounding_model(q, k, v, g, bias, mask, scale, fwd_terms=2,
                           bwd_terms=3):
    """The arithmetic of csrc/window_attention_bf16.cu in plain torch:
    q, k, v and g enter every product as the bf16 values they are (each
    product exact) and the products sum in float32; the scale applies to
    the float32 scores, bias and mask are summed first; the forward's
    weights e = exp(s - max s) enter e v as ``fwd_terms`` bf16 parts (hi +
    lo) and o is divided by sum e; the backward's p = e / sum e and ds
    enter p^T g, ds k and ds^T q as ``bwd_terms`` parts (hi + mid + lo;
    the earlier design took hi + lo, and 1 is the one rounding both
    avoid).
    (o, dq, dk, dv) rounded once to bf16 and dbias = sum over windows of
    ds, float32."""
    bank, idx = wa._mask_parts(mask, q.shape[0], q.shape[1], q.device)
    q, k, v, g = (t.float() for t in (q, k, v, g))
    BW, n, G, _ = q.shape
    add = bias[None, None].expand(BW, 1, G, n, n).reshape(BW, G, n, n)
    if bank is not None:
        m = bank[idx.long()]
        nW = m.shape[0]
        add = (bias[None, None] + m[None, :, None]).expand(
            BW // nW, nW, G, n, n).reshape(BW, G, n, n)
    s = torch.einsum("bngd,bmgd->bgnm", q, k) * scale + add
    e = torch.exp(s - s.amax(-1, keepdim=True))
    l = e.sum(-1, keepdim=True)
    p = e / l
    dp = torch.einsum("bngd,bmgd->bgnm", g, v)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    pp, dd = _bf16_parts(p, bwd_terms), _bf16_parts(ds, bwd_terms)
    o = sum(torch.einsum("bgnm,bmgd->bngd", x, v)
            for x in _bf16_parts(e, fwd_terms)) / l.squeeze(-1).permute(
                0, 2, 1)[..., None]
    dq = scale * sum(torch.einsum("bgnm,bmgd->bngd", x, k) for x in dd)
    dk = scale * sum(torch.einsum("bgnm,bngd->bmgd", x, q) for x in dd)
    dv = sum(torch.einsum("bgnm,bngd->bmgd", x, g) for x in pp)
    return tuple(t.to(BF16) for t in (o, dq, dk, dv)) + (ds.sum(0),)


def _excess(got, want, atol):
    """Largest |got - want| beyond one bf16 ulp of want + atol (<= 0: within
    the check)."""
    got, want = _np(got), _np(want)
    return float((np.abs(got - want) - (bf16_ulp(want) + atol)).max())


# n = 98 is the reference's default (2, 7, 7) window, shifted by (1, 3, 3)
MODEL_GEOMS = {8: GEOM_8, 32: GEOM_32, 98: (4, 14, 14, (2, 7, 7), (1, 3, 3))}


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
@pytest.mark.parametrize("hd", wa.HEAD_DIMS)
@pytest.mark.parametrize("n", sorted(MODEL_GEOMS))
def test_kernel_rounding_model_is_within_one_ulp_of_plain(n, hd, masked):
    """The bf16 kernels' numerics design, before any card run: the model
    of their rounding (_kernel_rounding_model) lies within the card
    checks' tolerances of the plain bf16 versions: o, dq, dk, dv within one
    bf16 ulp + 1e-5, dbias at rtol 1e-4 / atol 1e-5 x max |dbias|. Prints,
    without asserting, how far beyond that tolerance one bf16 rounding of p
    and ds would land. The backward's p and ds as hi + mid + lo, the
    forward's e as hi + lo."""
    geom = MODEL_GEOMS[n]
    q, k, v, g, bias, mask = _bf16_case(BW=8, n=n, G=2, hd=hd, seed=40 + n,
                                        mask_geom=geom if masked else None)
    m = _torch_mask(mask)
    scale = hd ** -0.5
    o = wa.window_attention_fwd_plain(q, k, v, bias, m, scale)
    want = (o,) + wa.window_attention_bwd_plain(q, k, v, bias, m, scale, o,
                                                g)
    names = ("o", "dq", "dk", "dv")
    once = _kernel_rounding_model(q, k, v, g, bias, m, scale, 1, 1)
    print(f"\nn={n} hd={hd} masked={masked}: one rounding of p and ds, "
          "excess over one ulp + 1e-5: " + ", ".join(
              f"{name} {_excess(a, b, CARD_ATOL):.3g}"
              for name, a, b in zip(names, once, want)))
    got = _kernel_rounding_model(q, k, v, g, bias, m, scale)
    for name, a, b in zip(names, got, want):
        assert a.dtype == BF16
        _within(_np(a), _np(b), CARD_ATOL, f"n={n} hd={hd} {name}")
    torch.testing.assert_close(got[4], want[4], rtol=GRAD_RTOL,
                               atol=DBIAS_REL * want[4].abs().max().item())


def test_three_term_split_holds_one_ulp_at_a_space_rank_stage_1_shape():
    """Fault C (ROADMAP.md queue 3) in the rounding model: at a [1, 2]
    rank's stage-1 shape (windows of 8 tokens, 12 heads of 8) p and ds as
    hi + lo bf16 (about 16 bits) miss one bf16 ulp + 1e-5 where dq or dv is
    a cancelling sum; as hi + mid + lo (all 24 bits of the float32 values
    JAX's _bwd_kernel sums) they do not. The output gradient is at 4x unit
    scale: at unit scale the hi + lo model's misses are rarer than one
    entry in 60 M (four seeds of 20,000 windows show none; the kernel's own
    1 in 15.36 M on the card adds ex2.approx and the tensor cores'
    accumulation), at 4x a few of 2,000 windows show them. Prints both
    models' counts of entries beyond the bound."""
    q, k, v, g, bias, _ = _bf16_case(BW=2_000, n=8, G=12, hd=8, seed=0)
    g = (4.0 * g.float()).to(BF16)
    scale = 8 ** -0.5
    o = wa.window_attention_fwd_plain(q, k, v, bias, None, scale)
    want = wa.window_attention_bwd_plain(q, k, v, bias, None, scale, o, g)
    counts = {}
    for terms in (2, 3):
        got = _kernel_rounding_model(q, k, v, g, bias, None, scale,
                                     bwd_terms=terms)
        counts[terms] = {
            name: int(((np.abs(_np(a) - _np(b))
                        - (bf16_ulp(_np(b)) + CARD_ATOL)) > 0).sum())
            for name, a, b in zip(("dq", "dk", "dv"), got[1:4], want)}
    print(f"\nentries beyond one bf16 ulp + 1e-5 of {want[0].numel()}: "
          f"hi + lo {counts[2]}, hi + mid + lo {counts[3]}")
    assert sum(counts[2].values()) > 0, counts
    assert counts[3] == {"dq": 0, "dk": 0, "dv": 0}, counts


BAD = {
    "bf16_bias": lambda q, k, v, b: (q, k, v, b.to(BF16)),
    "f32_k_with_bf16_q": lambda q, k, v, b: (q, k.float(), v, b),
    "float16": lambda q, k, v, b: (q.half(), k.half(), v.half(), b),
}


@pytest.mark.parametrize("bad", sorted(BAD))
def test_rejects_mixed_dtypes(bad):
    q, k, v, _, bias, mask = _bf16_case(**FWD_CASES["n8_mask"])
    with pytest.raises(ValueError):
        wa.window_attention(*BAD[bad](q, k, v, bias), _torch_mask(mask),
                            0.35)


# ---------------------------------------------------------------- card only

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the window-attention kernels have "
                    "no CPU mode)")
    return torch.device("cuda")


def _card(ts, dev):
    return [t.to(dev) for t in ts]


def _check_bf16_against_plain(ts, m, gt, scale, what="",
                              dbias_atol_floor=0.0):
    """One forward and backward through the bf16 kernels (one launch of
    each, no float32 kernel) against the plain bf16 versions."""
    before = dict(wa.launches)
    leaves = [t.detach().clone().requires_grad_() for t in ts]
    o = wa.window_attention(*leaves, m, scale)
    got = torch.autograd.grad(o, leaves, gt)
    torch.cuda.synchronize()
    want_counts = dict(before)
    for name in (wa.ATTN_FWD_BF16, wa.ATTN_BWD_BF16, wa.DBIAS_SUM):
        want_counts[name] += 1
    assert wa.launches == want_counts, what
    plain = [t.detach() for t in ts]
    o_p = wa.window_attention_fwd_plain(*plain, m, scale)
    want = wa.window_attention_bwd_plain(*plain, m, scale, o_p, gt)
    assert o.dtype == BF16
    _within(_np(o), _np(o_p), CARD_ATOL, f"{what} o")
    for name, a, b in zip(("dq", "dk", "dv"), got[:3], want[:3]):
        assert a.dtype == BF16
        _within(_np(a), _np(b), GRAD_ATOL, f"{what} {name}")
    atol = max(DBIAS_REL * want[3].abs().max().item(), dbias_atol_floor)
    torch.testing.assert_close(got[3], want[3], rtol=GRAD_RTOL, atol=atol,
                               msg=lambda msg: f"{what} dbias: {msg}")


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_bf16_kernels_match_plain_on_card(cuda, case):
    q, k, v, g, bias, mask = _bf16_case(**CARD_CASES[case], seed=4)
    _check_bf16_against_plain(_card((q, k, v, bias), cuda),
                              _torch_mask(mask, cuda), g.to(cuda),
                              q.shape[-1] ** -0.5, what=case)


@pytest.mark.gpu
@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
@pytest.mark.parametrize("hd", wa.HEAD_DIMS)
def test_bf16_kernels_match_plain_at_every_window_size_on_card(cuda, hd,
                                                               masked):
    """n = 1 .. 128 with G = 2 heads and BW = 2 (128 // n) + 1 windows (a
    ragged last window group); masked: a random 0 / -100 mask per window of
    three (bank, idx). dbias's absolute tolerance has 1e-5 as its floor,
    as in the float32 card test (at n = 1, ds = 0 and every entry is
    rounding noise)."""
    for n in range(1, wa.MAX_TOKENS + 1):
        BW = 2 * (wa.MAX_TOKENS // n) + 1
        if masked:
            BW -= BW % 3
        q, k, v, g, bias, _ = _bf16_case(BW=BW, n=n, G=2, hd=hd,
                                         seed=300 + n)
        m = None
        if masked:
            rng = np.random.default_rng(3000 + n)
            bank = np.where(rng.random((2, n, n)) < 0.3, -100.0,
                            0.0).astype(np.float32)
            m = (torch.from_numpy(bank).to(cuda),
                 torch.tensor([0, 1, 1], dtype=torch.int32, device=cuda))
        _check_bf16_against_plain(_card((q, k, v, bias), cuda), m,
                                  g.to(cuda), hd ** -0.5, what=f"n={n}",
                                  dbias_atol_floor=GRAD_ATOL)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["stage0", "stage0_shifted", "stage1"])
def test_bf16_kernels_are_bitwise_deterministic_on_card(cuda, case):
    q, k, v, g, bias, mask = _bf16_case(**CARD_CASES[case], seed=8)
    ts = [t.requires_grad_() for t in _card((q, k, v, bias), cuda)]
    m = _torch_mask(mask, cuda)
    gt = g.to(cuda)
    runs = []
    for _ in range(2):
        o = wa.window_attention(*ts, m, 0.35)
        runs.append((o,) + torch.autograd.grad(o, ts, gt))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_bf16_misaligned_cuda_view_matches_plain(cuda):
    """A bf16 q view that starts 2 bytes into its storage and a k view that
    is neither contiguous nor aligned are copied to aligned storage: output
    and gradients match the plain version's on the same views."""
    q, k, v, g, bias, _ = _bf16_case(BW=6, n=8, G=2, hd=8)
    q_base = torch.zeros(q.numel() + 1, dtype=BF16, device=cuda)
    q_base[1:] = q.reshape(-1).to(cuda)
    k_wide = torch.zeros(*k.shape[:-1], k.shape[-1] + 1, dtype=BF16,
                         device=cuda)
    k_wide[..., 1:] = k.to(cuda)
    v_t, bias_t = v.to(cuda), bias.to(cuda)
    leaves = [t.requires_grad_() for t in (q_base, k_wide, v_t, bias_t)]
    q_view = q_base[1:].view(q.shape)
    k_view = k_wide[..., 1:]
    assert q_view.is_contiguous() and q_view.data_ptr() % 16 != 0
    assert not k_view.is_contiguous() and k_view.data_ptr() % 16 != 0
    args = (q_view, k_view, v_t, bias_t, None, 0.35)
    gt = g.to(cuda)
    before = wa.launches[wa.ATTN_FWD_BF16]
    o = wa.window_attention(*args)
    got = torch.autograd.grad(o, leaves, gt)
    assert wa.launches[wa.ATTN_FWD_BF16] == before + 1
    o_p = wa.window_attention_fwd_plain(*args)
    want = torch.autograd.grad(o_p, leaves, gt)
    _within(_np(o), _np(o_p), CARD_ATOL, "o")
    for name, a, b in zip(("dq", "dk", "dv"), got[:3], want[:3]):
        _within(_np(a), _np(b), GRAD_ATOL, name)
    torch.testing.assert_close(got[3], want[3], rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)


# the bf16 kernels' shared memory per block at the stage shapes (n, masked),
# forward and backward: the budgets of csrc/window_attention_bf16.cu's
# design note (two stages of q, k, v for 4 heads x 193 rows of 16 B; the
# backward's stages, p and ds tiles and outputs); the mask changes neither
BF16_SMEM = {"stage0": (32, False, 74_112, 63_616),
             "stage0_shifted": (32, True, 74_112, 63_616),
             "stage1": (8, False, 74_112, 35_968)}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(BF16_SMEM))
def test_bf16_occupancy_reports_the_kernels_shared_memory_on_card(cuda,
                                                                   case):
    n, masked, fwd_smem, bwd_smem = BF16_SMEM[case]
    assert wa.fwd_occupancy(n, 8, masked, BF16)[0] == fwd_smem
    assert wa.bwd_occupancy(n, 8, masked, BF16)[0] == bwd_smem
    assert wa.fwd_occupancy(n, 8, masked, BF16)[1] >= 1
    assert wa.bwd_occupancy(n, 8, masked, BF16)[1] >= 1
    assert all(0 < r <= 255 for r in wa.bf16_registers(n, 8))
