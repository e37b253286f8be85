# ------------------------------------------------------------------
"""The per-variable Dense layer's weight-gradient kernel
(kernels/grouped_dense.py, csrc/grouped_wgrad.cu).

CPU: ``GroupedDenseFunction``'s and ``grouped_dense_reference``'s dx, dW
and db against autograd of the einsum it replaces, at every (I, O) of the Mamba and Swin_3D encoders
(and I = 1 with O = 3), with and without a bias, with a non-contiguous
input and a token count that is a multiple of no chunk; the limit the
kernel is held to (``bench_grouped_wgrad.float64_wgrad``: the float32
sums' rounding) holds float32 sums along the plan's longest chains and
rejects TF32 operands; the plan's splits. Card (``-m gpu``): the kernel
against float64 at the same shapes, and on TF32-rounded operands beyond
the limit, bit-equal reruns, bf16 within one bf16 ulp of cuBLAS's weight
gradient, inside a captured CUDA graph, the forward bit-identical to the
einsum, and a Mamba block's backward launching it for every Dense
layer. No JAX here:
``python -m pytest --noconftest tests/test_torch_grouped_dense.py -m gpu``.
"""
# ------------------------------------------------------------------

import pytest
import torch

from idee_tpu_torch.kernels import bench_grouped_wgrad as bench
from idee_tpu_torch.kernels import grouped_dense as gd

V = 6
# (I, O, bias) of every GroupedDense of the two encoders at the bench
# width: Mamba's in_proj, x_proj, dt_proj, out_proj, mlp_fc1, mlp_fc2;
# Swin_3D's qkv, proj (mlp as Mamba's); and the narrowest pair
SHAPES = [(16, 32, False), (16, 3, False), (1, 16, True), (16, 16, False),
          (16, 64, True), (64, 16, True), (16, 48, True), (16, 16, True),
          (1, 3, False)]
SHAPE_IDS = [f"{i}x{o}{'b' if b else ''}" for i, o, b in SHAPES]


def _inputs(I, O, lead, dtype=torch.float32, seed=0, device="cpu",
            contiguous=True, V=V):
    g = torch.Generator().manual_seed(seed)
    if contiguous:
        x = torch.randn(*lead, V * I, generator=g)
    else:
        # the layout of out_proj's input, the scan output's transpose
        x = torch.randn(lead[1], lead[0], V * I, generator=g).transpose(0, 1)
    w = torch.randn(V, I, O, generator=g) / I ** 0.5
    b = torch.randn(V * O, generator=g)
    gy = torch.randn(*lead, V * O, generator=g)
    return tuple(t.to(device=device, dtype=dtype) for t in (x, w, b, gy))


def _grads(fn, x, w, b, gy):
    leaves = [t.detach().clone().requires_grad_(True) for t in (x, w)]
    if b is not None:
        leaves.append(b.detach().clone().requires_grad_(True))
    y = fn(*leaves[:2], leaves[2] if b is not None else None)
    y.backward(gy)
    return (y.detach(),) + tuple(t.grad for t in leaves)


def _within_rounding(got, want, limit, extra=0.0):
    err = (got.double() - want).abs()
    bad = bench.beyond(got, want, limit, extra)
    assert bad == 0, f"{bad} entries beyond rounding; max err {err.max()}"


def _tf32_misses(fn, x, gy, I, O, bias, V=V):
    """Entries that fn's dW and db of TF32-rounded operands put beyond the
    limit of the float32 operands' float64 sums, and the entries."""
    want, want_b, limit, limit_b = bench.float64_wgrad(x, gy, I, O, bias,
                                                       V=V)
    dw, db = fn(bench.tf32_rounded(x), bench.tf32_rounded(gy))
    n = bench.beyond(dw, want, limit)
    if bias:
        n += bench.beyond(db, want_b, limit_b)
    return n, want.numel() + (want_b.numel() if bias else 0)


# ---------------------------------------------------------------- CPU

@pytest.mark.parametrize("fn", [gd.GroupedDenseFunction.apply,
                                gd.grouped_dense_reference],
                         ids=["function", "reference"])
@pytest.mark.parametrize("contiguous", [True, False],
                         ids=["contiguous", "transposed"])
@pytest.mark.parametrize("I,O,bias", SHAPES, ids=SHAPE_IDS)
def test_function_matches_einsum_autograd(I, O, bias, contiguous, fn):
    # 3 x 37 tokens: a multiple of no tile, chunk or group
    x, w, b, gy = _inputs(I, O, (3, 37), contiguous=contiguous)
    b = b if bias else None
    want = _grads(gd.grouped_dense_plain, x, w, b, gy)
    got = _grads(fn, x, w, b, gy)
    assert torch.equal(got[0], want[0])  # the same einsum forward
    for name, a, e in zip(("dx", "dW", "db"), got[1:], want[1:]):
        assert a.shape == e.shape and a.dtype == e.dtype, name
        torch.testing.assert_close(a, e, msg=lambda m: f"{name}: {m}")


def test_function_grads_only_what_is_asked():
    x, w, b, gy = _inputs(16, 16, (40,))
    x.requires_grad_(True)
    y = gd.GroupedDenseFunction.apply(x, w, b)
    (dx,) = torch.autograd.grad(y, x, gy)
    torch.testing.assert_close(dx, gd.grouped_dense_plain(
        gy, w.transpose(1, 2)))


def _chain_sums(x, gy, I, O):
    """dW and db of x [M, V*I] and gy [M, V*O] as float32 sums along the
    plan's longest chains: each chunk's tokens in order, then the chunks'
    partials in order (products rounded apart from the adds)."""
    M = x.shape[0]
    p = gd.wgrad_plan(M, V, I, O, True, 4)
    pad = p.n_chunks * p.chunk_len - M
    x4 = torch.nn.functional.pad(x, (0, 0, 0, pad)).reshape(
        p.n_chunks, p.chunk_len, V, I, 1)
    x4 = torch.cat([x4, torch.ones_like(x4[:, :, :, :1])], 3)
    g4 = torch.nn.functional.pad(gy, (0, 0, 0, pad)).reshape(
        p.n_chunks, p.chunk_len, V, 1, O)
    part = torch.zeros(p.n_chunks, V, I + 1, O)
    for t in range(p.chunk_len):
        part += x4[:, t] * g4[:, t]
    total = torch.zeros(V, I + 1, O)
    for c in range(p.n_chunks):
        total += part[c]
    return total[:, :I], total[:, I].reshape(V * O)


@pytest.mark.parametrize("offset", [0.0, 1.0], ids=["centred", "offset"])
@pytest.mark.parametrize("I,O,bias", SHAPES, ids=SHAPE_IDS)
def test_limit_holds_float32_sums_and_rejects_tf32(I, O, bias, offset):
    # 10,007 tokens: 251 chunks of 40; with an offset the terms' mean
    # outweighs their spread, the partial sums grow along the chains
    x, _, _, gy = _inputs(I, O, (10_007,), seed=3)
    x, gy = x + offset, gy + offset / 2
    want, want_b, limit, limit_b = bench.float64_wgrad(x, gy, I, O, True)
    dw, db = _chain_sums(x, gy, I, O)
    _within_rounding(dw, want, limit)
    _within_rounding(db, want_b, limit_b)
    # float64 sums of TF32 operands: the operands' rounding alone
    bad, entries = _tf32_misses(
        lambda a, b: gd.grouped_wgrad_plain(a.double(), b.double(), V,
                                            bias), x, gy, I, O, bias)
    assert bad > entries // 2, (bad, entries)


@pytest.mark.parametrize("I,O,bias", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("elem", [4, 2], ids=["float32", "bf16"])
def test_plan_covers_the_tokens_in_aligned_chunks(I, O, bias, elem):
    for M in (1, 7, 1003, 320_000, 3_407_872):
        p = gd.wgrad_plan(M, V, I, O, bias, elem)
        assert p.chunk_len % 8 == 0 and p.tile % 8 == 0
        assert (p.n_chunks - 1) * p.chunk_len < M <= p.n_chunks * p.chunk_len
        assert p.threads <= 512 and p.threads % 32 == 0
        assert p.units * p.groups <= p.threads
        assert p.units * p.y_groups >= V * -(-I // 4) * -(-O // 4)
        assert p.smem_bytes <= 232_448
        assert p.sum_out * p.sum_runs <= 1024
        assert p.E == V * I * O + (V * O if bias else 0)
        assert p == gd.wgrad_plan(M, V, I, O, bias, elem)
    # the bench's 320,000 tokens: two blocks on each of the 132 SMs
    assert gd.wgrad_plan(320_000, V, I, O, bias, elem).n_chunks == 264


def test_plan_splits_many_outputs_over_blocks():
    # ERA5-Land's 9 variables: mlp_fc1's 4x4 blocks and bias quads need
    # more than a block's 512 threads
    p = gd.wgrad_plan(320_000, 9, 16, 64, True, 4)
    assert p.y_groups == 2 and p.units == 512 and p.groups == 1
    assert p.n_chunks * p.y_groups >= 264


def test_plan_raises_on_rows_too_wide_for_shared_memory():
    with pytest.raises(ValueError, match="shared memory"):
        gd.wgrad_plan(1000, 6, 2048, 2048, False, 4)
    with pytest.raises(ValueError, match="empty"):
        gd.wgrad_plan(0, 6, 16, 16, False, 4)


def test_wgrad_raises_on_mismatched_inputs():
    x, _, _, gy = _inputs(16, 16, (10,))
    with pytest.raises(ValueError, match="leading axes"):
        gd.grouped_wgrad(x, gy[:5], V, False)
    with pytest.raises(ValueError, match="groups"):
        gd.grouped_wgrad(x[:, :95], gy, V, False)
    with pytest.raises(ValueError, match="differ"):
        gd.grouped_wgrad(x, gy.double(), V, False)


def test_layer_on_cpu_is_the_einsum_under_autograd():
    from idee_tpu_torch.nn.layers import GroupedDense

    layer = GroupedDense(V, 16, 64)
    x = torch.randn(2, 5, V * 16, requires_grad=True)
    y = layer(x)
    assert type(y.grad_fn).__name__ == "AddBackward0"
    want = gd.grouped_dense_plain(x, layer.kernel,
                                  layer.bias.reshape(V * 64))
    assert torch.equal(y, want)


# ---------------------------------------------------------------- card only

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def _bf16_ulp(t):
    m, e = torch.frexp(t.float().abs())
    return torch.where(m == 0, 0.0, torch.ldexp(torch.ones_like(m), e - 8))


@pytest.mark.gpu
@pytest.mark.parametrize("contiguous", [True, False],
                         ids=["contiguous", "transposed"])
@pytest.mark.parametrize("I,O,bias", SHAPES, ids=SHAPE_IDS)
def test_kernel_matches_float64_on_card(cuda, I, O, bias, contiguous):
    # 7 x 5,717 tokens: a multiple of no tile, chunk or group
    x, _, _, gy = _inputs(I, O, (7, 5717), device=cuda, seed=5,
                          contiguous=contiguous)
    before = dict(gd.launches)
    dw, db = gd.grouped_wgrad(x, gy, V, bias)
    torch.cuda.synchronize()
    assert gd.launches[gd.GROUPED_WGRAD] == before[gd.GROUPED_WGRAD] + 1
    assert (gd.launches[gd.GROUPED_WGRAD_SUM]
            == before[gd.GROUPED_WGRAD_SUM] + 1)
    want, want_b, limit, limit_b = bench.float64_wgrad(x, gy, I, O, bias)
    assert dw.dtype == torch.float32 and dw.shape == (V, I, O)
    _within_rounding(dw, want, limit)
    if bias:
        _within_rounding(db, want_b, limit_b)
    # the control: the kernel's sums of TF32 operands miss the limit
    bad, entries = _tf32_misses(
        lambda a, b: gd.grouped_wgrad(a, b, V, bias), x, gy, I, O, bias)
    assert bad > entries // 2, (bad, entries)


@pytest.mark.gpu
def test_kernel_splits_many_outputs_over_blocks_on_card(cuda):
    x, _, _, gy = _inputs(16, 64, (30_011,), device=cuda, seed=4, V=9)
    assert gd.wgrad_plan(30_011, 9, 16, 64, True, 4).y_groups == 2
    dw, db = gd.grouped_wgrad(x, gy, 9, True)
    want, want_b, limit, limit_b = bench.float64_wgrad(x, gy, 16, 64, True,
                                                       V=9)
    _within_rounding(dw, want, limit)
    _within_rounding(db, want_b, limit_b)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bf16"])
@pytest.mark.parametrize("I,O,bias", SHAPES[:6], ids=SHAPE_IDS[:6])
def test_kernel_is_bitwise_deterministic_on_card(cuda, I, O, bias, dtype):
    x, _, _, gy = _inputs(I, O, (320_000,), dtype=dtype, device=cuda,
                          seed=6)
    runs = [gd.grouped_wgrad(x, gy, V, bias) for _ in range(2)]
    assert torch.equal(runs[0][0], runs[1][0])
    if bias:
        assert torch.equal(runs[0][1], runs[1][1])


@pytest.mark.gpu
@pytest.mark.parametrize("I,O,bias", SHAPES, ids=SHAPE_IDS)
def test_bf16_kernel_within_one_ulp_of_cublas_on_card(cuda, I, O, bias):
    x, w, b, gy = _inputs(I, O, (40_003,), dtype=torch.bfloat16,
                          device=cuda, seed=7)
    b = b if bias else None
    want = _grads(gd.grouped_dense_plain, x, w, b, gy)
    got = _grads(gd.GroupedDenseFunction.apply, x, w, b, gy)
    assert torch.equal(got[0], want[0])
    # dx, the transposed einsum: float32 sums of O exact products, rounded
    # once, so within one bf16 ulp of float64 plus O EPS of the sum of
    # their magnitudes (at I = 1 autograd of the einsum multiplies by
    # broadcast and rounds each product to bf16 before summing, so its dx
    # is no yardstick there)
    g3, w64 = gy.double().reshape(-1, V, O), w.double()
    dx64 = torch.einsum("mvo,vio->mvi", g3, w64).reshape(got[1].shape)
    dx_mag = torch.einsum("mvo,vio->mvi", g3.abs(), w64.abs()).reshape(
        got[1].shape)
    _within_rounding(got[1], dx64, O * bench.EPS * dx_mag,
                     extra=_bf16_ulp(dx64).double())
    dw64, db64, limit, limit_b = bench.float64_wgrad(x, gy, I, O, bias)
    # dW and db: the float32 sums rounded once, so within half a bf16 ulp
    # of float64 plus the float32 sums' rounding
    assert got[2].dtype == torch.bfloat16
    _within_rounding(got[2], dw64, limit,
                     extra=_bf16_ulp(dw64).double() / 2)
    if bias:
        assert got[3].dtype == torch.bfloat16
        _within_rounding(got[3], db64, limit_b,
                         extra=_bf16_ulp(db64).double() / 2)
    # and one bf16 ulp of cuBLAS's where autograd of the einsum runs cuBLAS
    # (I > 1; at I = 1 it multiplies by broadcast, each product rounded to
    # bf16, and sums those), plus cuBLAS's own rounding
    if I > 1:
        err = (got[2].float() - want[2].float()).abs()
        allow = (_bf16_ulp(want[2])
                 + bench.cublas_allowance(x, gy, I, O).float())
        assert int((err > allow).sum()) == 0, err.max()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bf16"])
def test_kernel_in_a_cuda_graph_equals_eager_on_card(cuda, dtype):
    I, O, bias = 16, 64, True
    x, _, _, gy = _inputs(I, O, (50_000,), dtype=dtype, device=cuda,
                          seed=8)
    static_x, static_gy = x.clone(), gy.clone()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        gd.grouped_wgrad(static_x, static_gy, V, bias)  # warm up
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = gd.grouped_wgrad(static_x, static_gy, V, bias)
    for seed in (9, 10, 11):
        x, _, _, gy = _inputs(I, O, (50_000,), dtype=dtype, device=cuda,
                              seed=seed)
        static_x.copy_(x)
        static_gy.copy_(gy)
        graph.replay()
        torch.cuda.synchronize()
        eager = gd.grouped_wgrad(x, gy, V, bias)
        assert torch.equal(out[0], eager[0]) and torch.equal(out[1],
                                                              eager[1])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bf16"])
def test_forward_is_the_einsum_bit_for_bit_on_card(cuda, dtype):
    x, w, b, _ = _inputs(16, 64, (2, 300, 50), dtype=dtype, device=cuda,
                         seed=12)
    want = gd.grouped_dense_plain(x, w, b)
    xg = x.clone().requires_grad_(True)
    assert torch.equal(gd.grouped_dense(xg, w, b), want)
    assert torch.equal(gd.GroupedDenseFunction.apply(xg, w, b), want)
    with torch.inference_mode():
        assert torch.equal(gd.grouped_dense(x, w, b), want)
        assert torch.equal(gd.GroupedDenseFunction.apply(x, w, b), want)


@pytest.mark.gpu
def test_mamba_block_backward_runs_the_kernel_for_every_dense(cuda):
    from idee_tpu_torch.nn.layers import GroupedDense
    from idee_tpu_torch.nn.mamba import PackedMambaBlock

    block = PackedMambaBlock(V, 16, window_size=(2, 4, 4),
                             generator=torch.Generator().manual_seed(0)
                             ).to(cuda)
    dense = [m for m in block.modules() if isinstance(m, GroupedDense)]
    assert len(dense) == 6
    x = torch.randn(1, 8, 16, 16, V * 16, device=cuda, requires_grad=True)
    before = dict(gd.launches)
    block(x, train=True).square().mean().backward()
    torch.cuda.synchronize()
    for k in (gd.GROUPED_WGRAD, gd.GROUPED_WGRAD_SUM):
        assert gd.launches[k] - before[k] == len(dense), k
    assert all(m.kernel.grad is not None for m in dense)
