# ------------------------------------------------------------------
"""The port's codebooks against the JAX package's: LFQ at any power-of-two
codebook_size, FSQ, LatentQuantize, VQ (learnable, EMA, k-means init,
dead-code expiry, gumbel sampling, cosine similarity, heads, the
orthogonal loss) and Random_VQ, plus the registry.

Each port module takes the JAX module's own initial variables (params and
the "codebook" collection) through ``flax_to_state_dict`` and the same
numpy-seeded inputs. The random draws of a JAX training forward (k-means
seed rows, gumbel uniforms, expiry rows) are recomputed from the key its
``make_rng("codebook")`` returned and fed to the port's forward as
``draws``. Tolerances, float32: values, losses and gradients rtol 1e-5 /
atol 1e-6; indices at least 99.9 % equal (at these sizes: all).

The JAX side is imported inside fixtures.
"""
# ------------------------------------------------------------------

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from idee_tpu_torch.models.interop import flax_to_state_dict
from idee_tpu_torch.quant import QUANTIZERS, get_quantizer
from idee_tpu_torch.quant.fsq import FSQ
from idee_tpu_torch.quant.latent_quantize import LatentQuantize
from idee_tpu_torch.quant.lfq import LFQ
from idee_tpu_torch.quant.random_vq import Random_VQ
from idee_tpu_torch.quant.vq import VQ, laplace_smoothing, orthogonal_loss_fn

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
PORT = {"LFQ": LFQ, "FSQ": FSQ, "LatentQuantize": LatentQuantize,
        "VQ": VQ, "Random_VQ": Random_VQ}


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp

    from idee_tpu import quant as jquant
    from idee_tpu.quant import vq as jvq

    keys = []

    class RecordingVQ(jquant.get_quantizer("VQ")):
        """The JAX VQ, recording the key of each make_rng("codebook")."""

        def make_rng(self, name="params"):
            key = super().make_rng(name)
            if name == "codebook":
                keys.append(key)
            return key

    return SimpleNamespace(jax=jax, jnp=jnp, quant=jquant, vq=jvq,
                           RecordingVQ=RecordingVQ, keys=keys)


def _np(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)


def _inputs(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(
        np.float32)


def _pair(jx, name, kw, x):
    """The JAX module of ``name`` with its own initial variables (from
    PRNGKey(0)), and the port module with the same variables."""
    jmod = (jx.RecordingVQ if name == "VQ"
            else jx.quant.get_quantizer(name))(**kw)
    variables = jmod.init({"params": jx.jax.random.PRNGKey(0),
                           "codebook": jx.jax.random.PRNGKey(1)},
                          jx.jnp.asarray(x), train=False)
    mod = PORT[name](**kw)
    mod.load_state_dict(flax_to_state_dict(variables, mod.state_dict()))
    return jmod, variables, mod


def _jax_forward(jx, jmod, variables, x, train, r, key=2):
    """JAX forward: outputs, the updated collection, and (train) the
    gradients of aux_loss + sum(quantized * r) w.r.t. params and x."""
    jx.keys.clear()
    cb = {k: v for k, v in variables.items() if k != "params"}

    def f(params, xx):
        out, upd = jmod.apply({"params": params, **cb}, xx, train=train,
                              rngs={"codebook": jx.jax.random.PRNGKey(key)},
                              mutable=list(cb) or False) if cb else (
            jmod.apply({"params": params}, xx, train=train), {})
        return out.aux_loss + jx.jnp.sum(out.quantized * r), (out, upd)

    (_, (out, upd)), grads = jx.jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(variables.get("params", {}),
                                        jx.jnp.asarray(x))
    return out, _np(upd), grads


def _port_forward(mod, x, train, r, draws=None):
    xt = torch.from_numpy(x).requires_grad_()
    kw = {} if draws is None else {"draws": draws}
    out = mod(xt, train=train, **kw)
    loss = out.aux_loss + (out.quantized * torch.from_numpy(r)).sum()
    if train and loss.requires_grad:
        loss.backward()
    return out, xt.grad


def _close(got, want, what, rtol=RTOL, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=what)


def _same_indices(got, want, what):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape, what
    assert got.dtype == np.int32, what
    assert (got == want).mean() >= 0.999, what


def _check(jx, name, kw, x, train, draws_from=None):
    """One forward of both, with the input (and parameter) gradients of
    aux_loss + sum(quantized * r) under train."""
    jmod, variables, mod = _pair(jx, name, kw, x)
    out_dim = mod.vq.dim if isinstance(mod, Random_VQ) else x.shape[-1]
    r = _inputs(99, x.shape[:2] + (out_dim,))
    want, upd, (want_gp, want_gx) = _jax_forward(jx, jmod, variables, x,
                                                 train, r)
    draws = draws_from(jx, x) if draws_from else None
    got, gx = _port_forward(mod, x, train, r, draws)
    _close(got.quantized, want.quantized, f"{name} quantized")
    _same_indices(got.indices, want.indices, f"{name} indices")
    _close(got.aux_loss, want.aux_loss, f"{name} aux_loss")
    if train:
        _close(gx if gx is not None else np.zeros_like(x), want_gx,
               f"{name} input gradient")
        for k, w in flax_to_state_dict(want_gp, mod.state_dict()).items():
            p = dict(mod.named_parameters())[k]
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            _close(g, w, f"{name} gradient of {k}")
    return mod, upd


# ---------------------------------------------------------------- registry

def test_registry_names_and_error_match_jax(jx):
    assert sorted(QUANTIZERS) == sorted(jx.quant.QUANTIZERS)
    for name in QUANTIZERS:
        assert get_quantizer(name) is PORT[name]
    with pytest.raises(NotImplementedError) as got:
        get_quantizer("nope")
    with pytest.raises(NotImplementedError) as want:
        jx.quant.get_quantizer("nope")
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------- LFQ

@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("size,books", [(2, 1), (4, 1), (8, 1), (4, 2)])
def test_lfq_any_codebook_size_matches_jax(jx, size, books, train):
    kw = dict(dim=8, codebook_size=size, num_codebooks=books,
              entropy_loss_weight=0.1, diversity_gamma=0.5,
              commitment_loss_weight=1.5, inv_temperature=10.0)
    x = _inputs(1, (2, 40, 8), 0.5)
    mod, _ = _check(jx, "LFQ", kw, x, train)
    jmod, variables, _ = _pair(jx, "LFQ", kw, x)
    idx = np.arange(size)
    # the JAX projection takes one codebook's bits only
    proj = books == 1
    want = jmod.apply(variables, jx.jnp.asarray(idx), proj,
                      method=jmod.indices_to_codes)
    _close(mod.indices_to_codes(torch.from_numpy(idx), proj), want,
           "indices_to_codes")


def test_lfq_frozen_out_projection_matches_jax(jx):
    kw = dict(dim=8, codebook_size=2, freeze_project_out=True)
    mod, _ = _check(jx, "LFQ", kw, _inputs(2, (2, 40, 8)), True)
    assert mod.project_out.weight.grad is None


# ---------------------------------------------------------------- FSQ

@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("levels,dim,books", [((2,), 16, 1),
                                              ((3, 5, 4), 16, 1),
                                              ((3, 5, 4), None, 1),
                                              ((5, 3), 8, 2)])
def test_fsq_matches_jax(jx, levels, dim, books, train):
    kw = dict(levels=levels, dim=dim, num_codebooks=books)
    width = dim or len(levels) * books
    x = _inputs(3, (2, 40, width), 2.0)
    mod, _ = _check(jx, "FSQ", kw, x, train)
    jmod, variables, _ = _pair(jx, "FSQ", kw, x)
    n = int(np.prod(levels))
    idx = np.stack([np.arange(n), np.arange(n)[::-1]][:books], -1)
    idx = idx[:, 0] if books == 1 else idx  # [n] or [n, books]
    want = jmod.apply(variables, jx.jnp.asarray(idx),
                      method=jmod.indices_to_codes)
    _close(mod.indices_to_codes(torch.from_numpy(idx)), want,
           "indices_to_codes")
    codes = mod.indices_to_codes(torch.from_numpy(idx), project_out=False)
    back = mod.codes_to_indices(codes.reshape(n, books, len(levels)))
    assert back.reshape(idx.shape).tolist() == idx.tolist()


# -------------------------------------------------------- LatentQuantize

@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("levels,dim", [((2,), 16), ((3, 3), 8),
                                        ((3, 5), 8), ((4, 2), None)])
def test_latent_quantize_matches_jax(jx, levels, dim, train):
    kw = dict(levels=levels, dim=dim, commitment_loss_weight=0.7,
              quantization_loss_weight=1.3)
    width = dim or len(levels)
    x = _inputs(4, (2, 40, width))
    mod, _ = _check(jx, "LatentQuantize", kw, x, train)
    names = {n for n, _ in mod.named_parameters()}
    assert ("values_per_latent" in names) == (len(set(levels)) == 1)
    jmod, variables, _ = _pair(jx, "LatentQuantize", kw, x)
    idx = np.arange(int(np.prod(levels)))
    want = jmod.apply(variables, jx.jnp.asarray(idx),
                      method=jmod.indices_to_codes)
    _close(mod.indices_to_codes(torch.from_numpy(idx)), want,
           "indices_to_codes")


# ---------------------------------------------------------------- VQ

def _jax_draws(jx, vq, M, train=True):
    """The draws of the JAX VQ's last training forward, from the key its
    make_rng("codebook") returned (idee_tpu/quant/vq.py:233-308)."""
    jax = jx.jax
    key = jx.keys[-1]
    H, K = (vq.heads if vq.separate_codebook_per_head else 1,
            vq.codebook_size)
    out = {}
    if vq.kmeans_init:
        k, key = jax.random.split(key)
        out["kmeans"] = jax.random.randint(k, (H, K), 0, M)
    if vq.stochastic_sample_codes:
        k, key = jax.random.split(key)
        out["gumbel"] = jax.random.uniform(k, (H, M, K), minval=1e-20,
                                           maxval=1.0)
    if vq.ema_update and vq.threshold_ema_dead_code > 0:
        k, key = jax.random.split(key)
        out["expire"] = jax.random.randint(k, (H, K), 0, M)
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("extra", [
    {}, {"use_cosine_sim": True}, {"codebook_dim": 4},
    {"heads": 2, "codebook_dim": 4, "separate_codebook_per_head": True},
    {"heads": 2, "codebook_dim": 4},
    {"orthogonal_reg_weight": 10.0},
    {"orthogonal_reg_weight": 10.0, "orthogonal_reg_active_codes_only": True,
     "codebook_size": 16},
    {"freeze_codebook": True}])
def test_learnable_vq_matches_jax(jx, extra, train):
    kw = dict(dim=8, codebook_size=6, codebook_dim=8, commitment_weight=0.7)
    kw.update(extra)
    x = _inputs(5, (2, 48, 8))
    mod, _ = _check(jx, "VQ", kw, x, train)
    trainable = not kw.get("freeze_codebook", False)
    assert isinstance(mod.embed, torch.nn.Parameter) == trainable
    if train and trainable:
        assert mod.embed.grad.abs().max() > 0
    jmod, variables, _ = _pair(jx, "VQ", kw, x)
    idx = np.arange(kw["codebook_size"])
    want = jmod.apply(variables, jx.jnp.asarray(idx),
                      method=jmod.indices_to_codes)
    _close(mod.indices_to_codes(torch.from_numpy(idx)), want,
           "indices_to_codes")


def test_vq_gumbel_sampling_matches_jax_with_its_draws(jx):
    kw = dict(dim=8, codebook_size=6, codebook_dim=8,
              stochastic_sample_codes=True, sample_codebook_temp=0.5)
    x = _inputs(6, (2, 48, 8))
    _check(jx, "VQ", kw, x, True,
           draws_from=lambda jx, x: _jax_draws(jx, VQ(**kw), 96))


@pytest.mark.parametrize("cosine", [False, True])
def test_vq_ema_three_steps_match_jax(jx, cosine):
    """Three EMA training steps (no k-means, no expiry: no randomness):
    outputs, loss and the collection after each step."""
    kw = dict(dim=8, codebook_size=5, codebook_dim=8, ema_update=True,
              learnable_codebook=False, decay=0.8, use_cosine_sim=cosine)
    xs = [_inputs(10 + i, (2, 48, 8)) for i in range(3)]
    jmod, variables, mod = _pair(jx, "VQ", kw, xs[0])
    assert not dict(mod.named_parameters())
    cb = variables["codebook"]
    for i, x in enumerate(xs):
        (want, _, loss), upd = jmod.apply({"codebook": cb},
                                          jx.jnp.asarray(x), train=True,
                                          mutable=["codebook"])
        cb = _np(upd["codebook"])
        got = mod(torch.from_numpy(x), train=True)
        _close(got.quantized, want, f"step {i} quantized")
        _close(got.aux_loss, loss, f"step {i} loss")
        for k in ("cluster_size", "embed_avg", "embed", "initted"):
            _close(getattr(mod, k), cb[k], f"step {i} {k}")
    # the eval forward leaves the state alone
    before = {k: v.clone() for k, v in mod.state_dict().items()}
    mod(torch.from_numpy(xs[0]), train=False)
    for k, v in mod.state_dict().items():
        assert torch.equal(v, before[k]), k


@pytest.mark.parametrize("cosine", [False, True])
def test_vq_kmeans_matches_jax_with_its_init_indices(jx, cosine):
    kw = dict(dim=4, codebook_size=5, codebook_dim=4, ema_update=True,
              learnable_codebook=False, kmeans_init=True, kmeans_iters=6,
              use_cosine_sim=cosine)
    z = _inputs(20, (1, 200, 4))
    jmod, variables, mod = _pair(jx, "VQ", kw, z)
    key = jx.jax.random.PRNGKey(7)
    want_means, want_bins = jmod.apply(variables, jx.jnp.asarray(z), key,
                                       method=jx.vq.VQ._kmeans)
    idx = np.array(jx.jax.random.randint(key, (1, 5), 0, 200))
    means, bins = mod.kmeans(torch.from_numpy(z), torch.from_numpy(idx))
    _close(means, want_means, "means")
    _close(bins, want_bins, "bins")
    assert bins.sum().item() == 200


def test_vq_kmeans_init_runs_once_as_in_jax(jx):
    """The first training forward k-means-initialises the codebook (with
    JAX's seed rows fed in), every later one keeps it; the state after
    each of two steps equals JAX's."""
    kw = dict(dim=4, codebook_size=4, codebook_dim=4, ema_update=True,
              learnable_codebook=False, kmeans_init=True, kmeans_iters=5)
    xs = [_inputs(30 + i, (2, 50, 4)) for i in range(2)]
    jmod, variables, mod = _pair(jx, "VQ", kw, xs[0])
    assert mod.initted.item() == 0.0 and not mod._initted
    with torch.inference_mode():  # eval before training: index 0
        assert mod(torch.from_numpy(xs[0])).indices.abs().sum() == 0
    cb = variables["codebook"]
    calls = []
    kmeans = mod.kmeans
    mod.kmeans = lambda *a: calls.append(1) or kmeans(*a)
    for i, x in enumerate(xs):
        jx.keys.clear()
        (want, want_idx, loss), upd = jmod.apply(
            {"codebook": cb}, jx.jnp.asarray(x), train=True,
            mutable=["codebook"],
            rngs={"codebook": jx.jax.random.PRNGKey(i)})
        cb = _np(upd["codebook"])
        got = mod(torch.from_numpy(x), train=True,
                  draws=_jax_draws(jx, mod, 100))
        _close(got.quantized, want, f"step {i} quantized")
        _same_indices(got.indices, want_idx, f"step {i} indices")
        _close(got.aux_loss, loss, f"step {i} loss")
        for k in ("cluster_size", "embed_avg", "embed", "initted"):
            _close(getattr(mod, k), cb[k], f"step {i} {k}")
    assert calls == [1] and mod._initted


def test_vq_dead_code_expiry_matches_jax(jx):
    """Codes whose decayed cluster size falls under the threshold take a
    row of z as their code and the reset size; with JAX's expiry rows fed
    in, the whole state equals JAX's."""
    kw = dict(dim=4, codebook_size=8, codebook_dim=4, ema_update=True,
              learnable_codebook=False, decay=0.8,
              threshold_ema_dead_code=2.0)
    x = _inputs(40, (1, 64, 4))
    jmod, variables, mod = _pair(jx, "VQ", kw, x)
    jx.keys.clear()
    (want, want_idx, _), upd = jmod.apply(
        variables, jx.jnp.asarray(x), train=True, mutable=["codebook"],
        rngs={"codebook": jx.jax.random.PRNGKey(3)})
    cb = _np(upd["codebook"])
    draws = _jax_draws(jx, mod, 64)
    got = mod(torch.from_numpy(x), train=True, draws=draws)
    _close(got.quantized, want, "quantized")
    _same_indices(got.indices, want_idx, "indices")
    bins = np.bincount(np.asarray(want_idx).ravel(), minlength=8)
    expired = 0.2 * bins < 2.0
    assert 0 < expired.sum() < 8
    for k in ("cluster_size", "embed_avg", "embed"):
        _close(getattr(mod, k), cb[k], k)
    np.testing.assert_array_equal(mod.cluster_size[0].numpy()[expired], 2.0)
    rows = x.reshape(-1, 4)[draws["expire"][0].numpy()[expired]]
    np.testing.assert_array_equal(mod.embed[0].numpy()[expired], rows)


@pytest.mark.parametrize("mask", [False, True])
def test_orthogonal_loss_matches_jax(jx, mask):
    t = _inputs(50, (2, 6, 4))
    m = (np.arange(12).reshape(2, 6) % 3 != 0).astype(np.float32)
    want = jx.vq.orthogonal_loss_fn(jx.jnp.asarray(t),
                                    jx.jnp.asarray(m) if mask else None)
    got = orthogonal_loss_fn(torch.from_numpy(t),
                             torch.from_numpy(m) if mask else None)
    _close(got, want, "orthogonal loss")
    c = np.array([[1.0, 0.0, 3.0]], np.float32)
    _close(laplace_smoothing(torch.from_numpy(c), 3),
           jx.vq.laplace_smoothing(jx.jnp.asarray(c), 3), "laplace")


# ---------------------------------------------------------------- Random_VQ

@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("extra", [{}, {"num_codebooks": 2,
                                        "codebook_dim": 8}])
def test_random_vq_matches_jax(jx, extra, train):
    kw = dict(dim=8, codebook_size=4, codebook_dim=8)
    kw.update(extra)
    x = _inputs(60, (2, 40, 8))
    mod, upd = _check(jx, "Random_VQ", kw, x, train)
    assert not dict(mod.named_parameters())
    assert {"rand_projs", "vq.embed", "vq.initted"} <= set(mod.state_dict())
    xt = torch.from_numpy(x).requires_grad_()
    out = mod(xt, train=True)
    assert not out.quantized.requires_grad and out.aux_loss.item() == 0.0
    if train:  # frozen: the collection does not move
        for k, v in flax_to_state_dict({"params": {}, **upd},
                                       mod.state_dict()).items():
            _close(mod.state_dict()[k], v, k)
    idx = np.arange(4)
    jmod, variables, _ = _pair(jx, "Random_VQ", kw, x)
    want = jmod.apply(variables, jx.jnp.asarray(idx),
                      method=jmod.indices_to_codes)
    _close(mod.indices_to_codes(torch.from_numpy(idx)), want,
           "indices_to_codes")
