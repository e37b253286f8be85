# ------------------------------------------------------------------
"""The baseline zoo at bf16 (cfg.dtype = "bfloat16") against the JAX
package's at bf16, on the CPU, at the tiny widths of
test_torch_baselines_*.py, weights (their init plus N(0, 0.05)) carried
across by ``load_flax_params``.

* MIL: the eval forward of each variant (over CNN_3D, and RTFM over Mamba,
  DeepMIL over Swin_3D, JAX's Swin through its Pallas kernels in
  interpret mode): scores within 2e-2, features within 2e-2 x max |f|
  (the bf16 encoder-output tolerance of test_torch_bf16.py; the scores
  lie in [0, 1]).
* MIL: one train step per variant with the top-k selections pinned. The
  scores are computed in bf16, where ties and near-ties are common, and
  the two frameworks round in other places, so their own selections part
  (the flips, counted and printed: 10-12 of the 12 calls of DeepMIL,
  ARNet and RTFM, 0 of MGFN's, which scores in float32). JAX's losses
  take the port's selections (``masked_topk`` replaced while its loss,
  unrolled into the port's call order, is traced), so both differentiate
  through the same entries. The loss lies within rtol 5e-2 of JAX's at
  bf16. The gradients are held by relative L2 distance, not by the max
  entry that test_torch_bf16_train.py reads: they flow through the few
  selected pixels and through ReLU kinks (and BatchNorm) that bf16 noise
  moves, so JAX's own bf16 gradient already lies 0.02-0.20 (all leaves
  together) and up to 1.4 (one leaf) from its float32 one, and its max
  entries up to 0.36 x max |grad| from it (measured, the six cases). All
  leaves together, the port's bf16 gradient lies within JAX's bf16
  distance + 0.1 of JAX's float32 gradient (measured 0.02-0.17 against
  JAX's 0.02-0.20) and within 0.3 of JAX's bf16 one (measured
  0.02-0.21); each leaf whose JAX bf16 gradient lies within 0.25 of its
  float32 one lies within 0.75 of it (measured up to 0.66: Mamba's
  x_proj under RTFM). A zeroed or sign-flipped gradient lies 1 or 2 away.
  The parameters and their gradients stay float32.
* SimpleNet: the frozen backbone at bf16 (encoder output within 2e-2 x
  max) and the float32 head's scores on it.
* STEAL and UniAD, which JAX builds without a dtype: at
  dtype="bfloat16" the port's forward and step gradients are bit-equal
  to its float32 run, float32 throughout, and JAX's bf16 forward agrees
  within the float32 tests' 1e-5.
"""
# ------------------------------------------------------------------

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import idee_tpu_torch.baselines.mil.losses as port_mil_losses
from idee_tpu_torch.baselines.config import recon_config
from idee_tpu_torch.baselines.mil.driver import mil_total_loss
from idee_tpu_torch.baselines.recon.driver import build_recon_model
from idee_tpu_torch.models.interop import (flax_to_state_dict,
                                           load_flax_params)
from test_torch_baselines_mil import VARIANTS, _batch, _jax_variables
from test_torch_baselines_mil import _port_model as _mil_port_model
from test_torch_baselines_mil import _tiny as _mil_tiny
from test_torch_baselines_mil import jx  # noqa: F401
from test_torch_baselines_oneclass import _jax_models, _port_models
from test_torch_baselines_oneclass import _tiny as _oc_tiny
from test_torch_baselines_recon import _batch as _recon_batch
from test_torch_baselines_recon import _jax_variables as _recon_variables
from test_torch_baselines_recon import _tiny as _recon_tiny

torch.set_num_threads(1)

BF16 = dict(dtype="bfloat16")
OUT_TOL = 2e-2       # test_torch_bf16.py's encoder-output tolerance
LOSS_RTOL = 5e-2     # test_torch_bf16_train.py's
# the MIL step gradients, as relative L2 distances (see the docstring)
GRAD_MARGIN = 0.1    # the port's from float32, beyond JAX's bf16 one's
GRAD_APART = 0.3     # the port's from JAX's bf16 gradient
LEAF_JAX, LEAF_CAP = 0.25, 0.75


@pytest.fixture(scope="module")
def oc_jx():
    """What test_torch_baselines_oneclass.py's helpers read of JAX."""
    import jax
    import jax.numpy as jnp

    from idee_tpu.baselines.config import oneclass_config
    from idee_tpu.baselines.oneclass import driver
    from idee_tpu.baselines.oneclass.simplenet import SimpleNet

    return SimpleNamespace(jax=jax, jnp=jnp, cfg=oneclass_config,
                           driver=driver, SimpleNet=SimpleNet)


@pytest.fixture(scope="module")
def recon_jx():
    """What test_torch_baselines_recon.py's helpers read of JAX."""
    import jax
    import jax.numpy as jnp

    from idee_tpu.baselines.config import recon_config as jax_recon_config
    from idee_tpu.baselines.recon import driver

    return SimpleNamespace(jax=jax, jnp=jnp, cfg=jax_recon_config,
                           driver=driver)


def _spread(variables):
    """``variables`` with the heads scaled (the classifier and Aggregate x 4,
    the agent x 2): at the tiny init the scores lie within 0.005 of one
    value (float32 std 2e-4-6e-4, under bf16's resolution near 0.5, so
    JAX's bf16 scores are one value); scaled, their std is 0.017-0.048
    (measured, CNN_3D, both dtypes)."""
    factor = {"classifier": 4.0, "Aggregate": 4.0, "agent": 2.0}
    params = {k: (_scale(v, factor[k]) if k in factor else v)
              for k, v in variables["params"].items()}
    return {**variables, "params": params}


def _scale(tree, f):
    if isinstance(tree, dict):
        return {k: _scale(v, f) for k, v in tree.items()}
    return (np.asarray(tree) * f).astype(np.float32)


def _rel(a, b):
    return (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)


def _l2(a, b):
    """The relative L2 distance |a - b| / |b|."""
    return ((a - b).norm() / b.norm().clamp(min=1e-30)).item()


# ---------------------------------------------------------------- MIL forward

@pytest.mark.parametrize("encoder,variant", [
    ("CNN_3D", v) for v in VARIANTS] + [("Mamba", "rtfm"),
                                        ("Swin_3D", "deepmil")])
def test_mil_eval_forward_bf16_matches_jax(jx, encoder, variant):
    kw = _mil_tiny(encoder=encoder, **BF16)
    jmodel, variables = _jax_variables(jx, kw, variant)
    variables = _spread(variables)
    x = _batch(0)["x"]
    jx.runtime.set_force_pallas(True)
    try:
        want = jx.jax.jit(lambda v, a: jmodel.apply(v, a, train=False))(
            variables, x)
    finally:
        jx.runtime.set_force_pallas(False)
    cfg, model = _mil_port_model(kw, variant, variables)
    with torch.no_grad():
        got = model(torch.from_numpy(x).to(torch.bfloat16), train=False)
    assert got.scores.dtype == torch.float32
    ws = torch.from_numpy(np.asarray(want.scores))
    err = (got.scores - ws).abs().max().item()
    assert err <= OUT_TOL, f"scores {err} from JAX's at bf16"
    if want.features is None:
        assert got.features is None
    else:
        assert got.features.dtype == torch.float32
        err = _rel(got.features, torch.from_numpy(np.asarray(
            want.features)))
        assert err <= OUT_TOL, f"features {err} x max from JAX's at bf16"
    # the scores spread over many bf16 steps (``_spread``; 0.004 near 0.5)
    assert ws.std().item() > 5e-3


# ---------------------------------------------------------------- MIL step

def _record_port_selections(monkeypatch):
    """The port's masked_topk, recording every selection in call order."""
    calls = []
    topk = port_mil_losses.masked_topk

    def record(values, mask, k):
        top, idx, valid = topk(values, mask, k)
        calls.append(idx.numpy())
        return top, idx, valid

    monkeypatch.setattr(port_mil_losses, "masked_topk", record)
    return calls


def _jax_pinned_grads(jx, monkeypatch, kw, variant, variables, b,
                      selections):
    """(loss, gradients as numpy tree, flips) of JAX's MIL training loss on
    batch ``b`` with every masked_topk taking ``selections`` in call
    order (the loss unrolled by ``_jax_mil_loss``); flips: the calls whose
    own selection differs."""
    import idee_tpu.baselines.mil.losses as jl

    topk, calls, flips = jl.masked_topk, [0], []

    def pinned(values, mask, k):
        idx = jx.jnp.asarray(selections[calls[0]])
        calls[0] += 1
        own = topk(values, mask, k)[1]
        jx.jax.debug.callback(lambda d: flips.append(bool(d)),
                              jx.jnp.any(own != idx))
        filled = jx.jnp.where(mask[(...,) + (None,) * (values.ndim - 1)],
                              values, jl._FILL)
        top = jx.jnp.take_along_axis(filled, idx, axis=0)
        return top, idx, top > jl._FILL + 0.5

    monkeypatch.setattr(jl, "masked_topk", pinned)
    jcfg = jx.cfg(**kw)
    model = jx.build(jcfg, variant)
    extra = {k: v for k, v in variables.items() if k != "params"}

    def loss_fn(p):
        out = model.apply({"params": p, **extra}, b["x"], train=True,
                          mutable=list(extra))[0]
        return _jax_mil_loss(jx, jl, jcfg, variant, out,
                             b["mask_extreme_loss"])

    jx.runtime.set_force_pallas(True)
    try:
        loss, grads = jx.jax.jit(jx.jax.value_and_grad(loss_fn))(
            variables["params"])
        jx.jax.effects_barrier()
    finally:
        jx.runtime.set_force_pallas(False)
        monkeypatch.setattr(jl, "masked_topk", topk)
    assert calls[0] == len(selections)
    return float(loss), grads, sum(flips)


def _jax_mil_loss(jx, jl, cfg, variant, out, mask):
    """JAX's mil_total_loss (idee_tpu/baselines/mil/driver.py:44-103) with
    its vmaps over (n, v) unrolled into the port's loops, so that
    masked_topk runs once per (n, v) in the port's call order (the
    instance drop is off: nothing is drawn)."""
    jnp = jx.jnp
    scores = out.scores
    N, V, T, H, W = scores.shape
    s = jnp.transpose(scores, (0, 1, 3, 4, 2)).reshape(N, V, H * W, T)
    m = mask.reshape(N, H * W)
    mask_p, mask_n = m != 0, m == 0
    key, drop = jx.jax.random.PRNGKey(0), cfg.instance_drop_rate
    assert drop == 0.0
    if variant in ("rtfm", "mgfn"):
        feats = out.features
        f = jnp.transpose(feats, (0, 1, 3, 4, 2, 5)).reshape(
            N, V, H * W, T, feats.shape[-1])
    if variant == "mgfn":
        return sum(jl.mgfn_loss(s[:, v], f[:, v], mask_p, mask_n,
                                k=cfg.loss_k_mgfn,
                                lambda_mgfn=cfg.loss_lambda_mgfn,
                                margin=cfg.loss_margin_mgfn, drop_rate=drop,
                                train=True, rng=key) for v in range(V))
    total = 0.0
    for n in range(N):
        for v in range(V):
            if variant == "deepmil":
                total += jl.ranking_loss(s[n, v], mask_p[n], mask_n[n],
                                         k=cfg.loss_k_deepmil,
                                         drop_rate=drop, train=True,
                                         rng=key)
            elif variant == "arnet":
                k = max(int(H * W // cfg.loss_alpha_arnet), 1)
                total += jl.dmil_ranking_loss(s[n, v], mask_p[n],
                                              mask_n[n], k=k,
                                              drop_rate=drop, train=True,
                                              rng=key)
                total += jl.center_loss(s[n, v], mask_n[n],
                                        lambda_c=cfg.loss_lambda_c_arnet)
            else:
                total += jl.rtfm_loss(s[n, v], f[n, v], mask_p[n],
                                      mask_n[n], k=cfg.loss_k_rtfm,
                                      margin=cfg.loss_margin_rtfm,
                                      alpha=cfg.loss_alpha_rtfm,
                                      drop_rate=drop, train=True, rng=key)
    return total / N


@pytest.mark.parametrize("encoder,variant", [
    ("CNN_3D", v) for v in VARIANTS] + [("Mamba", "rtfm"),
                                        ("Swin_3D", "deepmil")])
def test_mil_train_step_bf16_matches_jax(jx, monkeypatch, encoder, variant):
    kw = _mil_tiny(encoder=encoder, **BF16)
    _, variables = _jax_variables(jx, kw, variant, seed=2)
    variables = _spread(variables)
    b = _batch(10)
    cfg, model = _mil_port_model(kw, variant, variables)
    selections = _record_port_selections(monkeypatch)
    model.train()
    out = model(torch.from_numpy(b["x"]).to(torch.bfloat16), train=True,
                generator=torch.Generator().manual_seed(0))
    loss = mil_total_loss(cfg, variant, out,
                          torch.from_numpy(b["mask_extreme_loss"]), True,
                          torch.Generator().manual_seed(0))
    loss.backward()
    assert selections

    want_loss, want, flips = _jax_pinned_grads(
        jx, monkeypatch, kw, variant, variables, b, selections)
    _, want32, _ = _jax_pinned_grads(
        jx, monkeypatch, dict(kw, dtype="float32"), variant, variables, b,
        selections)
    sd = model.state_dict()
    want = flax_to_state_dict({"params": want}, sd)
    want32 = flax_to_state_dict({"params": want32}, sd)
    np.testing.assert_allclose(loss.item(), want_loss, rtol=LOSS_RTOL)
    # every parameter with a gradient in JAX's float32 step (the rest are
    # zero in exact arithmetic, float noise in both frameworks)
    named = [(k, p) for k, p in model.named_parameters()
             if want32[k].abs().max().item() > 0]
    for k, p in named:
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32, k
        if _l2(want[k], want32[k]) <= LEAF_JAX:
            err = _l2(p.grad, want32[k])
            assert err <= LEAF_CAP, f"{k}: {err} from JAX's float32 gradient"
    got = torch.cat([p.grad.reshape(-1) for _, p in named])
    w16 = torch.cat([want[k].reshape(-1) for k, _ in named])
    w32 = torch.cat([want32[k].reshape(-1) for k, _ in named])
    jax_dev, dev, apart = _l2(w16, w32), _l2(got, w32), _l2(got, w16)
    print(f"{encoder}/{variant}: {flips} of {len(selections)} top-k "
          f"selections flip between the frameworks at bf16; gradient "
          f"(relative L2) {dev:.4f} from JAX's float32, JAX's bf16 "
          f"{jax_dev:.4f}, {apart:.4f} from JAX's bf16")
    assert dev <= jax_dev + GRAD_MARGIN
    assert apart <= GRAD_APART


# ---------------------------------------------------------------- SimpleNet

def test_simplenet_bf16_backbone_matches_jax(oc_jx):
    jx = oc_jx
    kw = _oc_tiny(**BF16)
    _, backbone, head, bb, hv = _jax_models(jx, kw)
    x = np.random.default_rng(1).normal(size=(2, 3, 1, 8, 16, 16)).astype(
        np.float32)
    z = backbone.apply(bb, x, train=False)
    assert z.dtype == jx.jnp.bfloat16
    want = head.apply(hv, z, train=False)
    _, pbb, phead = _port_models(kw, bb, hv)
    with torch.no_grad():
        pz = pbb(torch.from_numpy(x))
        got = phead(pz)
    assert pz.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in phead.parameters())
    zf = torch.from_numpy(np.asarray(z.astype(jx.jnp.float32)))
    assert _rel(pz.float(), zf) <= OUT_TOL
    assert got.z_n_scores.dtype == torch.float32
    err = _rel(got.z_n_scores,
               torch.from_numpy(np.asarray(want.z_n_scores)))
    assert err <= OUT_TOL, f"scores {err} x max from JAX's"


# ---------------------------------------------------------------- STEAL, UniAD

@pytest.mark.parametrize("which", ["steal", "uniad"])
def test_recon_baselines_compute_float32_at_bf16(recon_jx, which):
    jx = recon_jx
    kw = _recon_tiny(which)
    _, jmodel, variables = _recon_variables(jx, kw, which)
    b = _recon_batch(which, 1)
    x = b["x"][:, :, 0] if which == "steal" else b["x"][:, :, 0, 0]
    m = b["mask_extreme_loss_t"][:, 0]

    def port_run(dtype):
        cfg = recon_config(**dict(kw, dtype=dtype))
        model = build_recon_model(cfg, which, (16, 16))[0]
        model.load_state_dict(load_flax_params(cfg, variables, model))
        model.train()
        xt = torch.from_numpy(x)
        if which == "steal":
            out = model(xt).pred
        else:
            out = model(xt, torch.from_numpy(m)).loss_map
        out.float().mean().backward()
        assert all(p.dtype == torch.float32 for p in model.parameters())
        return out, {k: p.grad for k, p in model.named_parameters()}

    got, grads = port_run("bfloat16")
    ref, ref_grads = port_run("float32")
    assert got.dtype == torch.float32
    assert torch.equal(got, ref)
    for k, g in ref_grads.items():
        assert torch.equal(grads[k], g), k

    jmodel16 = jx.driver._build(jx.cfg(**dict(kw, dtype="bfloat16")),
                                which)[0]
    if which == "steal":
        want = jmodel16.apply(variables, x, train=False).pred
    else:
        want = jmodel16.apply(variables, x, m, train=False).loss_map
    assert want.dtype == jx.jnp.float32
    port_cfg = recon_config(**dict(kw, dtype="bfloat16"))
    model = build_recon_model(port_cfg, which, (16, 16))[0]
    model.load_state_dict(load_flax_params(port_cfg, variables, model))
    with torch.no_grad():
        ev = (model(torch.from_numpy(x)).pred if which == "steal" else
              model(torch.from_numpy(x), torch.from_numpy(m)).loss_map)
    np.testing.assert_allclose(ev.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
