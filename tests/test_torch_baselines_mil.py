# ------------------------------------------------------------------
"""The port's MIL baselines (DeepMIL, ARNet, RTFM, MGFN) against the JAX
package: the models' eval forwards over CNN_3D, Mamba and Swin_3D (the
JAX Pallas scan and window attention in interpret mode), every MIL loss
against JAX and against naive ragged bags (bags smaller than k, tied
slots), the vote thresholds, two train steps per variant with the
BatchNorm statistics and vote sums, each variant's driver train + test
end to end with its vote map, and the CLIs' flags.

Tiny config (``tests/test_baselines.py::_tiny_mil``): 3 variables, 16x16,
delta_t=8, en_embed_dim=[8, 8], batch 2, every dropout, drop-path and
instance-drop rate 0 where the two frameworks are compared (their random
bits differ; the port's draws are checked for their own statistics).
Weights: the JAX model's own init plus N(0, 0.05) from a numpy seed,
BatchNorm statistics drawn too; carried across by ``load_flax_params``.
Tolerances, float32: scores and features atol 1e-5 / rtol 1e-5; losses
rtol 1e-5; step-1 gradients rtol 1e-4 / atol 1e-6; BatchNorm
buffers after 2 Adam steps atol 1e-5, parameters atol 1e-5 but for a
share of FAR_SHARE held to 2 lr (lr 1e-3), vote sums equal; driver
losses rtol 1e-4, RTFM's F1 and vote map equal, the others' (scores
centred on 0.5) F1 within 1e-3, vote maps equal at 99.5 % of the pixels.

The JAX side is imported inside fixtures, so the card-only test also
collects where JAX is not installed
(``python -m pytest --noconftest tests/test_torch_baselines_mil.py -m gpu``).
"""
# ------------------------------------------------------------------

import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from idee_tpu_torch.baselines.config import mil_config
from idee_tpu_torch.baselines.mil import losses as L
from idee_tpu_torch.baselines.mil.driver import (init_mil_metrics,
                                                 make_mil_train_step,
                                                 mil_total_loss)
from idee_tpu_torch.baselines.mil.driver import \
    test_mil_synthetic as port_test_mil
from idee_tpu_torch.baselines.mil.driver import \
    train_mil_synthetic as port_train_mil
from idee_tpu_torch.baselines.mil.models import build_mil_model
from idee_tpu_torch.data.fake import make_fake_cube
from idee_tpu_torch.models.interop import (flax_to_state_dict,
                                           load_flax_params, save_flax_npz)
from idee_tpu_torch.train.state import create_train_state

torch.set_num_threads(1)

VARS = ["var_01", "var_02", "var_03"]
VARIANTS = ["deepmil", "arnet", "rtfm", "mgfn"]
NO_DROP = dict(instance_drop_rate=0.0, cls_drop_rate=0.0,
               agent_drop_rate=0.0, agent_drop_path_rate=0.0)
T_LINE = 20


def _tiny(**kw) -> dict:
    base = dict(in_channels_dynamic=3, variables=VARS, x_max=16, y_max=16,
                en_embed_dim=[8, 8], en_depths=[1, 1], cls_dim=[32, 8, 1],
                loss_k_deepmil=5, loss_alpha_arnet=32, loss_k_rtfm=5,
                loss_k_mgfn=3, dim_mtn_rtfm=8, agent_embed_dim=[8],
                dim_head_mgfn=[8, 8], times_train=(1, 18),
                times_val=(19, 30), batch_size=2, n_epochs=2,
                lr_warmup_epochs=0, is_clima_scale=False, **NO_DROP)
    base.update(kw)
    return base


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp

    from idee_tpu.baselines.config import mil_config as jax_mil_config
    from idee_tpu.baselines.mil import driver as jdriver
    from idee_tpu.baselines.mil import losses as jlosses
    from idee_tpu.baselines.mil.models import build_mil_model as jbuild
    from idee_tpu.kernels import runtime
    from idee_tpu.train import state as jstate

    return SimpleNamespace(jax=jax, jnp=jnp, cfg=jax_mil_config,
                           driver=jdriver, losses=jlosses, build=jbuild,
                           runtime=runtime, state=jstate)


def _batch(seed: int, n: int = 2, t0: float = 1.0):
    rng = np.random.default_rng(seed)
    return {"x": rng.normal(size=(n, 3, 1, 8, 16, 16)).astype(np.float32),
            "mask_extreme_loss": (rng.random((n, 16, 16)) < 0.3).astype(
                np.float32),
            "timestep": np.array([[t0 + 7 + i] for i in range(n)],
                                 np.float32)}


def _jax_variables(jx, kw, variant, seed=1):
    """The JAX model of ``kw`` and its variables: its own init plus
    N(0, 0.05), BatchNorm means N(0, 0.1) and variances U(0.5, 1.5)."""
    model = jx.build(jx.cfg(**kw), variant)
    x = jx.jnp.zeros((2, 3, 1, 8, 16, 16), jx.jnp.float32)
    init = jx.jax.jit(lambda a: model.init(
        {"params": jx.jax.random.PRNGKey(seed)}, a, train=False))(x)
    rng = np.random.default_rng(seed)
    out = {"params": jx.jax.tree_util.tree_map(
        lambda p: (np.asarray(p) + 0.05 * rng.normal(size=p.shape))
        .astype(np.float32), init["params"])}
    if "batch_stats" in init:
        out["batch_stats"] = jx.jax.tree_util.tree_map(np.array,
                                                       init["batch_stats"])
        for path, leaf in list(_leaves(out["batch_stats"])):
            leaf[...] = (rng.normal(0, 0.1, leaf.shape) if path[-1] == "mean"
                         else rng.uniform(0.5, 1.5, leaf.shape))
    return model, out


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _port_model(kw, variant, variables):
    cfg = mil_config(**kw)
    model = build_mil_model(cfg, variant)
    model.load_state_dict(load_flax_params(cfg, variables, model))
    return cfg, model


# ---------------------------------------------------------------- forward

@pytest.mark.parametrize("encoder,variant", [
    ("CNN_3D", v) for v in VARIANTS] + [("Mamba", "rtfm"),
                                        ("Swin_3D", "deepmil")])
def test_eval_forward_matches_jax(jx, encoder, variant):
    kw = _tiny(encoder=encoder)
    jmodel, variables = _jax_variables(jx, kw, variant)
    x = _batch(0)["x"]
    jx.runtime.set_force_pallas(True)
    try:
        want = jx.jax.jit(lambda v, a: jmodel.apply(v, a, train=False))(
            variables, x)
    finally:
        jx.runtime.set_force_pallas(False)
    _, model = _port_model(kw, variant, variables)
    with torch.no_grad():
        got = model(torch.from_numpy(x), train=False)
    T = 1 if variant == "mgfn" else 8
    assert got.scores.shape == (2, 3, T, 16, 16)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=1e-5, atol=1e-5)
    if want.features is None:
        assert got.features is None
    else:
        np.testing.assert_allclose(got.features.numpy(),
                                   np.asarray(want.features), rtol=1e-5,
                                   atol=1e-5)


def test_agent_masks_its_own_variable_with_minus_1e9():
    """A tower never attends to its own variable (its key scores -1e9
    before the softmax): its output does not move when that variable's
    keys and values change in its view, and does when another's do."""
    from idee_tpu_torch.baselines.mil.agent import CrossVariableAttention

    torch.manual_seed(0)
    attn = CrossVariableAttention(3, 8, 8, 2)
    y = torch.randn(1, 2, 2, 2, 24)
    con = torch.randn(1, 2, 2, 2, 3, 3, 8)
    base = attn(y, con).reshape(1, 2, 2, 2, 3, 8)
    for v in range(3):
        own, other = con.clone(), con.clone()
        own[..., v, v, :] += 5.0       # tower v's view of variable v
        other[..., v, (v + 1) % 3, :] += 5.0
        assert torch.equal(attn(y, own).reshape(base.shape), base)
        moved = attn(y, other).reshape(base.shape)
        assert not torch.allclose(moved[..., v, :], base[..., v, :])


def _flax_module(jx, module, x, seed):
    """A flax module's variables from its init plus N(0, 0.05), the
    BatchNorm statistics drawn too."""
    v = module.init(jx.jax.random.PRNGKey(seed), x)
    rng = np.random.default_rng(seed)
    out = {"params": jx.jax.tree_util.tree_map(
        lambda p: (np.asarray(p) + 0.05 * rng.normal(size=p.shape))
        .astype(np.float32), v["params"])}
    if "batch_stats" in v:
        out["batch_stats"] = jx.jax.tree_util.tree_map(
            lambda a: (np.asarray(a) + rng.uniform(0.1, 0.5, a.shape))
            .astype(np.float32), v["batch_stats"])
    return out


@pytest.mark.parametrize("train", [False, True])
def test_non_local_block_and_glance_match_jax(jx, train):
    """The two modules off the default path: RTFM's NonLocalBlock1D (kept
    for inventory parity, not wired into Aggregate) and MGFN's glance
    branch (types_mgfn "gb"), in eval and training mode (BatchNorm
    statistics moved)."""
    from idee_tpu.baselines.mil.mgfn import MGFN as JMGFN
    from idee_tpu.baselines.mil.rtfm_net import NonLocalBlock1D as JNL

    from idee_tpu_torch.baselines.mil.mgfn import MGFN
    from idee_tpu_torch.baselines.mil.rtfm_net import NonLocalBlock1D

    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 10, 6)).astype(np.float32)
    jm = JNL(in_channels=6)
    v = _flax_module(jx, jm, x, 0)
    want, upd = jm.apply(v, x, train=train, mutable=["batch_stats"])
    pm = NonLocalBlock1D(6)
    pm.load_state_dict(load_flax_params(None, v, pm))
    got = pm(torch.from_numpy(x), train=train)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(pm.W_bn.var.numpy(), np.asarray(
        upd["batch_stats"]["W_bn"]["var"]), rtol=0, atol=1e-6)

    x = rng.normal(size=(2, 3, 4, 8)).astype(np.float32)
    kw = dict(embed_dim=8, dim=[8, 12, 1], mgfn_types=["gb", "fb"],
              dim_head=[4, 6])
    jm = JMGFN(**kw)
    v = _flax_module(jx, jm, x, 1)
    (feat, s), _ = jm.apply(v, x, train=train, mutable=["batch_stats"])
    pm = MGFN(**kw)
    pm.load_state_dict(load_flax_params(None, v, pm))
    gf, gs = pm(torch.from_numpy(x), train=train)
    np.testing.assert_allclose(gs.detach().numpy(), np.asarray(s),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gf.detach().numpy(), np.asarray(feat),
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- losses

def _bags(P, T, seed, small=False):
    rng = np.random.default_rng(seed)
    s = rng.random((P, T)).astype(np.float32)
    f = rng.normal(size=(P, T, 6)).astype(np.float32)
    mask = rng.random(P) > 0.5
    if small:
        mask[:] = False
        mask[[3, 11]] = True      # a positive bag of 2 < k
    return s, f, mask


def _naive_topk(values, sel, k):
    """The reference's ragged bag: the members' top-k per column."""
    return np.sort(values[sel], axis=0)[::-1][:k]


@pytest.mark.parametrize("small", [False, True])
def test_ranking_and_dmil_losses_match_jax_and_ragged_bags(jx, small):
    s, _, mask = _bags(60, 3, seed=1, small=small)
    k = 4
    t = [torch.from_numpy(a) for a in (s, mask, ~mask)]
    j = [jx.jnp.asarray(a) for a in (s, mask, ~mask)]
    for name in ("ranking_loss", "dmil_ranking_loss"):
        got = getattr(L, name)(*t, k).item()
        want = float(getattr(jx.losses, name)(*j, k))
        np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=name)
    p, n = _naive_topk(s, mask, k), _naive_topk(s, ~mask, k)
    if not small:
        np.testing.assert_allclose(L.ranking_loss(*t, k).item(),
                                   np.maximum(1 - p + n, 0).mean(),
                                   rtol=1e-5)
    # the slots a small bag lacks leave the mean
    np.testing.assert_allclose(
        L.dmil_ranking_loss(*t, k).item(),
        (-np.log(p)).mean() + (-np.log(1 - n)).mean(), rtol=1e-5)
    got_c = L.center_loss(t[0], t[2], 20.0).item()
    np.testing.assert_allclose(got_c, float(jx.losses.center_loss(
        j[0], j[2], 20.0)), rtol=1e-5)
    bag = s[~mask]
    np.testing.assert_allclose(got_c, ((bag - bag.mean()) ** 2).mean() * 20,
                               rtol=1e-5)


@pytest.mark.parametrize("small", [False, True])
def test_rtfm_loss_matches_jax_and_ragged_bags(jx, small):
    s, f, mask = _bags(30, 2, seed=3, small=small)
    k = 3
    got = L.rtfm_loss(*(torch.from_numpy(a) for a in (s, f, mask, ~mask)),
                      k, margin=10.0, alpha=0.1).item()
    want = float(jx.losses.rtfm_loss(*(jx.jnp.asarray(a) for a in
                                       (s, f, mask, ~mask)), k,
                                     margin=10.0, alpha=0.1))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    if small:
        return

    def bag_terms(sel):  # the ragged bag: per column top-k by magnitude
        mag = np.where(sel[:, None], np.linalg.norm(f, axis=-1), -1.0)
        idx = np.argsort(-mag, axis=0, kind="stable")[:k]
        fsel = np.stack([f[idx[:, t], t] for t in range(2)], axis=1)
        return (np.take_along_axis(s, idx, axis=0),
                np.linalg.norm(fsel.mean(0), axis=-1))

    sp, pm = bag_terms(mask)
    sn, nm = bag_terms(~mask)
    naive = ((-np.log(sp)).mean() + (-np.log(1 - sn)).mean()
             + 0.1 * np.mean((np.abs(10.0 - pm) + nm) ** 2))
    np.testing.assert_allclose(got, naive, rtol=1e-4)


@pytest.mark.parametrize("B", [1, 2])
def test_mgfn_and_contrastive_losses_match_jax(jx, B):
    rng = np.random.default_rng(5 + B)
    s = rng.random((B, 40, 1)).astype(np.float32)
    f = rng.normal(size=(B, 40, 1, 5)).astype(np.float32)
    mp = rng.random((B, 40)) > 0.6
    mp[0] = False
    mp[0, [2, 9]] = True          # sample 0's positive bag: 2 < k
    args = (s, f, mp, ~mp)
    got = L.mgfn_loss(*(torch.from_numpy(a) for a in args), k=4,
                      lambda_mgfn=0.1, margin=5.0).item()
    want = float(jx.losses.mgfn_loss(*(jx.jnp.asarray(a) for a in args),
                                     k=4, lambda_mgfn=0.1, margin=5.0))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    o1, o2 = rng.normal(size=(2, 3, 4)).astype(np.float32)
    for label in (0.0, 1.0):
        np.testing.assert_allclose(
            L.contrastive_loss(torch.from_numpy(o1), torch.from_numpy(o2),
                               label, 3.0).item(),
            float(jx.losses.contrastive_loss(o1, o2, label, 3.0)),
            rtol=1e-5)


def test_topk_ties_go_to_the_lower_index_as_in_jax(jx):
    """masked_topk breaks ties by the lower index, as jax.lax.top_k does:
    the -1 fill of a bag smaller than k and tied magnitudes. RTFM gathers
    scores and features at those indices, so where tied instances differ
    the loss depends on which one is taken, and the port takes JAX's;
    where tied instances are identical, permuting them leaves it as it
    was."""
    rng = np.random.default_rng(9)
    vals = np.round(rng.random((40, 3)), 1).astype(np.float32)  # many ties
    mask = rng.random(40) > 0.5
    mask[:] = False
    mask[[1, 5, 7, 20]] = True
    top, idx, ok = L.masked_topk(torch.from_numpy(vals),
                                 torch.from_numpy(mask), 8)
    jtop, jidx, jok = jx.losses.masked_topk(vals, mask, 8)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(top.numpy(), np.asarray(jtop))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    assert ok.sum(0).tolist() == [4, 4, 4]

    # identical tied instances: rows 0-9 repeated three times
    s = np.tile(rng.random((10, 1)).astype(np.float32), (3, 1))
    f = np.tile(rng.normal(size=(10, 1, 4)).astype(np.float32), (3, 1, 1))
    m = np.ones(30, bool)
    m[::7] = False                                   # a negative bag of 5
    perm = np.arange(30)
    perm[:20] = perm[:20].reshape(2, 10)[::-1].ravel()  # swap twins

    def both(k, p):
        args = (s[p], f[p], m[p], ~m[p])
        return (L.rtfm_loss(*(torch.from_numpy(a) for a in args), k).item(),
                float(jx.losses.rtfm_loss(*args, k)))

    (a, ja), (b, jb) = both(4, np.arange(30)), both(4, perm)
    assert a == pytest.approx(b, rel=1e-6)
    # k = 6 > 5: the negative bag's sixth slot takes the lowest-index
    # non-member, whose features enter the mean; the order then matters,
    # and the port follows JAX in either order
    (a, ja), (b, jb) = both(6, np.arange(30)), both(6, perm)
    assert a == pytest.approx(ja, rel=1e-5) and b == pytest.approx(jb,
                                                                   rel=1e-5)
    assert abs(a - b) > 1e-4


def test_instance_drop_statistics():
    g = torch.Generator().manual_seed(0)
    keep = L._bern_keep((200_000,), 0.5, "cpu", g)
    assert abs(keep.mean().item() - 0.5) < 0.005
    x = torch.ones(1000, 2, 3)
    rows = L._dropped(x, 0.3, True, g, rows=True)
    assert rows.unique(dim=0).shape[0] == 2          # whole rows dropped
    assert abs((rows[:, 0, 0] == 0).float().mean().item() - 0.3) < 0.05
    assert torch.equal(L._dropped(x, 0.3, False, g, rows=True), x)


# ---------------------------------------------------------------- train

def _jax_steps(jx, kw, variant, variables, batches):
    """JAX: the losses and vote sums of make_mil_train_step's steps, the
    variables after them, and the first step's gradients."""
    jcfg = jx.cfg(**kw)
    model = jx.build(jcfg, variant)
    extra = {k: v for k, v in variables.items() if k != "params"}
    state = jx.state.TrainState.create(
        apply_fn=model.apply, params=variables["params"],
        tx=jx.state.make_optimizer(jcfg, 3, params=variables["params"]),
        rng=jx.jax.random.PRNGKey(0), extra_vars=extra)
    step = jx.driver.make_mil_train_step(model, jcfg, variant, t0=1.0,
                                         donate=False)

    def loss_fn(p, b):
        out = model.apply({"params": p, **extra}, b["x"], train=True,
                          mutable=list(extra))[0]
        return jx.driver.mil_total_loss(jcfg, variant, out,
                                        b["mask_extreme_loss"], True,
                                        jx.jax.random.PRNGKey(0))

    grads = jx.jax.jit(jx.jax.grad(loss_fn))(variables["params"], batches[0])
    losses, votes = [], []
    for b in batches:
        metrics = jx.driver.init_mil_metrics((3, T_LINE, 16, 16))
        state, metrics = step(state, metrics, b)
        losses.append(float(metrics["loss_sum"]))
        votes.append(np.asarray(metrics["vote_sum"]))
    return (losses, votes, {"params": state.params, **state.extra_vars},
            grads)


# Adam's first step is lr * u / (|u| + 1e-8) with u = g + weight_decay * p
# (the coupled decay). Where u is a few eps (~1 % of the entries, mostly
# where the decay cancels the gradient: measured 4.3e-5 apart for
# u = -2.3e-8 in an MGFN encoder kernel), that step follows u's last bits,
# and those entries move the second step's forward and gradients a little.
# So after two steps every entry is held to the most two steps can part
# it, 2 lr, and all but FAR_SHARE of them to 1e-5.
FAR_SHARE = 0.005


def _close_after_adam(got, want, lr):
    """Entries of ``got`` farther than 1e-5 from ``want``, after checking
    that none is farther than two Adam steps."""
    d = (got - want).abs()
    assert d.max().item() <= 2 * lr + 1e-5
    return int((d > 1e-5).sum())


@pytest.mark.parametrize("variant", VARIANTS)
def test_two_train_steps_match_jax(jx, variant):
    """Two Adam steps from the same weights: the losses, the vote sums
    (MGFN's one timestep broadcast over delta_t and thresholded at >= 0.5,
    the others' > 0.5), the first step's gradients (rtol 1e-4 / atol
    1e-6), every parameter and the BatchNorm statistics (RTFM's
    Aggregate, MGFN's FOCUS), which move with the biased batch variance
    and momentum 0.9."""
    kw = _tiny()
    _, variables = _jax_variables(jx, kw, variant, seed=2)
    batches = [_batch(10), _batch(11)]
    want_losses, want_votes, want, want_grads = _jax_steps(
        jx, kw, variant, variables, batches)

    cfg, model = _port_model(kw, variant, variables)
    state = create_train_state(cfg, model, "cpu", steps_per_epoch=3)
    step = make_mil_train_step(model, cfg, variant, t0=1.0)
    got_losses = []
    for i, b in enumerate(batches):
        metrics = init_mil_metrics((3, T_LINE, 16, 16), "cpu")
        step(state, metrics, {k: torch.from_numpy(v) for k, v in b.items()})
        got_losses.append(metrics["loss_sum"].item())
        assert int(metrics["vote_cnt"].sum()) == 2 * 8
        np.testing.assert_array_equal(metrics["vote_sum"].numpy(),
                                      want_votes[i])
        if i == 0:
            wg = flax_to_state_dict(want_grads, model.state_dict())
            for k, p in model.named_parameters():
                np.testing.assert_allclose(p.grad.numpy(), wg[k].numpy(),
                                           rtol=1e-4, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-5)
    got_sd = model.state_dict()
    want_sd = flax_to_state_dict(want, got_sd)
    before = flax_to_state_dict(variables, got_sd)
    assert sorted(got_sd) == sorted(want_sd)
    moved = far = 0
    for k, w in want_sd.items():
        if k.endswith((".mean", ".var")):
            np.testing.assert_allclose(got_sd[k].numpy(), w.numpy(), rtol=0,
                                       atol=1e-5, err_msg=k)
            moved += int(not torch.allclose(before[k], w))
            continue
        far += _close_after_adam(got_sd[k], w, cfg.lr)
    n = sum(p.numel() for p in model.parameters())
    assert far <= FAR_SHARE * n, (far, n)
    assert moved == {"deepmil": 0, "arnet": 0, "rtfm": 8, "mgfn": 4}[
        variant]


@pytest.mark.parametrize("variant", VARIANTS)
def test_dense_anomaly_matches_jax(jx, variant):
    """The vote bits from dense scores, scores of exactly 0.5 included:
    MGFN broadcasts its one timestep over delta_t and votes at >= 0.5,
    the others vote at > 0.5."""
    from idee_tpu_torch.baselines.mil.driver import dense_anomaly

    cfg = mil_config(**_tiny())
    T = 1 if variant == "mgfn" else 8
    rng = np.random.default_rng(7)
    scores = rng.choice(np.array([0.0, 0.25, 0.5, 0.5 + 2 ** -20, 1.0],
                                 np.float32), size=(2, 3, T, 16, 16))
    want = np.asarray(jx.driver._dense_anomaly(jx.cfg(**_tiny()), variant,
                                               jx.jnp.asarray(scores)))
    got = dense_anomaly(cfg, variant, torch.from_numpy(scores))
    assert got.shape == want.shape == (2, 3, 8, 16, 16)
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------- driver

N_TIME = 30


@pytest.fixture(scope="module")
def cube():
    return make_fake_cube(n_vars=3, n_time=N_TIME, height=16, width=16,
                          seed=4)


def _straddle_half(jx, jmodel, variables, x):
    """Shift the head's last bias so that the median score on ``x`` is 0.5
    (in place). Returns the port's key of that bias and the shift."""
    head = variables["params"]["classifier"]
    name = "mlp.Dense_2" if "mlp" in head else "fc"
    last = head["mlp"]["Dense_2"] if "mlp" in head else head["fc"]
    s = np.asarray(jx.jax.jit(lambda v, a: jmodel.apply(
        v, a, train=False).scores)(variables, x), np.float64)
    shift = np.float32(-np.median(np.log(s / (1 - s))))
    last["bias"] = last["bias"] + shift
    return f"classifier.{name}.bias", shift


def _driver_matches_jax(jx, cube, tmp_path, variant, straddle=False):
    """train_mil_synthetic (2 epochs, augmentations on) and
    test_mil_synthetic against the JAX drivers from the same weights (an
    orbax checkpoint for JAX, a flax-path .npz for the port; both start
    from the initial BatchNorm statistics): losses, F1 and pred rates per
    epoch; the test's metrics and its majority-vote map. The scores of
    these weights lie within 0.01 of 0.5, for RTFM on one side of it.
    ``straddle``: the trained weights of both get one shift of the head's
    last bias, centring the test scores on 0.5 so that both vote values
    occur. A score within float noise of 0.5 may then vote apart in the
    two frameworks (MGFN's do in training too), so every F1, IoU and pred
    rate is held within 1e-3 and the test's vote map equal at all but
    0.5 % of the pixels. Returns the JAX vote map."""
    import orbax.checkpoint as ocp

    from idee_tpu.data.fake import make_fake_cube as jax_fake_cube
    from idee_tpu.data.synthetic import SyntheticDataset as JDataset

    kw = _tiny(dir_log=str(tmp_path), name=variant)
    jmodel, variables = _jax_variables(jx, kw, variant, seed=3)
    params = variables["params"]
    ocp.StandardCheckpointer().save(str(tmp_path / "orbax"), params)
    save_flax_npz(str(tmp_path / "init.npz"), params)
    jcube = jax_fake_cube(n_vars=3, n_time=N_TIME, height=16, width=16,
                          seed=4)
    jcfg = jx.cfg(**dict(kw, en_de_pretrained=str(tmp_path / "orbax"),
                         name="jax"))
    want = jx.driver.train_mil_synthetic(jcfg, variant,
                                         jcube.time_slice(1, 18),
                                         jcube.time_slice(19, N_TIME))
    cfg = mil_config(**dict(kw, en_de_pretrained=str(tmp_path / "init.npz")))
    got = port_train_mil(cfg, variant, cube.time_slice(1, 18),
                         cube.time_slice(19, N_TIME), device="cpu")
    np.testing.assert_allclose(got["train_loss"], want["train_loss"],
                               rtol=1e-4)
    np.testing.assert_allclose(got["val_loss"], want["val_loss"], rtol=1e-4)
    for key in ("train_anom_f1", "val_anom_f1", "val_pred_rate"):
        if straddle:
            np.testing.assert_allclose(got[key], want[key], atol=1e-3,
                                       err_msg=key)
        else:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    ckpts = sorted(p.name for p in (tmp_path / variant /
                                    "model_checkpoints").iterdir())
    assert ckpts == ["best_loss_model.pt", "latest.pt"]

    # test on the trained weights, BatchNorm statistics included
    jstate = want["state"]
    jvars = jx.jax.tree_util.tree_map(
        np.asarray, {"params": jstate.params, **jstate.extra_vars})
    sd = dict(got["state"].model.state_dict())
    ds = JDataset(cube=jcube, times=(1, N_TIME), variables=VARS,
                  delta_t=8, is_aug=False, is_clima_scale=False)
    if straddle:
        key, shift = _straddle_half(
            jx, jmodel, jvars, np.stack([ds[i]["x"] for i in range(len(ds))]))
        sd[key] = sd[key] + shift
    tcfg = cfg.replace(times_test=(1, N_TIME))
    jres = jx.driver.test_mil_synthetic(jx.cfg(**dict(kw, times_test=(
        1, N_TIME))), variant, cube=jcube, params=jvars)
    res = port_test_mil(tcfg, variant, cube=cube, params=sd, device="cpu")
    np.testing.assert_allclose(res["mean_loss"], jres["mean_loss"],
                               rtol=1e-4)
    for key in ("driver_f1_pos", "driver_iou_pos"):
        if straddle:
            np.testing.assert_allclose(res[key], jres[key], atol=1e-3,
                                       err_msg=key)
        else:
            assert res[key] == jres[key] or (math.isnan(res[key])
                                             and math.isnan(jres[key])), key
    # the vote map, from the JAX eval step over the same test loader
    from idee_tpu.data.loader import DataLoader as JLoader
    from idee_tpu.train.metrics import majority_vote_from_device

    jcfg = jx.cfg(**dict(kw, times_test=(1, N_TIME)))
    step = jx.driver.make_mil_eval_step(jx.build(jcfg, variant), jcfg,
                                        variant, t0=1.0)
    metrics = jx.driver.init_mil_metrics(ds.anomaly.shape)
    for b in JLoader(ds, 2, shuffle=False, drop_last=True, seed=0,
                     prefetch=0):
        metrics = step(jvars, metrics, b, jx.jax.random.PRNGKey(0))
    m = jx.jax.device_get(metrics)
    want_map = majority_vote_from_device(m["vote_sum"], m["vote_cnt"])
    if not straddle:
        np.testing.assert_array_equal(res["anomaly"], want_map)
        return want_map
    np.testing.assert_array_equal(np.isnan(res["anomaly"]),
                                  np.isnan(want_map))
    seen = ~np.isnan(want_map)
    apart = (res["anomaly"][seen] != want_map[seen]).mean()
    assert apart <= 0.005, apart
    return want_map


def test_rtfm_driver_train_and_test_match_jax(jx, cube, tmp_path):
    _driver_matches_jax(jx, cube, tmp_path, "rtfm")


@pytest.mark.parametrize("variant", ["deepmil", "arnet", "mgfn"])
def test_driver_train_and_test_match_jax(jx, cube, tmp_path, variant):
    """The other variants' drivers, the test with both vote values in
    play: ARNet's k = H*W // alpha ranking and center losses, MGFN's one
    timestep broadcast over delta_t and its >= 0.5 votes."""
    want_map = _driver_matches_jax(jx, cube, tmp_path, variant,
                                   straddle=True)
    seen = want_map[~np.isnan(want_map)]
    assert 0.05 < seen.mean() < 0.95


# ---------------------------------------------------------------- CLIs

CLIS = [(f"train_{v}_synthetic", "train_mil_synthetic", v, True)
        for v in VARIANTS] + [("test_mil_synthetic", "test_mil_synthetic",
                               "rtfm", False)]


@pytest.mark.parametrize("cli,fn,variant,train", CLIS)
def test_cli_flags_match_the_jax_script(monkeypatch, tmp_path, cli, fn,
                                        variant, train):
    """Each CLI gives its driver the config the JAX script builds from the
    same flags (tests/test_baselines.py::TestCLIConfigs), the variant
    (MIL_VARIANT for the test script) and --device."""
    import importlib

    from idee_tpu.baselines.config import mil_config as jax_mil_config
    from idee_tpu.config import read_arguments as jax_read

    mod = importlib.import_module(f"idee_tpu_torch.cli.{cli}")
    seen = {}
    monkeypatch.setattr(mod, fn, lambda cfg, v, device: seen.update(
        cfg=cfg, variant=v, device=device))
    monkeypatch.setenv("MIL_VARIANT", variant)
    argv = ["--loss_k_deepmil", "7", "--agent_embed_dim", "[8]",
            "--dir_log", str(tmp_path), "--name", "cli",
            "--times_train", "(1,30)", "--cls_drop_rate", "0.25"]
    mod.main(argv + ["--device", "cpu"])
    want = jax_read(train=train, print_=False, save=False, argv=argv,
                    defaults=jax_mil_config())
    assert seen["variant"] == variant and seen["device"] == "cpu"
    assert seen["cfg"].to_dict() == want.to_dict()
    assert seen["cfg"].loss_k_deepmil == 7 and seen["cfg"].cls_dim == [
        512, 256, 1]
    assert (tmp_path / "cli" / "config.json").exists()


def test_train_cli_runs_on_a_fake_cube(cube, tmp_path):
    """python -m idee_tpu_torch.cli.train_deepmil_synthetic --device cpu on
    a .npz cube, then the test CLI on its checkpoint."""
    from idee_tpu_torch.cli.test_mil_synthetic import main as test_main
    from idee_tpu_torch.cli.train_deepmil_synthetic import main as train_main
    from idee_tpu_torch.data.fake import write_cube_npz

    root = tmp_path / "synthetic_fake"
    write_cube_npz(str(root), cube)
    flags = ["--device", "cpu", "--root_synthetic", str(root),
             "--dir_log", str(tmp_path / "log"), "--name", "dm",
             "--n_epochs", "1", "--variables", str(VARS)]
    for k, v in _tiny().items():
        if k not in ("variables", "n_epochs"):
            flags += [f"--{k}", str(v)]
    hist = train_main(flags)
    assert len(hist["train_loss"]) == 1
    assert all(map(math.isfinite, hist["train_loss"] + hist["val_loss"]))
    ckpt = tmp_path / "log" / "dm" / "model_checkpoints" / "latest.pt"
    res = test_main(flags + ["--en_de_pretrained", str(ckpt),
                             "--times_test", f"(1,{N_TIME})"])
    assert math.isfinite(res["mean_loss"])
    assert res["anomaly"].shape == (3, N_TIME, 16, 16)


# ---------------------------------------------------------------- card only

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("encoder", ["Mamba", "Swin_3D"])
def test_train_step_on_card_matches_cpu(cuda, encoder):
    """One RTFM train step on the card (over Mamba: the fused scan forward
    and backward kernels; over Swin_3D: the attention kernels) against
    the same step on the CPU: loss, gradients and BatchNorm statistics.
    (Over CNN_3D, which runs no kernel, its LayerNorm -> ReLU kinks flip
    with the two devices' float noise and move its first kernel's
    gradient by 4e-3 x max |grad|: test_torch_train.py's note.)"""
    kw = _tiny(encoder=encoder, en_depths=[2, 1])
    cfg = mil_config(**kw)
    b = _batch(6)
    runs = []
    for dev in ("cpu", cuda):
        model = build_mil_model(cfg, "rtfm")
        state = create_train_state(cfg, model, dev, steps_per_epoch=3)
        step = make_mil_train_step(model, cfg, "rtfm", t0=1.0)
        metrics = init_mil_metrics((3, T_LINE, 16, 16), dev)
        model.train()
        out = model(torch.from_numpy(b["x"]).to(dev), train=True)
        loss = mil_total_loss(cfg, "rtfm", out, torch.from_numpy(
            b["mask_extreme_loss"]).to(dev), True)
        loss.backward()
        grads = {k: p.grad.cpu() for k, p in model.named_parameters()}
        model.zero_grad()
        step(state, metrics, {k: torch.from_numpy(v).to(dev)
                              for k, v in b.items()})
        runs.append((loss.item(), grads,
                     {k: v.cpu() for k, v in model.state_dict().items()}))
    (l_cpu, g_cpu, sd_cpu), (l_gpu, g_gpu, sd_gpu) = runs
    np.testing.assert_allclose(l_gpu, l_cpu, rtol=1e-4)
    for k, want in g_cpu.items():
        tol = 1e-4 * want.abs().max().item() + 1e-7
        assert (g_gpu[k] - want).abs().max().item() <= tol, k
    for k in sd_cpu:
        if k.endswith((".mean", ".var")):
            torch.testing.assert_close(sd_gpu[k], sd_cpu[k], rtol=1e-4,
                                       atol=1e-6)
