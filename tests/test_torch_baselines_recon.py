# ------------------------------------------------------------------
"""The port's Reconstruction baselines (STEAL, UniAD) against the JAX
package: UniAD's bilinear resize against jax.image.resize (antialiased
when downsampling), its neighborhood mask and position embeddings, both
models' eval forwards, two train steps each (STEAL's BatchNorm
statistics), the drivers end to end with their vote maps, the jitter and
dropout draws, and the CLIs' flags.

Tiny configs: 3 variables, 16x16; STEAL at delta_t=8 with
en/de_embed_dim [8, 12, 16] / [16, 12, 8], UniAD at delta_t=1 with
hidden_dim 12, 3 heads, one encoder and two decoder layers, a 3x3
neighborhood. Weights: the JAX init plus N(0, 0.05) from a numpy seed,
carried across by ``load_flax_params``. Dropout and UniAD's jitter run at
rate / probability 0 where the frameworks are compared (their random bits
differ); the port's draws are checked for their own semantics.
Tolerances, float32: resize atol 1e-6; forwards rtol 1e-5 / atol 1e-5;
train-step losses rtol 1e-4 (the second 1e-3, see FAR_SHARE); step-1
gradients rtol 1e-4 / atol 1e-5 x max |grad| of the leaf (STEAL's first
convolution sums 12,288 products per weight: 1.4e-6 apart at 0.8);
BatchNorm statistics after 2 Adam steps atol 1e-5, parameters atol 1e-5
but for a share of FAR_SHARE held to 2 lr (and KEY_BIAS); driver losses
rtol 1e-4, F1 and vote maps equal.

The JAX side is imported inside fixtures, so the card-only test also
collects where JAX is not installed
(``python -m pytest --noconftest tests/test_torch_baselines_recon.py -m gpu``).
"""
# ------------------------------------------------------------------

import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from idee_tpu_torch.baselines.config import recon_config
from idee_tpu_torch.baselines.recon import uniad as port_uniad
from idee_tpu_torch.baselines.recon.driver import (build_recon_model,
                                                   init_recon_metrics)
from idee_tpu_torch.baselines.recon.driver import \
    test_recon_synthetic as port_test_recon
from idee_tpu_torch.baselines.recon.driver import \
    train_recon_synthetic as port_train_recon
from idee_tpu_torch.data.fake import make_fake_cube
from idee_tpu_torch.models.interop import (flax_to_state_dict,
                                           load_flax_params, save_flax_npz)
from idee_tpu_torch.train.state import create_train_state

torch.set_num_threads(1)

VARS = ["var_01", "var_02", "var_03"]
T_LINE = 20
N_TIME = 30


def _tiny(which: str, **kw) -> dict:
    base = dict(in_channels_dynamic=3, variables=VARS, x_max=16, y_max=16,
                batch_size=2, en_embed_dim_steal=[8, 12, 16],
                de_embed_dim_steal=[16, 12, 8], hidden_dim=12, nhead=3,
                dim_feedforward=24, num_encoder_layers=1,
                num_decoder_layers=2, neighbor_size=(3, 3), dropout=0.0,
                delta_t=8 if which == "steal" else 1, times_train=(1, 18),
                times_val=(19, N_TIME), n_epochs=2, lr_warmup_epochs=0,
                is_clima_scale=False)
    base.update(kw)
    return base


def _x_shape(which, n=2):
    return (n, 3, 8, 16, 16) if which == "steal" else (n, 3, 16, 16)


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp

    from idee_tpu.baselines.config import recon_config as jcfg
    from idee_tpu.baselines.recon import driver as jdriver
    from idee_tpu.baselines.recon import uniad as juniad
    from idee_tpu.train import state as jstate

    return SimpleNamespace(jax=jax, jnp=jnp, cfg=jcfg, driver=jdriver,
                           uniad=juniad, state=jstate)


def _jax_variables(jx, kw, which, seed=0):
    jcfg = jx.cfg(**kw)
    model = jx.driver._build(jcfg, which)[0]
    x = jx.jnp.zeros(_x_shape(which), jx.jnp.float32)
    init = jx.jax.jit(lambda a: model.init(
        {"params": jx.jax.random.PRNGKey(seed)}, a, train=False))(x)
    rng = np.random.default_rng(seed)
    out = {"params": jx.jax.tree_util.tree_map(
        lambda p: (np.asarray(p) + 0.05 * rng.normal(size=p.shape))
        .astype(np.float32), init["params"])}
    if "batch_stats" in init:
        out["batch_stats"] = jx.jax.tree_util.tree_map(
            lambda s: (rng.uniform(0.5, 1.5, s.shape) if s.ndim and
                       float(s[0]) == 1.0 else rng.normal(0, 0.1, s.shape))
            .astype(np.float32), init["batch_stats"])
    return jcfg, model, out


def _port_model(kw, which, variables):
    cfg = recon_config(**kw)
    model, make_train, make_eval = build_recon_model(cfg, which, (16, 16))
    model.load_state_dict(load_flax_params(cfg, variables, model))
    return cfg, model, make_train, make_eval


def _batch(which, seed, n=2):
    rng = np.random.default_rng(seed)
    dt = 8 if which == "steal" else 1
    return {"x": rng.normal(size=(n, 3, 1, dt, 16, 16)).astype(np.float32),
            "mask_extreme_loss_t": (rng.random((n, dt, 16, 16)) < 0.2)
            .astype(np.float32),
            "timestep": np.array([[8.0 + i] for i in range(n)], np.float32)}


# ---------------------------------------------------------------- UniAD parts

@pytest.mark.parametrize("shape,size", [((2, 3, 16, 16), (8, 8)),
                                        ((1, 2, 200, 200), (100, 100)),
                                        ((2, 3, 8, 8), (16, 16)),
                                        ((1, 1, 15, 9), (5, 3))])
def test_resize_matches_jax_image_resize(jx, shape, size):
    """UniAD's resize against jax.image.resize(..., "bilinear"): the 2x
    downsample of the tokens, the upsample of the loss map, and an odd
    one. Downsampling antialiases (a triangle filter widened by the
    scale); F.interpolate's plain bilinear, which reads 2 of every 4
    inputs at a 2x downsample, fails this test."""
    a = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    want = np.asarray(jx.jax.image.resize(a, shape[:2] + size, "bilinear"))
    got = port_uniad.resize_bilinear(torch.from_numpy(a), size).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    plain = F.interpolate(torch.from_numpy(a), size=size, mode="bilinear",
                          align_corners=False).numpy()
    if size[0] < shape[2]:
        assert np.abs(plain - want).max() > 0.1


def test_neighbor_mask_and_sine_embedding_match_jax(jx):
    for fs, ns in (((4, 4), (3, 3)), ((5, 7), (3, 5)), ((6, 6), (9, 9))):
        np.testing.assert_array_equal(port_uniad.neighbor_mask(fs, ns),
                                      jx.uniad.neighbor_mask(fs, ns))
    np.testing.assert_array_equal(port_uniad.sine_pos_embed((5, 7), 6),
                                  jx.uniad.sine_pos_embed((5, 7), 6))
    m = port_uniad.neighbor_mask((4, 4), (3, 3))
    np.testing.assert_array_equal(np.nonzero(m[0])[0], [0, 1, 4, 5])


def test_jitter_and_dropout_draws():
    """With feature_jitter_prob 1 the tokens move by N(0, 1) x |token| / V
    x scale; dropout and the jitter draw from the step's generator, so a
    training forward repeats with the same seed and differs with
    another."""
    kw = _tiny("uniad", feature_jitter_prob=1.0, feature_jitter_scale=0.5,
               dropout=0.2)
    cfg = recon_config(**kw)
    model = build_recon_model(cfg, "uniad", (16, 16))[0]
    x = torch.randn(2, 3, 16, 16)
    runs = [model(x, train=True, generator=torch.Generator().manual_seed(s))
            .loss_map for s in (0, 0, 1)]
    assert torch.equal(runs[0], runs[1])
    assert not torch.allclose(runs[0], runs[2])
    assert torch.equal(model(x).loss_map, model(x).loss_map)
    # the jitter itself: one coin per batch, noise scaled by the token norm
    g = torch.Generator().manual_seed(3)
    coin = torch.rand((), generator=g)
    noise = torch.randn((2, 64, 3), generator=g)
    assert coin <= 1.0
    tokens = port_uniad.resize_bilinear(x, (8, 8)).reshape(2, 3, 64) \
        .transpose(1, 2)
    want = tokens + noise * tokens.norm(dim=2, keepdim=True) / 3 * 0.5
    assert (want - tokens).abs().mean() > 0.01


# ---------------------------------------------------------------- models

@pytest.mark.parametrize("which,extra", [("steal", {}), ("uniad", {}),
                                         ("uniad", {"pos_embed_type": "sine",
                                                    "neighbor_mask": [
                                                        True, False, True]})])
def test_eval_forward_matches_jax(jx, which, extra):
    kw = _tiny(which, **extra)
    jcfg, jmodel, variables = _jax_variables(jx, kw, which)
    b = _batch(which, 1)
    if which == "steal":
        x = b["x"][:, :, 0]
        want = jmodel.apply(variables, x, train=False).pred
    else:
        x = b["x"][:, :, 0, 0]
        want = jmodel.apply(variables, x, b["mask_extreme_loss_t"][:, 0],
                            train=False).loss_map
    cfg, model, _, _ = _port_model(kw, which, variables)
    with torch.no_grad():
        if which == "steal":
            got = model(torch.from_numpy(x)).pred
        else:
            got = model(torch.from_numpy(x), torch.from_numpy(
                b["mask_extreme_loss_t"][:, 0])).loss_map
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_steal_refuses_what_its_decoder_cannot_give_back():
    cfg = recon_config(**_tiny("steal"))
    model = build_recon_model(cfg, "steal", (16, 16))[0]
    with pytest.raises(ValueError, match="delta_t 8"):
        model(torch.zeros(1, 3, 1, 16, 16))


# Adam's first step is lr * u / (|u| + 1e-8) with u = g + weight_decay * p
# (the coupled decay). Where u is a few eps (~1 % of the entries, mostly
# where the decay cancels the gradient: measured 4.3e-5 apart for
# u = -2.3e-8 in an MGFN encoder kernel), that step follows u's last bits,
# and those entries move the second step's forward and gradients a little.
# So after two steps every entry is held to the most two steps can part
# it, 2 lr, and all but FAR_SHARE of them to 1e-5; the second loss is held
# to rtol 1e-3 (STEAL: 3e-4 apart, measured). Attention key biases
# (UniAD's k_proj) have a zero gradient in exact arithmetic (they add one
# constant to a row of scores, which softmax ignores): checked tiny, then
# left out, as in test_torch_train.py.
FAR_SHARE = 0.005


def _close_after_adam(got, want, lr):
    """Entries of ``got`` farther than 1e-5 from ``want``, after checking
    that none is farther than two Adam steps."""
    d = (got - want).abs()
    assert d.max().item() <= 2 * lr + 1e-5
    return int((d > 1e-5).sum())
KEY_BIAS = "k_proj.bias"


@pytest.mark.parametrize("which", ["steal", "uniad"])
def test_two_train_steps_match_jax(jx, which):
    """Two Adam steps from the same weights: losses, the first step's
    gradients, every parameter and STEAL's BatchNorm statistics."""
    kw = _tiny(which)
    jcfg, jmodel, variables = _jax_variables(jx, kw, which, seed=2)
    batches = [_batch(which, 10), _batch(which, 11)]
    extra = {k: v for k, v in variables.items() if k != "params"}
    state = jx.state.TrainState.create(
        apply_fn=jmodel.apply, params=variables["params"],
        tx=jx.state.make_optimizer(jcfg, 3, params=variables["params"]),
        rng=jx.jax.random.PRNGKey(0), extra_vars=extra)
    make = jx.driver._build(jcfg, which)[1]
    step = make(jmodel, jcfg, t0=1.0, donate=False)

    def loss_fn(p, b):
        if which == "steal":
            x = b["x"][:, :, 0]
            out = jmodel.apply({"params": p, **extra}, x, train=True,
                               mutable=["batch_stats"])[0]
            from idee_tpu.baselines.recon.steal import steal_loss
            return steal_loss(out.pred, x, b["mask_extreme_loss_t"])
        out = jmodel.apply({"params": p}, b["x"][:, :, 0, 0], None,
                           train=True, rngs={
                               "jitter": jx.jax.random.PRNGKey(1),
                               "jitter_noise": jx.jax.random.PRNGKey(2),
                               "dropout": jx.jax.random.PRNGKey(3)})
        return jx.jnp.mean(out.loss_map)

    want_grads = jx.jax.grad(loss_fn)(variables["params"], batches[0])
    want_losses = []
    for b in batches:
        metrics = jx.driver.init_recon_metrics((3, T_LINE, 16, 16))
        state, metrics = step(state, metrics, b)
        want_losses.append(float(metrics["loss_sum"]))

    cfg, model, make_train, _ = _port_model(kw, which, variables)
    pstate = create_train_state(cfg, model, "cpu", steps_per_epoch=3)
    pstep = make_train(model, cfg, 1.0)
    got_losses = []
    for i, b in enumerate(batches):
        metrics = init_recon_metrics((3, T_LINE, 16, 16), "cpu")
        pstep(pstate, metrics, {k: torch.from_numpy(v) for k, v in b.items()})
        got_losses.append(metrics["loss_sum"].item())
        if i == 0:
            wg = flax_to_state_dict(want_grads, model.state_dict())
            for k, p in model.named_parameters():
                if k.endswith(KEY_BIAS):
                    continue
                scale = wg[k].abs().max().item()
                np.testing.assert_allclose(p.grad.numpy(), wg[k].numpy(),
                                           rtol=1e-4, atol=1e-5 * scale,
                                           err_msg=k)
    # STEAL's signed loss (normal MSE less extreme MSE, after training-mode
    # BatchNorms) is 1.6e-5 apart already at the first step (measured)
    np.testing.assert_allclose(got_losses[0], want_losses[0], rtol=1e-4)
    np.testing.assert_allclose(got_losses[1], want_losses[1], rtol=1e-3)
    got = model.state_dict()
    want = flax_to_state_dict({"params": state.params, **state.extra_vars},
                              got)
    before = flax_to_state_dict(variables, got)
    assert sorted(got) == sorted(want)
    far = 0
    for k, w in want.items():
        if k.endswith((".mean", ".var")):
            np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=0,
                                       atol=1e-5, err_msg=k)
            assert not torch.allclose(before[k], w), k
            continue
        if k.endswith(KEY_BIAS):
            assert wg[k].abs().max() < 1e-6, k
            continue
        far += _close_after_adam(got[k], w, cfg.lr)
    n = sum(p.numel() for p in model.parameters())
    assert far <= FAR_SHARE * n, (far, n)


# ---------------------------------------------------------------- drivers

@pytest.fixture(scope="module")
def cube():
    return make_fake_cube(n_vars=3, n_time=N_TIME, height=16, width=16,
                          seed=6)


@pytest.mark.parametrize("which", ["steal", "uniad"])
def test_drivers_match_jax(jx, cube, tmp_path, which):
    """train_recon_synthetic (2 epochs, anomaly-replaced, augmentations
    on) and test_recon_synthetic against the JAX drivers from the same
    weights (an orbax checkpoint for JAX, a flax-path .npz for the port):
    losses and F1 per epoch, the test's metrics and its vote map."""
    import orbax.checkpoint as ocp

    from idee_tpu.data.fake import make_fake_cube as jax_fake_cube
    from idee_tpu.data.loader import DataLoader as JLoader
    from idee_tpu.data.synthetic import SyntheticDataset as JDataset
    from idee_tpu.train.metrics import majority_vote_from_device

    kw = _tiny(which, dir_log=str(tmp_path), name=which,
               times_test=(1, N_TIME))
    jcfg, jmodel, variables = _jax_variables(jx, kw, which, seed=3)
    ocp.StandardCheckpointer().save(str(tmp_path / "orbax"),
                                    variables["params"])
    save_flax_npz(str(tmp_path / "init.npz"), variables["params"])
    jcube = jax_fake_cube(n_vars=3, n_time=N_TIME, height=16, width=16,
                          seed=6)
    want = jx.driver.train_recon_synthetic(
        jcfg.replace(name="jax", en_de_pretrained=str(tmp_path / "orbax")),
        which, jcube.time_slice(1, 18), jcube.time_slice(19, N_TIME))
    cfg = recon_config(**dict(kw, en_de_pretrained=str(tmp_path /
                                                       "init.npz")))
    got = port_train_recon(cfg, which, cube.time_slice(1, 18),
                           cube.time_slice(19, N_TIME), device="cpu")
    np.testing.assert_allclose(got["train_loss"], want["train_loss"],
                               rtol=1e-4)
    np.testing.assert_allclose(got["val_loss"], want["val_loss"], rtol=1e-4)
    np.testing.assert_array_equal(got["val_anom_f1"], want["val_anom_f1"])

    jvars = {"params": want["state"].params, **want["state"].extra_vars}
    jres = jx.driver.test_recon_synthetic(jcfg, which, cube=jcube,
                                          params=jvars)
    ckpt = tmp_path / which / "model_checkpoints" / "latest.pt"
    res = port_test_recon(cfg.replace(en_de_pretrained=str(ckpt)), which,
                          cube=cube, device="cpu")
    np.testing.assert_allclose(res["mean_loss"], jres["mean_loss"],
                               rtol=1e-4)
    for key in ("driver_f1_pos", "driver_iou_pos"):
        assert res[key] == jres[key] or (math.isnan(res[key])
                                         and math.isnan(jres[key])), key
    dt = kw["delta_t"]
    ds = JDataset(cube=jcube, times=(1, N_TIME), variables=VARS, delta_t=dt,
                  is_aug=False, is_clima_scale=False)
    step = jx.driver._build(jcfg, which)[2](jmodel, jcfg, t0=1.0)
    metrics = jx.driver.init_recon_metrics(ds.anomaly.shape)
    for b in JLoader(ds, 2, shuffle=False, drop_last=True, seed=0,
                     prefetch=0):
        metrics = step(jvars, metrics, b)
    m = jx.jax.device_get(metrics)
    np.testing.assert_array_equal(
        res["anomaly"], majority_vote_from_device(m["vote_sum"],
                                                  m["vote_cnt"]))


# ---------------------------------------------------------------- CLIs

@pytest.mark.parametrize("which", ["steal", "uniad"])
@pytest.mark.parametrize("phase", ["train", "test"])
def test_cli_flags_match_the_jax_script(monkeypatch, tmp_path, which,
                                        phase):
    import importlib

    from idee_tpu.baselines.config import recon_config as jax_recon_config
    from idee_tpu.config import read_arguments as jax_read

    mod = importlib.import_module(
        f"idee_tpu_torch.cli.{phase}_{which}_synthetic")
    fn = f"{phase}_recon_synthetic"
    seen = {}
    monkeypatch.setattr(mod, fn, lambda cfg, w, device: seen.update(
        cfg=cfg, which=w, device=device))
    argv = ["--neighbor_size", "(5,5)", "--neighbor_mask",
            "[True,False,True]", "--hidden_dim", "24", "--dir_log",
            str(tmp_path), "--name", "cli", "--delta_t", "8"]
    mod.main(argv + ["--device", "cpu"])
    want = jax_read(train=phase == "train", print_=False, save=False,
                    argv=argv, defaults=jax_recon_config())
    assert seen["which"] == which and seen["device"] == "cpu"
    assert seen["cfg"].to_dict() == want.to_dict()
    assert seen["cfg"].neighbor_size == (5, 5)


# ---------------------------------------------------------------- card only

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["steal", "uniad"])
def test_train_step_on_card_matches_cpu(cuda, which):
    """One train step on the card against the CPU: loss, the step's
    gradients (each leaf within 1e-4 x its largest entry, but KEY_BIAS,
    checked tiny), parameters (as FAR_SHARE says, but KEY_BIAS) and
    STEAL's BatchNorm statistics."""
    cfg = recon_config(**_tiny(which))
    b = _batch(which, 6)
    runs, grads = [], []
    for dev in ("cpu", cuda):
        model, make_train, _ = build_recon_model(cfg, which, (16, 16))
        state = create_train_state(cfg, model, dev, steps_per_epoch=3)
        metrics = init_recon_metrics((3, T_LINE, 16, 16), dev)
        make_train(model, cfg, 1.0)(state, metrics, {
            k: torch.from_numpy(v).to(dev) for k, v in b.items()})
        runs.append((metrics["loss_sum"].item(),
                     {k: v.cpu() for k, v in model.state_dict().items()}))
        grads.append({k: p.grad.cpu() for k, p in model.named_parameters()})
    np.testing.assert_allclose(runs[1][0], runs[0][0], rtol=1e-4)
    gmax = max(g.abs().max().item() for g in grads[0].values())
    for k, want in grads[0].items():
        if k.endswith(KEY_BIAS):  # zero in exact arithmetic (above)
            assert grads[1][k].abs().max().item() <= 1e-4 * gmax, k
            continue
        tol = 1e-4 * want.abs().max().item() + 1e-7
        assert (grads[1][k] - want).abs().max().item() <= tol, k
    far = 0
    for k, want in runs[0][1].items():
        if k.endswith((".mean", ".var")):
            torch.testing.assert_close(runs[1][1][k], want, rtol=1e-4,
                                       atol=1e-5)
        elif not k.endswith(KEY_BIAS):  # zero in exact arithmetic (above)
            far += _close_after_adam(runs[1][1][k], want, cfg.lr)
    assert far <= FAR_SHARE * sum(v.numel() for v in runs[0][1].values())
