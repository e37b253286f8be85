# ------------------------------------------------------------------
"""The port's One-Class baseline (SimpleNet over a frozen encoder) against
the JAX package: the anomaly-replaced dataset bit for bit, flax's
BatchNorm semantics at a small batch, the eval forward, two train steps
with the discriminator's BatchNorm statistics (noisy copy first, then the
clean one), the median thresholding, the drivers end to end, the backbone
loader and the CLIs' flags.

Tiny config: 3 variables, 16x16, delta_t=8, the CNN_3D backbone
(en_embed_dim=[8, 8]), dim=16, dsc_hidden=8, batch 2. Weights: the JAX
init plus N(0, 0.05) from a numpy seed, carried across by
``load_flax_params``. The noise of the negatives cannot be shared between
the frameworks' generators: the train steps hand both the same numpy
noise (``gaussian_noise`` / ``jax.random.normal`` patched), the driver runs
at noise_std 0, and the port's own draws are checked for their
statistics. Tolerances, float32: backbone features and scores atol 1e-5 /
rtol 1e-5; BatchNorm statistics atol 1e-6 at 8 values per channel;
parameters and statistics after 2 Adam steps atol 1e-5 (but the
discriminator's pre-BatchNorm bias, whose gradient is float noise: see
NOISE_BIAS); driver losses rtol 1e-4, F1 within 1e-3.

The JAX side is imported inside fixtures, so the card-only test also
collects where JAX is not installed
(``python -m pytest --noconftest tests/test_torch_baselines_oneclass.py -m gpu``).
"""
# ------------------------------------------------------------------

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from idee_tpu_torch.baselines.config import oneclass_config
from idee_tpu_torch.baselines.oneclass import driver as port_driver
from idee_tpu_torch.baselines.oneclass import simplenet as port_simplenet
from idee_tpu_torch.baselines.oneclass.driver import (Backbone,
                                                      init_oc_metrics,
                                                      load_backbone_params,
                                                      make_oc_eval_step,
                                                      make_oc_train_step,
                                                      val_anomaly)
from idee_tpu_torch.baselines.oneclass.driver import \
    test_simplenet_synthetic as port_test_simplenet
from idee_tpu_torch.baselines.oneclass.driver import \
    train_simplenet_synthetic as port_train_simplenet
from idee_tpu_torch.baselines.oneclass.simplenet import SimpleNet
from idee_tpu_torch.data.fake import make_fake_cube
from idee_tpu_torch.data.synthetic import SyntheticDataset
from idee_tpu_torch.models.interop import (flax_to_state_dict,
                                           load_flax_npz, load_flax_params,
                                           save_flax_npz)
from idee_tpu_torch.nn.layers import BatchNorm
from idee_tpu_torch.train.state import create_train_state

torch.set_num_threads(1)

VARS = ["var_01", "var_02", "var_03"]
T_LINE = 20
N_TIME = 30


def _tiny(**kw) -> dict:
    base = dict(in_channels_dynamic=3, variables=VARS, x_max=16, y_max=16,
                en_embed_dim=[8, 8], en_depths=[1, 1], dim=16, dsc_hidden=8,
                batch_size=2, times_train=(1, 18), times_val=(19, N_TIME),
                n_epochs=2, lr_warmup_epochs=0, is_clima_scale=False)
    base.update(kw)
    return base


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp

    from idee_tpu.baselines.config import oneclass_config as jcfg
    from idee_tpu.baselines.oneclass import driver as jdriver
    from idee_tpu.baselines.oneclass.simplenet import SimpleNet as JSimpleNet
    from idee_tpu.data.synthetic import SyntheticDataset as JDataset
    from idee_tpu.train import state as jstate

    return SimpleNamespace(jax=jax, jnp=jnp, cfg=jcfg, driver=jdriver,
                           SimpleNet=JSimpleNet, Dataset=JDataset,
                           state=jstate)


@pytest.fixture(scope="module")
def cube():
    return make_fake_cube(n_vars=3, n_time=N_TIME, height=16, width=16,
                          seed=5)


@pytest.fixture(scope="module")
def jcube():
    from idee_tpu.data.fake import make_fake_cube as jax_fake_cube

    return jax_fake_cube(n_vars=3, n_time=N_TIME, height=16, width=16,
                         seed=5)


def _noisy(jx, tree, rng, scale=0.05):
    return jx.jax.tree_util.tree_map(
        lambda p: (np.asarray(p) + scale * rng.normal(size=p.shape))
        .astype(np.float32), tree)


def _jax_models(jx, kw, seed=0):
    """The JAX backbone's and head's variables for ``kw``: their init plus
    N(0, 0.05); the head's BatchNorm statistics drawn too."""
    jcfg = jx.cfg(**kw)
    backbone, head = jx.driver.Backbone(config=jcfg), jx.SimpleNet(
        config=jcfg)
    rng = np.random.default_rng(seed)
    x = jx.jnp.zeros((2, 3, 1, 8, 16, 16), jx.jnp.float32)
    bb = jx.jax.jit(lambda a: backbone.init(
        {"params": jx.jax.random.PRNGKey(seed)}, a, train=False))(x)
    bb = {"params": _noisy(jx, bb["params"], rng)}
    z = jx.jax.jit(lambda v, a: backbone.apply(v, a, train=False))(bb, x)
    hv = jx.jax.jit(lambda a: head.init(
        {"params": jx.jax.random.PRNGKey(seed + 1)}, a, train=False))(z)
    stats = hv["batch_stats"]["discriminator"]["block1_bn"]
    head_vars = {"params": _noisy(jx, hv["params"], rng),
                 "batch_stats": {"discriminator": {"block1_bn": {
                     "mean": rng.normal(0, 0.1, stats["mean"].shape)
                     .astype(np.float32),
                     "var": rng.uniform(0.5, 1.5, stats["var"].shape)
                     .astype(np.float32)}}}}
    return jcfg, backbone, head, bb, head_vars


def _port_models(kw, bb, head_vars):
    cfg = oneclass_config(**kw)
    backbone = Backbone(cfg)
    backbone.load_state_dict(load_flax_params(cfg, bb, backbone))
    head = SimpleNet(cfg, in_planes=8)
    head.load_state_dict(load_flax_params(cfg, head_vars, head))
    return cfg, backbone.eval(), head


def _batch(seed, n=2):
    rng = np.random.default_rng(seed)
    return {"x": rng.normal(size=(n, 3, 1, 8, 16, 16)).astype(np.float32),
            "mask_extreme_loss": (rng.random((n, 16, 16)) < 0.3).astype(
                np.float32),
            "timestep": np.array([[8.0 + i] for i in range(n)], np.float32)}


# ---------------------------------------------------------------- data

@pytest.mark.parametrize("is_norm", [True, False])
def test_replace_anomaly_matches_jax_bit_for_bit(jx, cube, jcube, is_norm):
    """The extremes' pixels are overwritten by Normal(weekly median, |std|)
    draws of the dataset's numpy stream before normalisation, in JAX's
    order: the cube and the augmented items equal bit for bit."""
    kw = dict(times=(1, N_TIME), variables=VARS, delta_t=8, is_aug=True,
              is_norm=is_norm, is_clima_scale=False,
              is_replace_anomaly=True, seed=3)
    got = SyntheticDataset(cube=cube, **kw)
    want = jx.Dataset(cube=jcube, **kw)
    assert np.array_equal(got.datacube_dynamic, want.datacube_dynamic)
    for i in range(len(got)):
        a, b = got[i], want[i]
        for k in ("x", "mask_extreme_loss", "mask_extreme_loss_t"):
            assert np.array_equal(a[k], b[k]), (i, k)
    plain = SyntheticDataset(cube=cube, **dict(kw, is_replace_anomaly=False))
    sel = np.broadcast_to(plain.extreme[None] > 0,
                          plain.datacube_dynamic.shape)
    assert sel.any() and not sel.all()
    assert np.array_equal(plain.datacube_dynamic[~sel],
                          got.datacube_dynamic[~sel])
    assert not np.allclose(plain.datacube_dynamic[sel],
                           got.datacube_dynamic[sel])
    if not is_norm:
        # the draws: z-scores against the pixel's weekly climatology
        wk = ((np.arange(1, N_TIME + 1) - 1) % 52)
        med = cube.clima_median[:, wk]
        std = np.abs(cube.clima_std[:, wk])
        zs = ((got.datacube_dynamic - med) / std)[sel]
        assert abs(zs.mean()) < 0.1 and abs(zs.std() - 1) < 0.1


# ---------------------------------------------------------------- BatchNorm

def test_batchnorm_follows_flax_not_torch_at_a_small_batch(jx):
    """Two training calls and one eval call at 8 values per channel: the
    port's BatchNorm moves its running variance with the biased batch
    variance, as flax's nn.BatchNorm(momentum=0.9); torch's BatchNorm1d
    (momentum 0.1) takes the unbiased one, 8/7 larger, which this test
    tells apart (a torch-style update fails it)."""
    import flax.linen as fnn

    rng = np.random.default_rng(0)
    xs = [(1 + 2 * rng.normal(size=(8, 5))).astype(np.float32)
          for _ in range(2)]
    flax_bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                            epsilon=1e-5)
    variables = flax_bn.init(jx.jax.random.PRNGKey(0), xs[0])
    bn = BatchNorm(5)
    ref = torch.nn.BatchNorm1d(5, momentum=0.1, eps=1e-5)
    for x in xs:
        y, upd = flax_bn.apply(variables, x, mutable=["batch_stats"])
        variables = {"params": variables["params"], **upd}
        got = bn(torch.from_numpy(x), train=True)
        ref(torch.from_numpy(x))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(y),
                                   atol=1e-6)
    stats = variables["batch_stats"]
    for name in ("mean", "var"):
        np.testing.assert_allclose(getattr(bn, name).numpy(),
                                   np.asarray(stats[name]), atol=1e-6)
    gap = np.abs(ref.running_var.numpy() - np.asarray(stats["var"])).max()
    assert gap > 1e-2  # the unbiased update is far outside the tolerance
    eval_bn = fnn.BatchNorm(use_running_average=True, epsilon=1e-5)
    want = eval_bn.apply(variables, xs[0])
    np.testing.assert_allclose(bn(torch.from_numpy(xs[0])).detach().numpy(),
                               np.asarray(want), atol=1e-6)


# ---------------------------------------------------------------- model

def test_eval_forward_matches_jax(jx):
    kw = _tiny()
    jcfg, backbone, head, bb, hv = _jax_models(jx, kw)
    x = _batch(1)["x"]
    z = backbone.apply(bb, x, train=False)
    want = head.apply(hv, z, train=False)
    cfg, pbb, phead = _port_models(kw, bb, hv)
    with torch.no_grad():
        pz = pbb(torch.from_numpy(x))
        got = phead(pz)
    np.testing.assert_allclose(pz.numpy(), np.asarray(z), rtol=1e-5,
                               atol=1e-5)
    assert got.z_p_scores is None and got.z_n_scores.shape == (2, 3, 8, 16,
                                                               16, 1)
    np.testing.assert_allclose(got.z_n_scores.numpy(),
                               np.asarray(want.z_n_scores), rtol=1e-5,
                               atol=1e-5)


def test_noise_draws_and_training_call_order():
    """The negatives' noise is N(0, noise_std) from the step's generator,
    and the discriminator sees the noisy copy first: its BatchNorm
    statistics after one training call are those of the noisy batch
    folded in, then the clean one."""
    g = torch.Generator().manual_seed(0)
    n = port_simplenet.gaussian_noise((200_000,), g)
    assert abs(n.mean().item()) < 0.01 and abs(n.std().item() - 1) < 0.01
    cfg = oneclass_config(**_tiny(noise_std=1.5))
    head = SimpleNet(cfg, in_planes=8)
    z = torch.randn(1, 3, 8, 2, 4, 4) * 30
    g = torch.Generator().manual_seed(1)
    noise = 1.5 * port_simplenet.gaussian_noise(
        (3 * 2 * 4 * 4, 16), torch.Generator().manual_seed(1))
    with torch.no_grad():
        head(z, train=True, generator=g)
        proj = head.pre_projection(z.permute(0, 1, 3, 4, 5, 2).reshape(-1, 8)
                                   * 0.01)
        fc = head.discriminator.block1_fc
        stats = []
        for inp in (proj + noise, proj):
            h = fc(inp)
            stats.append((h.mean(0), (h * h).mean(0) - h.mean(0) ** 2))
    m = 0.9
    want = {"mean": torch.zeros(8), "var": torch.ones(8)}
    for mu, var in stats:
        want = {"mean": m * want["mean"] + (1 - m) * mu,
                "var": m * want["var"] + (1 - m) * var}
    bn = head.discriminator.block1_bn
    torch.testing.assert_close(bn.mean, want["mean"], atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(bn.var, want["var"], atol=1e-5, rtol=1e-5)


# The discriminator's Dense bias feeds a training-mode BatchNorm, which
# removes it: its gradient is 0 in exact arithmetic, and each framework
# gives it float noise (measured 1e-6-4e-5, against kernel gradients of
# 0.09), which Adam turns into lr-sized steps of random sign. The bias is
# checked for a tiny gradient and left out; the running mean it moves
# (the step-2 batch means hold the step-1 bias) is compared net of it.
NOISE_BIAS = "discriminator.block1_fc.bias"


def test_two_train_steps_match_jax(jx, monkeypatch):
    """Two Adam steps of the head over the frozen backbone, both frameworks
    given the same noise: losses, every parameter and the discriminator's
    BatchNorm statistics, moved twice per step (noisy copy, then clean:
    each step adds 0.1 * 0.9 and 0.1 of its batch means)."""
    kw = _tiny(noise_std=1.5)
    jcfg, backbone, head, bb, hv = _jax_models(jx, kw, seed=2)
    batches = [_batch(10), _batch(11)]
    noise = np.random.default_rng(7).normal(size=(2 * 3 * 8 * 16 * 16, 16)) \
        .astype(np.float32)

    monkeypatch.setattr(jx.jax.random, "normal",
                        lambda key, shape, *a, **k: jx.jnp.asarray(noise))
    state = jx.state.TrainState.create(
        apply_fn=head.apply, params=hv["params"],
        tx=jx.state.make_optimizer(jcfg, 3, params=hv["params"]),
        rng=jx.jax.random.PRNGKey(0),
        extra_vars={"batch_stats": hv["batch_stats"]})
    step = jx.driver.make_oc_train_step(backbone, head, jcfg, bb,
                                        donate=False)
    want_losses, want = [], []
    for b in batches:
        metrics = jx.driver.init_oc_metrics((3, T_LINE, 16, 16))
        state, metrics = step(state, metrics, b)
        want_losses.append(float(metrics["loss_sum"]))
        want.append({"params": state.params, **state.extra_vars})
    monkeypatch.undo()

    monkeypatch.setattr(port_simplenet, "gaussian_noise",
                        lambda shape, g=None, d=None: torch.from_numpy(noise))
    cfg, pbb, phead = _port_models(kw, bb, hv)
    pstate = create_train_state(cfg, phead, "cpu", steps_per_epoch=3)
    pstep = make_oc_train_step(pbb, phead, cfg)
    got_losses, got = [], []
    for b in batches:
        metrics = init_oc_metrics((3, T_LINE, 16, 16), "cpu")
        pstep(pstate, metrics, {k: torch.from_numpy(v) for k, v in b.items()})
        got_losses.append(metrics["loss_sum"].item())
        got.append({k: v.clone() for k, v in phead.state_dict().items()})
        if len(got) == 1:
            g = phead.discriminator.block1_fc
            assert g.bias.grad.abs().max() < 1e-3 * g.kernel.grad.abs().max()
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-5)
    want = [flax_to_state_dict(w, got[0]) for w in want]
    drift = got[0][NOISE_BIAS] - want[0][NOISE_BIAS]
    mean = "discriminator.block1_bn.mean"
    for i, (g, w) in enumerate(zip(got, want)):
        assert sorted(g) == sorted(w)
        if i == 1:
            g[mean] = g[mean] - (0.1 * 0.9 + 0.1) * drift
        for k in w:
            if k != NOISE_BIAS:
                np.testing.assert_allclose(g[k].numpy(), w[k].numpy(),
                                           rtol=0, atol=1e-5,
                                           err_msg=f"step {i + 1}: {k}")
    assert not torch.allclose(got[1]["discriminator.block1_bn.var"],
                              flax_to_state_dict(hv, got[0])[
                                  "discriminator.block1_bn.var"])
    # the backbone stayed frozen
    assert all(p.grad is None for p in pbb.parameters())


def test_val_anomaly_and_eval_step_match_jax(jx):
    """The per-variable threshold is the median of the normal pixels'
    scores (the mean of the two middle ones for an even count, as
    jnp.nanmedian; torch.nanmedian takes the lower) less 0.001; the eval
    step's loss and votes as JAX's."""
    rng = np.random.default_rng(3)
    s = np.round(rng.normal(size=(2, 3, 4, 5, 6)), 2).astype(np.float32)
    mask = (rng.random((2, 5, 6)) < 0.3).astype(np.float32)
    assert (mask == 0).sum() * 4 % 2 == 0  # an even count per variable
    anomaly, signed = val_anomaly(torch.from_numpy(s), torch.from_numpy(mask))
    janom, jsigned = jx.driver._val_anomaly(jx.jnp.asarray(s),
                                            jx.jnp.asarray(mask))
    np.testing.assert_array_equal(anomaly.numpy(), np.asarray(janom))
    np.testing.assert_array_equal(signed.numpy(), np.asarray(jsigned))
    lower = torch.from_numpy(s).transpose(0, 1).reshape(3, -1)[
        :, torch.from_numpy(np.broadcast_to(mask[:, None] == 0, (2, 4, 5, 6))
                            .reshape(-1))].nanmedian(1).values
    want_med = np.median(np.moveaxis(s, 1, 0).reshape(3, -1)[
        :, np.broadcast_to(mask[:, None] == 0, (2, 4, 5, 6)).reshape(-1)], 1)
    assert not np.allclose(lower.numpy(), want_med)

    kw = _tiny()
    jcfg, backbone, head, bb, hv = _jax_models(jx, kw, seed=4)
    b = _batch(5)
    jstep = jx.driver.make_oc_eval_step(backbone, head, jcfg, bb, t0=1.0)
    jm = jstep(hv, jx.driver.init_oc_metrics((3, T_LINE, 16, 16)), b)
    cfg, pbb, phead = _port_models(kw, bb, hv)
    pm = make_oc_eval_step(pbb, phead, cfg, t0=1.0)(
        init_oc_metrics((3, T_LINE, 16, 16), "cpu"),
        {k: torch.from_numpy(v) for k, v in b.items()})
    np.testing.assert_allclose(pm["loss_sum"].item(), float(jm["loss_sum"]),
                               rtol=1e-6)
    np.testing.assert_array_equal(pm["vote_sum"].numpy(),
                                  np.asarray(jm["vote_sum"]))


# ---------------------------------------------------------------- drivers

def test_drivers_match_jax(jx, cube, jcube, tmp_path, monkeypatch):
    """train_simplenet_synthetic (2 epochs, anomaly-replaced, augmentations
    on, noise_std 0) and test_simplenet_synthetic against the JAX drivers:
    the backbone from model_pretrained (an orbax checkpoint holding an
    "encoder" subtree for JAX, a flax-path .npz for the port), the head
    from the same weights (each driver's create_train_state patched to
    take them). Losses and F1 per epoch, the test's metrics."""
    import orbax.checkpoint as ocp

    kw = _tiny(noise_std=0.0, dir_log=str(tmp_path), is_aug=True)
    jcfg, backbone, head, bb, hv = _jax_models(jx, kw, seed=6)
    ocp.StandardCheckpointer().save(str(tmp_path / "bb_orbax"), bb["params"])
    save_flax_npz(str(tmp_path / "bb.npz"), bb["params"])
    save_flax_npz(str(tmp_path / "head.npz"), hv)

    real_create = jx.driver.create_train_state

    def with_head(*a, **k):
        s = real_create(*a, **k)
        return s.replace(params=hv["params"],
                         extra_vars={"batch_stats": hv["batch_stats"]})

    monkeypatch.setattr(jx.driver, "create_train_state", with_head)
    jcfg = jx.cfg(**dict(kw, name="jax",
                         model_pretrained=str(tmp_path / "bb_orbax")))
    want = jx.driver.train_simplenet_synthetic(
        jcfg, jcube.time_slice(1, 18), jcube.time_slice(19, N_TIME))
    jres = jx.driver.test_simplenet_synthetic(
        jcfg.replace(times_test=(1, N_TIME)), jcube,
        params={"params": want["state"].params, **want["state"].extra_vars},
        bb_variables=want["bb_variables"])
    monkeypatch.undo()

    cfg = oneclass_config(**dict(kw, name="port",
                                 model_pretrained=str(tmp_path / "bb.npz")))
    port_create = port_driver.create_train_state

    def port_with_head(c, model, *a, **k):
        model.load_state_dict(load_flax_params(
            c, load_flax_npz(str(tmp_path / "head.npz")), model))
        return port_create(c, model, *a, **k)

    monkeypatch.setattr(port_driver, "create_train_state", port_with_head)
    got = port_train_simplenet(cfg, cube.time_slice(1, 18),
                               cube.time_slice(19, N_TIME), device="cpu")
    monkeypatch.undo()
    np.testing.assert_allclose(got["train_loss"], want["train_loss"],
                               rtol=1e-4)
    np.testing.assert_allclose(got["val_loss"], want["val_loss"], rtol=1e-4)
    # NOISE_BIAS takes random-sign steps in both: the median thresholds move
    # by float noise, a few bits of the vote flip
    np.testing.assert_allclose(got["val_anom_f1"], want["val_anom_f1"],
                               atol=1e-3)
    # the test driver reads the head from its checkpoint and the backbone
    # from model_pretrained
    ckpt = tmp_path / "port" / "model_checkpoints" / "latest.pt"
    res = port_test_simplenet(cfg.replace(times_test=(1, N_TIME),
                                          en_de_pretrained=str(ckpt)),
                              cube, device="cpu")
    np.testing.assert_allclose(res["mean_loss"], jres["mean_loss"],
                               rtol=1e-4)
    for key in ("driver_f1_pos", "driver_iou_pos"):
        np.testing.assert_allclose(res[key], jres[key], atol=1e-3,
                                   err_msg=key)
    assert res["anomaly"].shape == (3, N_TIME, 16, 16)
    assert 0 < np.nanmean(res["anomaly"]) < 1


def test_backbone_loads_the_encoder_of_a_port_checkpoint(tmp_path):
    """load_backbone_params keeps the encoder of a core VQ-model
    checkpoint of the port's trainer (the reference's filtered load)."""
    from idee_tpu_torch.config import synthetic_config
    from idee_tpu_torch.models.vq_model import build_model
    from idee_tpu_torch.train.checkpoint import CheckpointManager

    core = synthetic_config(**{k: v for k, v in _tiny().items()
                               if k not in ("dim", "dsc_hidden")},
                            codebook_dim=8, cls_dim=8)
    model = build_model(core)
    state = create_train_state(core, model, "cpu")
    CheckpointManager(str(tmp_path)).save("latest", state, 0)
    cfg = oneclass_config(**_tiny())
    backbone = Backbone(cfg)
    sd = load_backbone_params(str(tmp_path / "model_checkpoints" /
                                  "latest.pt"), backbone, cfg)
    backbone.load_state_dict(sd)
    for k, v in backbone.state_dict().items():
        assert torch.equal(v, model.state_dict()[k]), k


# ---------------------------------------------------------------- CLIs

@pytest.mark.parametrize("cli,fn,train", [
    ("train_simplenet_synthetic", "train_simplenet_synthetic", True),
    ("test_simplenet_synthetic", "test_simplenet_synthetic", False)])
def test_cli_flags_match_the_jax_script(monkeypatch, tmp_path, cli, fn,
                                        train):
    import importlib

    from idee_tpu.baselines.config import oneclass_config as jax_oc_config
    from idee_tpu.config import read_arguments as jax_read

    mod = importlib.import_module(f"idee_tpu_torch.cli.{cli}")
    seen = {}
    monkeypatch.setattr(mod, fn, lambda cfg, device: seen.update(
        cfg=cfg, device=device))
    argv = ["--noise_std", "0.5", "--dsc_hidden", "12", "--dir_log",
            str(tmp_path), "--name", "cli", "--model_pretrained", "m.pt",
            "--is_replace_anomaly", "false"]
    mod.main(argv + ["--device", "cpu"])
    want = jax_read(train=train, print_=False, save=False, argv=argv,
                    defaults=jax_oc_config())
    assert seen["device"] == "cpu"
    assert seen["cfg"].to_dict() == want.to_dict()
    assert seen["cfg"].dsc_hidden == 12 and not seen["cfg"].is_replace_anomaly


# ---------------------------------------------------------------- card only

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
def test_train_step_on_card_matches_cpu(cuda, monkeypatch):
    """One SimpleNet train step over a frozen Swin_3D backbone on the card
    (the attention forward kernel, no backward) against the CPU, the same
    noise on both: loss, the step's gradients (each leaf within 1e-3 of
    its norm, NOISE_BIAS checked tiny), parameters (all within lr, all but
    0.5 % within 1e-5, but NOISE_BIAS) and BatchNorm statistics. The
    hinge and the LeakyReLU have kinks: a token whose input lies within
    float noise of one takes the other slope on the other device, which
    moves single gradient entries (measured on the H100: 2.6e-5 in one
    BatchNorm-bias entry of 0.04, one token's share), so the gradients
    are held leaf by leaf in norm, not entry by entry."""
    from idee_tpu_torch.kernels import window_attention as wa

    cfg = oneclass_config(**_tiny(encoder="Swin_3D", en_depths=[2, 1]))
    noise = torch.randn(2 * 3 * 8 * 16 * 16, 16,
                        generator=torch.Generator().manual_seed(0))
    monkeypatch.setattr(port_simplenet, "gaussian_noise",
                        lambda shape, g=None, d=None: noise.to(d))
    b = _batch(6)
    runs, grads = [], []
    for dev in ("cpu", cuda):
        backbone = Backbone(cfg).to(dev).eval()
        head = SimpleNet(cfg, in_planes=8)
        state = create_train_state(cfg, head, dev, steps_per_epoch=3)
        metrics = init_oc_metrics((3, T_LINE, 16, 16), dev)
        before = dict(wa.launches)
        make_oc_train_step(backbone, head, cfg)(
            state, metrics, {k: torch.from_numpy(v).to(dev)
                             for k, v in b.items()})
        runs.append((metrics["loss_sum"].item(),
                     {k: v.cpu() for k, v in head.state_dict().items()}))
        grads.append({k: p.grad.cpu() for k, p in head.named_parameters()})
    assert wa.launches[wa.ATTN_FWD] == before[wa.ATTN_FWD] + 3
    assert wa.launches[wa.ATTN_BWD] == before[wa.ATTN_BWD]
    np.testing.assert_allclose(runs[1][0], runs[0][0], rtol=1e-4)
    gmax = max(g.abs().max().item() for g in grads[0].values())
    for k, want in grads[0].items():
        if k == NOISE_BIAS:  # zero in exact arithmetic (see above)
            assert grads[1][k].abs().max().item() <= 1e-3 * gmax, k
            continue
        err = ((grads[1][k] - want).norm() / want.norm()).item()
        assert err <= 1e-3, (k, err)
    far = 0
    for k, want in runs[0][1].items():
        if k.endswith((".mean", ".var")):
            torch.testing.assert_close(runs[1][1][k], want, rtol=1e-4,
                                       atol=1e-5)
        elif k != NOISE_BIAS:  # its gradient is float noise (see above)
            # Adam's one step lr * u / (|u| + 1e-8) follows u's last bits
            # where u is a few eps: such entries may part by up to lr
            d = (runs[1][1][k] - want).abs()
            assert d.max().item() <= cfg.lr + 1e-5, k
            far += int((d > 1e-5).sum())
    assert far <= 0.005 * sum(v.numel() for v in runs[0][1].values())
