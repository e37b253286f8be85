# ------------------------------------------------------------------
"""The port's training slice against the JAX package: the anomaly L1's
custom backward, the LFQ training branch, the schedules, the optimizers,
the train step's trajectory, the driver with its checkpoints and resume,
and the loader's shuffled order.

Tiny config: 3 variables, 16x16, delta_t=8, en_embed_dim=[8, 8],
en_depths=[2, 1] (the shifted block runs), constant lr 1e-3, batch 2, with
the same weights carried across by ``load_flax_params``. Tolerances, all
float32:
  * anomaly L1 value and gradients: rtol 1e-6;
  * LFQ training-branch gradients: rtol 1e-5 / atol 1e-6;
  * schedules: rtol 1e-6 (JAX evaluates them in float32; the
    differences are ~4e-7 relative, under 1e-10 absolute);
  * two optimizer steps: rtol 1e-6 / atol 1e-4 x lr (optax rounds Adam's
    bias corrections in float32);
  * 3 train steps: losses rtol 1e-4, step-1 gradients rtol 1e-4 /
    atol 1e-6, parameters after 3 Adam steps atol 1e-5 at lr 1e-3 (the
    test needed 6.0e-6 for Mamba and 2.4e-6 for CNN_3D: Adam divides each
    gradient by its running RMS, so last-bit differences of small
    gradient entries become visible fractions of lr-sized steps);
  * driver, 2 epochs: train/val losses rtol 1e-4, every F1 equal.
Dropout and drop-path with nonzero rates run but cannot match JAX's random
bits (the two frameworks draw different numbers from the same seed): they
are checked for their own semantics and reproducibility only.

The JAX side is imported inside fixtures, so the card-only tests also
collect where JAX is not installed
(``python -m pytest --noconftest tests/test_torch_train.py -m gpu``).
"""
# ------------------------------------------------------------------

import json
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from idee_tpu_torch import losses
from idee_tpu_torch.config import Config, synthetic_config
from idee_tpu_torch.data.fake import make_fake_cube, write_cube_npz
from idee_tpu_torch.data.loader import DataLoader
from idee_tpu_torch.kernels import selective_scan as ss
from idee_tpu_torch.models.interop import (flax_to_state_dict,
                                           load_flax_params, save_flax_npz)
from idee_tpu_torch.models.vq_model import build_model
from idee_tpu_torch.nn.layers import drop_path, dropout
from idee_tpu_torch.quant.lfq import LFQ
from idee_tpu_torch.train.checkpoint import CheckpointManager
from idee_tpu_torch.train.driver import train_synthetic
from idee_tpu_torch.train.schedule import make_epoch_schedule
from idee_tpu_torch.train.state import create_train_state, param_groups
from idee_tpu_torch.train.steps import init_epoch_metrics, make_train_step
from idee_tpu_torch.utils.logging import StepTimer, SummaryWriter

torch.set_num_threads(1)

VARS = ["var_01", "var_02", "var_03"]
T_LINE = 20  # timeline slots of the step tests' vote buffers


def _tiny_config(**kw) -> Config:
    base = dict(encoder="Mamba", in_channels_dynamic=3, variables=VARS,
                x_max=16, y_max=16, en_embed_dim=[8, 8], en_depths=[2, 1],
                codebook_dim=8, cls_dim=8, batch_size=2, n_epochs=10,
                lr_warmup_epochs=0, name="train")
    base.update(kw)
    return synthetic_config(**base)


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp
    import optax

    from idee_tpu import losses as jlosses
    from idee_tpu.config import Config as JConfig
    from idee_tpu.kernels import runtime
    from idee_tpu.models.vq_model import build_model as jax_build_model
    from idee_tpu.quant.lfq import LFQ as JLFQ
    from idee_tpu.train import state as jstate
    from idee_tpu.train import steps as jsteps
    from idee_tpu.train.driver import train_synthetic as jax_train
    from idee_tpu.train.schedule import make_epoch_schedule as jax_schedule

    return SimpleNamespace(
        jax=jax, jnp=jnp, optax=optax, losses=jlosses, runtime=runtime,
        JLFQ=JLFQ, state=jstate, steps=jsteps, train=jax_train,
        schedule=jax_schedule, build_model=jax_build_model,
        cfg=lambda c: JConfig.from_dict(c.to_dict()))


def _jax_params(jx, cfg: Config, seed: int = 0):
    """The JAX VQModel of ``cfg`` and its own initial parameters (as
    numpy), from PRNGKey(seed)."""
    model = jx.build_model(jx.cfg(cfg))
    x = jx.jnp.zeros((1, 3, 1, 8, 16, 16), jx.jnp.float32)
    params = jx.jax.jit(lambda a: model.init(
        {"params": jx.jax.random.PRNGKey(seed)}, a, train=False))(x)
    return model, jx.jax.tree_util.tree_map(np.asarray, params["params"])


@pytest.fixture(scope="module")
def mamba_params(jx):
    """The JAX package's own initial parameters of the tiny Mamba config
    (PRNGKey(1))."""
    return _jax_params(jx, _tiny_config(), seed=1)[1]


def _close_trees(got_sd, want_sd, rtol, atol, what):
    assert sorted(got_sd) == sorted(want_sd), what
    for k in want_sd:
        np.testing.assert_allclose(got_sd[k].detach().cpu().numpy(),
                                   want_sd[k].numpy(), rtol=rtol, atol=atol,
                                   err_msg=f"{what}: {k}")


# ---------------------------------------------------------------- losses

def test_anomaly_l1_lfq_value_and_gradients_match_jax(jx):
    rng = np.random.default_rng(0)
    s_q = np.where(rng.random((2, 8, 6, 6, 3)) < 0.4, 1.0, -1.0).astype(
        np.float32)
    w_pix = (rng.random((2, 6, 6)) < 0.8).astype(np.float32)
    w_out, b_out = (rng.normal(size=(5,)).astype(np.float32)
                    for _ in range(2))
    args = (s_q, w_pix, w_out, b_out)
    want, want_grads = jx.jax.value_and_grad(
        jx.losses.anomaly_l1_lfq, argnums=(0, 2, 3))(
            *map(jx.jnp.asarray, args))
    ts = [torch.from_numpy(a) for a in args]
    for i in (0, 2, 3):
        ts[i].requires_grad_()
    got = losses.anomaly_l1_lfq(*ts)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    for i, wg in zip((0, 2, 3), want_grads):
        np.testing.assert_allclose(ts[i].grad.numpy(), np.asarray(wg),
                                   rtol=1e-6, atol=1e-9)
    # the custom backward, not autograd of the collapsed form: s_q gets a
    # gradient where s_q = +1, and b_out gets one at all
    assert ts[0].grad.abs().sum() > 0 and ts[3].grad.abs().sum() > 0


@pytest.mark.parametrize("freeze", [False, True])
def test_lfq_training_branch_gradients_match_jax(jx, freeze):
    V, d = 3, 8
    rng = np.random.default_rng(1)
    zp = (0.5 * rng.normal(size=(2, 4, 5, 5, V * d))).astype(np.float32)
    r, cw, cb = (rng.normal(size=s).astype(np.float32)
                 for s in ((2, 4, 5, 5, V), (d,), (d,)))
    jlfq = jx.JLFQ(dim=d, codebook_size=2, entropy_loss_weight=0.1,
                   diversity_gamma=0.1, commitment_loss_weight=3.0,
                   freeze_project_out=freeze)
    def f(m, z):
        parts = m.quantize_packed(z, V, train=True)
        w, b = m.out_proj_params()
        return (parts.aux_loss + jx.jnp.sum(parts.s_q * r)
                + jx.jnp.sum(w * cw) + jx.jnp.sum(b * cb))

    shapes = jx.jax.eval_shape(
        lambda z: jlfq.init(jx.jax.random.PRNGKey(0), z, method=f), zp)
    params = jx.jax.tree_util.tree_map(
        lambda s: (0.3 * rng.normal(size=s.shape)).astype(np.float32),
        shapes["params"])

    def jloss(p, z):
        return jlfq.apply({"params": p}, z, method=f)

    want, (want_p, want_z) = jx.jax.value_and_grad(jloss, argnums=(0, 1))(
        params, jx.jnp.asarray(zp))

    lfq = LFQ(dim=d, codebook_size=2, entropy_loss_weight=0.1,
              diversity_gamma=0.1, commitment_loss_weight=3.0,
              freeze_project_out=freeze)
    lfq.load_state_dict(flax_to_state_dict(params, lfq.state_dict()))
    z = torch.from_numpy(zp).requires_grad_()
    parts = lfq.quantize_packed(z, V, train=True)
    w, b = lfq.out_proj_params()
    got = (parts.aux_loss + (parts.s_q * torch.from_numpy(r)).sum()
           + (w * torch.from_numpy(cw)).sum()
           + (b * torch.from_numpy(cb)).sum())
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(z.grad.numpy(), np.asarray(want_z),
                               rtol=1e-5, atol=1e-6)
    want_sd = flax_to_state_dict(want_p, lfq.state_dict())
    for k, p in lfq.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        np.testing.assert_allclose(g.numpy(), want_sd[k].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    assert (lfq.project_out.weight.grad is None) == freeze


# ---------------------------------------------------------------- schedule

@pytest.mark.parametrize("sched", ["cosine", "step"])
def test_schedule_matches_jax_at_every_step(jx, sched):
    cfg = _tiny_config(lr_scheduler=sched, lr_warmup_epochs=2, n_epochs=5,
                       lr_decay_step=2, lr_decay_rate=0.5)
    spe = 3
    got = make_epoch_schedule(cfg, spe)
    want = jx.schedule(jx.cfg(cfg), spe)
    lrs = [got(s) for s in range(5 * spe)]
    # JAX evaluates the schedule in float32: within a few of its ulps
    np.testing.assert_allclose(lrs, [float(want(s)) for s in range(5 * spe)],
                               rtol=1e-6, atol=0.0)
    assert len(set(lrs)) >= 4  # warmup, then the decay: the steps differ


# ---------------------------------------------------------------- optimizer

@pytest.mark.parametrize("groups", [False, True])
@pytest.mark.parametrize("opt", ["Adam", "AdamW"])
def test_optimizer_steps_match_optax(jx, mamba_params, opt, groups):
    cfg = _tiny_config(optimizer=opt, use_optimizer_groups=groups,
                       weight_decay=0.05)
    params = mamba_params
    rng = np.random.default_rng(2)
    grads = [jx.jax.tree_util.tree_map(
        lambda p: rng.normal(size=p.shape).astype(np.float32), params)
        for _ in range(2)]

    tx = jx.state.make_optimizer(jx.cfg(cfg), 3, params=params)
    opt_state = tx.init(params)
    p = params

    @jx.jax.jit
    def update(g, opt_state, p):
        updates, opt_state = tx.update(g, opt_state, p)
        return jx.optax.apply_updates(p, updates), opt_state

    for g in grads:
        p, opt_state = update(g, opt_state, p)

    model = build_model(cfg)
    model.load_state_dict(load_flax_params(cfg, params))
    state = create_train_state(cfg, model, "cpu", steps_per_epoch=3)
    named = dict(model.named_parameters())
    for g in grads:
        for k, t in flax_to_state_dict(g, named).items():
            named[k].grad = t
        state.apply_gradients()
    assert state.step == 2
    # atol 1e-4 x lr: optax takes Adam's bias corrections 1 - beta^t in
    # float32, where 1 - 0.999^2 cancels to a relative 3e-5
    _close_trees(dict(model.named_parameters()),
                 flax_to_state_dict(p, model.state_dict()), rtol=1e-6,
                 atol=1e-4 * cfg.lr, what=f"{opt} groups={groups}")
    n_groups = len(param_groups(model, cfg))
    assert n_groups == (2 if groups else 1)


# ---------------------------------------------------------------- train step

def _batches(n, seed, t0=1.0):
    rng = np.random.default_rng(seed)
    return [{
        "x": rng.normal(size=(2, 3, 1, 8, 16, 16)).astype(np.float32),
        "mask_extreme": (rng.random((2, 16, 16)) < 0.1).astype(np.float32),
        "mask_extreme_loss": (rng.random((2, 16, 16)) < 0.2).astype(
            np.float32),
        "timestep": np.array([[t0 + 7 + 2 * i], [t0 + 8 + 2 * i]],
                             np.float32),
    } for i in range(n)]


def _jax_trajectory(jx, cfg, params, batches):
    """JAX: the losses of 3 make_train_step steps, the params after them,
    and the step-1 gradients."""
    jcfg = jx.cfg(cfg)
    model = jx.build_model(jcfg)
    state = jx.state.TrainState.create(
        apply_fn=model.apply, params=params,
        tx=jx.state.make_optimizer(jcfg, 3, params=params),
        rng=jx.jax.random.PRNGKey(0), extra_vars={})
    step = jx.steps.make_train_step(model, jcfg, t0=1.0, donate=False,
                                    steps_per_epoch=3)
    jb = [{k: jx.jnp.asarray(v) for k, v in b.items()} for b in batches]

    def loss_fn(p, b):
        out = model.apply({"params": p}, b["x"], train=True,
                          mask_extreme_loss=b["mask_extreme_loss"])
        return jx.losses.total_loss_synthetic(
            out, b["mask_extreme"], b["mask_extreme_loss"],
            jcfg.lambda_anomaly)[0]

    grads = jx.jax.jit(jx.jax.grad(loss_fn))(params, jb[0])
    loss_list = []
    for b in jb:
        metrics = jx.steps.init_epoch_metrics((3, T_LINE, 16, 16))
        state, metrics = step(state, metrics, b)
        loss_list.append(float(metrics["loss_sums"]["loss"]))
    return loss_list, state.params, grads


# The init seed of each encoder is one where no ReLU input behind a
# LayerNorm lies within float32 noise of 0: CNN_3D's blocks end in
# LayerNorm -> ReLU, and its LayerNorms amplify the two frameworks' last-bit
# differences ~20x (channels from the reference init are nearly collinear),
# so at other seeds a kink's derivative flips for a few pixels (checked:
# JAX init seeds 0-6, CNN_3D step-1 gradients; seed 2 has no flip). The
# Swin_3D case runs the JAX window attention's Pallas backward in
# interpret mode against the port's plain backward.
@pytest.mark.parametrize("encoder,seed", [("Mamba", 1), ("CNN_3D", 2),
                                          ("Swin_3D", 1)])
def test_train_step_trajectory_matches_jax(jx, encoder, seed):
    cfg = _tiny_config(encoder=encoder)
    _, params = _jax_params(jx, cfg, seed=seed)
    batches = _batches(3, seed=3)
    jx.runtime.set_force_pallas(True)
    try:
        want_losses, want_params, want_grads = _jax_trajectory(
            jx, cfg, params, batches)
    finally:
        jx.runtime.set_force_pallas(False)

    model = build_model(cfg)
    model.load_state_dict(load_flax_params(cfg, params))
    state = create_train_state(cfg, model, "cpu", steps_per_epoch=3)
    step = make_train_step(model, cfg, t0=1.0, steps_per_epoch=3)
    got_losses = []
    for i, b in enumerate(batches):
        metrics = init_epoch_metrics((3, T_LINE, 16, 16), "cpu")
        state, metrics = step(state, metrics,
                              {k: torch.from_numpy(v) for k, v in b.items()})
        got_losses.append(metrics["loss_sums"]["loss"].item())
        if i == 0:
            _close_trees({k: p.grad for k, p in model.named_parameters()},
                         flax_to_state_dict(want_grads, model.state_dict()),
                         rtol=1e-4, atol=1e-6, what="step-1 gradients")
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-4)
    got_params = dict(model.named_parameters())
    want_params = flax_to_state_dict(want_params, model.state_dict())
    if encoder == "Swin_3D":
        # the attention's key bias has a zero gradient in exact arithmetic
        # (it adds one constant to a whole row of scores, which softmax
        # ignores); both frameworks give it float noise, which Adam scales
        # to lr-sized steps of random sign. Checked tiny, then left out.
        for k in [k for k in want_params if k.endswith("attn.qkv.bias")]:
            C = want_params[k].shape[1] // 3
            key_grad = flax_to_state_dict(
                want_grads, model.state_dict())[k][:, C:2 * C]
            assert key_grad.abs().max() < 1e-6, k
            keep = torch.ones(3 * C, dtype=torch.bool)
            keep[C:2 * C] = False
            got_params[k] = got_params[k][:, keep]
            want_params[k] = want_params[k][:, keep]
    _close_trees(got_params, want_params, rtol=0.0, atol=1e-5,
                 what="params after 3 steps")
    assert state.step == 3


def test_train_step_ramps_the_anomaly_weight():
    """lambda_anomaly x clip((step - warm) / ramp, 0, 1) with warm = 1
    epoch and ramp = 2 epochs of 2 steps (JAX ``_train_step_body``)."""
    cfg = _tiny_config(anomaly_warmup_epochs=1, anomaly_ramp_epochs=2)
    model = build_model(cfg)
    state = create_train_state(cfg, model, "cpu", steps_per_epoch=2)
    step = make_train_step(model, cfg, t0=1.0, steps_per_epoch=2)
    batch = {k: torch.from_numpy(v) for k, v in _batches(1, seed=7)[0].items()}
    for k, frac in enumerate([0.0, 0.0, 0.0, 0.25, 0.5, 0.75, 1.0, 1.0]):
        metrics = init_epoch_metrics((3, T_LINE, 16, 16), "cpu")
        state, metrics = step(state, metrics, batch)
        c = {n: v.item() for n, v in metrics["loss_sums"].items()}
        want = (c["loss_bce"] + frac * cfg.lambda_anomaly * c["loss_anomaly"]
                + c["loss_var"] + c["loss_z_q"])
        assert c["loss"] == pytest.approx(want, rel=1e-6), k
        assert c["loss_anomaly"] > 0


def test_train_step_runs_dropout_and_drop_path_reproducibly():
    cfg = _tiny_config(en_drop_rate=0.2, en_drop_path_rate=0.3,
                       cls_drop_rate=0.2)
    b = {k: torch.from_numpy(v) for k, v in _batches(1, seed=4)[0].items()}
    runs = []
    for _ in range(2):
        model = build_model(cfg)
        state = create_train_state(cfg, model, "cpu", steps_per_epoch=3)
        step = make_train_step(model, cfg, t0=1.0, steps_per_epoch=3)
        metrics = init_epoch_metrics((3, T_LINE, 16, 16), "cpu")
        state, metrics = step(state, metrics, b)
        runs.append((metrics["loss_sums"]["loss"].item(),
                     model.state_dict()))
    assert math.isfinite(runs[0][0]) and runs[0][0] == runs[1][0]
    for k, v in runs[0][1].items():
        assert torch.equal(v, runs[1][1][k]), k


def test_dropout_and_drop_path_semantics():
    g = torch.Generator().manual_seed(0)
    x = torch.ones(200, 50)
    y = dropout(x, 0.25, True, g)
    assert set(y.unique().tolist()) <= {0.0, (torch.tensor(1.0) / 0.75).item()}
    assert abs((y == 0).float().mean().item() - 0.25) < 0.02
    y = drop_path(x, 0.5, True, g)
    # each sample is kept (scaled by 1/keep) or dropped as a whole
    assert y.unique(dim=1).shape[1] == 1
    assert set(y[:, 0].tolist()) == {0.0, 2.0}
    assert torch.equal(dropout(x, 0.25, False, g), x)


def test_checkpoint_resume_continues_the_same_trajectory(tmp_path):
    cfg = _tiny_config()
    batches = [{k: torch.from_numpy(v) for k, v in b.items()}
               for b in _batches(3, seed=5)]

    def fresh():
        model = build_model(cfg)
        state = create_train_state(cfg, model, "cpu", steps_per_epoch=3)
        return state, make_train_step(model, cfg, t0=1.0, steps_per_epoch=3)

    state, step = fresh()
    for b in batches[:2]:
        state, _ = step(state, init_epoch_metrics((3, T_LINE, 16, 16),
                                                  "cpu"), b)
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save("latest", state, epoch=0, mean_loss_train=1.0)
    state, _ = step(state, init_epoch_metrics((3, T_LINE, 16, 16), "cpu"),
                    batches[2])

    resumed, step2 = fresh()
    meta = ckpt.restore("latest", resumed)["meta"]
    assert meta["epoch"] == 0 and resumed.step == 2
    resumed, _ = step2(resumed, init_epoch_metrics((3, T_LINE, 16, 16),
                                                   "cpu"), batches[2])
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, resumed.model.state_dict()[k]), k


# ---------------------------------------------------------------- loader

def test_loader_shuffles_in_the_jax_order(jx):
    from idee_tpu.data.loader import DataLoader as JaxLoader

    items = [{"i": np.array([i])} for i in range(11)]
    want = JaxLoader(items, 2, shuffle=True, drop_last=True, seed=7,
                     prefetch=0)
    got = DataLoader(items, 2, device="cpu", shuffle=True, drop_last=True,
                     seed=7)
    for _ in range(3):  # a new order every epoch, the same on both sides
        w = [np.asarray(b["i"]).ravel().tolist() for b in want]
        g = [b["i"].ravel().tolist() for b in got]
        assert g == w and len(g) == 5
    tail = DataLoader(items, 2, device="cpu", drop_last=False)
    assert [b["i"].ravel().tolist() for b in tail][-1] == [10]


def test_step_timer_and_summary_writer_without_tensorboard(monkeypatch,
                                                           tmp_path):
    timer = StepTimer(warmup=1)
    assert math.isnan(timer.steps_per_sec)
    for _ in range(3):
        timer.tick()
    assert timer.steps_per_sec > 0
    import builtins

    real_import = builtins.__import__

    def no_tensorboard(name, *a, **kw):
        if name.startswith("torch.utils.tensorboard"):
            raise ImportError(name)
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_tensorboard)
    w = SummaryWriter(str(tmp_path))
    w.add_scalars("Loss", {"train": 1.0}, 1)
    w.flush()
    w.close()
    assert not list(tmp_path.iterdir())


# ---------------------------------------------------------------- driver

N_TIME = 30


@pytest.fixture(scope="module")
def cube():
    return make_fake_cube(n_vars=3, n_time=N_TIME, height=16, width=16,
                          seed=3)


def _driver_config(tmp, **kw):
    base = dict(times_train=(1, 18), times_val=(19, N_TIME), n_epochs=2,
                lr_warmup_epochs=1, dir_log=str(tmp))
    base.update(kw)
    return _tiny_config(**base)


def _same_history(got, want, keys_equal):
    np.testing.assert_allclose(got["train_loss"], want["train_loss"],
                               rtol=1e-4)
    np.testing.assert_allclose(got["val_loss"], want["val_loss"], rtol=1e-4)
    for k in keys_equal:
        assert len(got[k]) == len(want[k])
        for a, b in zip(got[k], want[k]):
            assert a == b or (math.isnan(a) and math.isnan(b)), (k, a, b)


F1_KEYS = ("train_f1", "val_f1", "train_anom_f1", "val_anom_f1")


def test_train_synthetic_matches_jax_and_resumes(jx, cube, tmp_path):
    from idee_tpu.data.fake import make_fake_cube as jax_make_fake_cube

    import orbax.checkpoint as ocp

    # weights N(0, 0.1) from a numpy seed, so that both anomaly codes
    # occur and the driver F1s are numbers: the JAX driver reads them as
    # an orbax checkpoint, the port as a flax-path .npz
    cfg = _driver_config(tmp_path / "port", name="drv")
    rng = np.random.default_rng(11)
    params = jx.jax.tree_util.tree_map(
        lambda p: (0.1 * rng.normal(size=p.shape)).astype(np.float32),
        _jax_params(jx, cfg)[1])
    ocp.StandardCheckpointer().save(str(tmp_path / "init_orbax"), params)
    save_flax_npz(str(tmp_path / "init.npz"), params)
    jcube = jax_make_fake_cube(n_vars=3, n_time=N_TIME, height=16, width=16,
                               seed=3)
    want = jx.train(jx.cfg(cfg.replace(
        dir_log=str(tmp_path / "jax"),
        en_de_pretrained=str(tmp_path / "init_orbax"))),
        train_cube=jcube.time_slice(1, 18),
        val_cube=jcube.time_slice(19, N_TIME))

    cfg = cfg.replace(en_de_pretrained=str(tmp_path / "init.npz"))
    got = train_synthetic(cfg, train_cube=cube.time_slice(1, 18),
                          val_cube=cube.time_slice(19, N_TIME),
                          device="cpu")
    _same_history(got, want, F1_KEYS)
    assert any(not math.isnan(v) for v in got["train_anom_f1"])
    ckpts = sorted(p.name for p in (tmp_path / "port" / "drv" /
                                    "model_checkpoints").iterdir())
    assert "latest.pt" in ckpts and "best_loss_model.pt" in ckpts
    with open(tmp_path / "port" / "drv" / "history.json") as fh:
        assert json.load(fh)["train_loss"] == got["train_loss"]

    # a third epoch resumes from latest: epochs 1-2 are kept, not rerun
    more = train_synthetic(cfg.replace(n_epochs=3),
                           train_cube=cube.time_slice(1, 18),
                           val_cube=cube.time_slice(19, N_TIME),
                           device="cpu")
    assert more["train_loss"][:2] == got["train_loss"]
    assert len(more["train_loss"]) == 3
    assert more["state"].step == 3 * ((18 - 8 + 1) // 2)


def test_train_cli_reads_npz_cube(cube, tmp_path):
    from idee_tpu_torch.cli.train_synthetic import main

    root = tmp_path / "synthetic_fake"
    write_cube_npz(str(root), cube)
    cfg = _driver_config(tmp_path / "log", name="cli", n_epochs=1)
    flags = ["--device", "cpu", "--root_synthetic", str(root),
             "--dir_log", cfg.dir_log, "--name", "cli", "--n_epochs", "1",
             "--variables", str(VARS)]
    for k in ("encoder", "in_channels_dynamic", "x_max", "y_max",
              "en_embed_dim", "en_depths", "codebook_dim", "cls_dim",
              "times_train", "times_val", "batch_size", "lr_warmup_epochs"):
        flags += [f"--{k}", str(getattr(cfg, k))]
    got = main(flags)
    want = train_synthetic(cfg.replace(name="direct"),
                           train_cube=cube.time_slice(1, 18),
                           val_cube=cube.time_slice(19, N_TIME),
                           device="cpu")
    assert got["train_loss"] == want["train_loss"]
    assert got["val_loss"] == want["val_loss"]


def test_driver_refuses_what_is_not_ported(tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        train_synthetic(_driver_config(tmp_path, mesh_shape=[2]),
                        device="cpu")
    # the profiler hook is ported: accepted, and it selects the per-step
    # loop over the fused epochs (tests/test_torch_tools.py runs it)
    from idee_tpu_torch.train.driver import _check_supported, use_fused

    cfg = _driver_config(tmp_path, profile_dir=str(tmp_path),
                         device_data=True)
    _check_supported(cfg)
    assert not use_fused(cfg) and use_fused(cfg.replace(profile_dir=None))


# ---------------------------------------------------------------- card only

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the scan kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
def test_train_step_on_card_matches_cpu(cuda):
    """One Mamba train step on the card (fused forward kernel keeping h,
    the fused backward kernel, no linear scan) against the same step
    on the CPU: loss and every gradient, and every encoder parameter gets
    a nonzero gradient."""
    cfg = _tiny_config()
    b = _batches(1, seed=6)[0]
    grads, loss = [], []
    for dev in ("cpu", cuda):
        model = build_model(cfg)
        state = create_train_state(cfg, model, dev, steps_per_epoch=3)
        step = make_train_step(model, cfg, t0=1.0, steps_per_epoch=3)
        metrics = init_epoch_metrics((3, T_LINE, 16, 16), dev)
        before = dict(ss.launches)
        state, metrics = step(state, metrics, {
            k: torch.from_numpy(v).to(dev) for k, v in b.items()})
        loss.append(metrics["loss_sums"]["loss"].item())
        grads.append({k: p.grad.cpu() for k, p in model.named_parameters()})
    assert ss.launches[ss.FUSED_FWD] == before[ss.FUSED_FWD] + 3
    assert ss.launches[ss.FUSED_BWD] == before[ss.FUSED_BWD] + 3
    assert ss.launches[ss.LINEAR_SCAN] == before[ss.LINEAR_SCAN]
    np.testing.assert_allclose(loss[1], loss[0], rtol=1e-4)
    for k, want in grads[0].items():
        got = grads[1][k]
        tol = 1e-4 * want.abs().max().item() + 1e-7
        assert (got - want).abs().max().item() <= tol, k
        if k.startswith("encoder."):
            assert got.abs().max().item() > 0, k
