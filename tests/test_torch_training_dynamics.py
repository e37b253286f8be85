# ------------------------------------------------------------------
"""Training dynamics of the port beside the JAX package's over many steps,
where one step's agreement (tests/test_torch_train.py,
tests/test_torch_baselines_mil.py) cannot show a drift: the two fault
candidates that the 48x48 accuracy runs raised (ROADMAP.md section 3,
items 11 and 12).

* Mamba under the stable recipe (1-bit LFQ, init_scheme "lecun",
  codebook_freeze_out, lambda_commitment 0, lambda_anomaly 0): the max
  |encoder output| grows step after step. Both frameworks train the same
  weights on the same batches of a 24x24 make_benchmark_cube (3
  variables, widths 8, batch 2, aug off) at lr 1e-2, ten times the
  config's, so that the growth shows within 10 steps. After each step the
  encoder's eval output on one fixed batch is read: the two agree within
  GROWTH_RTOL at every step (float32 last bits, which Adam's per-entry
  normalisation amplifies), and both grow to at least GROWTH_FACTOR times
  the first step's value.
* DeepMIL over CNN_3D: val_pred_rate. The drivers of both frameworks
  train the tiny MIL config of tests/test_torch_baselines_mil.py (16x16,
  no dropout) for 4 epochs from the same weights; losses within rtol
  1e-4 and every epoch's val_pred_rate equal. Both stop predicting: the
  rate is 0 in every epoch of both.
"""
# ------------------------------------------------------------------

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from idee_tpu_torch.config import synthetic_config
from idee_tpu_torch.data.fake import make_benchmark_cube
from idee_tpu_torch.models.interop import load_flax_params, save_flax_npz
from idee_tpu_torch.models.vq_model import build_model
from idee_tpu_torch.train.driver import _make_datasets
from idee_tpu_torch.train.state import create_train_state
from idee_tpu_torch.train.steps import init_epoch_metrics, make_train_step

torch.set_num_threads(1)

VARS = ["var_01", "var_02", "var_03"]
HW, STEPS, BATCH = 24, 10, 2
GROWTH_RTOL = 1e-3
GROWTH_FACTOR = 10.0


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp

    from idee_tpu.config import Config as JConfig
    from idee_tpu.models.vq_model import build_model as jax_build_model
    from idee_tpu.train import state as jstate
    from idee_tpu.train import steps as jsteps

    return SimpleNamespace(jax=jax, jnp=jnp, state=jstate, steps=jsteps,
                           build_model=jax_build_model,
                           cfg=lambda c: JConfig.from_dict(c.to_dict()))


def _stable_mamba_config():
    return synthetic_config(
        encoder="Mamba", in_channels_dynamic=3, variables=VARS, x_max=HW,
        y_max=HW, en_embed_dim=[8, 8], en_depths=[2, 1], codebook_dim=8,
        cls_dim=8, batch_size=BATCH, n_epochs=100, lr=1e-2,
        lr_warmup_epochs=0, is_clima_scale=False, is_aug=False,
        times_train=(1, 104), times_val=(105, 130),
        # the stable recipe of cli/train_benchmark_accuracy.py
        init_scheme="lecun", codebook_freeze_out=True,
        lambda_commitment=0.0, lambda_anomaly=0.0)


def test_mamba_encoder_growth_under_the_stable_recipe_is_jax_s(jx):
    cfg = _stable_mamba_config()
    cube = make_benchmark_cube(n_vars=3, n_time=130, height=HW, width=HW,
                               seed=0, variables=VARS)
    train_ds, _ = _make_datasets(cfg, cube.time_slice(1, 104),
                                 cube.time_slice(105, 130))
    rng = np.random.default_rng(0)
    keys = ("x", "mask_extreme", "mask_extreme_loss", "timestep")
    batches = []
    for _ in range(STEPS):
        items = [train_ds[int(i)]
                 for i in rng.permutation(len(train_ds))[:BATCH]]
        batches.append({k: np.stack([it[k] for it in items]) for k in keys})
    probe = batches[0]["x"]
    shape = (3, len(train_ds.timestep), HW, HW)
    t0 = float(train_ds.timestep[0])

    jcfg = jx.cfg(cfg)
    jmodel = jx.build_model(jcfg)
    params = jx.jax.jit(lambda a: jmodel.init(
        {"params": jx.jax.random.PRNGKey(0)}, a, train=False))(
            jx.jnp.asarray(probe))["params"]
    params = jx.jax.tree_util.tree_map(np.asarray, params)
    jstate = jx.state.TrainState.create(
        apply_fn=jmodel.apply, params=params,
        tx=jx.state.make_optimizer(jcfg, STEPS, params=params),
        rng=jx.jax.random.PRNGKey(0), extra_vars={})
    jstep = jx.steps.make_train_step(jmodel, jcfg, t0=t0, donate=False,
                                     steps_per_epoch=STEPS)
    jenc = jx.jax.jit(lambda p, x: jx.jnp.abs(jmodel.apply(
        {"params": p}, x,
        method=lambda m, a: m.encoder(a, train=False))).max())

    model = build_model(cfg)
    model.load_state_dict(load_flax_params(cfg, params))
    state = create_train_state(cfg, model, "cpu", steps_per_epoch=STEPS)
    step = make_train_step(model, cfg, t0=t0, steps_per_epoch=STEPS)

    want, got = [], []
    for b in batches:
        jstate, _ = jstep(jstate, jx.steps.init_epoch_metrics(shape),
                          {k: jx.jnp.asarray(v) for k, v in b.items()})
        want.append(float(jenc(jstate.params, jx.jnp.asarray(probe))))
        state, _ = step(state, init_epoch_metrics(shape, "cpu"),
                        {k: torch.from_numpy(v) for k, v in b.items()})
        model.eval()
        with torch.inference_mode():
            got.append(model.encoder(torch.from_numpy(probe),
                                     train=False).abs().max().item())
    print("max |encoder output| per step, JAX:", want, "port:", got)
    np.testing.assert_allclose(got, want, rtol=GROWTH_RTOL)
    for name, seq in (("jax", want), ("port", got)):
        assert max(seq) >= GROWTH_FACTOR * seq[0], (name, seq)


def test_deepmil_stops_predicting_in_jax_as_in_the_port(jx, tmp_path):
    import orbax.checkpoint as ocp

    from idee_tpu.data.fake import make_fake_cube as jax_fake_cube
    from idee_tpu_torch.baselines.config import mil_config
    from idee_tpu_torch.baselines.mil.driver import train_mil_synthetic
    from idee_tpu_torch.data.fake import make_fake_cube
    from idee_tpu.baselines.config import mil_config as jax_mil_config
    from idee_tpu.baselines.mil import driver as jax_mil_driver
    from idee_tpu.baselines.mil.models import build_mil_model as jbuild
    from test_torch_baselines_mil import N_TIME, _jax_variables, _tiny

    jxm = SimpleNamespace(jax=jx.jax, jnp=jx.jnp, cfg=jax_mil_config,
                          driver=jax_mil_driver, build=jbuild)
    kw = _tiny(dir_log=str(tmp_path), name="deepmil", n_epochs=4)
    _, variables = _jax_variables(jxm, kw, "deepmil", seed=3)
    ocp.StandardCheckpointer().save(str(tmp_path / "orbax"),
                                    variables["params"])
    save_flax_npz(str(tmp_path / "init.npz"), variables["params"])
    jcube = jax_fake_cube(n_vars=3, n_time=N_TIME, height=16, width=16,
                          seed=4)
    want = jxm.driver.train_mil_synthetic(
        jxm.cfg(**dict(kw, en_de_pretrained=str(tmp_path / "orbax"),
                       name="jax")), "deepmil",
        jcube.time_slice(1, 18), jcube.time_slice(19, N_TIME))
    cube = make_fake_cube(n_vars=3, n_time=N_TIME, height=16, width=16,
                          seed=4)
    got = train_mil_synthetic(
        mil_config(**dict(kw, en_de_pretrained=str(tmp_path / "init.npz"))),
        "deepmil", cube.time_slice(1, 18), cube.time_slice(19, N_TIME),
        device="cpu")
    print("val_pred_rate per epoch, JAX:", want["val_pred_rate"], "port:",
          got["val_pred_rate"], "train loss, JAX:", want["train_loss"],
          "port:", got["train_loss"])
    np.testing.assert_allclose(got["train_loss"], want["train_loss"],
                               rtol=1e-4)
    np.testing.assert_allclose(got["val_loss"], want["val_loss"], rtol=1e-4)
    assert list(got["val_pred_rate"]) == list(want["val_pred_rate"])
    assert len(want["val_pred_rate"]) == 4
    assert not any(want["val_pred_rate"])
