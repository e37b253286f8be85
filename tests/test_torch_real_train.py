# ------------------------------------------------------------------
"""The port's real-world (CERRA / ERA5-Land) training and test path
against the JAX package: the masked losses, VQModel.forward with
mask_exclude at in_channels=2, the real-world train and eval steps, the
drivers train_real and test_real, predict_real, and the four CLIs.

Tiny config: 3 variables x 2 channels, a 16x16 grid (grid_override),
delta_t=8, en_embed_dim=[8, 8], en_depths=[2, 1], batch 2, weights
N(0, 0.1) from a numpy seed carried across by ``load_flax_params``. The
CERRA tree is the port's NetCDF3 writer's, year 1984: the skip rule
leaves target weeks 44-52, 9 samples. Tolerances, all float32:
  * bce_loss and anomaly_l1_loss, value and gradient: rtol 1e-6;
  * the forward: logits and loss_anomaly within 1e-4, anomaly bits equal
    where the LFQ latent |s| > 1e-4 (flips near 0 counted and bounded);
  * one train step: loss components rtol 1e-4, counters equal, parameters
    after the Adam step atol 1e-5 (test_torch_train.py's tolerances);
  * the drivers' tolerances are in test_torch_real_drivers.py, which
    holds train_real, test_real and predict_real against the JAX drivers
    with this file's tree, config and weights.

The JAX side is imported inside fixtures, so the card-only tests also
collect where JAX is not installed (``python -m pytest --noconftest
tests/test_torch_real_train.py -m gpu``).
"""
# ------------------------------------------------------------------

import math
import os
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from idee_tpu_torch import losses
from idee_tpu_torch.config import Config
from idee_tpu_torch.data.fake import write_fake_reanalysis
from idee_tpu_torch.data.loader import collate
from idee_tpu_torch.kernels import selective_scan as ss
from idee_tpu_torch.models.interop import flax_to_state_dict, load_flax_params
from idee_tpu_torch.models.vq_model import build_model
from idee_tpu_torch.train.driver_real import make_reanalysis_dataset
from idee_tpu_torch.train.driver_real import test_real as port_test_real
from idee_tpu_torch.train.driver_real import train_real
from idee_tpu_torch.train.state import create_train_state
from idee_tpu_torch.train.steps_real import (init_epoch_metrics_real,
                                             make_eval_step_real,
                                             make_train_step_real)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
VARS = ["al", "t2m", "tp"]
ENCODERS = ["Mamba", "Swin_3D", "CNN_3D"]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """CERRA (year 1984) and ERA5-Land EUR-11 (year 1981) trees, 16x16."""
    root = tmp_path_factory.mktemp("real")
    write_fake_reanalysis(str(root / "CERRA"), str(root / "NOAA_CERRA"),
                          variables=VARS, years=("1984",), seed=0)
    write_fake_reanalysis(str(root / "ERA5"), str(root / "NOAA"),
                          variables=VARS, years=("1981",), seed=1,
                          era5_region="EUR-11")
    return root


def _cfg(tree, tmp, **kw) -> Config:
    base = dict(encoder="Mamba", in_channels=2, in_channels_dynamic=3,
                variables=VARS, variables_static=[], delta_t=8,
                root_CERRA=str(tree / "CERRA"),
                root_NOAA_CERRA=str(tree / "NOAA_CERRA"),
                root_ERA5_Land=str(tree / "ERA5"),
                root_NOAA=str(tree / "NOAA"),
                years_train=["1984"], years_val=["1984"],
                years_test=["1984"], grid_override=(16, 16), x_max=16,
                y_max=16, en_embed_dim=[8, 8], en_depths=[2, 1],
                codebook_dim=8, cls_dim=8, batch_size=2, n_epochs=2,
                lr_warmup_epochs=1, is_clima_scale=False, is_aug=True,
                dir_log=str(tmp), name="real")
    base.update(kw)
    return Config(**base)


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp

    from idee_tpu import losses as jlosses
    from idee_tpu.config import Config as JConfig
    from idee_tpu.models.vq_model import build_model as jax_build_model
    from idee_tpu.train import state as jstate
    from idee_tpu.train import steps_real as jsteps
    from idee_tpu.train import driver_real as jdriver

    return SimpleNamespace(
        jax=jax, jnp=jnp, losses=jlosses, state=jstate, steps=jsteps,
        driver=jdriver, build_model=jax_build_model,
        cfg=lambda c: JConfig.from_dict(c.to_dict()))


def _random_params(jx, cfg, seed=11):
    """The JAX model of ``cfg`` and its params tree filled with N(0, 0.1)
    from a numpy seed (both anomaly codes occur)."""
    model = jx.build_model(jx.cfg(cfg))
    x = jx.jnp.zeros((1, 3, 2, 8, 16, 16), jx.jnp.float32)
    shapes = jx.jax.eval_shape(
        lambda a: model.init(jx.jax.random.PRNGKey(0), a, train=False), x)
    rng = np.random.default_rng(seed)
    return model, jx.jax.tree_util.tree_map(
        lambda s: (0.1 * rng.normal(size=s.shape)).astype(np.float32),
        shapes["params"])


def _batch(tree, tmp, n=2, **kw):
    ds = make_reanalysis_dataset(_cfg(tree, tmp, **kw), "CERRA", ["1984"],
                                 is_aug=False)
    return collate([ds[i] for i in range(n)])


# ---------------------------------------------------------------- losses

def test_masked_losses_match_jax(jx):
    rng = np.random.default_rng(0)
    pred = rng.normal(size=(2, 6, 7)).astype(np.float32)
    target = (rng.random((2, 6, 7)) < 0.3).astype(np.float32)
    mask = np.clip(rng.random((2, 6, 7)) * 1.5, 0, 1).astype(np.float32)
    want, want_g = jx.jax.value_and_grad(jx.losses.bce_loss)(
        *map(jx.jnp.asarray, (pred, target, mask)))
    p = torch.from_numpy(pred).requires_grad_()
    got = losses.bce_loss(p, torch.from_numpy(target), torch.from_numpy(mask))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_g), rtol=1e-6,
                               atol=1e-9)

    z_q = rng.normal(size=(2, 3, 4, 5, 6, 7)).astype(np.float32)
    mel, mex = ((rng.random((2, 6, 7)) < f).astype(np.float32)
                for f in (0.2, 0.3))
    vq0 = rng.normal(size=(4,)).astype(np.float32)
    want, want_g = jx.jax.value_and_grad(jx.losses.anomaly_l1_loss)(
        *map(jx.jnp.asarray, (z_q, mel, mex, vq0)))
    z = torch.from_numpy(z_q).requires_grad_()
    got = losses.anomaly_l1_loss(z, torch.from_numpy(mel),
                                 torch.from_numpy(mex), torch.from_numpy(vq0))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(z.grad.numpy(), np.asarray(want_g), rtol=1e-6,
                               atol=1e-12)


# ---------------------------------------------------------------- model

@pytest.mark.parametrize("encoder", ENCODERS)
def test_forward_with_mask_exclude_matches_jax(jx, tree, tmp_path, encoder):
    cfg = _cfg(tree, tmp_path, encoder=encoder)
    model_j, params = _random_params(jx, cfg)
    b = _batch(tree, tmp_path)
    args = [b[k] for k in ("x", "mask_extreme_loss",
                           "mask_cold_surface_loss")]
    assert b["mask_cold_surface_loss"].any()
    want = jx.jax.jit(lambda p, x, m, e: model_j.apply(
        {"params": p}, x, train=False, mask_extreme_loss=m,
        mask_exclude=e))(params, *map(jx.jnp.asarray, args))

    model = build_model(cfg)
    model.load_state_dict(load_flax_params(cfg, params))
    model.eval()
    x, mel, mex = map(torch.from_numpy, args)
    with torch.inference_mode():
        got = model(x, mask_extreme_loss=mel, mask_exclude=mex)
        without = model(x, mask_extreme_loss=mel)
        zp = model.encoder(x, packed_out=True)
        k_in, b_in = model.vq.in_proj_params()
        s = (zp.reshape(*zp.shape[:-1], 3, 8) @ k_in + b_in).numpy()
    for name in ("z", "y", "loss_anomaly", "loss_z_q"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    assert got.loss_anomaly != without.loss_anomaly  # the mask is used
    bits, wbits = got.anomaly.numpy(), np.asarray(want.anomaly)
    clear = np.abs(s).transpose(0, 4, 1, 2, 3) > 1e-4
    np.testing.assert_array_equal(bits[clear], wbits[clear])
    assert int((bits[~clear] != wbits[~clear]).sum()) <= max(
        1, bits.size // 1000)
    assert 0 < bits.mean() < 1


def test_anomaly_l1_gradients_with_exclusion_match_jax(jx, tree, tmp_path):
    """Every parameter's gradient of the model's loss_anomaly with the
    cold-surface exclusion (anomaly_l1_lfq's custom backward on
    w_pix = 1 - clip(extreme + exclude))."""
    cfg = _cfg(tree, tmp_path)
    model_j, params = _random_params(jx, cfg)
    b = _batch(tree, tmp_path)
    args = [b[k] for k in ("x", "mask_extreme_loss",
                           "mask_cold_surface_loss")]
    want = jx.jax.jit(jx.jax.grad(lambda p, x, m, e: model_j.apply(
        {"params": p}, x, train=True, mask_extreme_loss=m,
        mask_exclude=e).loss_anomaly))(params, *map(jx.jnp.asarray, args))
    model = build_model(cfg)
    model.load_state_dict(load_flax_params(cfg, params))
    x, mel, mex = map(torch.from_numpy, args)
    model(x, train=True, mask_extreme_loss=mel,
          mask_exclude=mex).loss_anomaly.backward()
    want = flax_to_state_dict(want, model.state_dict())
    for k, p in model.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    assert model.vq.project_out.weight.grad.abs().sum() > 0


# ---------------------------------------------------------------- steps

def _host(metrics):
    from idee_tpu_torch.train.steps import metrics_to_host

    return metrics_to_host(metrics)


def test_train_and_eval_steps_match_jax(jx, tree, tmp_path):
    cfg = _cfg(tree, tmp_path)
    jcfg = jx.cfg(cfg)
    model_j, params = _random_params(jx, cfg)
    b = _batch(tree, tmp_path)
    jb = {k: jx.jnp.asarray(v) for k, v in b.items()}

    state_j = jx.state.TrainState.create(
        apply_fn=model_j.apply, params=params,
        tx=jx.state.make_optimizer(jcfg, 4, params=params),
        rng=jx.jax.random.PRNGKey(0), extra_vars={})
    step_j = jx.steps.make_train_step_real(model_j, jcfg, donate=False)
    state_j, m_j = step_j(state_j, jx.steps.init_epoch_metrics_real(), jb)
    eval_j = jx.steps.make_eval_step_real(model_j, jcfg, test_mode=True)
    e_j = eval_j({"params": params}, jx.steps.init_epoch_metrics_real(), jb)

    model = build_model(cfg)
    model.load_state_dict(load_flax_params(cfg, params))
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    e = make_eval_step_real(model, cfg, test_mode=True)(
        init_epoch_metrics_real("cpu"), tb)
    state = create_train_state(cfg, model, "cpu", steps_per_epoch=4)
    _, m = make_train_step_real(model, cfg)(
        state, init_epoch_metrics_real("cpu"), tb)

    for got, want in ((_host(m), jx.jax.device_get(m_j)),
                      (_host(e), jx.jax.device_get(e_j))):
        for k, v in want["counts"].items():
            np.testing.assert_array_equal(got["counts"][k], v, err_msg=k)
        for k, v in want["loss_sums"].items():
            np.testing.assert_allclose(got["loss_sums"][k], v, rtol=1e-4,
                                       err_msg=k)
        assert int(got["n_steps"]) == int(want["n_steps"]) == 1
    # test-time validity leaves out sea and no-vegetation too
    assert int(e["counts"]["seen_all"]) < int(m["counts"]["seen_all"])
    got_p, want_p = dict(model.named_parameters()), flax_to_state_dict(
        state_j.params, model.state_dict())
    for k, w in want_p.items():
        np.testing.assert_allclose(got_p[k].detach().numpy(), w.numpy(),
                                   rtol=0.0, atol=1e-5, err_msg=k)


def _close(got, want, tol, what):
    assert len(got) == len(want), what
    for a, b in zip(got, want):
        assert (math.isnan(a) and math.isnan(b)) or abs(a - b) <= tol * max(
            1.0, abs(b)), (what, got, want)


# ---------------------------------------------------------------- CLIs

def _flags(cfg, keys):
    return sum(([f"--{k}", str(getattr(cfg, k))] for k in keys), [])


def test_real_clis_run_on_cpu(tree, tmp_path):
    from idee_tpu_torch.cli import (predict_real, test_CERRA, test_ERA5_Land,
                                    train_CERRA, train_ERA5_Land)

    common = ["in_channels_dynamic", "variables", "variables_static",
              "grid_override", "x_max", "y_max", "en_embed_dim",
              "en_depths", "codebook_dim", "cls_dim", "batch_size",
              "is_clima_scale", "dir_log"]
    runs = {"CERRA": (train_CERRA, test_CERRA,
                      ["root_CERRA", "root_NOAA_CERRA"], "1984"),
            "ERA5_Land": (train_ERA5_Land, test_ERA5_Land,
                          ["root_ERA5_Land", "root_NOAA", "region"],
                          "1981")}
    for family, (train_cli, test_cli, roots, year) in runs.items():
        cfg = _cfg(tree, tmp_path, name=f"cli_{family}", n_epochs=1,
                   years_train=[year], years_val=[year], years_test=[year])
        flags = ["--device", "cpu", "--name", cfg.name, "--n_epochs", "1",
                 "--years_train", str([year]), "--years_val", str([year]),
                 "--years_test", str([year])] + _flags(cfg, common + roots)
        hist = train_cli.main(flags)
        assert len(hist["train_loss"]) == 1
        assert all(map(math.isfinite, hist["train_loss"] + hist["val_loss"]))
        latest = os.path.join(cfg.log_dir, "model_checkpoints", "latest.pt")
        got = test_cli.main(flags + ["--en_de_pretrained", latest])
        want = port_test_real(cfg, family,
                              params=hist["state"].model.state_dict(),
                              device="cpu")
        assert got == want
        payload = predict_real.main(["--run_dir", cfg.log_dir, "--family",
                                     family, "--checkpoint", "latest",
                                     "--device", "cpu"])
        assert payload["drought_prob"].shape[1:] == (16, 16)
        assert os.path.exists(os.path.join(cfg.log_dir,
                                           "predictions_real.npz"))


def test_real_entry_points_need_a_card_or_explicit_cpu(monkeypatch, tree,
                                                       tmp_path):
    from idee_tpu_torch.cli import train_CERRA

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _cfg(tree, tmp_path, n_epochs=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_real(cfg, "CERRA")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_test_real(cfg, "CERRA")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_CERRA.main(["--root_CERRA", cfg.root_CERRA, "--dir_log",
                          cfg.dir_log])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_real(cfg.replace(device_data=True), "CERRA")
    # data parallelism and the space axis are ported; a mesh of 2 needs 2
    # processes (torchrun)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="WORLD_SIZE 1"):
        train_real(cfg.replace(mesh_shape=[1, 2],
                               mesh_axes=["data", "space"]), "CERRA",
                   device="cpu")
    with pytest.raises(ValueError, match="WORLD_SIZE 1"):
        train_real(cfg.replace(mesh_shape=[2]), "CERRA", device="cpu")


# ---------------------------------------------------------------- card only

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the scan kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
def test_real_train_step_on_card_matches_cpu(cuda, tree, tmp_path):
    """One Mamba real-world train step on the card (fused scan forward and
    backward kernels) against the same step on the CPU: loss components,
    counters and every gradient."""
    cfg = _cfg(tree, tmp_path)
    b = _batch(tree, tmp_path)
    runs = []
    for dev in ("cpu", cuda):
        model = build_model(cfg)
        state = create_train_state(cfg, model, dev, steps_per_epoch=4)
        before = dict(ss.launches)
        _, m = make_train_step_real(model, cfg)(
            state, init_epoch_metrics_real(dev),
            {k: torch.from_numpy(v).to(dev) for k, v in b.items()})
        runs.append((_host(m), {k: p.grad.cpu()
                                for k, p in model.named_parameters()}))
    assert ss.launches[ss.FUSED_FWD] == before[ss.FUSED_FWD] + 3
    assert ss.launches[ss.FUSED_BWD] == before[ss.FUSED_BWD] + 3
    (m_cpu, g_cpu), (m_gpu, g_gpu) = runs
    for k in m_cpu["counts"]:
        np.testing.assert_array_equal(m_gpu["counts"][k], m_cpu["counts"][k])
    for k in m_cpu["loss_sums"]:
        np.testing.assert_allclose(m_gpu["loss_sums"][k],
                                   m_cpu["loss_sums"][k], rtol=1e-4)
    for k, want in g_cpu.items():
        tol = 1e-4 * want.abs().max().item() + 1e-7
        assert (g_gpu[k] - want).abs().max().item() <= tol, k


@pytest.mark.gpu
def test_test_real_on_card_matches_cpu(cuda, tree, tmp_path):
    cfg = _cfg(tree, tmp_path, name="card_test")
    params = build_model(cfg, torch.Generator().manual_seed(3)).state_dict()
    before = ss.launches[ss.FUSED_FWD]
    got = port_test_real(cfg, "CERRA", params=params, device=cuda)
    assert ss.launches[ss.FUSED_FWD] == before + 3 * 4  # 4 batches of 2
    want = port_test_real(cfg, "CERRA", params=params, device="cpu")
    for k in want:
        _close([got[k]], [want[k]], 1e-6, k)
