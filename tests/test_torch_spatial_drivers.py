# ------------------------------------------------------------------
"""The ``space`` mesh axis through the steps' options and the drivers on
the CPU: two gloo ranks at mesh_shape [1, 2] (each a process of
tests/torch_parallel_worker.py), against the port's world-1 runs.

Checked, at atol 2e-5 on the parameters and rtol 2e-4 on the losses as
in tests/test_torch_parallel.py:
  * one train_real step whose two halves of H hold unequal valid pixels
    (90 % in the top half, 30 % in the bottom one): the masked BCE's and
    the anomaly L1's denominators are the global batch's;
  * 2 train steps with dropout, drop-path and (Swin_3D) attention
    dropout above 0: the two ranks of a data index draw the single-device
    masks (each draws at the global shape and keeps its rows), so Mamba,
    Swin_3D and CNN_3D equal world 1;
  * VQ-EMA (k-means init, dead-code expiry, lambda_anomaly 0 as
    test_torch_parallel.py explains): rows sampled from the global batch
    found on the rank that holds them; codebook buffers rtol 1e-5;
  * train_synthetic and train_real under mesh_shape [1, 2] (Mamba, the
    config's encoder; Swin_3D's attention key bias has a gradient that is
    0 up to rounding, which Adam turns into steps of +-lr over a driver's
    epoch, so its parameters are held over 2 steps above): rank 0 alone
    writes, the run resumes, the history equals the world-1 driver's;
  * the device-resident loaders refuse a space axis without the spatial
    context of their H (under one they gather the rank's rows:
    tests/test_torch_spatial_device.py).
"""
# ------------------------------------------------------------------

import os

import numpy as np
import pytest
import torch

from idee_tpu_torch.data.device import DeviceLoader
from idee_tpu_torch.data.fake import (make_fake_cube, write_cube_npz,
                                      write_fake_reanalysis)
from idee_tpu_torch.models.vq_model import build_model
from idee_tpu_torch.parallel import spatial
from idee_tpu_torch.parallel.mesh import Mesh
from idee_tpu_torch.train.driver import train_synthetic
from idee_tpu_torch.train.driver_real import train_real
from test_torch_parallel import (LOSS_RTOL, VQ_EMA, _close, _codebook_buffers,
                                 _hold_vq, _initted, _world1_steps, run_ranks)
from test_torch_train import _batches, _tiny_config

torch.set_num_threads(1)

SPACE = dict(mesh_shape=[1, 2], mesh_axes=["data", "space"])
DROPS = dict(en_drop_rate=0.1, en_drop_path_rate=0.2, cls_drop_rate=0.1,
             en_attn_drop_rate=0.1)
REAL_VARS = ["al", "t2m", "tp"]


def _real_batch(seed=5):
    """A real-world global batch of 2 rows whose valid pixels (1 - cold
    surface) differ between the halves of H: 90 % above, 30 % below."""
    rng = np.random.default_rng(seed)
    p = np.where(np.arange(16)[:, None] < 8, 0.1, 0.7)
    return {
        "x": rng.normal(size=(2, 3, 2, 8, 16, 16)).astype(np.float32),
        "mask_extreme": (rng.random((2, 16, 16)) < 0.2).astype(np.float32),
        "mask_extreme_loss": (rng.random((2, 16, 16)) < 0.3).astype(
            np.float32),
        "mask_cold_surface": (rng.random((2, 16, 16)) < p).astype(
            np.float32),
        "mask_cold_surface_loss": (rng.random((2, 16, 16)) < 0.2).astype(
            np.float32),
    }


def _synthetic(root, log, **kw):
    return _tiny_config(root_synthetic=str(root / "cube"),
                        times_train=(1, 18), times_val=(19, 30),
                        dir_log=str(log), n_epochs=1, is_aug=True,
                        fused_epoch=False, **kw)


def _real(root, log, **kw):
    return _tiny_config(in_channels=2, variables=REAL_VARS,
                        variables_static=[], root_CERRA=str(root / "CERRA"),
                        root_NOAA_CERRA=str(root / "NOAA_CERRA"),
                        years_train=["1984"], years_val=["1984"],
                        grid_override=(16, 16), dir_log=str(log),
                        name="real", n_epochs=1, is_aug=True, **kw)


def _finished(hist):
    state = hist.pop("state")
    return dict(history=hist, step=state.step,
                state_dict=state.model.state_dict())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The jobs on two ranks at [1, 2] (one launch of the workers), and
    the world-1 run of each."""
    tmp = tmp_path_factory.mktemp("space_drivers")
    write_cube_npz(str(tmp / "cube"), make_fake_cube(
        n_vars=3, n_time=30, height=16, width=16, seed=3))
    write_fake_reanalysis(str(tmp / "CERRA"), str(tmp / "NOAA_CERRA"),
                          variables=REAL_VARS, years=("1984",), seed=0)
    jobs, want = [], {}

    def steps(name, cfg, batches, real=False):
        sd = build_model(cfg).state_dict()
        want[name] = _world1_steps(cfg, sd, batches, real=real)
        jobs.append(dict(kind="steps", mesh_shape=[1, 2], cfg=cfg.to_dict(),
                         state_dict=sd, batches=batches, real=real))

    steps("real", _tiny_config(in_channels=2, variables_static=[],
                               name="real"), [_real_batch()], real=True)
    for enc in ("Mamba", "Swin_3D", "CNN_3D"):
        steps(f"drop_{enc}", _tiny_config(encoder=enc, **DROPS),
              _batches(2, seed=4))
    steps("vq", _tiny_config(**VQ_EMA, lambda_anomaly=0.0, name="vq"),
          _batches(2, seed=4))
    syn = _synthetic(tmp, tmp / "syn2", **SPACE)
    real = _real(tmp, tmp / "real2", **SPACE)
    jobs += [dict(kind="driver", cfg=syn.to_dict()),
             dict(kind="driver", cfg=syn.replace(n_epochs=2).to_dict()),
             dict(kind="train_real", cfg=real.to_dict())]
    got = run_ranks(tmp / "ranks", jobs, timeout=300)
    names = list(want) + ["driver", "driver_resumed", "train_real"]
    out = {n: [r[i] for r in got] for i, n in enumerate(names)}
    # the world-1 drivers, run and resumed as the ranks were
    w1 = _synthetic(tmp, tmp / "syn1")
    train_synthetic(w1, device="cpu")
    want["driver_resumed"] = _finished(train_synthetic(
        w1.replace(n_epochs=2), device="cpu"))
    want["train_real"] = _finished(train_real(_real(tmp, tmp / "real1"),
                                              "CERRA", device="cpu"))
    return out, want, tmp


def test_real_step_with_unequal_valid_halves_matches_world_1(runs):
    got, want, _ = runs
    valid = 1.0 - _real_batch()["mask_cold_surface"]
    assert valid[:, :8].sum() > 2 * valid[:, 8:].sum()
    w1_losses, _, w1_sd = want["real"]
    for r, g in enumerate(got["real"]):
        np.testing.assert_allclose(g["losses"], w1_losses, rtol=LOSS_RTOL)
        _close(g["state_dict"], w1_sd, f"rank {r}")


@pytest.mark.parametrize("encoder", ["Mamba", "Swin_3D", "CNN_3D"])
def test_dropout_and_drop_path_draw_the_world_1_masks(runs, encoder):
    got, want, _ = runs
    w1_losses, _, w1_sd = want[f"drop_{encoder}"]
    for r, g in enumerate(got[f"drop_{encoder}"]):
        np.testing.assert_allclose(g["losses"], w1_losses, rtol=LOSS_RTOL)
        _close(g["state_dict"], w1_sd, f"rank {r}")


def test_vq_ema_samples_rows_of_the_global_batch(runs):
    got, want, _ = runs
    _, _, w1_sd = want["vq"]
    buffers = _codebook_buffers(w1_sd)
    assert _initted(w1_sd, buffers) == 1.0
    _hold_vq(got["vq"], w1_sd, buffers)


def _same_history(got, want, what):
    for k, v in want["history"].items():
        if k != "steps_per_sec":
            np.testing.assert_allclose(got["history"][k], v, rtol=LOSS_RTOL,
                                       err_msg=f"{what}: {k}")
    assert got["step"] == want["step"] > 0
    _close(got["state_dict"], want["state_dict"], what)


def test_train_synthetic_writes_once_and_resumes(runs):
    got, want, tmp = runs
    first, resumed = got["driver"], got["driver_resumed"]
    assert first[1]["calls"] == resumed[1]["calls"] == {
        "save": 0, "flush_history": 0, "save_options": 0}
    assert first[0]["calls"]["save_options"] == 1
    assert resumed[0]["calls"]["flush_history"] == 1  # epoch 2 only
    assert "latest.pt" in os.listdir(tmp / "syn2" / "train" /
                                     "model_checkpoints")
    for r, g in enumerate(resumed):
        _same_history(g, want["driver_resumed"], f"rank {r}")


def test_train_real_matches_world_1(runs):
    got, want, _ = runs
    for r, g in enumerate(got["train_real"]):
        _same_history(g, want["train_real"], f"rank {r}")


def test_device_loaders_refuse_the_space_axis():
    """A device loader under a space axis needs the spatial context of
    its data's H when it is made (the rows it gathers); it refuses a mesh
    with a space axis and no context, or a context of another H."""
    cube = make_fake_cube(n_vars=3, n_time=20, height=16, width=16, seed=1)
    from idee_tpu_torch.data.synthetic import SyntheticDataset

    ds = SyntheticDataset(cube=cube, variables=["var_01", "var_02",
                                                "var_03"],
                          x_max=16, y_max=16)
    mesh = Mesh(1, 2, torch.device("cpu"), space=2)
    with pytest.raises(ValueError, match="space axis of 2 ranks"):
        DeviceLoader(ds, 2, device="cpu", mesh=mesh)
    with spatial.activate(mesh, 32), pytest.raises(ValueError,
                                                   match="splits 32 rows"):
        DeviceLoader(ds, 2, device="cpu", mesh=mesh)
    with spatial.activate(mesh, 16, 4):
        batch = next(iter(DeviceLoader(ds, 2, device="cpu", mesh=mesh)))
    assert batch["x"].shape[-2:] == (8, 16)
