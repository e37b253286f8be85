# ------------------------------------------------------------------
"""The device-resident data (data/device.py) and the fused epochs
(train/steps.py::FusedEpoch) under the ``space`` mesh axis on the CPU:
two gloo ranks at mesh_shape [1, 2] (each a process of
tests/torch_parallel_worker.py, one launch of the workers), against the
port's world-1 runs. On the CPU the fused step runs eagerly, so these
tests hold the arithmetic of the fused path under the space axis (each
rank's H rows gathered from the epoch's order and flip buffers, the halo
and shift exchanges in the step, the epoch metrics reduced after the
epoch), not its capture.

Checked:
  * each rank's device batches of one epoch of the training (augmented,
    so that samples flip H) and validation loaders bit-equal to
    ``spatial.shard_rows`` of the world-1 device batches: the synthetic
    cube (with the anomaly bits), the tiny CERRA tree (with the sea and
    no-vegetation masks), and an uneven split (H of 3 window rows over 2
    ranks: 8 and 4 rows);
  * train_synthetic and train_real with ``device_data``, per-step and
    fused, against the world-1 fused run: losses rtol 2e-4, parameters
    atol 2e-5 (tests/test_torch_parallel.py's rule, dropout 0), the step
    count equal; the uneven split's fused train_synthetic too;
  * the fused and per-step runs under the space axis equal each other;
  * a gloo mesh with a space axis on a card refuses the fused epochs
    (parallel/mesh.py::check_fused_epochs), checked without a card.
"""
# ------------------------------------------------------------------

import numpy as np
import pytest
import torch

from idee_tpu_torch.data.device import DeviceLoader, RealDeviceLoader
from idee_tpu_torch.data.fake import (make_fake_cube, write_cube_npz,
                                      write_fake_reanalysis)
from idee_tpu_torch.parallel import spatial
from idee_tpu_torch.parallel.mesh import Mesh, check_fused_epochs
from idee_tpu_torch.train.driver import (_make_datasets, data_parallel,
                                         train_synthetic)
from idee_tpu_torch.train.driver_real import (make_reanalysis_dataset,
                                              train_real)
from test_torch_parallel import LOSS_RTOL, PARAM_ATOL, run_ranks
from test_torch_train import _tiny_config

torch.set_num_threads(1)

SPACE = dict(mesh_shape=[1, 2], mesh_axes=["data", "space"])
REAL_VARS = ["al", "t2m", "tp"]


def _synthetic(root, log, cube="cube", **kw):
    kw = dict(dict(device_data=True, fused_epoch=True), **kw)
    return _tiny_config(root_synthetic=str(root / cube),
                        times_train=(1, 18), times_val=(19, 30),
                        dir_log=str(log), n_epochs=1, is_aug=True, **kw)


def _uneven(root, log, **kw):
    """The synthetic path on a cube of H 12: Mamba's window rows of 4
    split 8 / 4 over two ranks."""
    return _synthetic(root, log, cube="cube12", y_max=12, **kw)


def _real(root, log, **kw):
    kw = dict(dict(device_data=True, fused_epoch=True), **kw)
    return _tiny_config(in_channels=2, variables=REAL_VARS,
                        variables_static=[], root_CERRA=str(root / "CERRA"),
                        root_NOAA_CERRA=str(root / "NOAA_CERRA"),
                        years_train=["1984"], years_val=["1984"],
                        grid_override=(16, 16), dir_log=str(log),
                        name="real", n_epochs=1, is_aug=True, **kw)


PATHS = {"synthetic": (_synthetic, "driver"), "real": (_real, "train_real"),
         "uneven": (_uneven, "driver")}


def _world1_batches(cfg, real: bool):
    """One epoch of the world-1 training and validation device loaders, as
    the worker's ``device_batches`` job makes them."""
    if real:
        sets = (make_reanalysis_dataset(cfg, "CERRA", cfg.years_train,
                                        cfg.is_aug),
                make_reanalysis_dataset(cfg, "CERRA", cfg.years_val, False))
        make, extra = RealDeviceLoader, {"with_eval_masks": True}
    else:
        sets = _make_datasets(cfg)
        make, extra = DeviceLoader, {"with_anomaly": True}
    loaders = (make(sets[0], cfg.batch_size, seed=cfg.seed, device="cpu"),
               make(sets[1], cfg.batch_size, seed=cfg.seed, device="cpu",
                    **extra))
    flips = loaders[0].epoch_flips(1)
    return [list(loader) for loader in loaders], flips, \
        sets[0].input_size[1]


def _finished(hist):
    state = hist.pop("state")
    return dict(history=hist, step=state.step,
                state_dict=state.model.state_dict())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every job on two ranks at [1, 2] (one launch of the workers), and
    the world-1 fused run of each driver path."""
    tmp = tmp_path_factory.mktemp("space_device")
    write_cube_npz(str(tmp / "cube"), make_fake_cube(
        n_vars=3, n_time=30, height=16, width=16, seed=3))
    write_cube_npz(str(tmp / "cube12"), make_fake_cube(
        n_vars=3, n_time=30, height=12, width=16, seed=5))
    write_fake_reanalysis(str(tmp / "CERRA"), str(tmp / "NOAA_CERRA"),
                          variables=REAL_VARS, years=("1984",), seed=0)
    jobs, names = [], []
    for path, (make, _) in PATHS.items():
        jobs.append(dict(kind="device_batches", mesh_shape=[1, 2],
                         cfg=make(tmp, tmp / "batches").to_dict(),
                         family="CERRA" if path == "real" else None))
        names.append(("batches", path))
    for path, (make, kind) in PATHS.items():
        for fused in (True, False) if path != "uneven" else (True,):
            cfg = make(tmp, tmp / f"{path}_space_{fused}", fused_epoch=fused,
                       **SPACE)
            jobs.append(dict(kind=kind, cfg=cfg.to_dict()))
            names.append((path, "fused" if fused else "per_step"))
    got = run_ranks(tmp / "ranks", jobs, timeout=300)
    out = {name: [r[i] for r in got] for i, name in enumerate(names)}
    world1 = {}
    for path, (make, _) in PATHS.items():
        cfg = make(tmp, tmp / f"{path}_w1")
        hist = (train_real(cfg, "CERRA", device="cpu") if path == "real"
                else train_synthetic(cfg, device="cpu"))
        world1[path] = _finished(hist)
    return out, world1, tmp


@pytest.mark.parametrize("path", sorted(PATHS))
def test_device_batches_are_shard_rows_of_the_world_1_batches(runs, path):
    got, _, tmp = runs
    cfg = PATHS[path][0](tmp, tmp / "batches")
    (train, val), flips, H = _world1_batches(cfg, real=path == "real")
    fh = flips[..., 0] ^ (flips[..., 1] & ~flips[..., 2])
    assert fh.any() and not fh.all(), "no sample flips H, or every one"
    align = spatial.model_row_align(cfg)
    for r, g in enumerate(got[("batches", path)]):
        ctx = spatial.make_context(Mesh(r, 2, torch.device("cpu"), space=2),
                                   H, align)
        assert g["rows"] == (ctx.lo, ctx.hi)
        if path == "uneven":
            assert g["rows"] == [(0, 8), (8, 12)][r]
        for what, epoch, want in (("train", g["train"], train),
                                  ("val", g["val"], val)):
            assert len(epoch) == len(want) > 0
            for b, (a, w) in enumerate(zip(epoch, want)):
                w = spatial.shard_rows(w, ctx)
                assert sorted(a) == sorted(w)
                for k, v in w.items():
                    assert a[k].dtype == v.dtype and torch.equal(a[k], v), (
                        f"rank {r} {what} batch {b}: {k}")


def _curves(hist):
    return {k: v for k, v in hist.items() if k != "steps_per_sec"}


CASES = [("synthetic", "fused"), ("synthetic", "per_step"),
         ("real", "fused"), ("real", "per_step"), ("uneven", "fused")]


@pytest.mark.parametrize("path,loop", CASES)
def test_space_device_data_matches_world_1(runs, path, loop):
    got, world1, _ = runs
    want = world1[path]
    for r, g in enumerate(got[(path, loop)]):
        for k in ("train_loss", "val_loss", "train_f1", "val_f1"):
            np.testing.assert_allclose(g["history"][k], want["history"][k],
                                       rtol=LOSS_RTOL,
                                       err_msg=f"rank {r}: {k}")
        assert g["step"] == want["step"] > 0
        for k, w in want["state_dict"].items():
            np.testing.assert_allclose(g["state_dict"][k].float().numpy(),
                                       w.float().numpy(), rtol=0.0,
                                       atol=PARAM_ATOL,
                                       err_msg=f"rank {r}: {k}")
    # the ranks hold one model
    ranks = got[(path, loop)]
    for k, v in ranks[0]["state_dict"].items():
        assert torch.equal(v, ranks[1]["state_dict"][k]), k


@pytest.mark.parametrize("path", ["synthetic", "real"])
def test_space_fused_epochs_equal_the_per_step_loop(runs, path):
    got, _, _ = runs
    for r, (fused, step) in enumerate(zip(got[(path, "fused")],
                                          got[(path, "per_step")])):
        a, b = _curves(fused["history"]), _curves(step["history"])
        assert sorted(a) == sorted(b)
        for k, v in b.items():  # NaN F1s compare equal
            np.testing.assert_array_equal(a[k], v, err_msg=f"rank {r}: {k}")
        assert fused["step"] == step["step"]
        for k, v in step["state_dict"].items():
            assert torch.equal(fused["state_dict"][k], v), (r, k)


def test_gloo_space_mesh_on_a_card_refuses_the_fused_epochs(tmp_path):
    """Checked without a card: the refusal reads the mesh only."""
    card = torch.device("cuda", 0)
    gloo = Mesh(0, 2, card, backend="gloo", space=2)
    with pytest.raises(ValueError, match="fused_epoch=False"):
        check_fused_epochs(gloo)
    cfg = _synthetic(tmp_path, tmp_path, **SPACE)
    with pytest.raises(ValueError, match="gloo"):
        data_parallel(cfg, None, gloo)
    # the per-step device loop under gloo on a card, and the fused epochs
    # under NCCL or on the CPU, pass the check
    assert data_parallel(cfg.replace(fused_epoch=False), None, gloo) == (
        gloo, card)
    check_fused_epochs(Mesh(0, 2, card, backend="nccl", space=2))
    check_fused_epochs(Mesh(0, 2, torch.device("cpu"), backend="gloo",
                            space=2))
