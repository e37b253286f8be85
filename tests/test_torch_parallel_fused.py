# ------------------------------------------------------------------
"""The fused epochs (train/steps.py::FusedEpoch) under a data-parallel
mesh (parallel/mesh.py) on the CPU: two gloo ranks, each a process of
tests/torch_parallel_worker.py, as tests/test_torch_parallel.py starts
them. On the CPU the fused step runs eagerly, so these tests hold the
arithmetic of the fused path under a mesh (each rank's rows of the global
batches from the epoch's order and flip buffers, the epoch metrics
reduced after the epoch), not its capture.

The rule is JAX's (tests/test_parallel.py:40-65), dropout at 0: at world
size 2 a fused epoch computes the update of the world-1 fused epoch on
the same global batches. Checked for train_synthetic (device_data,
fused_epoch, augmentation on, 2 epochs) and train_real (the port's tiny
CERRA tree, whose global batches hold rows with unequal valid pixels):
  * against the world-1 fused run: losses rtol 2e-4, parameters atol
    2e-5, the F1 read from the reduced epoch counters within rtol 2e-4,
    the step count equal;
  * against the two-rank per-step run over the same device batches
    (fused_epoch=False): equal, as the fused and per-step loops are
    without a mesh (tests/test_torch_device_data.py).
A gloo mesh on a card refuses the fused epochs (parallel/mesh.py::
check_fused_epochs), which needs no card to test. The card-only test
captures a fused epoch under a one-rank NCCL mesh and finds the NCCL
collectives in a replay's profile.
"""
# ------------------------------------------------------------------

import numpy as np
import pytest
import torch

from idee_tpu_torch.data.fake import (make_fake_cube, write_cube_npz,
                                      write_fake_reanalysis)
from idee_tpu_torch.parallel.mesh import Mesh, check_fused_epochs
from idee_tpu_torch.train.driver import data_parallel, train_synthetic
from idee_tpu_torch.train.driver_real import (make_reanalysis_dataset,
                                              train_real)
from test_torch_parallel import LOSS_RTOL, PARAM_ATOL, run_ranks
from test_torch_train import _tiny_config

torch.set_num_threads(1)

VARS = ["var_01", "var_02", "var_03"]
REAL_VARS = ["al", "t2m", "tp"]


def _synthetic(root, log, **kw):
    kw = dict(dict(device_data=True, fused_epoch=True), **kw)
    return _tiny_config(root_synthetic=str(root / "cube"),
                        times_train=(1, 18), times_val=(19, 30),
                        dir_log=str(log), n_epochs=2, is_aug=True, **kw)


def _real(root, log, **kw):
    kw = dict(dict(device_data=True, fused_epoch=True), **kw)
    return _tiny_config(in_channels=2, variables=REAL_VARS,
                        variables_static=[], root_CERRA=str(root / "CERRA"),
                        root_NOAA_CERRA=str(root / "NOAA_CERRA"),
                        years_train=["1984"], years_val=["1984"],
                        grid_override=(16, 16), dir_log=str(log),
                        name="real", n_epochs=2, is_aug=True, **kw)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The fused and per-step drivers on 2 ranks (one launch of the
    workers), and the world-1 fused run of each path."""
    tmp = tmp_path_factory.mktemp("fused")
    write_cube_npz(str(tmp / "cube"), make_fake_cube(
        n_vars=3, n_time=30, height=16, width=16, seed=3))
    write_fake_reanalysis(str(tmp / "CERRA"), str(tmp / "NOAA_CERRA"),
                          variables=REAL_VARS, years=("1984",), seed=0)
    jobs = []
    for name, kind, make in (("synthetic", "driver", _synthetic),
                             ("real", "train_real", _real)):
        for fused in (True, False):
            cfg = make(tmp, tmp / f"{name}_w2_{fused}", mesh_shape=[2],
                       fused_epoch=fused)
            jobs.append(dict(kind=kind, cfg=cfg.to_dict()))
    got = run_ranks(tmp / "ranks", jobs)
    world1 = {}
    for name, make, train in (
            ("synthetic", _synthetic,
             lambda c: train_synthetic(c, device="cpu")),
            ("real", _real, lambda c: train_real(c, "CERRA", device="cpu"))):
        hist = train(make(tmp, tmp / f"{name}_w1"))
        state = hist.pop("state")
        world1[name] = dict(history=hist, step=state.step,
                            state_dict=state.model.state_dict())
    return {name: dict(fused=[r[2 * i] for r in got],
                       per_step=[r[2 * i + 1] for r in got],
                       world1=world1[name], tmp=tmp)
            for i, name in enumerate(("synthetic", "real"))}


def _curves(hist):
    return {k: v for k, v in hist.items() if k != "steps_per_sec"}


@pytest.mark.parametrize("path", ["synthetic", "real"])
def test_two_rank_fused_epochs_match_world_1(runs, path):
    run = runs[path]
    want = run["world1"]
    for r, got in enumerate(run["fused"]):
        for k in ("train_loss", "val_loss"):
            np.testing.assert_allclose(got["history"][k],
                                       want["history"][k], rtol=LOSS_RTOL,
                                       err_msg=f"rank {r}: {k}")
        for k in ("train_f1", "val_f1"):
            np.testing.assert_allclose(got["history"][k],
                                       want["history"][k], rtol=LOSS_RTOL,
                                       err_msg=f"rank {r}: {k}")
        assert got["step"] == want["step"] > 0
        for k, w in want["state_dict"].items():
            np.testing.assert_allclose(got["state_dict"][k].float().numpy(),
                                       w.float().numpy(), rtol=0.0,
                                       atol=PARAM_ATOL,
                                       err_msg=f"rank {r}: {k}")
    # the ranks hold one model
    for k, v in run["fused"][0]["state_dict"].items():
        assert torch.equal(v, run["fused"][1]["state_dict"][k]), k


@pytest.mark.parametrize("path", ["synthetic", "real"])
def test_two_rank_fused_epochs_equal_the_per_step_loop(runs, path):
    run = runs[path]
    for r, (fused, step) in enumerate(zip(run["fused"], run["per_step"])):
        got, want = _curves(fused["history"]), _curves(step["history"])
        assert sorted(got) == sorted(want)
        for k, v in want.items():  # NaN F1s compare equal
            np.testing.assert_array_equal(got[k], v, err_msg=f"rank {r}")
        assert fused["step"] == step["step"]
        for k, v in step["state_dict"].items():
            assert torch.equal(fused["state_dict"][k], v), (r, k)


def test_real_global_batches_hold_unequal_valid_pixels(runs):
    """The masked BCE's denominator is the global batch's only if the
    ranks' rows differ in valid pixels (1 - cold surface)."""
    tmp = runs["real"]["tmp"]
    cfg = _real(tmp, tmp / "valid")
    ds = make_reanalysis_dataset(cfg, "CERRA", cfg.years_train, False)
    valid = {float((1.0 - ds[i]["mask_cold_surface"]).sum())
             for i in range(len(ds))}
    assert len(valid) > 1, valid


def test_gloo_mesh_on_a_card_refuses_the_fused_epochs(tmp_path):
    """Checked without a card: the refusal reads the mesh only."""
    card = torch.device("cuda", 0)
    gloo = Mesh(0, 2, card, backend="gloo")
    with pytest.raises(ValueError, match="fused_epoch=False"):
        check_fused_epochs(gloo)
    cfg = _synthetic(tmp_path, tmp_path)
    with pytest.raises(ValueError, match="gloo"):
        data_parallel(cfg, None, gloo)
    # per-step loops under gloo on a card, and fused ones under NCCL or on
    # the CPU, pass the check
    assert data_parallel(cfg.replace(fused_epoch=False), None, gloo) == (
        gloo, card)
    check_fused_epochs(Mesh(0, 2, card, backend="nccl"))
    check_fused_epochs(Mesh(0, 2, torch.device("cpu"), backend="gloo"))
    check_fused_epochs(None)


# ---------------------------------------------------------------- card only

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (NCCL and the scan kernels)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_fused_epochs_capture_nccl_collectives_at_one_rank(cuda, tmp_path):
    """A fused train and val epoch of the tiny Mamba config under a mesh
    of one NCCL rank, the second epoch replays only: each graph's replay
    holds NCCL kernels (the AVG all-reduces of the gradients, the losses'
    normalisers and LFQ's entropy; at one rank NCCL launches its
    oneRankReduce kernel for each, and nothing for an in-place SUM), the
    scan kernels are credited per replay, and the losses are finite."""
    import socket

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from idee_tpu_torch.data.device import DeviceLoader
    from idee_tpu_torch.kernels import selective_scan as ss
    from idee_tpu_torch.models.vq_model import build_model
    from idee_tpu_torch.parallel.mesh import make_mesh
    from idee_tpu_torch.train.driver import _make_datasets
    from idee_tpu_torch.train.state import create_train_state
    from idee_tpu_torch.train.steps import (make_eval_epoch,
                                            make_train_epoch,
                                            metrics_to_host)

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    cube = make_fake_cube(n_vars=3, n_time=30, height=16, width=16, seed=3)
    cfg = _synthetic(tmp_path, tmp_path, mesh_shape=[1])
    mesh = make_mesh([1], ["data"], device="cuda:0", backend="nccl",
                     init_method=f"tcp://localhost:{port}")
    try:
        train_ds, val_ds = _make_datasets(cfg, cube.time_slice(1, 18),
                                          cube.time_slice(19, 30))
        tl = DeviceLoader(train_ds, 2, seed=0, device=cuda, mesh=mesh)
        vl = DeviceLoader(val_ds, 2, seed=0, device=cuda, mesh=mesh)
        model = build_model(cfg)
        state = create_train_state(cfg, model, cuda, steps_per_epoch=len(tl))
        train = make_train_epoch(model, cfg, tl, train_ds.anomaly.shape,
                                 t0=float(train_ds.timestep[0]),
                                 steps_per_epoch=len(tl))
        val = make_eval_epoch(model, cfg, vl, val_ds.anomaly.shape,
                              t0=float(val_ds.timestep[0]))
        for _ in range(2):
            before = dict(ss.launches)
            m = metrics_to_host(train(state))
            assert ss.launches[ss.FUSED_BWD] - before[ss.FUSED_BWD] \
                == 3 * len(tl)
            assert np.isfinite(float(m["loss_sums"]["loss"]))
            assert np.isfinite(float(metrics_to_host(val())["loss_sums"][
                "loss"]))
        for epoch in (train, val):
            assert epoch.graph is not None
            epoch.pos.zero_()  # after the epoch it points past the last
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                epoch.graph.replay()
                torch.cuda.synchronize()
            nccl = [e.name for e in prof.events()
                    if e.device_type == DeviceType.CUDA
                    and ("nccl" in e.name.lower()
                         or "onerank" in e.name.lower())]
            assert nccl, "a replay holds no NCCL kernel"
    finally:
        mesh.close()
