# ------------------------------------------------------------------
"""Data parallelism of the port (parallel/mesh.py) on the CPU: two gloo
ranks, each a process of tests/torch_parallel_worker.py (torch and the
port only, no JAX) started with RANK / WORLD_SIZE / LOCAL_RANK as torchrun
sets them and a ``file://`` store under tmp_path.

The rule is JAX's (tests/test_parallel.py:40-78): a train step at world
size 2 computes the update of the single-device step on the same global
batch. Checked, with dropout at 0 as there:
  * 2 train steps of the tiny synthetic config (Mamba, CNN_3D): the
    parameters of both ranks equal the port's world-1 run and JAX's
    single-device steps within atol 2e-5, the global losses within rtol
    2e-4;
  * one train_real step whose rows hold unequal valid pixels (the masked
    BCE's denominator is the global batch's);
  * VQ-EMA (k-means init, dead-code expiry): the codebook buffers of both
    ranks equal the world-1 run's (rtol 1e-5: the k-means and EMA sums
    add in another order), and so do the parameters. This job runs with
    lambda_anomaly 0: in the k-means step the anomaly L1 compares each
    code-0 token's z_q with vq_0 as the EMA has just rewritten it, equal
    up to rounding, so that term's gradient is the sign of rounding noise
    (in JAX too, whose vq_0 is read after the same update). Measured on
    the CPU: with it, the world-2 step-1 gradients part 0.20 x max |grad|
    from world 1's, Adam moves those entries 2 lr apart and the second
    step's dead-code expiry differs; without it every gradient lies
    within 6e-6 x max;
  * VQ-EMA past the k-means step, at the config's lambda_anomaly (100):
    2 steps from the world-1 state after one step (codebook initialised),
    so the anomaly L1's global-batch normaliser runs under two ranks;
    parameters atol 2e-5, codebook buffers rtol 1e-5 against world 1;
  * the epoch counters and vote buffers, summed over the ranks, equal the
    world-1 step's;
  * train_synthetic under mesh_shape [2]: rank 0 alone writes the
    checkpoints, history and config, a second run resumes on both ranks,
    and the losses equal the world-1 driver's;
  * a mesh_shape that is not the world size raises (over ["data"] and
    over ["data", "space"]); the loaders' rows of the ranks together are
    the world-1 batch.
"""
# ------------------------------------------------------------------

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from idee_tpu_torch.data.device import DeviceLoader
from idee_tpu_torch.data.fake import make_fake_cube, write_cube_npz
from idee_tpu_torch.data.loader import DataLoader
from idee_tpu_torch.data.synthetic import SyntheticDataset
from idee_tpu_torch.models.interop import (flax_to_state_dict,
                                           load_flax_params)
from idee_tpu_torch.models.vq_model import build_model
from idee_tpu_torch.parallel.mesh import Mesh, make_mesh
from idee_tpu_torch.train.driver import train_synthetic
from idee_tpu_torch.train.state import create_train_state
from idee_tpu_torch.train.steps import init_epoch_metrics, make_train_step
from idee_tpu_torch.train.steps_real import (init_epoch_metrics_real,
                                             make_train_step_real)
from test_torch_train import (T_LINE, _batches, _jax_params, _jax_trajectory,
                              _tiny_config, jx)  # noqa: F401

torch.set_num_threads(1)

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_parallel_worker.py")
PARAM_ATOL, LOSS_RTOL = 2e-5, 2e-4  # tests/test_parallel.py:60-65
VQ_EMA = dict(codebook="VQ", vq_ema_update=True, vq_kmeans_init=True,
              vq_threshold_ema_dead_code=2.0, lambda_commitment=0.25)
ENCODER_SEEDS = {"Mamba": 1, "CNN_3D": 2}  # test_torch_train's


def run_ranks(tmp, jobs, world=2, timeout=150):
    """Run ``jobs`` on ``world`` worker processes; their results, by
    rank."""
    tmp.mkdir(parents=True, exist_ok=True)
    torch.save(jobs, tmp / "jobs.pt")
    init = f"file://{tmp / 'store'}"
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(tmp / "jobs.pt"), init, str(tmp)],
        env=dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                 LOCAL_RANK=str(r), OMP_NUM_THREADS="1"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]
    try:
        outs = [p.communicate(timeout=timeout)[0].decode() for p in procs]
    finally:
        for p in procs:  # a rank that failed leaves the other waiting
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out[-4000:]}"
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def _world1_steps(cfg, state_dict, batches, real=False):
    model = build_model(cfg)
    model.load_state_dict(state_dict)
    state = create_train_state(cfg, model, "cpu", steps_per_epoch=3)
    step = (make_train_step_real(model, cfg) if real else
            make_train_step(model, cfg, t0=1.0, steps_per_epoch=3))
    losses, metrics = [], []
    for b in batches:
        m = (init_epoch_metrics_real("cpu") if real else
             init_epoch_metrics((3, T_LINE, 16, 16), "cpu"))
        state, m = step(state, m, {k: torch.from_numpy(v)
                                   for k, v in b.items()})
        losses.append(m["loss_sums"]["loss"].item())
        metrics.append(m)
    return losses, metrics, model.state_dict()


def _real_batch(seed=5):
    """A real-world global batch of 2 rows whose valid pixels (1 - cold
    surface) differ: 90 % of row 0, 30 % of row 1."""
    rng = np.random.default_rng(seed)
    cold = np.stack([rng.random((16, 16)) < p for p in (0.1, 0.7)])
    return {
        "x": rng.normal(size=(2, 3, 2, 8, 16, 16)).astype(np.float32),
        "mask_extreme": (rng.random((2, 16, 16)) < 0.2).astype(np.float32),
        "mask_extreme_loss": (rng.random((2, 16, 16)) < 0.3).astype(
            np.float32),
        "mask_cold_surface": cold.astype(np.float32),
        "mask_cold_surface_loss": (rng.random((2, 16, 16)) < 0.2).astype(
            np.float32),
    }


def _real_config():
    return _tiny_config(in_channels=2, variables_static=[], name="real")


@pytest.fixture(scope="module")
def step_runs(jx, tmp_path_factory):
    """The step jobs on 2 ranks, and the port's world-1 run of each (the
    encoder jobs start from JAX's init of their seed)."""
    jobs, want = [], {}
    for enc, seed in ENCODER_SEEDS.items():
        cfg = _tiny_config(encoder=enc)
        _, params = _jax_params(jx, cfg, seed=seed)
        sd = load_flax_params(cfg, params)
        batches = _batches(2, seed=3)
        want[enc] = dict(world1=_world1_steps(cfg, sd, batches),
                         params=params, batches=batches)
        jobs.append(dict(kind="steps", cfg=cfg.to_dict(), state_dict=sd,
                         batches=batches))
    cfg = _real_config()
    sd = build_model(cfg).state_dict()
    want["real"] = dict(world1=_world1_steps(cfg, sd, [_real_batch()],
                                             real=True))
    jobs.append(dict(kind="steps", cfg=cfg.to_dict(), state_dict=sd,
                     batches=[_real_batch()], real=True))
    cfg = _tiny_config(**VQ_EMA, lambda_anomaly=0.0, name="vq")
    sd = build_model(cfg).state_dict()
    batches = _batches(2, seed=4)
    want["vq"] = dict(world1=_world1_steps(cfg, sd, batches))
    jobs.append(dict(kind="steps", cfg=cfg.to_dict(), state_dict=sd,
                     batches=batches))
    # past the k-means step: the world-1 state after one step, initted
    cfg = _tiny_config(**VQ_EMA, name="vq_past")
    _, _, sd = _world1_steps(cfg, build_model(cfg).state_dict(),
                             _batches(1, seed=6))
    batches = _batches(2, seed=7)
    want["vq_past"] = dict(world1=_world1_steps(cfg, sd, batches), start=sd)
    jobs.append(dict(kind="steps", cfg=cfg.to_dict(), state_dict=sd,
                     batches=batches))
    got = run_ranks(tmp_path_factory.mktemp("steps"), jobs)
    names = list(ENCODER_SEEDS) + ["real", "vq", "vq_past"]
    return {n: ([r[i] for r in got], want[n]) for i, n in enumerate(names)}


def _close(got_sd, want_sd, what, rtol=0.0):
    assert sorted(got_sd) == sorted(want_sd), what
    for k, w in want_sd.items():
        np.testing.assert_allclose(got_sd[k].float().numpy(),
                                   w.float().numpy(), rtol=rtol,
                                   atol=PARAM_ATOL, err_msg=f"{what}: {k}")


@pytest.mark.parametrize("encoder", list(ENCODER_SEEDS))
def test_two_rank_steps_match_world_1_and_jax(jx, step_runs, encoder):
    ranks, want = step_runs[encoder]
    w1_losses, _, w1_sd = want["world1"]
    jx.runtime.set_force_pallas(True)
    try:
        jax_losses, jax_params, _ = _jax_trajectory(
            jx, _tiny_config(encoder=encoder), want["params"],
            want["batches"])
    finally:
        jx.runtime.set_force_pallas(False)
    jax_params = flax_to_state_dict(jax_params, w1_sd)
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["losses"], w1_losses, rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["losses"], jax_losses,
                                   rtol=LOSS_RTOL)
        _close(got["state_dict"], w1_sd, f"rank {r} against world 1")
        _close({k: got["state_dict"][k] for k in jax_params}, jax_params,
               f"rank {r} against JAX")
    # the ranks hold one model
    for k, v in ranks[0]["state_dict"].items():
        assert torch.equal(v, ranks[1]["state_dict"][k]), k


def test_real_masked_step_matches_world_1(step_runs):
    ranks, want = step_runs["real"]
    w1_losses, _, w1_sd = want["world1"]
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["losses"], w1_losses, rtol=LOSS_RTOL)
        _close(got["state_dict"], w1_sd, f"rank {r}")


def _codebook_buffers(sd):
    buffers = [k for k in sd if k.split(".")[-1] in (
        "embed", "cluster_size", "embed_avg", "initted")]
    assert len(buffers) == 4, buffers
    return buffers


def _initted(sd, buffers) -> float:
    return float(sd[[k for k in buffers if k.endswith("initted")][0]])


def _hold_vq(ranks, w1_sd, buffers):
    """Both ranks' parameters atol 2e-5 and codebook buffers rtol 1e-5
    from world 1's, the ranks' buffers equal. Returns rank 0's largest
    parameter difference and each buffer's largest relative one."""
    for r, got in enumerate(ranks):
        _close({k: v for k, v in got["state_dict"].items()
                if k not in buffers},
               {k: v for k, v in w1_sd.items() if k not in buffers},
               f"rank {r}")
        _close({k: got["state_dict"][k] for k in buffers},
               {k: w1_sd[k] for k in buffers}, f"rank {r}", rtol=1e-5)
        for k in buffers:
            assert torch.equal(got["state_dict"][k],
                               ranks[0]["state_dict"][k]), k
    got = {k: v.float() for k, v in ranks[0]["state_dict"].items()}
    return (max((got[k] - w1_sd[k].float()).abs().max().item()
                for k in w1_sd if k not in buffers),
            {k: ((got[k] - w1_sd[k].float()).abs()
                 / w1_sd[k].float().abs().clamp(min=1e-30)).max().item()
             for k in buffers})


def test_vq_ema_codebook_state_matches_world_1(step_runs):
    ranks, want = step_runs["vq"]
    _, _, w1_sd = want["world1"]
    buffers = _codebook_buffers(w1_sd)
    # the codebook moved: k-means ran and the EMA stepped
    assert _initted(w1_sd, buffers) == 1.0
    _hold_vq(ranks, w1_sd, buffers)


def test_vq_ema_past_kmeans_with_the_anomaly_term_matches_world_1(
        step_runs):
    ranks, want = step_runs["vq_past"]
    _, _, w1_sd = want["world1"]
    buffers = _codebook_buffers(w1_sd)
    assert _tiny_config(**VQ_EMA).lambda_anomaly > 0
    # started past the k-means step, which therefore ran in no step here
    assert _initted(want["start"], buffers) == 1.0
    for r, got in enumerate(ranks):
        assert all(np.isfinite(got["losses"])), r
    params, rel = _hold_vq(ranks, w1_sd, buffers)
    print(f"VQ-EMA past k-means, world 2 against world 1: parameters "
          f"{params:.3g} max abs, buffers {rel} max rel")  # -s shows it


def test_counts_and_votes_are_global(step_runs):
    ranks, want = step_runs["Mamba"]
    _, w1_metrics, _ = want["world1"]
    for got in ranks:
        for m, w in zip(got["metrics"], w1_metrics):
            assert int(m["counts"]["seen_all"]) == 2 * 16 * 16
            for k, v in w["counts"].items():
                assert int(m["counts"][k]) == int(v), k
            np.testing.assert_array_equal(m["vote_sum"],
                                          w["vote_sum"].numpy())
            np.testing.assert_array_equal(m["vote_cnt"],
                                          w["vote_cnt"].numpy())
            assert int(m["n_steps"]) == 1


def test_driver_writes_once_and_resumes_on_two_ranks(tmp_path):
    cube = make_fake_cube(n_vars=3, n_time=30, height=16, width=16, seed=3)
    write_cube_npz(str(tmp_path / "cube"), cube)
    cfg = _tiny_config(root_synthetic=str(tmp_path / "cube"),
                       times_train=(1, 18), times_val=(19, 30),
                       dir_log=str(tmp_path / "log2"), n_epochs=1,
                       is_aug=True, mesh_shape=[2], fused_epoch=False)
    got = run_ranks(tmp_path / "run", [
        dict(kind="driver", cfg=cfg.to_dict()),
        dict(kind="driver", cfg=cfg.replace(n_epochs=2).to_dict())])
    # rank 0 wrote the config once per run, latest and the best aliases
    # per epoch, and history.json per epoch; rank 1 wrote nothing
    assert got[1][0]["calls"] == got[1][1]["calls"] == {
        "save": 0, "flush_history": 0, "save_options": 0}
    assert got[0][0]["calls"]["save_options"] == 1
    assert got[0][0]["calls"]["flush_history"] == 1
    assert got[0][1]["calls"]["flush_history"] == 1  # resumed: epoch 2
    ckpts = sorted(os.listdir(tmp_path / "log2" / "train" /
                              "model_checkpoints"))
    assert "latest.pt" in ckpts and not any(c.endswith(".tmp")
                                            for c in ckpts)
    one = got[0][1]["history"]
    assert one["train_loss"][:1] == got[0][0]["history"]["train_loss"]
    assert got[0][1]["step"] == got[1][1]["step"] == 2 * ((18 - 8 + 1) // 2)
    for k, v in got[0][1]["state_dict"].items():
        assert torch.equal(v, got[1][1]["state_dict"][k]), k

    # the world-1 driver on the same cube, run and resumed as above (a
    # resumed run starts its loaders' order streams afresh): the same
    # losses
    w1 = cfg.replace(mesh_shape=None, dir_log=str(tmp_path / "log1"))
    train_synthetic(w1, device="cpu")
    want = train_synthetic(w1.replace(n_epochs=2), device="cpu")
    np.testing.assert_allclose(one["train_loss"], want["train_loss"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(one["val_loss"], want["val_loss"],
                               rtol=LOSS_RTOL)
    assert one["val_f1"] == pytest.approx(want["val_f1"], nan_ok=True)


def test_mesh_shape_must_be_the_world_size(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(ValueError, match="WORLD_SIZE 2"):
        make_mesh([3], ["data"], device="cpu")
    # a data x space mesh counts both axes' ranks
    with pytest.raises(ValueError, match="WORLD_SIZE 2"):
        make_mesh([1, 3], ["data", "space"], device="cpu")
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("device_data", [False, True])
def test_loaders_split_the_global_batch_over_the_ranks(device_data):
    """The ranks' rows, in rank order, are the world-1 batch: the same
    order, and the augmentations drawn for the whole global batch."""
    cube = make_fake_cube(n_vars=3, n_time=30, height=16, width=16, seed=1)

    def batches(mesh):
        ds = SyntheticDataset(cube=cube.time_slice(1, 20), is_aug=True,
                              variables=["var_01", "var_02", "var_03"],
                              x_max=16, y_max=16, seed=0)
        if device_data:
            loader = DeviceLoader(ds, 4, seed=0, device="cpu", mesh=mesh)
        else:
            loader = DataLoader(ds, 4, device="cpu", shuffle=True, seed=0,
                                mesh=mesh)
        return [b for _, b in zip(range(3), loader)]

    whole = batches(None)
    parts = [batches(Mesh(r, 2, torch.device("cpu")))
             for r in range(2)]
    for b, (p0, p1) in enumerate(zip(*parts)):
        for k, v in whole[b].items():
            assert p0[k].shape[0] == 2, k
            assert torch.equal(torch.cat([p0[k], p1[k]]), v), (b, k)
    with pytest.raises(ValueError, match="does not split"):
        DataLoader(None, 3, device="cpu",
                   mesh=Mesh(0, 2, torch.device("cpu")))
