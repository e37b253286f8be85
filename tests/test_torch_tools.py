# ------------------------------------------------------------------
"""The driver tools of the port against the JAX package where it has a
counterpart: the image panels (utils/vis.py), the trainers' ``profile_dir``
hook and per-epoch panels, and the CLIs memory_fit, profile_step and
visualize_data.

CPU, small sizes (3 variables, 16x16, CNN_3D or Mamba with depths [1, 1]):
  * the panels equal idee_tpu.utils.vis's (max abs <= 1e-7; the cividis
    table is carried without matplotlib), NaN probabilities included;
  * ``profile_dir`` writes a Chrome trace of steps 2-7 of a per-step loop
    (a shorter epoch closes it at its end) or of a fused first epoch
    whole, its step spans in it, and leaves the history equal to a run
    without it; the
    panels are made each epoch from the last val batch (shapes as JAX's,
    values in [0, 1]), for train_synthetic and train_real, host and device
    loaders; RealDeviceLoader's eval masks equal JAX's;
  * memory_fit and profile_step run their CPU path (no memory and no
    device time measured there: profile_step reads the spans' host
    ranges); visualize_data writes a PNG.
Card (``gpu`` marker): a memory_fit probe and a profile_step run on the
card (the spans from their device marks), and the profile hook's trace
naming the scan kernels and the span marks.
"""
# ------------------------------------------------------------------

import json
import math
import os

import numpy as np
import pytest
import torch

from idee_tpu_torch.cli import memory_fit, profile_step, visualize_data
from idee_tpu_torch.config import synthetic_config
from idee_tpu_torch.data.device import RealDeviceLoader
from idee_tpu_torch.data.fake import (make_fake_cube, write_fake_reanalysis,
                                      write_synthetic_netcdf)
from idee_tpu_torch.train import driver, driver_real
from idee_tpu_torch.utils import vis

torch.set_num_threads(1)

VARS = ["var_01", "var_02", "var_03"]
REAL_VARS = ["al", "t2m", "tp"]
N_TIME = 40


@pytest.fixture(scope="module")
def cube():
    return make_fake_cube(n_vars=3, n_time=N_TIME, height=16, width=16,
                          seed=3)


@pytest.fixture(scope="module")
def cerra(tmp_path_factory):
    root = tmp_path_factory.mktemp("tools_cerra")
    write_fake_reanalysis(str(root / "CERRA"), str(root / "NOAA"),
                          variables=REAL_VARS, years=("1984",), seed=0)
    return str(root / "CERRA"), str(root / "NOAA")


def _tiny(tmp, **kw):
    base = dict(encoder="CNN_3D", in_channels_dynamic=3, variables=VARS,
                x_max=16, y_max=16, en_embed_dim=[8, 8], en_depths=[1, 1],
                codebook_dim=8, cls_dim=8, batch_size=2, n_epochs=2,
                times_train=(1, 28), times_val=(29, N_TIME), is_aug=True,
                is_clima_scale=False, dir_log=str(tmp), name="tools")
    base.update(kw)
    return synthetic_config(**base)


def _tiny_real(tmp, cerra, **kw):
    return _tiny(tmp, in_channels=2, variables=REAL_VARS, root_CERRA=cerra[0],
                 root_NOAA_CERRA=cerra[1], years_train=["1984"],
                 years_val=["1984"], grid_override=(16, 16), name="real",
                 **kw)


class Recorder:
    """A SummaryWriter stand-in that keeps the add_images calls."""

    runs = []

    def __init__(self, log_dir):
        self.images = []
        Recorder.runs.append(self)

    def add_scalars(self, *a, **k):
        pass

    def add_images(self, tag, images, step, dataformats="HWC"):
        self.images.append((tag, np.array(images), step, dataformats))

    def flush(self):
        pass

    def close(self):
        pass


# ---------------------------------------------------------------- panels

def test_panels_match_jax():
    from idee_tpu.utils import vis as jvis

    rng = np.random.default_rng(0)
    pred = rng.uniform(-0.1, 1.1, (2, 16, 24)).astype(np.float32)
    pred[0, 0, :3] = [np.nan, 0.0, 1.0]
    pred_c = (pred > 0.5).astype(np.float32)
    target = rng.integers(0, 2, pred.shape).astype(np.float32)
    masks = [rng.integers(0, 2, pred.shape).astype(np.float32)
             for _ in range(4)]
    anomaly = rng.integers(0, 2, (2, 3, 8, 16, 24)).astype(np.uint8)
    pairs = [(vis.generate_images_synthetic(pred, pred_c, target),
              jvis.generate_images_synthetic(pred, pred_c, target)),
             (vis.generate_images(pred, pred_c, target, *masks),
              jvis.generate_images(pred, pred_c, target, *masks)),
             (vis.generate_images(pred, pred_c, target, *masks[:3]),
              jvis.generate_images(pred, pred_c, target, *masks[:3])),
             ((vis.generate_anomaly(anomaly),),
              (jvis.generate_anomaly(anomaly),))]
    for got, want in pairs:
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == w.dtype
            assert np.max(np.abs(g - w)) <= 1e-7
    # the table itself: matplotlib's cividis at every row
    import matplotlib.pyplot as plt

    x = (np.arange(256) + 0.5) / 256
    np.testing.assert_array_equal(vis._cividis(x),
                                  plt.cm.cividis(x)[:, :3])


def _history(hist):
    return {k: v for k, v in hist.items()
            if k not in ("state", "steps_per_sec")}


def _same_histories(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k], float),
                                      np.asarray(want[k], float), err_msg=k)


def _trace_events(path):
    with open(path) as fh:
        return json.load(fh)["traceEvents"]


@pytest.mark.parametrize("loop", ["host", "device_fused"])
def test_profile_dir_traces_and_keeps_the_synthetic_history(
        cube, tmp_path, monkeypatch, loop):
    """10 train steps per epoch: the trace covers steps 2-7 of the first
    epoch of the host loop, and the whole first epoch of the fused
    epochs (device_data and fused_epoch), which the hook leaves selected;
    the history equals the run's without the hook."""
    monkeypatch.setattr(driver, "SummaryWriter", Recorder)
    Recorder.runs = []
    kw = dict(device_data=loop != "host", encoder="Mamba")
    train, val = cube.time_slice(1, 28), cube.time_slice(29, N_TIME)
    want = driver.train_synthetic(_tiny(tmp_path / "plain", **kw),
                                  train_cube=train, val_cube=val,
                                  device="cpu")
    prof = tmp_path / "prof"
    got = driver.train_synthetic(
        _tiny(tmp_path / "traced", profile_dir=str(prof), **kw),
        train_cube=train, val_cube=val, device="cpu")
    _same_histories(_history(got), _history(want))
    assert got["state"].step == 2 * 10
    events = _trace_events(prof / "tools_train.trace.json")
    steps = [e for e in events if e.get("name", "").startswith(
        "aten::native_layer_norm") or e.get("name") == "aten::conv3d"]
    assert steps  # the model's operators ran under the profiler
    traced_steps = [e for e in events if e.get("name") == "idee.step"]
    assert len(traced_steps) == (6 if loop == "host" else 10)
    # the fused epoch's host work around its steps
    epoch_ranges = {e["name"] for e in events
                    if e.get("name") in ("idee.order", "idee.upload")}
    assert epoch_ranges == (set() if loop == "host"
                            else {"idee.order", "idee.upload"})
    with open(tmp_path / "traced" / "tools" / "log_file.txt") as fh:
        assert f"profiler trace -> {prof}" in fh.read()

    # the panels: each epoch, the extremes panel and one per variable
    for rec in Recorder.runs:
        tags = [(t, s) for t, _, s, _ in rec.images]
        assert tags == [(t, e) for e in (1, 2)
                        for t in ["extremes"] + VARS]
        for tag, im, _, fmt in rec.images:
            if tag == "extremes":
                assert fmt == "NHWC" and im.shape == (2, 16, 48, 3)
            else:
                # prediction above ground truth, the 8 weeks side by side
                assert fmt == "HWC" and im.shape == (2 * 16, 8 * 16, 3)
            assert im.min() >= 0 and im.max() <= 1


def test_profile_dir_shorter_epoch_and_real_panels(cerra, tmp_path,
                                                   monkeypatch):
    """train_real on a 9-sample year at batch 2: 4 steps, so the epoch's
    end closes the trace; the real-world panels from the device loader's
    last val batch (with its sea and no-vegetation masks), equal histories
    with and without the hook."""
    monkeypatch.setattr(driver_real, "SummaryWriter", Recorder)
    Recorder.runs = []
    want = driver_real.train_real(
        _tiny_real(tmp_path / "plain", cerra, device_data=True), "CERRA",
        device="cpu")
    prof = tmp_path / "prof"
    got = driver_real.train_real(
        _tiny_real(tmp_path / "traced", cerra, device_data=True,
                   profile_dir=str(prof)), "CERRA", device="cpu")
    _same_histories(_history(got), _history(want))
    assert got["state"].step == 2 * 4
    assert _trace_events(prof / "real_train.trace.json")
    for rec in Recorder.runs:
        tags = [(t, s) for t, _, s, _ in rec.images]
        assert tags == [(t, e) for e in (1, 2) for t in
                        ["probability", "prediction", "target"] + REAL_VARS]
        for tag, im, _, fmt in rec.images:
            want_shape = ((2, 16, 16, 3) if fmt == "NHWC"
                          else (16, 8 * 16, 3))
            assert im.shape == want_shape, tag
            assert im.min() >= 0 and im.max() <= 1


def test_real_device_loader_eval_masks_match_jax(cerra):
    from idee_tpu.data import device as jdevice
    from idee_tpu.data import reanalysis as jreanalysis

    from idee_tpu_torch.data.reanalysis import ReanalysisDataset, cerra_spec

    def dataset(mod, spec):
        spec = spec(8)
        spec.grid_height = spec.grid_width = 16
        return mod(spec, *cerra, delta_t=8, variables=REAL_VARS,
                   years=["1984"], x_max=16, y_max=16, window_size=2)

    ds = dataset(ReanalysisDataset, cerra_spec)
    jds = dataset(jreanalysis.ReanalysisDataset, jreanalysis.cerra_spec)
    got = RealDeviceLoader(ds, 3, seed=2, with_eval_masks=True,
                           device="cpu")
    want = jdevice.RealDeviceLoader(jds, 3, seed=2, with_eval_masks=True)
    assert 0 < ds.mask_water_scaled.mean() < 1
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]),
                                          err_msg=k)


# ---------------------------------------------------------------- CLIs

@pytest.mark.parametrize("family,encoder,extra", [
    ("synthetic", "CNN_3D", ["--batch", "2"]),
    ("real", "Mamba", ["--remat"]),
    ("synthetic", "Swin_3D", ["--dtype", "bfloat16"])])
def test_memory_fit_runs_its_cpu_path(family, encoder, extra):
    row = memory_fit.main(["--device", "cpu", "--family", family,
                           "--encoder", encoder, "--hw", "16x24"] + extra)
    assert row["loss_finite"] and row["device"] == "cpu"
    # nothing is measured on the CPU
    assert row["peak_gb"] is None and row["fits"] is None
    assert row["hw"] == "16x24"
    assert memory_fit.parse_hw("512x832") == (512, 832)
    assert memory_fit.parse_hw("200") == (200, 200)


def test_profile_step_runs_its_cpu_path(tmp_path):
    out = tmp_path / "profile.json"
    summary = profile_step.main(["--device", "cpu", "--encoder", "Mamba",
                                 "--hw", "16", "--iters", "2", "--out",
                                 str(out)])
    rows = {r["span"]: r for r in summary["spans"]}
    assert list(rows) == ["step", "data", "encoder", "quantizer",
                          "classifier", "loss", "backward",
                          "encoder_backward", "optimizer", "accumulate"]
    assert all("cpu_ms" in r and "ms" not in r and "mfu" not in r
               and math.isfinite(r["cpu_ms"]) for r in rows.values())
    assert all(r["n"] == 2 for k, r in rows.items() if k != "loss")
    assert rows["loss"]["n"] == 4
    # the children lie inside the step, the encoder's backward inside
    # the backward
    assert 0.5 < summary["children_cover"] <= 1
    assert rows["encoder_backward"]["cpu_ms"] < rows["backward"]["cpu_ms"]
    assert json.loads(out.read_text())["step_cpu_ms"] == \
        rows["step"]["cpu_ms"]
    assert "step_mfu" not in summary and "busy_cover" not in summary


def test_visualize_data_writes_pngs(cube, cerra, tmp_path):
    root = tmp_path / "synthetic_fake"
    write_synthetic_netcdf(str(root), cube)
    out = tmp_path / "synthetic.png"
    visualize_data.main(["--dataset", "synthetic", "--root", str(root),
                         "--timestep", "3", "--out", str(out)])
    week = tmp_path / "week.png"
    visualize_data.main(["--dataset", "cerra", "--root", cerra[0],
                         "--year", "1984", "--week", "45", "--out",
                         str(week)])
    for path in (out, week):
        assert path.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


# ---------------------------------------------------------------- card only

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the scan kernels have no CPU mode; "
                    "memory is measured on the card)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_memory_fit_on_card(cuda):
    row = memory_fit.probe("synthetic", "Mamba", 1, 32, 32, device="cuda")
    assert row["fits"] and 0 < row["peak_gb"] < row["total_gb"]
    assert row["reserved_gb"] * 1e9 >= row["peak_bytes"]


@pytest.mark.gpu
def test_profile_step_on_card(cuda):
    summary = profile_step.profile("Mamba", hw=32, iters=3, device="cuda")
    rows = {r["span"]: r for r in summary["spans"]}
    assert all(r["ms"] > 0 and r["n"] == (6 if k == "loss" else 3)
               for k, r in rows.items())
    assert "encoder_backward" in rows and "mfu" not in rows["step"]
    assert 0.97 <= summary["children_cover"] <= 1
    assert 0.97 <= summary["busy_cover"] <= 1
    assert summary["marks_per_step"] == 2 * (len(rows) + 1)  # 2 losses
    assert "W" in summary["card"]


@pytest.mark.gpu
def test_profile_hook_trace_names_the_scan_kernels(cube, cuda, tmp_path):
    prof = tmp_path / "prof"
    driver.train_synthetic(
        _tiny(tmp_path, encoder="Mamba", n_epochs=1, device_data=True,
              profile_dir=str(prof)),
        train_cube=cube.time_slice(1, 28),
        val_cube=cube.time_slice(29, N_TIME), device="cuda")
    names = {e.get("name", "") for e in
             _trace_events(prof / "tools_train.trace.json")}
    for kernel in ("fused_scan_n1_fwd_kernel", "fused_scan_n1_bwd_kernel",
                   "idee_span_encoder_backward_begin"):
        assert any(kernel in n for n in names), kernel
    assert os.path.getsize(prof / "tools_train.trace.json") > 0
