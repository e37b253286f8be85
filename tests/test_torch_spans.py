# ------------------------------------------------------------------
"""The step's spans (idee_tpu_torch/utils/spans.py): host ranges and, on a
card, device marks that every CUDA-graph replay emits.

CPU, small sizes (3 variables, 16x16, Mamba with plain scans or CNN_3D,
batch 1):
  * a train and an eval epoch under torch.profiler open the ``idee.*``
    host ranges nested in the step's order, the epoch's host ranges
    around them;
  * the spans change no output: histories and parameters bit-equal with
    the spans and with them replaced by no-ops, the fused epochs equal to
    the per-step loop;
  * ``encoder_backward`` opens inside ``backward`` only where gradients
    reach the encoder's output;
  * the marks' source declares every span; marks pair by name in device
    order, nested and repeated, and unpaired marks raise.
Card (``gpu`` marker): a fused epoch of N replays under the profiler
emits N instances of every span, in order, ``encoder_backward`` inside
``backward``; the step's children cover 97 % of it, and 97 % of the
device's busy time falls inside the steps; a capture runs with the
cyclic collector paused (CPU: the pause restores the collector's state).
"""
# ------------------------------------------------------------------

import contextlib
import gc
import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from idee_tpu_torch.config import synthetic_config
from idee_tpu_torch.data.device import DeviceLoader
from idee_tpu_torch.data.fake import make_fake_cube
from idee_tpu_torch.data.synthetic import SyntheticDataset
from idee_tpu_torch.kernels import build
from idee_tpu_torch.models.vq_model import build_model, compute_dtype
from idee_tpu_torch.train import steps
from idee_tpu_torch.train.driver import train_synthetic
from idee_tpu_torch.train.state import create_train_state
from idee_tpu_torch.train.steps import (init_epoch_metrics, make_eval_epoch,
                                        make_eval_step, make_train_epoch,
                                        make_train_step, metrics_to_host)
from idee_tpu_torch.utils import spans

torch.set_num_threads(1)

VARS = ["var_01", "var_02", "var_03"]
TRAIN = ["data", "encoder", "quantizer", "classifier", "loss", "loss",
         "backward", "optimizer", "accumulate"]
EVAL = ["data", "encoder", "quantizer", "classifier", "loss", "loss",
        "accumulate"]


def _config(train: bool, hw: int = 16, **kw):
    base = dict(encoder="Mamba", in_channels_dynamic=3, variables=VARS,
                x_max=hw, y_max=hw, en_embed_dim=[8, 8], en_depths=[2, 1],
                codebook_dim=8, cls_dim=8, batch_size=1, is_aug=train,
                is_clima_scale=False, lr_warmup_epochs=0)
    base.update(kw)
    return synthetic_config(**base)


def _epoch(train: bool, device, steps: int = 2, hw: int = 16,
           batch: int = 1, **kw):
    """A fused train or eval epoch of ``steps`` batches: (run, fused,
    loader, model, state), run() running one epoch and reading its
    metrics."""
    cfg = _config(train, hw, batch_size=batch, **kw)
    n_time = steps * batch + cfg.delta_t - 1
    cube = make_fake_cube(n_vars=3, n_time=n_time, height=hw, width=hw,
                          seed=3)
    ds = SyntheticDataset(cube=cube, times=(1, n_time), variables=VARS,
                          delta_t=cfg.delta_t, is_aug=train,
                          is_clima_scale=False, x_max=hw, y_max=hw)
    loader = DeviceLoader(ds, batch, seed=0, dtype=compute_dtype(cfg),
                          device=device)
    model = build_model(cfg, torch.Generator().manual_seed(0),
                        input_size=ds.input_size).to(device)
    t0 = float(ds.timestep[0])
    state = None
    if train:
        state = create_train_state(cfg, model, device,
                                   steps_per_epoch=len(loader))
        fused = make_train_epoch(model, cfg, loader, ds.anomaly.shape,
                                 t0=t0, steps_per_epoch=len(loader))
    else:
        fused = make_eval_epoch(model, cfg, loader, ds.anomaly.shape, t0=t0)

    def run():
        return metrics_to_host(fused(state) if train else fused())

    return SimpleNamespace(run=run, fused=fused, loader=loader, model=model,
                           state=state, cfg=cfg, ds=ds)


def _profiled(fn, cuda: bool = False):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        fn()
    return prof.profiler.kineto_results.events()


def _inside(iv, outer) -> bool:
    return outer[0] <= iv[0] and iv[1] <= outer[1]


def _children(found, step):
    """The names of the step's child spans in the order they open."""
    return [name for _, name in sorted(
        (iv[0], k) for k, v in found.items() if spans.PARENT.get(k) == "step"
        for iv in v if _inside(iv, step))]


def _check_steps(found, train: bool, n: int) -> None:
    """n steps, each holding the table's spans in order, and in training
    encoder_backward once inside each backward."""
    assert len(found["step"]) == n
    want = TRAIN if train else EVAL
    for step in found["step"]:
        assert _children(found, step) == want
    if train:
        assert len(found["encoder_backward"]) == n
        for iv, outer in zip(found["encoder_backward"], found["backward"]):
            assert _inside(iv, outer)
    else:
        assert "encoder_backward" not in found and "backward" not in found
    assert "grad_sync" not in found  # no mesh


# ---------------------------------------------------------------- CPU

@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_epoch_opens_the_host_ranges_in_order(train):
    e = _epoch(train, "cpu")
    e.run()
    found = spans.host_ranges(_profiled(e.run))
    _check_steps(found, train, 2)
    first, last = found["step"][0][0], found["step"][-1][1]
    for name in ("order", "upload", "zero"):
        (iv,) = found[name]
        assert iv[1] <= first, name
    (iv,) = found["metrics_to_host"]
    assert iv[0] >= last
    assert found["order"][0][1] <= found["upload"][0][0]
    assert found["upload"][0][1] <= found["zero"][0][0]
    # the replay loop's range is the card's
    assert "replays" not in found


def _no_spans(monkeypatch):
    """The spans replaced by no-ops."""
    @contextlib.contextmanager
    def nothing(*a, **k):
        yield

    monkeypatch.setattr(spans, "span", nothing)
    monkeypatch.setattr(spans, "backward", nothing)
    monkeypatch.setattr(spans, "host_range", nothing)
    monkeypatch.setattr(spans, "begin_on_grad", lambda *a, **k: None)


@pytest.mark.parametrize("encoder", ["Mamba", "CNN_3D"])
def test_spans_change_no_output(encoder, tmp_path, monkeypatch):
    """train_synthetic with device_data, aug on: the fused epochs with the
    spans, with them replaced by no-ops, and the per-step loop with them
    give equal histories and parameters, bit for bit."""
    cube = make_fake_cube(n_vars=3, n_time=30, height=16, width=16, seed=5)

    def run(name, fused):
        cfg = _config(True, encoder=encoder, en_depths=[1, 1],
                      batch_size=2, n_epochs=2, lr_warmup_epochs=1,
                      times_train=(1, 20), times_val=(21, 30),
                      device_data=True, fused_epoch=fused,
                      dir_log=str(tmp_path), name=name)
        hist = train_synthetic(cfg, train_cube=cube.time_slice(1, 20),
                               val_cube=cube.time_slice(21, 30),
                               device="cpu")
        state = hist.pop("state")
        hist.pop("steps_per_sec")
        return hist, {k: v.clone()
                      for k, v in state.model.state_dict().items()}

    with_spans, params = run("spans", True)
    per_step, step_params = run("per_step", False)
    with monkeypatch.context() as m:
        _no_spans(m)
        without, bare_params = run("bare", True)
    for other in (without, per_step):
        assert sorted(other) == sorted(with_spans)
        for k, v in with_spans.items():
            # NaN F1s (no positive pixel) compare equal here
            np.testing.assert_array_equal(np.asarray(other[k], float),
                                          np.asarray(v, float), err_msg=k)
    for k, v in params.items():
        assert torch.equal(v, bare_params[k]), k
        assert torch.equal(v, step_params[k]), k


@pytest.mark.parametrize("case", ["train", "eval", "frozen_encoder",
                                  "backward_outside_the_span"])
def test_encoder_backward_opens_only_where_gradients_flow(case):
    """A train step's backward holds encoder_backward; an eval step, a
    train step whose encoder takes no gradient and a backward run outside
    the backward span open none."""
    e = _epoch(case != "eval", "cpu")
    batch = next(iter(e.loader))
    metrics = init_epoch_metrics(e.ds.anomaly.shape, "cpu")
    if case == "frozen_encoder":
        for p in e.model.encoder.parameters():
            p.requires_grad_(False)
    if case == "eval":
        step = make_eval_step(e.model, e.cfg)
        found = spans.host_ranges(_profiled(lambda: step(metrics, batch)))
    elif case == "backward_outside_the_span":
        def fwd_bwd():
            out = e.model(batch["x"], train=True,
                          mask_extreme_loss=batch["mask_extreme_loss"])
            (out.z.sum() + out.loss_anomaly).backward()

        found = spans.host_ranges(_profiled(fwd_bwd))
        assert found["encoder"] and "backward" not in found
    else:
        step = make_train_step(e.model, e.cfg, steps_per_epoch=1)
        found = spans.host_ranges(
            _profiled(lambda: step(e.state, metrics, batch)))
        assert len(found["backward"]) == 1
    assert len(found.get("encoder_backward", [])) == (case == "train")
    assert spans._late is None


def test_span_marks_source_declares_every_span():
    src = (build.CSRC / f"{spans.SOURCE}.cu").read_text()
    assert tuple(re.findall(r"^IDEE_SPAN\((\w+)\)$", src, re.M)) == \
        spans.NAMES
    with pytest.raises(ValueError, match="no span"):
        with spans.span("encoder_forward", "cpu"):
            pass


@pytest.mark.parametrize("enabled", [True, False])
def test_collector_paused_restores_its_state(enabled):
    was = gc.isenabled()
    (gc.enable if enabled else gc.disable)()
    try:
        with steps._collector_paused():
            assert not gc.isenabled()
        assert gc.isenabled() == enabled
    finally:
        (gc.enable if was else gc.disable)()


def _ev(name, start, dur, device="CUDA"):
    return SimpleNamespace(name=lambda: name, start_ns=lambda: start,
                           duration_ns=lambda: dur,
                           device_type=lambda: f"DeviceType.{device}",
                           is_user_annotation=lambda: False)


def test_marks_pair_by_name_in_device_order():
    """A step with data, two loss instances and encoder_backward inside
    backward; events out of order, other kernels and host ranges among
    them."""
    m = spans.MARK
    evs = [_ev(f"{m}step_end", 300, 10), _ev(f"{m}step_begin", 0, 10),
           _ev(f"{m}data_begin", 20, 10), _ev(f"{m}data_end", 50, 10),
           _ev(f"{m}loss_begin", 70, 10), _ev(f"{m}loss_end", 100, 10),
           _ev(f"{m}loss_begin", 120, 10), _ev(f"{m}loss_end", 150, 10),
           _ev(f"{m}backward_begin", 170, 10),
           _ev(f"{m}encoder_backward_begin", 190, 10),
           _ev(f"{m}encoder_backward_end", 250, 10),
           _ev(f"{m}backward_end", 270, 10),
           _ev("sm90_gemm_kernel", 30, 15), _ev("idee.step", 0, 400, "CPU"),
           _ev(f"{m}data_begin", 25, 1, "CPU")]
    found = spans.read_spans(evs)
    assert found == {"step": [(10, 300)], "data": [(30, 50)],
                     "loss": [(80, 100), (130, 150)],
                     "backward": [(180, 270)],
                     "encoder_backward": [(200, 250)]}
    assert spans.host_ranges(evs) == {"step": [(0, 400)]}
    # a mark from before the window (an earlier trace's) is left out
    stale = evs + [_ev(f"{m}data_end", -50, 10)]
    assert spans.read_spans(stale, window=(0, 400)) == found
    with pytest.raises(ValueError, match="no begin"):
        spans.read_spans(stale)
    # 12 device marks of 10 ns, and the kernel's 15 ns inside data
    assert spans.busy_ns(evs) == 12 * 10 + 15
    # inside the step: all but its marks' outer halves
    assert spans.busy_ns(evs, within=[(10, 300)]) == 12 * 10 + 15 - 20
    assert spans.mark_of("idee_span_encoder_backward_end") == \
        ("encoder_backward", "end")
    assert spans.mark_of("idee_span_x_middle") is None


@pytest.mark.parametrize("kernels", [
    ["loss_begin"], ["loss_end"], ["loss_begin", "loss_begin", "loss_end",
                                   "loss_end"],
    ["step_begin", "loss_begin", "step_end"]],
    ids=["begin_alone", "end_alone", "nested_same_name", "open_at_the_end"])
def test_unpaired_marks_raise(kernels):
    marks = [(10 * i, 10 * i + 2, spans.MARK + k)
             for i, k in enumerate(kernels)]
    with pytest.raises(ValueError):
        spans.pair_marks(marks)


# ---------------------------------------------------------------- card only

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the mark kernels and CUDA graphs "
                    "have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_replays_emit_every_span_once_a_step(cuda, train):
    """A 32x32 Mamba: the first epoch runs the warm-up steps, the capture
    and replays; the second, N replays under the profiler, holds N
    instances of every span (the loss 2N), in order; the step's children
    cover 97 % of its device time, and 97 % of the device's busy time in
    the epoch falls inside the steps."""
    n = 6
    e = _epoch(train, cuda, steps=n, hw=32)
    e.run()
    assert e.fused.graph is not None
    events = _profiled(e.run, cuda=True)
    found = spans.read_spans(events)
    _check_steps(found, train, n)
    assert len(found["loss"]) == 2 * n
    total = {k: sum(b - a for a, b in v) for k, v in found.items()}
    children = sum(t for k, t in total.items()
                   if spans.PARENT.get(k) == "step")
    assert children >= 0.97 * total["step"], (children, total["step"])
    busy = spans.busy_ns(events)
    in_steps = spans.busy_ns(events, within=found["step"])
    assert in_steps >= 0.97 * busy, (in_steps, busy)
    # the marks' kernels are on the timeline as they are named
    names = {ev.name() for ev in events}
    assert {f"{spans.MARK}step_begin", f"{spans.MARK}step_end"} <= names
    np.testing.assert_equal(len(spans.device_marks(events)),
                            2 * sum(len(v) for v in found.values()))


@pytest.mark.gpu
def test_capture_pauses_the_collector(cuda):
    """CUDA forbids destroying a graph while a stream captures, and an
    earlier FusedEpoch's graph, which only a reference cycle keeps (the
    epoch and its step's closure), goes whenever the cyclic collector
    runs: the capture runs with the collector paused, and resumes it."""
    e = _epoch(True, cuda, steps=5, hw=32)
    body = e.fused.body
    seen = []

    def watched():
        if torch.cuda.is_current_stream_capturing():
            seen.append(gc.isenabled())
        body()

    e.fused.body = watched
    assert gc.isenabled()
    e.run()
    assert e.fused.graph is not None
    assert seen == [False] and gc.isenabled()
