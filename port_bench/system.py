"""The system under test: the port's synthetic training or evaluation
epochs, built as its training driver builds them with the cube on the
device (``train/driver.py::_train_synthetic`` with ``device_data``): the
dataset over the benchmark's cube, ``DeviceLoader``, ``build_model`` with
the benchmark's weights copied in, the train state, and
``make_train_epoch`` or ``make_eval_epoch``, each epoch followed by the
driver's one metric read (``metrics_to_host``). No validation epochs,
checkpoints or image panels.

This is the only module of the benchmark that imports the port.
"""

import gc
import time
from typing import Dict, Optional

import numpy as np
import torch


def _config(cell, seed: int):
    from idee_tpu_torch.config import Config

    t = cell.traffic
    fields = dict(cell.cfg)
    fields.update(seed=seed, batch_size=t["batch_size"], is_aug=t["is_aug"],
                  x_min=0, x_max=t["width"], y_min=0, y_max=t["height"],
                  device_data=True, fused_epoch=True,
                  times_train=tuple(fields["times_train"]),
                  times_test=tuple(fields["times_test"]),
                  en_window_size=[tuple(w) for w in fields["en_window_size"]],
                  en_patch_size=tuple(fields["en_patch_size"]))
    return Config(**fields)


class System:
    """One cell's program: ``epoch()`` runs one epoch and returns its
    metrics on the host. The first epoch is recorded: ``record`` then
    holds, on the host, what each of its steps left behind, the eager
    warm-up steps and the graph replays alike (``losses``: the epoch's
    loss sums after the step; ``z``: the step's joint-head logits), Adam's
    first moments after the first step and the parameters after the epoch
    (training), and the epoch's metrics. ``parts``: the host seconds of
    the set-up's parts."""

    def __init__(self, cell, cube: Dict[str, np.ndarray],
                 weights: Dict[str, torch.Tensor], seed: int, device,
                 record: bool = True):
        t0 = time.perf_counter()
        from idee_tpu_torch.data.device import DeviceLoader
        from idee_tpu_torch.data.synthetic import (SyntheticCube,
                                                   SyntheticDataset)
        from idee_tpu_torch.models.vq_model import build_model, compute_dtype
        from idee_tpu_torch.train.state import create_train_state
        from idee_tpu_torch.train.steps import (make_eval_epoch,
                                                make_train_epoch,
                                                metrics_to_host)

        self.parts = {"port_import": time.perf_counter() - t0}
        self.device = torch.device(device)
        self._to_host = metrics_to_host
        cfg = self.cfg = _config(cell, seed)
        self.train = cell.traffic["mode"] == "train"
        t = cell.traffic
        times = cfg.times_train if self.train else cfg.times_test
        if tuple(times) != (1, t["weeks"]):
            raise ValueError(f"the configuration runs weeks {tuple(times)}, "
                             f"the traffic's cube holds 1-{t['weeks']}")
        V = cfg.in_channels_dynamic
        variables = [f"var_{v + 1:02d}" for v in range(V)]
        sc = SyntheticCube(dynamic=cube["dynamic"], anomaly=cube["anomaly"],
                           extreme=cube["extreme"], variables=variables,
                           stats=cube["stats"])
        t0 = time.perf_counter()
        ds = SyntheticDataset(
            cube=sc, times=tuple(times), variables=variables,
            variables_static=[], delta_t=cfg.delta_t, is_aug=cfg.is_aug,
            is_norm=cfg.is_norm, is_clima_scale=cfg.is_clima_scale,
            window_size=cfg.window_size, x_min=0, x_max=t["width"],
            y_min=0, y_max=t["height"], seed=seed)
        self.parts["dataset"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.loader = DeviceLoader(ds, cfg.batch_size, seed=seed,
                                   dtype=compute_dtype(cfg), device=device)
        self.samples_per_epoch = len(self.loader) * cfg.batch_size
        self.parts["loader"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        model = self.model = build_model(cfg, input_size=ds.input_size)
        self.parts["build_model"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.state = create_train_state(cfg, model, device,
                                        steps_per_epoch=len(self.loader))
        self.parts["train_state"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.params = dict(model.named_parameters())
        if set(self.params) != set(weights):
            raise RuntimeError(
                "the port's parameters are not the benchmark's: missing "
                f"{sorted(set(weights) - set(self.params))}, unknown "
                f"{sorted(set(self.params) - set(weights))}")
        with torch.no_grad():
            for k, p in self.params.items():
                if tuple(p.shape) != tuple(weights[k].shape):
                    raise RuntimeError(f"parameter {k}: the port's shape "
                                       f"{tuple(p.shape)}, the benchmark's "
                                       f"{tuple(weights[k].shape)}")
                p.copy_(weights[k])
        self.parts["weights_in"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        ts = float(ds.timestep[0])
        if self.train:
            self.fused = make_train_epoch(model, cfg, self.loader,
                                          ds.anomaly.shape, t0=ts,
                                          steps_per_epoch=len(self.loader))
        else:
            self.fused = make_eval_epoch(model, cfg, self.loader,
                                         ds.anomaly.shape, t0=ts)
        self.parts["epoch_build"] = time.perf_counter() - t0
        # what the program's step calls for its forward (a fault planted
        # in a test replaces it)
        self.forward = model.forward
        self.record: Optional[dict] = None
        self._recording = None
        if record:
            self._start_record()

    def _start_record(self) -> None:
        """Until the first epoch ends, keep copies of what each of its
        steps leaves behind: after each eager step (the capture's call of
        the step body is not one: the graph records it) and after each
        replay of the captured step. The joint-head logits are read where
        the model returns them (on the card, the graph's own output
        buffer, which every replay rewrites)."""
        fused, model = self.fused, self.model
        body, capture = fused.body, fused._capture
        opt = self.state.optimizer
        rec = {"losses": [], "z": []}
        out = {}
        marks = {"start": time.perf_counter()}

        def watched(*a, **k):
            o = self.forward(*a, **k)
            out["z"] = o.z
            return o

        def keep():
            m = fused.metrics
            rec["losses"].append({k: v.detach().clone()
                                  for k, v in m["loss_sums"].items()})
            rec["z"].append(out["z"].detach().clone())
            if self.train and "exp_avg" not in rec:
                # a step that never reached the optimizer leaves no moment
                rec["exp_avg"] = {
                    k: opt.state[p]["exp_avg"].clone() if p in opt.state
                    else torch.zeros_like(p) for k, p in self.params.items()}

        def recorded_body():
            body()
            if self.device.type == "cuda" and \
                    torch.cuda.is_current_stream_capturing():
                return
            keep()

        def recorded_capture(stream):
            marks["capture"] = time.perf_counter()
            capture(stream)
            marks["replays"] = time.perf_counter()
            fused.graph = _Kept(fused.graph, keep)

        model.forward = watched
        fused.body = recorded_body
        fused._capture = recorded_capture
        self._recording = (rec, body, marks)

    def _finish_record(self, metrics: dict) -> None:
        """The first epoch's record to the host; the program's step, graph
        and forward as they were."""
        rec, body, marks = self._recording
        self._recording = None
        fused = self.fused
        fused.body = body
        del fused._capture
        if isinstance(fused.graph, _Kept):
            fused.graph = fused.graph.graph
        self.model.forward = self.forward
        if self.train:
            rec["params"] = {k: p.detach().clone()
                             for k, p in self.params.items()}
        self.record = _to_host(rec)
        # a copy: on the CPU the host metrics share the epoch's buffers,
        # which the next epoch zeroes
        self.record["metrics"] = _copy(metrics)
        end = time.perf_counter()
        if "capture" in marks:
            self.parts.update(
                eager_steps=marks["capture"] - marks["start"],
                capture=marks["replays"] - marks["capture"],
                replays=end - marks["replays"])
        else:
            self.parts["eager_steps"] = end - marks["start"]

    def epoch(self) -> dict:
        """One epoch and its metrics on the host (the epoch's one
        synchronisation)."""
        if self.train:
            m = self._to_host(self.fused(self.state))
        else:
            m = self._to_host(self.fused())
        if self._recording is not None:
            self._finish_record(m)
        return m

    def close(self) -> None:
        """Free the program's device state."""
        for k in ("fused", "loader", "state", "params", "model",
                  "forward"):
            setattr(self, k, None)
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


class _Kept:
    """A CUDA graph whose every replay is followed by ``keep()``."""

    def __init__(self, graph, keep):
        self.graph = graph
        self.keep = keep

    def replay(self):
        self.graph.replay()
        self.keep()


def _copy(x):
    if isinstance(x, dict):
        return {k: _copy(v) for k, v in x.items()}
    return np.array(x, copy=True)


def _to_host(x):
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_to_host(v) for v in x]
    return x.cpu() if torch.is_tensor(x) else x
