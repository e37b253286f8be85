"""One run of one cell: inputs from the seed, set-up, the measured window
(traced or not), the comparison with the reference, and the result line.

A cell is found by its name in BENCHMARK.json, which names its
configuration and traffic; each lives in a file of its own under
port_bench/ (configs/<config>.json, traffic/<traffic>.json), and the cell
has one too (workloads/<cell>.json: the model FLOPs per sample and the
limits of the comparison). A per-layer metric is read by
metrics/<metric>.py. Nothing here names a cell, a configuration or a
metric.
"""

import gc
import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from port_bench import check, readers, traffic, trace, weights
from port_bench.reference import data as ref_data
from port_bench.reference import model as ref_model
from port_bench.reference import steps as ref_steps

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "idee_tpu")
E2E = {"train": "train_samples_per_s", "eval": "eval_samples_per_s"}


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict         # the configuration's file
    traffic: dict        # the traffic's parameters
    workload: dict       # the cell's own file
    per_layer: Dict[str, str]   # the cell's per-layer metrics: unit

    @property
    def cfg(self) -> dict:
        return self.config["config"]

    @property
    def mode(self) -> str:
        return self.traffic["mode"]


def load_cell(name: str, bench: Optional[dict] = None,
              here: Path = HERE) -> Cell:
    """The cell ``name`` of BENCHMARK.json (or of ``bench``) with its
    files."""
    bench = bench or load_json(here.parent / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    per_layer = {m["name"]: m["unit"] for m in bench["per_layer"]
                 if name in m.get("workloads", [name])}
    return Cell(name=name, chips=entry["chips"],
                config=load_json(here.parent / conf["file"]),
                traffic=load_json(here / "traffic" /
                                  f"{entry['traffic']}.json"),
                workload=load_json(here / "workloads" / f"{name}.json"),
                per_layer=per_layer)


def load_metric(metric: str, here: Path = HERE):
    """The module metrics/<metric>.py."""
    path = here / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "port_bench.metrics." + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(metric: str, here: Path = HERE):
    """metrics/<metric>.py's ``read``."""
    return load_metric(metric, here).read


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Inputs:
    """What the benchmark makes from the seed and hands to both sides: the
    cube (traffic.py) and the weights (weights.py), the latter on the
    device and kept as made."""

    def __init__(self, cell: Cell, seed: int, device):
        t, cfg = cell.traffic, cell.cfg
        t0 = time.perf_counter()
        self.cube = traffic.make_cube(cfg["in_channels_dynamic"], t["weeks"],
                                      t["height"], t["width"], seed,
                                      t["anomaly_rate"])
        t1 = time.perf_counter()
        shapes = ref_model.shapes_for_input(
            cfg, cfg["in_channels"], (cfg["delta_t"], t["height"], t["width"]))
        self.weights = weights.make_weights(shapes, cell.config["init"], seed,
                                            device)
        self.parts = {"cube": t1 - t0, "weights": time.perf_counter() - t1}

    def normalized(self) -> np.ndarray:
        st = self.cube["stats"]
        keys = sorted(st)
        return ref_data.normalize(self.cube["dynamic"],
                                  [st[k]["median"] for k in keys],
                                  [st[k]["std"] for k in keys])


def _span(name: str):
    return torch.profiler.record_function(trace.PREFIX + name)


def _spanned(fn, name: str):
    def wrapped(*a, **k):
        with _span(name):
            return fn(*a, **k)
    return wrapped


def _to_host(x):
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_to_host(v) for v in x]
    return x.cpu() if torch.is_tensor(x) else x


def run(cell: Cell, seed: int, seconds: float, traced: bool, device,
        t_start: float, system_factory=None, detail: Optional[dict] = None
        ) -> dict:
    """One run; returns the result object. ``system_factory`` (tests)
    builds the program in place of system.py's."""
    if system_factory is None:
        from port_bench.system import System as system_factory
    device = torch.device(device)
    parts = {"imports": time.perf_counter() - t_start}
    inputs = Inputs(cell, seed, device)
    parts.update(inputs.parts)
    t0 = time.perf_counter()
    prog = system_factory(cell, inputs.cube, inputs.weights, seed, device)
    _sync(device)
    parts["program"] = time.perf_counter() - t0
    train = cell.mode == "train"
    per_epoch = prog.samples_per_epoch

    # set-up: the first epoch runs the warm-up steps, the capture and the
    # replays, and is recorded step by step: the steps compared
    epochs: List[dict] = []
    t0 = time.perf_counter()
    m = prog.epoch()
    epochs.append(_light(m))
    record = prog.record
    _sync(device)
    t_window = time.perf_counter()
    parts["first_epoch"] = t_window - t0
    parts.update({"program." + k: v for k, v in prog.parts.items()})
    setup_s = t_window - t_start

    fused = prog.fused
    prof = None
    if traced:
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        prof.start()
        prog.epoch = _spanned(prog.epoch, "epoch")
        prog.loader.epoch_order = _spanned(prog.loader.epoch_order, "order")
        prog.loader.epoch_flips = _spanned(prog.loader.epoch_flips, "order")
        prog._to_host = _spanned(prog._to_host, "metric_read")
        if fused.graph is not None:
            fused.graph = _Replays(fused.graph)
        t_window = time.perf_counter()
    samples = failed = 0
    with _span("window"):
        while True:
            m = prog.epoch()
            samples += per_epoch
            if not math.isfinite(float(m["loss_sums"]["loss"])):
                failed += per_epoch
            if not train:
                epochs.append(_light(m))
            elapsed = time.perf_counter() - t_window
            if elapsed >= seconds:
                break
    result = {"metrics": {}, "attempted": samples, "failed": failed}
    dev_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                "kind": (torch.cuda.get_device_name(device)
                         if device.type == "cuda" else "cpu"),
                "count": cell.chips,
                "memory_peak_bytes": (torch.cuda.max_memory_allocated(device)
                                      if device.type == "cuda" else 0)}
    if traced:
        prof.stop()
        summary = trace.summarize(prof.profiler.kineto_results.events())
        del prof
        ctx = readers.Context(cfg=cell.cfg,
                              traffic=cell.traffic, workload=cell.workload,
                              summary=summary, samples=samples,
                              peak_bytes=dev_info["memory_peak_bytes"])
        for name, unit in cell.per_layer.items():
            v = load_reader(name)(ctx)
            if v is not None:
                result["metrics"][name] = {"value": v, "unit": unit}
        dev_info["busy_s"] = summary.busy_s
        dev_info["window_s"] = summary.window_s
        result["breakdown"] = summary.breakdown()
    else:
        result["metrics"][E2E[cell.mode]] = {"value": samples / elapsed,
                                             "unit": "samples/s"}
        result["metrics"]["setup_s"] = {"value": setup_s, "unit": "s"}
    result["device"] = dev_info
    result["setup_parts"] = parts

    # the comparison, after the window, with the program's state freed
    last = m
    prog.close()
    del prog, fused
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = compare(cell, inputs, seed, record, epochs, last,
                      detail=detail)
    limits = cell.workload["limits"]
    result["correct"] = check.verdict(numbers, limits)
    result["checks"] = {k: {"value": numbers[k], "limit": v}
                        for k, v in limits.items()}
    result["readings"] = numbers
    return result


def compare(cell: Cell, inputs: Inputs, seed: int, record: dict, epochs,
            last, prec_name: str = "float32", detail: Optional[dict] = None
            ) -> Dict[str, float]:
    """The reference over the same inputs, and check.py's numbers.
    ``record``: the program's first epoch, step by step (system.py)."""
    cfg = cell.cfg
    x_norm = inputs.normalized()
    extreme = inputs.cube["extreme"]
    if cell.mode == "train":
        ref = ref_steps.train_steps(inputs.weights, cfg, x_norm, extreme,
                                    seed, cell.traffic["batch_size"],
                                    prec_name)
        P0 = {k: v.cpu() for k, v in inputs.weights.items()}
        ref = _to_host(ref)
        return check.train_numbers(record, ref, P0, cfg["beta1"], detail)
    ref = _to_host(ref_steps.eval_epoch(inputs.weights, cfg, x_norm, extreme,
                                        prec_name))
    order = ref_data.epoch_orders(seed, ref["n_samples"],
                                  cell.traffic["batch_size"], 1)[0]
    return check.eval_numbers(record, epochs, last, ref, order[:, 0], detail)


class _Replays:
    """A CUDA graph whose every replay is a host span."""

    def __init__(self, graph):
        self.graph = graph

    def replay(self):
        with _span("replay"):
            self.graph.replay()


def _light(m: dict) -> dict:
    """A copy of an epoch's metrics without the vote buffers (on the CPU
    the host metrics share the epoch's buffers)."""
    return {k: ({j: np.array(v, copy=True) for j, v in m[k].items()}
                if isinstance(m[k], dict) else np.array(m[k], copy=True))
            for k in ("loss_sums", "counts", "n_steps")}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)

