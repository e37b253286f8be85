"""BENCHMARK.json and the files it names: every cell, configuration,
traffic and per-layer metric loads by its name, a cell added as files
alone is found, and the file keeps to the benchmark's contract."""

import json
import math
import re
import shutil

import pytest

from port_bench import harness, readers
from port_bench.trace import Summary

ROOT = harness.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "port_bench/run.py"]
    assert BENCH["paths"] == ["port_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads"):
        assert len({x["name"] for x in BENCH[k]}) == len(BENCH[k])
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_every_cell_loads_by_name():
    used = set()
    for w in BENCH["workloads"]:
        cell = harness.load_cell(w["name"])
        used.add(w["config"])
        assert w["chips"] == 1 == cell.chips
        assert len(w["why"]) <= 200
        assert cell.mode in harness.E2E
        limits = cell.workload["limits"]
        assert limits["steps_off"] == 0.0 and len(limits) >= 2
        # every cell reports setup_s, one other end-to-end metric and a
        # per-layer one
        e2e = [m["name"] for m in BENCH["end_to_end"]
               if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in e2e and harness.E2E[cell.mode] in e2e
        assert cell.per_layer
    assert used == {c["name"] for c in BENCH["configs"]}


def test_every_config_file_names_its_source():
    for c in BENCH["configs"]:
        doc = json.loads((ROOT / c["file"]).read_text())
        assert c["file"].startswith("port_bench/")
        assert doc["source"] == c["source"]
        # the cuts of scale, each with its reason and the source's value
        assert doc["reduced"] == c["reduced"] == ["times_train",
                                                  "times_test"]
        assert set(doc["cut"]) == set(doc["reduced"])
        assert all(k in doc["config"] for k in doc["reduced"])
        assert doc["config"]["dtype"] in ("float32", "bfloat16")


def test_every_cell_runs_the_weeks_its_configuration_states():
    for w in BENCH["workloads"]:
        cell = harness.load_cell(w["name"])
        span = cell.cfg["times_train" if cell.mode == "train"
                        else "times_test"]
        assert span == [1, cell.traffic["weeks"]]


def test_every_metric_has_a_reader_that_finds_nothing_elsewhere():
    """On a window with nothing in it (no kernels, samples, time or
    peak) every reader returns None, in every cell it is listed for."""
    for m in BENCH["per_layer"]:
        read = harness.load_reader(m["name"])
        for cell in m["workloads"]:
            c = harness.load_cell(cell)
            ctx = readers.Context(cfg=c.cfg, traffic=c.traffic,
                                  workload=c.workload,
                                  summary=Summary(0.0, 0.0), samples=0,
                                  peak_bytes=0)
            assert read(ctx) is None
        for cell in m["workloads"]:
            assert m["moves"] in [
                e["name"] for e in BENCH["end_to_end"]
                if cell in e.get("workloads", [cell])]


def test_a_cell_added_as_files_alone_is_found(tmp_path):
    """A new configuration, traffic, cell and per-layer metric as new
    files and manifest entries: found by name, no file edited."""
    here = tmp_path / "port_bench"
    shutil.copytree(harness.HERE / "configs", here / "configs")
    shutil.copytree(harness.HERE / "traffic", here / "traffic")
    shutil.copytree(harness.HERE / "workloads", here / "workloads")
    shutil.copytree(harness.HERE / "metrics", here / "metrics")
    conf = json.loads((here / "configs/idee-mamba-f32.json").read_text())
    conf["config"].update(d_state=[2, 2])
    (here / "configs/idee-mamba-dstate2-f32.json").write_text(
        json.dumps(conf))
    (here / "traffic/train-96.json").write_text(json.dumps(
        {"mode": "train", "height": 96, "width": 96, "weeks": 12,
         "batch_size": 1, "is_aug": True, "anomaly_rate": 0.05}))
    (here / "workloads/mamba-f32-train-dstate2-96.json").write_text(
        json.dumps({"flops_per_sample": 1, "limits": {"loss_gap": 1e-4}}))
    (here / "metrics/window_s.train.py").write_text(
        "def read(ctx):\n    return ctx.summary.window_s\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "idee-mamba-dstate2-f32",
                             "file": "port_bench/configs/"
                                     "idee-mamba-dstate2-f32.json"})
    bench["workloads"].append({"name": "mamba-f32-train-dstate2-96",
                               "config": "idee-mamba-dstate2-f32",
                               "traffic": "train-96", "chips": 1})
    bench["per_layer"].append({"name": "window_s.train", "unit": "s",
                               "workloads": ["mamba-f32-train-dstate2-96"]})
    cell = harness.load_cell("mamba-f32-train-dstate2-96", bench, here)
    assert cell.cfg["d_state"] == [2, 2]
    assert cell.traffic["height"] == 96
    assert cell.per_layer == {"window_s.train": "s"}
    ctx = readers.Context(cfg=cell.cfg, traffic=cell.traffic,
                          workload=cell.workload,
                          summary=Summary(2.5, 2.0), samples=4,
                          peak_bytes=10)
    assert harness.load_reader("window_s.train", here)(ctx) == 2.5
    assert harness.load_reader("idle_share.train", here)(ctx) == \
        pytest.approx(20.0)
    assert math.isclose(harness.load_reader("peak_mem_gb.train", here)(ctx),
                        1e-8)


def test_run_seconds_fit_the_check_at_24_cells():
    runs = 2 + 14 * 24
    total = runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200
