"""A whole run of each cell's kind, at a tiny size on the CPU (the look
for a card skipped; the port's plain versions stand in for its kernels),
with each cell's own limits: a sound run comes out correct, and a run
with its timed path broken underneath does not, for each fault the cells
can have (batch 1 and one chip: no half batch, no exchange between
chips): a step that leaves its state unchanged, and an answer altered
where it is produced. Also what a run loads: nothing of JAX or of the
JAX package, and the reference nothing of the port."""

import ast
import json
import subprocess
import sys
import time

import pytest
import torch

from port_bench import harness
from port_bench.calibrate import altered_answer
from port_bench.system import System

CELLS = ["mamba-f32-train-200", "swin-bf16-train-200",
         "mamba-f32-eval-512x832", "swin-bf16-eval-512x832"]
SEED = 2 ** 31 + 11


def tiny(name):
    """The cell with its configuration and limits, on a 16x24 cube of 11
    weeks (4 samples an epoch)."""
    cell = harness.load_cell(name)
    cell.traffic = dict(cell.traffic, height=16, width=24, weeks=11)
    cell.config = dict(cell.config, config=dict(
        cell.cfg, times_train=[1, 11], times_test=[1, 11]))
    return cell


def run(cell, factory=System):
    return harness.run(cell, SEED, 0.0, False, "cpu", time.perf_counter(),
                       system_factory=factory)


def unchanged_state(*a):
    """The optimizer never steps: the train step returns its state as it
    found it."""
    prog = System(*a)
    prog.state.optimizer.step = lambda *a, **k: None
    return prog


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    result = run(tiny(name))
    assert result["correct"], result["checks"]
    assert result["attempted"] == 4 and result["failed"] == 0
    assert set(result["metrics"]) == {harness.E2E[tiny(name).mode],
                                      "setup_s"}


@pytest.mark.parametrize("name,fault", [
    (n, f) for n in CELLS for f in (unchanged_state, altered_answer)
    if "train" in n or f is altered_answer])
def test_broken_timed_path_is_not_correct(name, fault):
    result = run(tiny(name), fault)
    assert not result["correct"], result["checks"]


SCRIPT = """
import json, sys, time
sys.path.insert(0, {root!r})
from port_bench import harness
cell = harness.load_cell("mamba-f32-eval-512x832")
cell.traffic = dict(cell.traffic, height=8, width=8, weeks=9)
cell.config = dict(cell.config, config=dict(
    cell.cfg, times_train=[1, 9], times_test=[1, 9]))
harness.run(cell, 3, 0.0, False, "cpu", time.perf_counter())
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_a_run_loads_no_jax_and_the_reference_none_of_the_port():
    out = subprocess.run(
        [sys.executable, "-c", SCRIPT.format(root=str(harness.ROOT))],
        capture_output=True, text=True, timeout=300, check=True)
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "idee_tpu_torch" in top
    assert not top & set(harness.FORBIDDEN)
    for path in harness.HERE.rglob("*.py"):
        tree = ast.parse(path.read_text())
        names = [a.name for n in ast.walk(tree)
                 if isinstance(n, ast.Import) for a in n.names]
        names += [n.module for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom) and n.module]
        top = {n.split(".")[0] for n in names}
        assert not top & set(harness.FORBIDDEN), path
        if "reference" in path.parts:
            assert "idee_tpu_torch" not in top, path


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(cuda, name):
    """The control, the reference one precision below the configuration's
    in the program's place, at the cell's own size on three seeds: each
    fails the cell's limits."""
    from port_bench import calibrate

    cell = harness.load_cell(name)
    for seed in (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103):
        nums = calibrate.control_numbers(cell, seed, cuda, {})
        assert not harness.check.verdict(nums, cell.workload["limits"]), nums
        torch.cuda.empty_cache()
