# ------------------------------------------------------------------
"""One rank of a data-parallel run of the port, for
tests/test_torch_parallel.py and chip_smoke.py's phase ``train_ddp``.

The caller starts one process per rank with RANK, WORLD_SIZE and
LOCAL_RANK set as torchrun sets them:

    python tests/torch_parallel_worker.py JOBS.pt INIT OUT_DIR [BACKEND]

JOBS.pt holds a list of jobs (``torch.save``); INIT is the process group's
``init_method`` (``file://...``, or ``env://`` with MASTER_ADDR /
MASTER_PORT); every rank writes its results to OUT_DIR/rank<r>.pt. A job
is a dict:

* ``steps``: ``cfg`` (a Config dict), ``state_dict`` (the model's start),
  ``batches`` (global batches of numpy arrays), ``real`` (the real-world
  step); the rank trains on its rows of each batch, one step each, and
  returns the losses and metrics of every step made global
  (``Mesh.reduce_metrics``), the first step's averaged gradients, the
  state_dict after the steps and the kernel launches of its steps;
* ``driver``: ``cfg`` (with ``mesh_shape``) for ``train_synthetic``;
  returns the history and the calls each rank made to the functions that
  write files;
* ``train_real``: ``cfg`` (with ``mesh_shape``) for ``train_real`` on
  ``family``'s tree; returns the history.

Both driver kinds also return the final step count and state_dict; with
``device_data`` and ``fused_epoch`` in ``cfg`` they run the fused epochs.

Imports torch, numpy and the port only (no JAX).
"""
# ------------------------------------------------------------------

import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from idee_tpu_torch.config import Config  # noqa: E402
from idee_tpu_torch.kernels import selective_scan, window_attention  # noqa
from idee_tpu_torch.models.vq_model import build_model  # noqa: E402
from idee_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from idee_tpu_torch.train import driver, driver_real  # noqa: E402
from idee_tpu_torch.train.state import create_train_state  # noqa: E402
from idee_tpu_torch.train.steps import (init_epoch_metrics,  # noqa: E402
                                        make_train_step)
from idee_tpu_torch.train.steps_real import (  # noqa: E402
    init_epoch_metrics_real, make_train_step_real)

T_LINE = 20  # the timeline slots of the step jobs' vote buffers


def _launches():
    return {**selective_scan.launches, **window_attention.launches}


def run_steps(job, mesh):
    cfg = Config.from_dict(job["cfg"])
    dev = mesh.device
    model = build_model(cfg)
    model.load_state_dict(job["state_dict"])
    state = create_train_state(cfg, model, dev, steps_per_epoch=3)
    driver.join_ranks(mesh, state, cfg)
    if job.get("real"):
        step = make_train_step_real(model, cfg)
    else:
        step = make_train_step(model, cfg, t0=1.0, steps_per_epoch=3)
    out = {"losses": [], "metrics": []}
    before = _launches()
    for b in job["batches"]:
        rows = mesh.rows(len(b["x"]))
        batch = {k: torch.from_numpy(v[rows]).to(dev) for k, v in b.items()}
        if "x" in batch and cfg.dtype == "bfloat16":
            batch["x"] = batch["x"].to(torch.bfloat16)
        metrics = (init_epoch_metrics_real(dev) if job.get("real") else
                   init_epoch_metrics((cfg.in_channels_dynamic, T_LINE,
                                       cfg.y_max, cfg.x_max), dev))
        state, metrics = step(state, metrics, batch)
        m = driver.epoch_metrics(mesh, metrics)
        out["losses"].append(float(m["loss_sums"]["loss"]))
        out["metrics"].append(m)
        out.setdefault("grads", {k: p.grad.detach().cpu().clone()
                                 for k, p in model.named_parameters()
                                 if p.grad is not None})
    after = _launches()
    out["launches"] = {k: after[k] - before.get(k, 0) for k in after
                       if after[k] != before.get(k, 0)}
    out["state_dict"] = {k: v.detach().cpu()
                         for k, v in model.state_dict().items()}
    return out


def run_driver(job, mesh):
    calls = {"save": 0, "flush_history": 0, "save_options": 0}

    def counted(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    save = driver.CheckpointManager.save
    flush, options = driver.flush_history, driver.save_options
    driver.CheckpointManager.save = counted("save", save)
    driver.flush_history = counted("flush_history", flush)
    driver.save_options = counted("save_options", options)
    try:
        cfg = Config.from_dict(job["cfg"])
        hist = driver.train_synthetic(cfg, device=str(mesh.device))
    finally:
        driver.CheckpointManager.save = save
        driver.flush_history, driver.save_options = flush, options
    return dict(_finished(hist), calls=calls)


def run_train_real(job, mesh):
    cfg = Config.from_dict(job["cfg"])
    return _finished(driver_real.train_real(cfg, job.get("family", "CERRA"),
                                            device=str(mesh.device)))


def _finished(hist):
    state = hist.pop("state")
    return {"history": hist, "step": state.step,
            "state_dict": {k: v.detach().cpu()
                           for k, v in state.model.state_dict().items()}}


RUNS = {"steps": run_steps, "driver": run_driver,
        "train_real": run_train_real}


def main(argv):
    jobs_path, init, out_dir = argv[:3]
    backend = argv[3] if len(argv) > 3 else None
    torch.set_num_threads(1)
    jobs = torch.load(jobs_path, weights_only=False)
    device = jobs[0].get("device", "cpu")
    mesh = make_mesh([int(os.environ["WORLD_SIZE"])], ["data"],
                     device=device, backend=backend, init_method=init)
    results = []
    try:
        for job in jobs:
            results.append(RUNS[job["kind"]](job, mesh))
        torch.save(results, os.path.join(out_dir, f"rank{mesh.rank}.pt"))
    finally:
        mesh.close()


if __name__ == "__main__":
    main(sys.argv[1:])
