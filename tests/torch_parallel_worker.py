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
  state_dict after the steps, the kernel launches of its steps, each
  step's seconds (synchronised) and on a card the job's peak allocated
  bytes;
* ``driver``: ``cfg`` (with ``mesh_shape``) for ``train_synthetic``;
  returns the history and the calls each rank made to the functions that
  write files;
* ``train_real``: ``cfg`` (with ``mesh_shape``) for ``train_real`` on
  ``family``'s tree (with ``items`` (n_train, n_val) its training and
  validation sets cut to their first weeks, after the shuffle); returns
  the history;
* ``device_batches``: the device loaders (data/device.py) of
  ``cfg``'s training and validation sets (synthetic, or with ``family``
  the real-world tree's), made as the drivers make them, inside the
  spatial context of their H; returns the rank's rows [lo, hi) and the
  batches of one epoch of each loader, on the CPU;
* ``ops``: the space axis's exchanges (parallel/spatial.py) on the rank's
  rows of ``x`` (a global numpy array, H along ``dim``; the context's H
  ``H``, default all of x's, split on ``align``): for each of ``ops``
  (("halo", before, after, mode) or ("roll", shift, H_total), the last
  rank's rows reaching H_total) the output and the gradient of
  sum(output * the rank's span of the op's weight in ``weights``).

Both driver kinds also return the final step count and state_dict, the
run's seconds, its kernel launches and on a card its peak allocated
bytes; with
``device_data`` and ``fused_epoch`` in ``cfg`` they run the fused epochs.

The mesh is the first job's ``mesh_shape`` over ``mesh_axes`` (default:
every rank on the ``data`` axis). Under a ``space`` axis the ``steps``
jobs run inside the spatial context of their batches' H and each rank
keeps its H rows of every batch leaf (parallel/spatial.py).

Imports torch, numpy and the port only (no JAX).
"""
# ------------------------------------------------------------------

import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from idee_tpu_torch.config import Config  # noqa: E402
from idee_tpu_torch.data.device import (DeviceLoader,  # noqa: E402
                                        RealDeviceLoader)
from idee_tpu_torch.kernels import selective_scan, window_attention  # noqa
from idee_tpu_torch.models.vq_model import build_model  # noqa: E402
from idee_tpu_torch.parallel import spatial  # noqa: E402
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
    out = {"losses": [], "metrics": [], "step_s": []}
    H = job["batches"][0]["x"].shape[-2]
    card = dev.type == "cuda"
    if card:
        torch.cuda.reset_peak_memory_stats(dev)
    before = _launches()
    with spatial.activate(mesh, H, spatial.model_row_align(cfg)) as ctx:
        for b in job["batches"]:
            rows = mesh.rows(len(b["x"]))
            part = spatial.shard_rows({k: v[rows] for k, v in b.items()},
                                      ctx)
            batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                     for k, v in part.items()}
            if "x" in batch and cfg.dtype == "bfloat16":
                batch["x"] = batch["x"].to(torch.bfloat16)
            metrics = (init_epoch_metrics_real(dev) if job.get("real") else
                       init_epoch_metrics((cfg.in_channels_dynamic, T_LINE,
                                           H, cfg.x_max), dev))
            t0 = time.perf_counter()
            state, metrics = step(state, metrics, batch)
            if card:
                torch.cuda.synchronize(dev)
            out["step_s"].append(time.perf_counter() - t0)
            m = driver.epoch_metrics(mesh, metrics)
            out["losses"].append(float(m["loss_sums"]["loss"]))
            out["metrics"].append(m)
            out.setdefault("grads", {k: p.grad.detach().cpu().clone()
                                     for k, p in model.named_parameters()
                                     if p.grad is not None})
        out["rows"] = None if ctx is None else (ctx.lo, ctx.hi)
    after = _launches()
    if card:
        out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
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
        out = _measured(mesh, lambda: driver.train_synthetic(
            cfg, device=str(mesh.device)))
    finally:
        driver.CheckpointManager.save = save
        driver.flush_history, driver.save_options = flush, options
    return dict(out, calls=calls)


def run_train_real(job, mesh):
    cfg = Config.from_dict(job["cfg"])
    family = job.get("family", "CERRA")
    sets = {}
    if job.get("items"):
        for key, years, aug, n in (
                ("train_ds", cfg.years_train, cfg.is_aug, job["items"][0]),
                ("val_ds", cfg.years_val, False, job["items"][1])):
            ds = driver_real.make_reanalysis_dataset(cfg, family, years, aug)
            ds.files = ds.files[:n]
            sets[key] = ds
    return _measured(mesh, lambda: driver_real.train_real(
        cfg, family, device=str(mesh.device), **sets))


def _measured(mesh, run):
    """``run()``'s history, final step and state_dict, with its seconds,
    the kernel launches it made and on a card its peak allocated
    bytes."""
    card = mesh.device.type == "cuda"
    if card:
        torch.cuda.reset_peak_memory_stats(mesh.device)
    before = _launches()
    t0 = time.perf_counter()
    hist = run()
    if card:
        torch.cuda.synchronize(mesh.device)
    seconds = time.perf_counter() - t0
    after = _launches()
    state = hist.pop("state")
    out = {"history": hist, "step": state.step, "seconds": seconds,
           "state_dict": {k: v.detach().cpu()
                          for k, v in state.model.state_dict().items()},
           "launches": {k: after[k] - before.get(k, 0) for k in after
                        if after[k] != before.get(k, 0)}}
    if card:
        out["peak_bytes"] = torch.cuda.max_memory_allocated(mesh.device)
    return out


def run_device_batches(job, mesh):
    cfg = Config.from_dict(job["cfg"])
    family = job.get("family")
    if family:
        train_ds = driver_real.make_reanalysis_dataset(
            cfg, family, cfg.years_train, cfg.is_aug)
        val_ds = driver_real.make_reanalysis_dataset(cfg, family,
                                                     cfg.years_val, False)
        make = RealDeviceLoader
        extra = {"with_eval_masks": True}
    else:
        train_ds, val_ds = driver._make_datasets(cfg)
        make, extra = DeviceLoader, {"with_anomaly": True}
    kw = dict(seed=cfg.seed, device=mesh.device, mesh=mesh)
    with spatial.activate(mesh, train_ds.input_size[1],
                          spatial.model_row_align(cfg)) as ctx:
        loaders = (make(train_ds, cfg.batch_size, **kw),
                   make(val_ds, cfg.batch_size, **extra, **kw))
        epochs = [[{k: v.cpu() for k, v in b.items()} for b in loader]
                  for loader in loaders]
    return {"rows": (ctx.lo, ctx.hi), "train": epochs[0],
            "val": epochs[1]}


def run_ops(job, mesh):
    dim, x = job["dim"], torch.from_numpy(job["x"])
    out = []
    with spatial.activate(mesh, job.get("H", x.shape[dim]),
                          job.get("align", 1)) as ctx:
        for op, w in zip(job["ops"], job["weights"]):
            if op[0] == "halo":
                n = ctx.rows
                span = n + op[1] + op[2]
            else:  # the last rank's rows reach the roll's (padded) H
                n = span = (op[2] if ctx.last else ctx.hi) - ctx.lo
            local = x.narrow(dim, ctx.lo, n).clone().requires_grad_()
            if op[0] == "halo":
                y = spatial.halo_pad_h(local, dim, *op[1:])
            else:
                y = spatial.roll_h(local, dim, *op[1:])
            w = torch.from_numpy(w).narrow(dim, ctx.lo, span)
            (y * w).sum().backward()
            out.append({"y": y.detach(), "grad": local.grad,
                        "rows": (ctx.lo, ctx.lo + n)})
    return out


RUNS = {"steps": run_steps, "driver": run_driver,
        "train_real": run_train_real, "device_batches": run_device_batches,
        "ops": run_ops}


def main(argv):
    jobs_path, init, out_dir = argv[:3]
    backend = argv[3] if len(argv) > 3 else None
    torch.set_num_threads(1)
    jobs = torch.load(jobs_path, weights_only=False)
    device = jobs[0].get("device", "cpu")
    shape = jobs[0].get("mesh_shape", [int(os.environ["WORLD_SIZE"])])
    axes = ["data", "space"][:len(shape)]
    mesh = make_mesh(shape, axes, device=device, backend=backend,
                     init_method=init)
    results = []
    try:
        for job in jobs:
            results.append(RUNS[job["kind"]](job, mesh))
        torch.save(results, os.path.join(out_dir, f"rank{mesh.rank}.pt"))
    finally:
        mesh.close()


if __name__ == "__main__":
    main(sys.argv[1:])
