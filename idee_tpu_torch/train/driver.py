# ------------------------------------------------------------------
"""Training driver for the synthetic benchmark (counterpart of
idee_tpu/train/driver.py; reference train_synthetic.py:30-334).

The same data flow, loss composition, evaluators, per-epoch majority-vote
driver scoring, best-loss / best-F1 / latest checkpoint policy, auto-resume
from ``latest`` and per-epoch ``history.json``. A train or eval step leaves
everything on the device (loss sums, evaluator counters, the anomaly vote
timeline); the host reads one metrics tree per epoch.

Three loops, as in JAX: the host DataLoader (the default); with
``device_data`` the cube on the device (data/device.py::DeviceLoader) and
either the fused epochs (``fused_epoch``, the default: on a card one CUDA
graph replay per step, train/steps.py::FusedEpoch) or, with
``fused_epoch=False``, the per-step loop over the device batches. A fused
epoch is timed from its start to one synchronise at its end (JAX's
``nb / wall``).

``profile_dir`` traces the first train epoch with torch.profiler
(utils/spans.py::StepTrace): steps 2-7 of a per-step loop, as in JAX, or
a fused epoch whole (its warm-up steps, capture and replays, whose spans
the device marks show).
Each epoch the TensorBoard image panels (utils/vis.py) are made from the
last val batch, which the val loaders carry with its anomaly bits, through
an eval step that returns the predictions, outside any captured graph.

Data parallelism (``mesh_shape=[N]`` under ``torchrun --nproc_per_node
N``, or a ``mesh`` from parallel/mesh.py::make_mesh): each rank trains on
its rows of every global batch of ``batch_size`` with any of the three
loops, the gradients averaged over the ranks, and the epoch's counters and
vote buffers summed over them before the evaluators read them; rank 0
alone writes the log, config snapshot, checkpoints, history.json and
TensorBoard, and every rank reads ``latest`` on resume. The fused epochs
under a mesh capture the step's collectives in the CUDA graph, which
needs the NCCL backend on a card (parallel/mesh.py::check_fused_epochs:
a gloo mesh on a card raises).

The ``space`` axis (``mesh_shape=[D, S]``, ``mesh_axes=["data",
"space"]`` under ``torchrun --nproc_per_node D*S``): the driver makes
the spatial context of the dataset's H (parallel/spatial.py) before the
loaders, each rank trains on its H rows of its data rows with any of the
three loops (with ``device_data`` every rank holds the whole cube and
gathers its rows on the card; the fused epochs' step runs the halo and
shift exchanges, on a card captured with them under NCCL), the S ranks
of a data index draw the same dropout bits, and the image panels gather
the rows of their forward to every rank.
"""
# ------------------------------------------------------------------

import contextlib
import os
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch

from idee_tpu_torch import resolve_device
from idee_tpu_torch.config import Config, save_options
from idee_tpu_torch.data.device import DeviceLoader
from idee_tpu_torch.data.loader import DataLoader
from idee_tpu_torch.data.synthetic import SyntheticCube, SyntheticDataset
from idee_tpu_torch.models.vq_model import build_model, compute_dtype
from idee_tpu_torch.parallel import spatial
from idee_tpu_torch.parallel.mesh import check_fused_epochs, make_mesh
from idee_tpu_torch.train.checkpoint import (CheckpointManager,
                                             load_pretrained_weights)
from idee_tpu_torch.train.history import flush_history, seed_history
from idee_tpu_torch.train.metrics import (EvaluatorAnomalySynthetic,
                                          EvaluatorSynthetic,
                                          majority_vote_from_device)
from idee_tpu_torch.train.state import (TrainState, count_parameters,
                                        create_train_state)
from idee_tpu_torch.train.steps import (init_epoch_metrics, make_eval_epoch,
                                        make_eval_step, make_train_epoch,
                                        make_train_step, metrics_to_host)
from idee_tpu_torch.utils.logging import (StepTimer, SummaryWriter,
                                          fix_seed, get_logger, log_string)
from idee_tpu_torch.utils.spans import StepTrace
from idee_tpu_torch.utils.vis import (generate_anomaly,
                                      generate_images_synthetic)

_KEYS = ["x", "mask_extreme", "mask_extreme_loss", "timestep"]


def _nanmean(a) -> float:
    """np.nanmean without the all-NaN RuntimeWarning."""
    a = np.asarray(a, dtype=float)
    m = ~np.isnan(a)
    return float(a[m].mean()) if m.any() else float("nan")


def _make_datasets(cfg: Config, train_cube=None, val_cube=None):
    common = dict(
        variables=list(cfg.variables),
        variables_static=list(cfg.variables_static),
        delta_t=cfg.delta_t, is_norm=cfg.is_norm,
        is_clima_scale=cfg.is_clima_scale, window_size=cfg.window_size,
        x_min=cfg.x_min, x_max=cfg.x_max, y_min=cfg.y_min, y_max=cfg.y_max,
        seed=cfg.seed,
    )
    root = None if train_cube is not None else cfg.root_synthetic
    train_ds = SyntheticDataset(cube=train_cube, root_datacube=root,
                                times=cfg.times_train, is_aug=cfg.is_aug,
                                **common)
    root = None if val_cube is not None else cfg.root_synthetic
    val_ds = SyntheticDataset(cube=val_cube, root_datacube=root,
                              times=cfg.times_val, is_aug=False, **common)
    return train_ds, val_ds


def _check_supported(cfg: Config):
    if cfg.debug_nans and use_fused(cfg):
        # anomaly detection reads every gradient on the host, which a CUDA
        # graph cannot capture
        raise ValueError("debug_nans needs the per-step loop: set "
                         "fused_epoch=False (or device_data=False)")


def use_fused(cfg: Config) -> bool:
    """The fused epochs run with ``device_data`` and ``fused_epoch``; the
    ``profile_dir`` hook traces them as they run."""
    return bool(cfg.device_data and cfg.fused_epoch)


def data_parallel(cfg: Config, device, mesh):
    """(mesh, device) of a train driver: the caller's ``mesh``, else one
    made from cfg.mesh_shape (parallel/mesh.py::make_mesh, on ``device``
    or the local rank's card), else None; the device is the mesh's. With
    the fused epochs the mesh's collectives must be capturable."""
    if mesh is None and cfg.mesh_shape:
        mesh = make_mesh(cfg.mesh_shape, cfg.mesh_axes, device=device)
    if mesh is None:
        return None, resolve_device(device)
    if use_fused(cfg):
        check_fused_epochs(mesh)
    return mesh, mesh.device


@contextlib.contextmanager
def rank_output(mesh):
    """Rank 0 prints; under a mesh the other ranks' stdout is
    discarded."""
    if mesh is None or mesh.is_main:
        yield
        return
    with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
        yield
        sys.stdout.flush()


def join_ranks(mesh, state: TrainState, cfg: Config) -> None:
    """Under a mesh, after any restore: every rank takes rank 0's
    parameters and buffers, the first rank of every data index but 0
    reseeds its generator from (cfg.seed, data index, step)
    (parallel/mesh.py::Mesh.seed), so no two data indices draw the same
    dropout bits, and the other ranks of its space row take its
    generator's state, so they draw the same ones."""
    if mesh is None:
        return
    mesh.broadcast_module(state.model)
    if mesh.space_rank == 0 and not mesh.is_main:
        state.generator.manual_seed(mesh.seed(cfg.seed, state.step))
    mesh.sync_generator(state.generator)


def activate_space(scope: contextlib.ExitStack, mesh, dataset,
                   cfg: Config) -> None:
    """Under a space axis, the spatial context of ``dataset``'s H for the
    rest of ``scope`` (parallel/spatial.py), split on the encoder's window
    rows: made before the loaders, which keep the rank's rows."""
    scope.enter_context(spatial.activate(
        mesh, dataset.input_size[1], spatial.model_row_align(cfg)))


def epoch_metrics(mesh, metrics):
    """The epoch metrics on the host, summed over the ranks under a
    mesh."""
    return metrics_to_host(metrics if mesh is None
                           else mesh.reduce_metrics(metrics))


def _hook(cfg: Config, epoch: int, start_epoch: int, device,
          logger) -> Optional[StepTrace]:
    """The ``profile_dir`` hook in the first epoch, else None; under a
    mesh on rank 0 only (the caller passes logger None on the others)."""
    if not cfg.profile_dir or epoch != start_epoch or logger is None:
        return None
    return StepTrace(cfg.profile_dir, f"{cfg.name}_train", device, logger)


def traced(loader, cfg: Config, epoch: int, start_epoch: int, device,
           logger):
    """``loader``'s batches; in the first epoch with ``profile_dir`` the
    hook traces steps 2-7 of the per-step loop."""
    hook = _hook(cfg, epoch, start_epoch, device, logger)
    return loader if hook is None else hook.steps(loader)


def traced_epoch(cfg: Config, epoch: int, start_epoch: int, device,
                 logger):
    """A context; in the first epoch with ``profile_dir`` the hook traces
    the fused epoch run inside it whole."""
    hook = _hook(cfg, epoch, start_epoch, device, logger)
    return contextlib.nullcontext() if hook is None else hook.whole()


def _epoch_results(m, evaluator, eval_anom, gt_anomaly) -> float:
    """Fold one epoch's metrics (on the host) into the evaluators; returns
    the mean loss."""
    evaluator.update_counts(m["counts"])
    anomaly = majority_vote_from_device(m["vote_sum"], m["vote_cnt"])
    eval_anom(np.swapaxes(anomaly, 0, 1), np.swapaxes(gt_anomaly, 0, 1))
    n = max(int(m["n_steps"]), 1)
    return float(m["loss_sums"]["loss"]) / n


def _panels(writer, eval_step_preds, batch, metrics, variables, step: int):
    """The extremes panel (probability | prediction | target) and one
    driver panel (prediction | ground truth) per variable of ``batch``
    (JAX idee_tpu/train/driver.py:315-333)."""
    _, preds = eval_step_preds(metrics, batch)
    # under the space axis the whole H of every rank's forward
    preds = {k: spatial.gather_h(v) for k, v in preds.items()}
    batch = {k: spatial.gather_h(batch[k]) for k in ("mask_extreme",
                                                     "mask_anomaly")}
    pred = preds["pred"][:, 0].float().cpu().numpy()
    pred_c = preds["pred_c"][:, 0].float().cpu().numpy()
    im_p, im_c, im_t = generate_images_synthetic(
        pred, pred_c, batch["mask_extreme"].cpu().numpy())
    writer.add_images("extremes", np.concatenate([im_p, im_c, im_t], axis=2),
                      step, dataformats="NHWC")
    im_a = np.concatenate([
        generate_anomaly(preds["anomaly"].cpu().numpy()),
        generate_anomaly(batch["mask_anomaly"].cpu().numpy())], axis=2)
    for v, var in enumerate(variables):
        writer.add_images(var, im_a[0, v], step, dataformats="HWC")


def train_synthetic(cfg: Config,
                    train_cube: Optional[SyntheticCube] = None,
                    val_cube: Optional[SyntheticCube] = None,
                    device=None, mesh=None) -> Dict:
    """Train on the synthetic benchmark; returns the history dict (plus the
    final TrainState under "state"). ``device``: cuda unless given.
    ``mesh``: a data-parallel mesh (parallel/mesh.py), by default made from
    cfg.mesh_shape."""
    _check_supported(cfg)
    given = mesh
    mesh, dev = data_parallel(cfg, device, mesh)
    try:
        with rank_output(mesh), contextlib.ExitStack() as scope:
            return _train_synthetic(cfg, train_cube, val_cube, dev, mesh,
                                    scope)
    finally:
        if mesh is not None and given is None and mesh.started:
            mesh.close()  # the process group this driver started


def _train_synthetic(cfg, train_cube, val_cube, dev, mesh, scope) -> Dict:
    main = mesh is None or mesh.is_main
    logger = get_logger(cfg) if main else None
    if main:
        save_options(cfg)
    fix_seed(cfg.seed)

    log_string(logger, "loading training dataset ...")
    train_ds, val_ds = _make_datasets(cfg, train_cube, val_cube)
    log_string(logger, "# training samples: %d" % len(train_ds))
    log_string(logger, "# evaluation samples: %d" % len(val_ds))
    # the JAX driver draws item 0 to shape its parameter init, which
    # advances the augmentation RNG; drawing it here too keeps both drivers
    # on the same augmentations
    train_ds[0]
    activate_space(scope, mesh, train_ds, cfg)
    # x in the compute dtype (the JAX driver's cast)
    if cfg.device_data:
        # the cube lives on the card; a step sends the host nothing
        train_loader = DeviceLoader(train_ds, cfg.batch_size, seed=cfg.seed,
                                    dtype=compute_dtype(cfg), device=dev,
                                    mesh=mesh)
        # the anomaly bits feed the image panels only
        val_loader = DeviceLoader(val_ds, cfg.batch_size, seed=cfg.seed,
                                  dtype=compute_dtype(cfg),
                                  with_anomaly=True, device=dev, mesh=mesh)
    else:
        train_loader = DataLoader(train_ds, cfg.batch_size, device=dev,
                                  keys=_KEYS, shuffle=True,
                                  drop_last=True, seed=cfg.seed,
                                  x_dtype=compute_dtype(cfg), mesh=mesh)
        val_loader = DataLoader(val_ds, cfg.batch_size, device=dev,
                                keys=_KEYS + ["mask_anomaly"], shuffle=True,
                                drop_last=True, seed=cfg.seed,
                                x_dtype=compute_dtype(cfg), mesh=mesh)

    log_string(logger, "\nloading the model ...")
    model = build_model(cfg, input_size=train_ds.input_size)
    if cfg.en_de_pretrained:
        log_string(logger,
                   f"initialize weights from {cfg.en_de_pretrained} ...")
        model.load_state_dict(
            load_pretrained_weights(cfg, cfg.en_de_pretrained))
    state = create_train_state(cfg, model, dev,
                               steps_per_epoch=len(train_loader))
    log_string(logger, "all parameters: %d\n" % count_parameters(model))

    ckpt = CheckpointManager(cfg.log_dir)
    start_epoch = 0
    restored = ckpt.restore("latest", state)
    if restored is not None:
        start_epoch = int(restored["meta"]["epoch"]) + 1
        log_string(logger, f"auto-resumed from epoch {start_epoch}")
    join_ranks(mesh, state, cfg)

    t0_train, t0_val = float(train_ds.timestep[0]), float(val_ds.timestep[0])
    if use_fused(cfg):
        # made after the restore: a capture reads the restored optimizer
        # state
        train_epoch = make_train_epoch(model, cfg, train_loader,
                                       train_ds.anomaly.shape, t0=t0_train,
                                       steps_per_epoch=len(train_loader))
        eval_epoch = make_eval_epoch(model, cfg, val_loader,
                                     val_ds.anomaly.shape, t0=t0_val)
    train_step = make_train_step(model, cfg, t0=t0_train,
                                 steps_per_epoch=len(train_loader))
    eval_step = make_eval_step(model, cfg, t0=t0_val)
    eval_step_preds = make_eval_step(model, cfg, t0=t0_val,
                                     return_preds=True)
    writer = SummaryWriter(cfg.log_dir if main else None)

    eval_train = EvaluatorSynthetic(logger, "Training")
    eval_val = EvaluatorSynthetic(logger, "Validation")
    eval_train_anom = EvaluatorAnomalySynthetic(logger, "Training",
                                                cfg.variables)
    eval_val_anom = EvaluatorAnomalySynthetic(logger, "Validation",
                                              cfg.variables)

    best_loss_train, best_loss_val = np.inf, np.inf
    best_f1_val = 0.0
    history = seed_history(cfg.log_dir,
                           ["train_loss", "val_loss", "train_f1", "val_f1",
                            "train_anom_f1", "val_anom_f1",
                            "steps_per_sec"], start_epoch)

    with torch.autograd.set_detect_anomaly(cfg.debug_nans):
        for epoch in range(start_epoch, cfg.n_epochs):
            log_string(logger, "################# Epoch (%s/%s) "
                       "#################" % (epoch + 1, cfg.n_epochs))
            timer = StepTimer()

            # -- train epoch: device-resident accumulation --
            if use_fused(cfg):
                with traced_epoch(cfg, epoch, start_epoch, dev, logger):
                    t_ep = time.perf_counter()
                    # the epoch's one device sync ends its time
                    m = epoch_metrics(mesh, train_epoch(state))
                    sps = len(train_loader) / (time.perf_counter() - t_ep)
            else:
                metrics = init_epoch_metrics(train_ds.anomaly.shape, dev)
                for batch in traced(train_loader, cfg, epoch, start_epoch,
                                    dev, logger):
                    state, metrics = train_step(state, metrics, batch)
                    timer.tick()
                sps = timer.steps_per_sec
                m = epoch_metrics(mesh, metrics)
            mean_loss_train = _epoch_results(m, eval_train, eval_train_anom,
                                             train_ds.anomaly)
            eval_train_anom.get_results()
            eval_train.get_results(mean_loss_train, best_loss_train)
            best_loss_train = min(best_loss_train, mean_loss_train)

            # -- validation --
            last_batch = None
            if use_fused(cfg):
                m = epoch_metrics(mesh, eval_epoch())
                # the epoch's last batch (JAX's one extra fetch,
                # idee_tpu/train/driver.py:269-271)
                last_batch = eval_epoch.batch_at(-1)
            else:
                metrics = init_epoch_metrics(val_ds.anomaly.shape, dev)
                for batch in val_loader:
                    metrics = eval_step(metrics, batch)
                    last_batch = batch
                m = epoch_metrics(mesh, metrics)
            mean_loss_val = _epoch_results(m, eval_val, eval_val_anom,
                                           val_ds.anomaly)
            eval_val_anom.get_results()
            eval_val.get_results(mean_loss_val, best_loss_val)

            # -- checkpoints (reference policy: train_synthetic.py:302-308)
            aliases = []
            if mean_loss_val <= best_loss_val:
                best_loss_val = mean_loss_val
                aliases.append("best_loss_model")
            f1_val = _nanmean(eval_val.F1)
            if f1_val >= best_f1_val:
                best_f1_val = f1_val
                aliases.append("best_F1_model")
            for alias in aliases + ["latest"]:
                if main:
                    ckpt.save(alias, state, epoch, mean_loss_train,
                              mean_loss_val)

            history["train_loss"].append(mean_loss_train)
            history["val_loss"].append(mean_loss_val)
            history["train_f1"].append(_nanmean(eval_train.F1))
            history["val_f1"].append(f1_val)
            history["train_anom_f1"].append(
                _nanmean(eval_train_anom.F1_pos))
            history["val_anom_f1"].append(_nanmean(eval_val_anom.F1_pos))
            history["steps_per_sec"].append(sps)
            log_string(logger, "steps/sec: %.3f" % sps)
            if main:
                flush_history(cfg.log_dir, history)

            # -- TensorBoard scalars (reference: train_synthetic.py:310-319)
            writer.add_scalars("Loss", {"train": mean_loss_train,
                                        "val": mean_loss_val}, epoch + 1)
            writer.add_scalars("F1", {"train": history["train_f1"][-1],
                                      "val": f1_val}, epoch + 1)
            writer.add_scalars("IOU", {"train": _nanmean(eval_train.iou),
                                       "val": _nanmean(eval_val.iou)},
                               epoch + 1)
            if last_batch is not None:
                # last-batch image panels (reference:
                # train_synthetic.py:283-299)
                _panels(writer, eval_step_preds, last_batch,
                        init_epoch_metrics(val_ds.anomaly.shape, dev),
                        cfg.variables, epoch + 1)
            writer.flush()

            for ev in (eval_train, eval_val, eval_train_anom, eval_val_anom):
                ev.reset()
    writer.close()

    history["state"] = state
    return history
