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

``profile_dir`` traces steps 2-7 of the first epoch with torch.profiler
(utils/logging.py::StepTrace) and so selects the per-step loop, as in JAX.
Each epoch the TensorBoard image panels (utils/vis.py) are made from the
last val batch, which the val loaders carry with its anomaly bits, through
an eval step that returns the predictions, outside any captured graph.

Not ported yet (ROADMAP.md): meshes (``mesh_shape``).
"""
# ------------------------------------------------------------------

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
from idee_tpu_torch.train.checkpoint import (CheckpointManager,
                                             load_pretrained_weights)
from idee_tpu_torch.train.history import flush_history, seed_history
from idee_tpu_torch.train.metrics import (EvaluatorAnomalySynthetic,
                                          EvaluatorSynthetic,
                                          majority_vote_from_device)
from idee_tpu_torch.train.state import count_parameters, create_train_state
from idee_tpu_torch.train.steps import (init_epoch_metrics, make_eval_epoch,
                                        make_eval_step, make_train_epoch,
                                        make_train_step, metrics_to_host)
from idee_tpu_torch.utils.logging import (StepTimer, StepTrace,
                                          SummaryWriter, fix_seed,
                                          get_logger, log_string)
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
    if cfg.mesh_shape:
        raise NotImplementedError("mesh_shape: multi-GPU is not ported yet "
                                  "(ROADMAP.md, open items)")
    if cfg.debug_nans and use_fused(cfg):
        # anomaly detection reads every gradient on the host, which a CUDA
        # graph cannot capture
        raise ValueError("debug_nans needs the per-step loop: set "
                         "fused_epoch=False (or device_data=False)")


def use_fused(cfg: Config) -> bool:
    """The fused epochs run with ``device_data`` and ``fused_epoch``, unless
    ``profile_dir`` asks for the per-step loop's step boundaries (JAX
    idee_tpu/train/driver.py:176-177)."""
    return bool(cfg.device_data and cfg.fused_epoch and not cfg.profile_dir)


def traced(loader, cfg: Config, epoch: int, start_epoch: int, device,
           logger):
    """``loader``'s batches; in the first epoch with ``profile_dir`` the
    ``profile_dir`` hook traces steps 2-7 (utils/logging.py::StepTrace)."""
    if not cfg.profile_dir or epoch != start_epoch:
        return loader
    return StepTrace(cfg.profile_dir, f"{cfg.name}_train", device,
                     logger).steps(loader)


def last_val_batch(fused, loader) -> Dict[str, torch.Tensor]:
    """The last batch of the fused val epoch just run (JAX's one extra
    fetch, idee_tpu/train/driver.py:269-271), built eagerly from the
    epoch's order and flip bits."""
    flips = None if fused.flips is None else fused.flips[-1]
    return loader.batch(fused.order[-1], flips)


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
                    device=None) -> Dict:
    """Train on the synthetic benchmark; returns the history dict (plus the
    final TrainState under "state"). ``device``: cuda unless given."""
    _check_supported(cfg)
    dev = resolve_device(device)
    logger = get_logger(cfg)
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
    # x in the compute dtype (the JAX driver's cast)
    if cfg.device_data:
        # the cube lives on the card; a step sends the host nothing
        train_loader = DeviceLoader(train_ds, cfg.batch_size, seed=cfg.seed,
                                    dtype=compute_dtype(cfg), device=dev)
        # the anomaly bits feed the image panels only
        val_loader = DeviceLoader(val_ds, cfg.batch_size, seed=cfg.seed,
                                  dtype=compute_dtype(cfg),
                                  with_anomaly=True, device=dev)
    else:
        train_loader = DataLoader(train_ds, cfg.batch_size, device=dev,
                                  keys=_KEYS, shuffle=True,
                                  drop_last=True, seed=cfg.seed,
                                  x_dtype=compute_dtype(cfg))
        val_loader = DataLoader(val_ds, cfg.batch_size, device=dev,
                                keys=_KEYS + ["mask_anomaly"], shuffle=True,
                                drop_last=True, seed=cfg.seed,
                                x_dtype=compute_dtype(cfg))

    log_string(logger, "\nloading the model ...")
    model = build_model(cfg)
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
    writer = SummaryWriter(cfg.log_dir)

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
                t_ep = time.perf_counter()
                # the epoch's one device sync ends its time
                m = metrics_to_host(train_epoch(state))
                sps = len(train_loader) / (time.perf_counter() - t_ep)
            else:
                metrics = init_epoch_metrics(train_ds.anomaly.shape, dev)
                for batch in traced(train_loader, cfg, epoch, start_epoch,
                                    dev, logger):
                    state, metrics = train_step(state, metrics, batch)
                    timer.tick()
                sps = timer.steps_per_sec
                m = metrics_to_host(metrics)
            mean_loss_train = _epoch_results(m, eval_train, eval_train_anom,
                                             train_ds.anomaly)
            eval_train_anom.get_results()
            eval_train.get_results(mean_loss_train, best_loss_train)
            best_loss_train = min(best_loss_train, mean_loss_train)

            # -- validation --
            last_batch = None
            if use_fused(cfg):
                m = metrics_to_host(eval_epoch())
                last_batch = last_val_batch(eval_epoch, val_loader)
            else:
                metrics = init_epoch_metrics(val_ds.anomaly.shape, dev)
                for batch in val_loader:
                    metrics = eval_step(metrics, batch)
                    last_batch = batch
                m = metrics_to_host(metrics)
            mean_loss_val = _epoch_results(m, eval_val, eval_val_anom,
                                           val_ds.anomaly)
            eval_val_anom.get_results()
            eval_val.get_results(mean_loss_val, best_loss_val)

            # -- checkpoints (reference policy: train_synthetic.py:302-308)
            if mean_loss_val <= best_loss_val:
                best_loss_val = mean_loss_val
                ckpt.save("best_loss_model", state, epoch, mean_loss_train,
                          mean_loss_val)
            f1_val = _nanmean(eval_val.F1)
            if f1_val >= best_f1_val:
                best_f1_val = f1_val
                ckpt.save("best_F1_model", state, epoch, mean_loss_train,
                          mean_loss_val)
            ckpt.save("latest", state, epoch, mean_loss_train, mean_loss_val)

            history["train_loss"].append(mean_loss_train)
            history["val_loss"].append(mean_loss_val)
            history["train_f1"].append(_nanmean(eval_train.F1))
            history["val_f1"].append(f1_val)
            history["train_anom_f1"].append(
                _nanmean(eval_train_anom.F1_pos))
            history["val_anom_f1"].append(_nanmean(eval_val_anom.F1_pos))
            history["steps_per_sec"].append(sps)
            log_string(logger, "steps/sec: %.3f" % sps)
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
