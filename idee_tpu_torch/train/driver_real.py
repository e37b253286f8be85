# ------------------------------------------------------------------
"""Training and test drivers of the real-world CERRA and ERA5-Land
pipelines (counterpart of the per-step path of
idee_tpu/train/driver_real.py; reference train_CERRA.py, train_ERA5_Land.py,
test_CERRA.py, test_ERA5_Land.py).

The loop of train/driver.py with the 2-class {normal, drought} evaluator
over valid pixels, threshold 0.35, no driver ground truth (the real world
has no labelled drivers), and the best-F1 checkpoint on the drought
class's F1 (train_CERRA.py:303-305). Best-loss, best-F1 and latest
checkpoints, auto-resume from latest, per-epoch history.json and
TensorBoard scalars as in the synthetic driver. With ``device_data`` the
weeks live on the card (data/device.py::RealDeviceLoader) and the epochs
run fused (on a card as CUDA graph replays) or, with
``fused_epoch=False``, step by step over the device batches. The
``profile_dir`` hook and the image panels (probability, prediction and
target with the sea, no-vegetation and cold overlays, and the drivers)
are train/driver.py's; the val loaders carry the sea and no-vegetation
masks for the panels. Data parallelism (``mesh_shape`` under torchrun)
is train/driver.py's, with any of the three loops: each rank on its rows
of every global batch, the masked losses normalised over the global
batch, rank 0 writing; so is the ``space`` axis, with any of the three
loops: each rank on its H rows (with ``device_data`` gathered on the card
from the whole week slabs and masks every rank holds), the valid pixels
counted over the global batch.
"""
# ------------------------------------------------------------------

import contextlib
import os
import time
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from idee_tpu_torch import resolve_device
from idee_tpu_torch.config import Config, save_options
from idee_tpu_torch.data.device import RealDeviceLoader
from idee_tpu_torch.data.loader import DataLoader
from idee_tpu_torch.data.reanalysis import (ReanalysisDataset, cerra_spec,
                                            era5_land_spec)
from idee_tpu_torch.models.vq_model import build_model, compute_dtype
from idee_tpu_torch.train.checkpoint import CheckpointManager
from idee_tpu_torch.parallel import spatial
from idee_tpu_torch.train.driver import (_check_supported, activate_space,
                                         data_parallel, epoch_metrics,
                                         join_ranks, rank_output, traced,
                                         traced_epoch, use_fused)
from idee_tpu_torch.train.evaluate import load_weights
from idee_tpu_torch.train.history import flush_history, seed_history
from idee_tpu_torch.train.metrics import Evaluator
from idee_tpu_torch.train.state import count_parameters, create_train_state
from idee_tpu_torch.train.steps import metrics_to_host
from idee_tpu_torch.train.steps_real import (init_epoch_metrics_real,
                                             make_eval_epoch_real,
                                             make_eval_step_real,
                                             make_train_epoch_real,
                                             make_train_step_real)
from idee_tpu_torch.utils.logging import (StepTimer, SummaryWriter, fix_seed,
                                          get_logger, log_string)
from idee_tpu_torch.utils.vis import generate_anomaly, generate_images

# what the train and val steps read; the test step also reads the sea and
# no-vegetation masks
TRAIN_KEYS = ["x", "mask_extreme", "mask_extreme_loss", "mask_cold_surface",
              "mask_cold_surface_loss"]
TEST_KEYS = TRAIN_KEYS + ["mask_sea", "mask_no_vegetation"]


def make_reanalysis_dataset(cfg: Config, family: str, years, is_aug: bool,
                            seed: Optional[int] = None) -> ReanalysisDataset:
    """The ``family`` ("CERRA" or "ERA5_Land") dataset of ``years`` with
    cfg's crop, normalisation and labels; cfg.grid_override replaces the
    family's grid (a fixture tree smaller than the real archive)."""
    if family == "CERRA":
        spec = cerra_spec(cfg.delta_t)
        root_main, root_noaa = cfg.root_CERRA, cfg.root_NOAA_CERRA
    elif family == "ERA5_Land":
        spec = era5_land_spec(cfg.region, cfg.delta_t)
        root_main = os.path.join(cfg.root_ERA5_Land, cfg.region)
        root_noaa = os.path.join(cfg.root_NOAA, cfg.region)
    else:
        raise ValueError(family)
    if cfg.grid_override:
        spec.grid_height, spec.grid_width = cfg.grid_override
    return ReanalysisDataset(
        spec, root_main, root_noaa, nan_fill=cfg.nan_fill,
        delta_t=cfg.delta_t, is_aug=is_aug, is_shuffle=cfg.is_shuffle,
        is_clima_scale=cfg.is_clima_scale, is_norm=cfg.is_norm,
        variables=list(cfg.variables),
        variables_static=list(cfg.variables_static),
        years=list(years), threshold=cfg.threshold, alpha=cfg.alpha,
        window_size=cfg.window_size,
        x_min=cfg.x_min, x_max=cfg.x_max, y_min=cfg.y_min, y_max=cfg.y_max,
        seed=cfg.seed if seed is None else seed,
        cache_root=cfg.cache_root,
    )


def _mean_loss(m) -> float:
    return float(m["loss_sums"]["loss"]) / max(int(m["n_steps"]), 1)


def _panels_real(writer, eval_step_preds, batch, metrics, variables,
                 step: int):
    """Probability, prediction and target panels with the sea,
    no-vegetation and cold overlays, and one driver panel per variable, of
    ``batch`` (JAX idee_tpu/train/driver_real.py:264-291; reference
    train_CERRA.py:283-310)."""
    _, preds = eval_step_preds(metrics, batch)
    # under the space axis the whole H of every rank's forward
    preds = {k: spatial.gather_h(v) for k, v in preds.items()}
    host = {k: spatial.gather_h(batch[k]).float().cpu().numpy() for k in (
        "mask_extreme", "mask_cold_surface", "mask_sea",
        "mask_no_vegetation")}
    mask_valid = np.clip(1.0 - host["mask_cold_surface"], 0.0, None)
    im_pred, im_pred_c, im_target = generate_images(
        preds["pred"].float().cpu().numpy(),
        preds["pred_c"].float().cpu().numpy(), host["mask_extreme"],
        host["mask_cold_surface"], host["mask_sea"],
        host["mask_no_vegetation"], mask_valid)
    writer.add_images("probability", im_pred, step, dataformats="NHWC")
    writer.add_images("prediction", im_pred_c, step, dataformats="NHWC")
    writer.add_images("target", im_target, step, dataformats="NHWC")
    im_anom = generate_anomaly(preds["anomaly"].cpu().numpy())
    for v, var in enumerate(variables):
        writer.add_images(var, im_anom[0, v], step, dataformats="HWC")


def train_real(cfg: Config, family: str,
               train_ds: Optional[ReanalysisDataset] = None,
               val_ds: Optional[ReanalysisDataset] = None,
               device=None, mesh=None) -> Dict:
    """Train on ``family``; returns the history dict (plus the final
    TrainState under "state"). ``device``: cuda unless given. ``mesh``: a
    data-parallel mesh (parallel/mesh.py), by default made from
    cfg.mesh_shape."""
    _check_supported(cfg)
    given = mesh
    mesh, dev = data_parallel(cfg, device, mesh)
    try:
        with rank_output(mesh), contextlib.ExitStack() as scope:
            return _train_real(cfg, family, train_ds, val_ds, dev, mesh,
                               scope)
    finally:
        if mesh is not None and given is None and mesh.started:
            mesh.close()  # the process group this driver started


def _train_real(cfg, family, train_ds, val_ds, dev, mesh, scope) -> Dict:
    main = mesh is None or mesh.is_main
    logger = get_logger(cfg) if main else None
    if main:
        save_options(cfg)
    fix_seed(cfg.seed)

    log_string(logger, f"loading {family} training dataset ...")
    if train_ds is None:
        train_ds = make_reanalysis_dataset(cfg, family, cfg.years_train,
                                           cfg.is_aug)
    if val_ds is None:
        val_ds = make_reanalysis_dataset(cfg, family, cfg.years_val, False)
    log_string(logger, "# training samples: %d" % len(train_ds))
    log_string(logger, "# evaluation samples: %d" % len(val_ds))
    # the JAX driver draws item 0 to shape its parameter init, which
    # advances the augmentation RNG; drawing it here too keeps both drivers
    # on the same augmentations
    train_ds[0]
    activate_space(scope, mesh, train_ds, cfg)
    # x in the compute dtype (idee_tpu/train/driver_real.py:115-130)
    if cfg.device_data:
        # one normalised slab and mask triple per unique week on the card
        loader_kw = dict(seed=cfg.seed, dtype=compute_dtype(cfg), device=dev,
                         mesh=mesh)
        train_loader = RealDeviceLoader(train_ds, cfg.batch_size, **loader_kw)
        val_loader = RealDeviceLoader(val_ds, cfg.batch_size,
                                      with_eval_masks=True, **loader_kw)
    else:
        # the val batches also carry the sea and no-vegetation masks of the
        # image panels (JAX idee_tpu/train/driver_real.py:111-114)
        loader_kw = dict(device=dev, shuffle=True, drop_last=True,
                         seed=cfg.seed, workers=cfg.loader_workers,
                         x_dtype=compute_dtype(cfg), mesh=mesh)
        train_loader = DataLoader(train_ds, cfg.batch_size, keys=TRAIN_KEYS,
                                  **loader_kw)
        val_loader = DataLoader(val_ds, cfg.batch_size, keys=TEST_KEYS,
                                **loader_kw)

    log_string(logger, "\nloading the model ...")
    model = build_model(cfg, input_size=train_ds.input_size)
    if cfg.en_de_pretrained:
        log_string(logger,
                   f"initialize weights from {cfg.en_de_pretrained} ...")
        load_weights(model, cfg, None, logger)
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

    if use_fused(cfg):  # after the restore, as in train/driver.py
        train_epoch = make_train_epoch_real(model, cfg, train_loader)
        eval_epoch = make_eval_epoch_real(model, cfg, val_loader)
    train_step = make_train_step_real(model, cfg)
    eval_step = make_eval_step_real(model, cfg)
    eval_step_preds = make_eval_step_real(model, cfg, return_preds=True)
    writer = SummaryWriter(cfg.log_dir if main else None)
    eval_train = Evaluator(logger, "Training")
    eval_val = Evaluator(logger, "Validation")

    best_loss_train, best_loss_val, best_f1_val = np.inf, np.inf, 0.0
    history = seed_history(cfg.log_dir,
                           ["train_loss", "val_loss", "train_f1", "val_f1",
                            "steps_per_sec"], start_epoch)

    with torch.autograd.set_detect_anomaly(cfg.debug_nans):
        for epoch in range(start_epoch, cfg.n_epochs):
            log_string(logger, "################# Epoch (%s/%s) "
                       "#################" % (epoch + 1, cfg.n_epochs))
            timer = StepTimer()

            if use_fused(cfg):
                with traced_epoch(cfg, epoch, start_epoch, dev, logger):
                    t_ep = time.perf_counter()
                    # the epoch's one device sync ends its time
                    m = epoch_metrics(mesh, train_epoch(state))
                    sps = len(train_loader) / (time.perf_counter() - t_ep)
            else:
                metrics = init_epoch_metrics_real(dev)
                for batch in traced(train_loader, cfg, epoch, start_epoch,
                                    dev, logger):
                    state, metrics = train_step(state, metrics, batch)
                    timer.tick()
                sps = timer.steps_per_sec
                m = epoch_metrics(mesh, metrics)
            eval_train.update_counts(m["counts"])
            mean_loss_train = _mean_loss(m)
            eval_train.get_results(mean_loss_train, best_loss_train)
            best_loss_train = min(best_loss_train, mean_loss_train)

            last_batch = None
            if use_fused(cfg):
                m = epoch_metrics(mesh, eval_epoch())
                last_batch = eval_epoch.batch_at(-1)
            else:
                metrics = init_epoch_metrics_real(dev)
                for batch in val_loader:
                    metrics = eval_step(metrics, batch)
                    last_batch = batch
                m = epoch_metrics(mesh, metrics)
            eval_val.update_counts(m["counts"])
            mean_loss_val = _mean_loss(m)
            eval_val.get_results(mean_loss_val, best_loss_val)

            aliases = []
            if mean_loss_val <= best_loss_val:
                best_loss_val = mean_loss_val
                aliases.append("best_loss_model")
            # best F1 on the drought class (train_CERRA.py:303-305)
            f1_val = (float(eval_val.F1[1]) if np.isfinite(eval_val.F1[1])
                      else 0.0)
            if f1_val >= best_f1_val:
                best_f1_val = f1_val
                aliases.append("best_F1_model")
            for alias in aliases + ["latest"]:
                if main:
                    ckpt.save(alias, state, epoch, mean_loss_train,
                              mean_loss_val)

            # TensorBoard scalars (reference: train_CERRA.py:313-315)
            writer.add_scalars("Loss", {"train": mean_loss_train,
                                        "val": mean_loss_val}, epoch + 1)
            writer.add_scalars("IOU", {"train": float(eval_train.iou[1]),
                                       "val": float(eval_val.iou[1])},
                               epoch + 1)
            writer.add_scalars("F1", {"train": float(eval_train.F1[1]),
                                      "val": f1_val}, epoch + 1)
            if last_batch is not None:
                _panels_real(writer, eval_step_preds, last_batch,
                             init_epoch_metrics_real(dev), cfg.variables,
                             epoch + 1)
            writer.flush()

            history["train_loss"].append(mean_loss_train)
            history["val_loss"].append(mean_loss_val)
            history["train_f1"].append(float(eval_train.F1[1]))
            history["val_f1"].append(f1_val)
            history["steps_per_sec"].append(sps)
            log_string(logger, "steps/sec: %.3f" % sps)
            if main:
                flush_history(cfg.log_dir, history)

            eval_train.reset()
            eval_val.reset()
    writer.close()

    history["state"] = state
    return history


def test_real(cfg: Config, family: str, params: Optional[Mapping] = None,
              test_ds: Optional[ReanalysisDataset] = None,
              device=None) -> Dict:
    """Test protocol (reference: test_CERRA.py:95-127): the valid mask
    leaves out sea, cold surface and no-vegetation pixels; threshold 0.35.
    ``params``: a port state_dict or the JAX package's flax params
    (default: cfg.en_de_pretrained, else a random initialization from
    cfg.seed). Returns drought_f1, drought_iou, mean_f1 and mean_iou.
    ``device``: cuda unless given."""
    dev = resolve_device(device)
    logger = get_logger(cfg)
    fix_seed(cfg.seed)

    if test_ds is None:
        test_ds = make_reanalysis_dataset(cfg, family, cfg.years_test, False)
    log_string(logger, "# testing samples: %d" % len(test_ds))

    model = build_model(cfg, input_size=test_ds.input_size)
    load_weights(model, cfg, params, logger)
    model.to(dev)

    loader = DataLoader(test_ds, cfg.batch_size, device=dev, keys=TEST_KEYS,
                        seed=cfg.seed, workers=cfg.loader_workers,
                        x_dtype=compute_dtype(cfg))
    eval_step = make_eval_step_real(model, cfg, test_mode=True)
    evaluator = Evaluator(logger, "Testing")

    metrics = init_epoch_metrics_real(dev)
    for batch in loader:
        metrics = eval_step(metrics, batch)
    evaluator.update_counts(metrics_to_host(metrics)["counts"])
    evaluator.get_results(0, 0)

    return {
        "drought_f1": float(evaluator.F1[1]),
        "drought_iou": float(evaluator.iou[1]),
        "mean_f1": float(np.nanmean(evaluator.F1)),
        "mean_iou": float(np.nanmean(evaluator.iou)),
    }
