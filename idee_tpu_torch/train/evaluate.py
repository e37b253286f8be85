# ------------------------------------------------------------------
"""Test/evaluation driver for the synthetic benchmark (counterpart of
idee_tpu/train/evaluate.py; reference test_synthetic.py:27-129): no-grad
loop over the test split, sigmoid > 0.5 thresholding, evaluator_synthetic
plus majority-vote driver scoring against the ground-truth anomaly cube.
"""
# ------------------------------------------------------------------

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from idee_tpu_torch import resolve_device
from idee_tpu_torch.config import Config
from idee_tpu_torch.data.loader import DataLoader
from idee_tpu_torch.data.synthetic import SyntheticCube, SyntheticDataset
from idee_tpu_torch.models.interop import load_flax_params
from idee_tpu_torch.models.vq_model import build_model, compute_dtype
from idee_tpu_torch.train.checkpoint import load_pretrained_weights
from idee_tpu_torch.train.metrics import (EvaluatorAnomalySynthetic,
                                          EvaluatorSynthetic,
                                          majority_vote_from_device)
from idee_tpu_torch.train.steps import (init_epoch_metrics, make_eval_step,
                                        metrics_to_host)
from idee_tpu_torch.utils.logging import fix_seed, get_logger, log_string


def _state_dict(cfg: Config, params: Mapping,
                model) -> Dict[str, torch.Tensor]:
    """``params`` as ``model``'s state_dict: either one already (flat keys
    with '.') or the JAX package's flax params (or variables) tree."""
    if all(isinstance(v, torch.Tensor) for v in params.values()):
        return dict(params)
    return load_flax_params(cfg, params, model)


def load_weights(model, cfg: Config, params: Optional[Mapping],
                 logger) -> None:
    """Load ``params`` (a port state_dict or the JAX package's flax
    params) into ``model``, else cfg.en_de_pretrained (the JAX package's
    params as a flax-path .npz, or a checkpoint of the port's trainer),
    else keep the random initialization from cfg.seed."""
    if params is not None:
        model.load_state_dict(_state_dict(cfg, params, model))
    elif cfg.en_de_pretrained:
        model.load_state_dict(load_pretrained_weights(
            cfg, cfg.en_de_pretrained, model))
    else:
        log_string(logger, "WARNING: no pretrained model (en_de_pretrained "
                           "unset); evaluating a random initialization")


def test_synthetic(cfg: Config, cube: Optional[SyntheticCube] = None,
                   params: Optional[Mapping] = None,
                   device=None) -> Dict:
    """Evaluate on the test split; returns extreme_f1, extreme_iou,
    driver_f1_pos, driver_iou_pos and mean_loss. ``params``: a port
    state_dict or the JAX package's flax params (default: cfg
    en_de_pretrained, else a random initialization from cfg.seed).
    ``device``: cuda unless given."""
    dev = resolve_device(device)
    logger = get_logger(cfg)
    fix_seed(cfg.seed)

    log_string(logger, "loading testing dataset ...")
    ds = SyntheticDataset(
        cube=cube, root_datacube=None if cube is not None
        else cfg.root_synthetic,
        times=cfg.times_test, is_aug=False, is_norm=cfg.is_norm,
        is_clima_scale=cfg.is_clima_scale, variables=list(cfg.variables),
        variables_static=list(cfg.variables_static), delta_t=cfg.delta_t,
        window_size=cfg.window_size, x_min=cfg.x_min, x_max=cfg.x_max,
        y_min=cfg.y_min, y_max=cfg.y_max,
    )
    log_string(logger, "# testing samples: %d" % len(ds))

    model = build_model(cfg, input_size=ds.input_size)
    load_weights(model, cfg, params, logger)
    model.to(dev)

    loader = DataLoader(ds, cfg.batch_size, device=dev,
                        keys=["x", "mask_extreme", "mask_extreme_loss",
                              "timestep"], x_dtype=compute_dtype(cfg))
    eval_step = make_eval_step(model, cfg, t0=float(ds.timestep[0]))

    evaluator = EvaluatorSynthetic(logger, "Testing")
    eval_anom = EvaluatorAnomalySynthetic(logger, "Testing", cfg.variables)

    metrics = init_epoch_metrics(ds.anomaly.shape, dev)
    for batch in loader:
        metrics = eval_step(metrics, batch)
    m = metrics_to_host(metrics)

    evaluator.update_counts(m["counts"])
    anomaly = majority_vote_from_device(m["vote_sum"], m["vote_cnt"])
    eval_anom(np.swapaxes(anomaly, 0, 1), np.swapaxes(ds.anomaly, 0, 1))
    eval_anom.get_results()
    n = max(int(m["n_steps"]), 1)
    loss_sum = float(m["loss_sums"]["loss"])
    evaluator.get_results(loss_sum / n, np.nan)

    return {
        "extreme_f1": float(np.nanmean(evaluator.F1)),
        "extreme_iou": float(np.nanmean(evaluator.iou)),
        "driver_f1_pos": float(np.nanmean(eval_anom.F1_pos)),
        "driver_iou_pos": float(np.nanmean(eval_anom.iou_pos)),
        "mean_loss": loss_sum / n,
    }
