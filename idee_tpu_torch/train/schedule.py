# ------------------------------------------------------------------
"""Learning-rate schedules with timm-equivalent semantics (counterpart of
idee_tpu/train/schedule.py).

The reference steps timm's CosineLRScheduler(t_initial=n_epochs,
warmup_lr_init, warmup_t, warmup_prefix=False, cycle_limit=1) once per
epoch (reference: train_synthetic.py:331, utils/utils_train.py:156-167).
Here, as in the JAX package, the schedule is a function of the optimizer
step, floored to whole epochs; it is plain Python on the step count, read
on the host before each optimizer step.

The 'step' schedule is the intended staircase decay (the reference's
StepLRScheduler is a no-op as driven; see the JAX module).
"""
# ------------------------------------------------------------------

import math
from typing import Callable

from idee_tpu_torch.config import Config


def cosine_epoch_lr(epoch: float, *, base_lr: float, lr_min: float,
                    warmup_lr_init: float, warmup_t: int,
                    t_initial: int) -> float:
    """timm CosineLRScheduler._get_lr for one cycle, warmup_prefix=False."""
    if epoch < warmup_t:
        return warmup_lr_init + epoch * (
            (base_lr - warmup_lr_init) / max(warmup_t, 1))
    return lr_min + 0.5 * (base_lr - lr_min) * (
        1.0 + math.cos(math.pi * epoch / t_initial))


def step_epoch_lr(epoch: float, *, base_lr: float, decay_t: int,
                  decay_rate: float, warmup_lr_init: float,
                  warmup_t: int) -> float:
    if epoch < warmup_t:
        return warmup_lr_init + epoch * (
            (base_lr - warmup_lr_init) / max(warmup_t, 1))
    return base_lr * decay_rate ** math.floor(epoch / decay_t)


def make_epoch_schedule(cfg: Config,
                        steps_per_epoch: int) -> Callable[[int], float]:
    """fn(step) -> lr, constant within each epoch of ``steps_per_epoch``
    optimizer steps."""
    spe = max(int(steps_per_epoch), 1)
    if cfg.lr_scheduler == "cosine":
        def fn(step: int) -> float:
            return cosine_epoch_lr(
                step // spe, base_lr=cfg.lr, lr_min=cfg.lr_min,
                warmup_lr_init=cfg.lr_warmup, warmup_t=cfg.lr_warmup_epochs,
                t_initial=cfg.n_epochs)
        return fn
    if cfg.lr_scheduler == "step":
        def fn(step: int) -> float:
            return step_epoch_lr(
                step // spe, base_lr=cfg.lr, decay_t=cfg.lr_decay_step,
                decay_rate=cfg.lr_decay_rate, warmup_lr_init=cfg.lr_warmup,
                warmup_t=cfg.lr_warmup_epochs)
        return fn
    raise ValueError(
        f"unsupported lr_scheduler {cfg.lr_scheduler!r} (step|cosine)")
