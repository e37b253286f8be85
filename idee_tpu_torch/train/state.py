# ------------------------------------------------------------------
"""Train state and optimizer (counterpart of idee_tpu/train/state.py).

Optimizer parity: the reference uses torch.optim.Adam(lr, weight_decay,
betas) (reference: train_synthetic.py:127-129), whose coupled L2 is what
the JAX package builds as optax add_decayed_weights -> scale_by_adam ->
scale_by_learning_rate; AdamW decays after the moments in both. eps is 1e-8
in both.

optax reads its schedule at the count of updates already applied, so
``TrainState.apply_gradients`` sets every group's lr from the schedule at
``step`` (the steps taken so far) before ``optimizer.step()``.

The optimizer holds exactly the JAX package's ``params`` tree: the model's
parameters. Codebook state (VQ's EMA statistics, Random_VQ's projections)
lives in buffers, which it never sees.
"""
# ------------------------------------------------------------------

from dataclasses import dataclass
from typing import Callable, Dict, List

import torch
import torch.nn as nn

from idee_tpu_torch.config import Config
from idee_tpu_torch.train.schedule import make_epoch_schedule

# minGPT-style decay exemptions (the JAX package's decay_mask; reference:
# utils/utils_train.py:73-124), matched on the last component of the
# parameter's name. The port keeps the flax names, except that its torch-
# layout layers call the flax "kernel" "weight", which decays too.
NO_DECAY_NAMES = frozenset({
    "bias", "scale", "g", "b", "relative_position_bias_table",
    "learned_embed", "row_embed", "col_embed", "A_log", "D",
    "values_per_latent"})


def param_groups(model: nn.Module, cfg: Config) -> List[Dict]:
    """One group decaying at cfg.weight_decay, or with
    cfg.use_optimizer_groups a decay group and an exempt group."""
    params = list(model.named_parameters())
    if not cfg.use_optimizer_groups:
        return [{"params": [p for _, p in params],
                 "weight_decay": cfg.weight_decay}]
    decay = [p for n, p in params
             if n.rsplit(".", 1)[-1] not in NO_DECAY_NAMES]
    exempt = [p for n, p in params
              if n.rsplit(".", 1)[-1] in NO_DECAY_NAMES]
    groups = [{"params": decay, "weight_decay": cfg.weight_decay},
              {"params": exempt, "weight_decay": 0.0}]
    return [g for g in groups if g["params"]]


def make_optimizer(cfg: Config, model: nn.Module) -> torch.optim.Optimizer:
    kw = dict(lr=cfg.lr, betas=(cfg.beta1, cfg.beta2), eps=1e-8)
    if cfg.optimizer == "Adam":
        return torch.optim.Adam(param_groups(model, cfg), **kw)
    if cfg.optimizer == "AdamW":
        return torch.optim.AdamW(param_groups(model, cfg), **kw)
    raise ValueError(f"Unexpected optimizer {cfg.optimizer}; supported: "
                     "Adam, AdamW")


@dataclass
class TrainState:
    """The model, its optimizer and lr schedule, the count of optimizer
    steps taken, and the generator that draws dropout / drop-path masks."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    generator: torch.Generator
    step: int = 0

    def apply_gradients(self) -> None:
        """One optimizer step at the lr the schedule gives for the steps
        taken so far. A parameter the loss does not reach (a frozen LFQ
        project_out, Random_VQ's encoder) steps with a zero gradient, as in
        the JAX package, whose gradient tree holds zeros there: torch's Adam
        would skip it, and so skip its weight decay."""
        lr = self.schedule(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
            for p in group["params"]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        self.optimizer.step()
        self.step += 1


def create_train_state(cfg: Config, model: nn.Module, device,
                       steps_per_epoch: int = 1) -> TrainState:
    """Move ``model`` to ``device`` and wrap it with its optimizer, the
    epoch schedule and a generator on ``device`` seeded with cfg.seed."""
    model.to(device)
    return TrainState(
        model=model, optimizer=make_optimizer(cfg, model),
        schedule=make_epoch_schedule(cfg, steps_per_epoch),
        generator=torch.Generator(device=device).manual_seed(cfg.seed))


def count_parameters(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
