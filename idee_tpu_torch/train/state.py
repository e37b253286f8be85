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

On a card the optimizer is ``capturable``, so that a train step can run
inside a CUDA graph (train/steps.py::make_train_epoch): its step counts
live on the device, its lr is a device tensor that ``set_lr`` writes, and
Adam's bias corrections 1 - beta^t are taken on the device in float32 (as
optax takes them), not on the host in float64. On the CPU it is not
(PyTorch's capturable Adam takes only device tensors).

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
    """Adam or AdamW over ``model``'s parameters, capturable (with a device
    lr tensor) when they lie on a card."""
    kw = dict(lr=cfg.lr, betas=(cfg.beta1, cfg.beta2), eps=1e-8)
    device = next(model.parameters()).device
    if device.type == "cuda":
        kw.update(capturable=True,
                  lr=torch.tensor(float(cfg.lr), device=device))
    if cfg.optimizer == "Adam":
        opt = torch.optim.Adam(param_groups(model, cfg), **kw)
    elif cfg.optimizer == "AdamW":
        opt = torch.optim.AdamW(param_groups(model, cfg), **kw)
    else:
        raise ValueError(f"Unexpected optimizer {cfg.optimizer}; supported: "
                         "Adam, AdamW")
    # the per-step loops run this optimizer uncaptured on purpose (one
    # optimizer for both loops); PyTorch would warn about it once
    opt._warned_capturable_if_run_uncaptured = True
    return opt


@dataclass
class TrainState:
    """The model, its optimizer and lr schedule, the count of optimizer
    steps taken, and the generator that draws dropout / drop-path masks."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    generator: torch.Generator
    step: int = 0

    def set_lr(self, lr: float) -> None:
        """Every group's lr: a Python float, or on a card the device lr
        tensor, written in place (a step captured in a CUDA graph reads that
        tensor at each replay). A restored optimizer brings its saved lr
        back as a host tensor; it is replaced by one on the device."""
        for group in self.optimizer.param_groups:
            if not group["capturable"]:
                group["lr"] = lr
                continue
            device = group["params"][0].device
            cur = group["lr"]
            if isinstance(cur, torch.Tensor) and cur.device == device:
                cur.fill_(lr)
            else:
                group["lr"] = torch.tensor(float(lr), device=device)

    def settle_optimizer(self) -> None:
        """After ``optimizer.load_state_dict``: a loaded checkpoint brings
        its groups' capturable flag and lr, and Adam's step counts where
        its optimizer kept them (a checkpoint may move between the CPU and
        a card). The groups get this optimizer's mode back, the step counts
        the place that mode reads them from, and the lr the schedule's."""
        capturable = self.optimizer.defaults["capturable"]
        for group in self.optimizer.param_groups:
            group["capturable"] = capturable
            for p in group["params"]:
                st = self.optimizer.state.get(p, {})
                if isinstance(st.get("step"), torch.Tensor):
                    st["step"] = st["step"].to(
                        p.device if capturable else "cpu", torch.float32)
        self.set_lr(self.schedule(self.step))

    def update(self) -> None:
        """The optimizer step at the lr already set; host state (``step``)
        is left alone, so a CUDA graph can capture it. A parameter the loss
        does not reach (a frozen LFQ project_out, Random_VQ's encoder) steps
        with a zero gradient, as in the JAX package, whose gradient tree
        holds zeros there: torch's Adam would skip it, and so skip its
        weight decay."""
        for group in self.optimizer.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        self.optimizer.step()

    def apply_gradients(self) -> None:
        """One optimizer step at the lr the schedule gives for the steps
        taken so far."""
        self.set_lr(self.schedule(self.step))
        self.update()
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
