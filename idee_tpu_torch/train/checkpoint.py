# ------------------------------------------------------------------
"""Checkpoints with ``torch.save`` (counterpart of
idee_tpu/train/checkpoint.py, which uses orbax).

The same aliases as the JAX package (best_loss_model / best_F1_model /
best_train_model / latest), each a file under
``<log_dir>/model_checkpoints/`` holding the full train state (model,
optimizer state, step, generator state) and the epoch meta, and the same
auto-resume from ``latest``. The port cannot read orbax checkpoints;
pretrained weights of the JAX package come in as a flax-path ``.npz``
(``models/interop.py::load_flax_npz``).
"""
# ------------------------------------------------------------------

import os
from typing import Any, Dict, Optional

import torch

from idee_tpu_torch.models.interop import load_flax_npz, load_flax_params
from idee_tpu_torch.train.state import TrainState


class CheckpointManager:
    """Named-alias checkpoints: best_loss_model / best_F1_model / latest."""

    ALIASES = ("best_loss_model", "best_F1_model", "best_train_model",
               "latest")

    def __init__(self, directory: str):
        self.directory = os.path.abspath(
            os.path.join(directory, "model_checkpoints"))
        os.makedirs(self.directory, exist_ok=True)

    def path(self, alias: str) -> str:
        return os.path.join(self.directory, f"{alias}.pt")

    def has(self, alias: str) -> bool:
        return os.path.exists(self.path(alias))

    def save(self, alias: str, state: TrainState, epoch: int,
             mean_loss_train: float = float("nan"),
             mean_loss_val: float = float("nan")) -> None:
        if alias not in self.ALIASES:
            raise ValueError(f"unknown checkpoint alias {alias!r}")
        payload = {
            "model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "step": state.step,
            "generator": state.generator.get_state(),
            "meta": {"epoch": epoch, "mean_loss_train": mean_loss_train,
                     "mean_loss_validation": mean_loss_val},
        }
        # write a temporary file and rename it: a kill mid-save never
        # leaves a torn checkpoint under the alias
        path = self.path(alias)
        torch.save(payload, path + ".tmp")
        os.replace(path + ".tmp", path)

    def restore(self, alias: str,
                state: TrainState) -> Optional[Dict[str, Any]]:
        """Load ``alias`` into ``state`` in place; returns {"state",
        "meta"}, or None when there is no such checkpoint."""
        if not self.has(alias):
            return None
        # on the host: load_state_dict moves the weights and the moments to
        # the parameters' device; settle_optimizer puts Adam's step counts
        # where this optimizer reads them (on the host without capturable,
        # so that it reads them without a device sync)
        payload = torch.load(self.path(alias), map_location="cpu",
                             weights_only=True)
        state.model.load_state_dict(payload["model"])
        state.optimizer.load_state_dict(payload["optimizer"])
        state.step = int(payload["step"])
        state.settle_optimizer()
        state.generator.set_state(payload["generator"])
        return {"state": state, "meta": payload["meta"]}


def load_pretrained_weights(cfg, path: str,
                            model=None) -> Dict[str, torch.Tensor]:
    """The model state_dict for cfg.en_de_pretrained: the JAX package's
    params as a flax-path ``.npz`` (checked against ``model``, default the
    VQModel of ``cfg``), or a checkpoint this module wrote."""
    if path.endswith(".npz"):
        return load_flax_params(cfg, load_flax_npz(path), model)
    return torch.load(path, map_location="cpu", weights_only=True)["model"]
