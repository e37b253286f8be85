"""Plain reference of the synthetic data path: the per-variable
normalisation of the cube, each epoch's sample order and augmentation
bits, the batch of a sample (the time-reversed window, its extreme masks,
the 180-degree rotation and flip), and the epoch counters that a step adds
its outputs to.

The order and the bits follow the data path's documented streams: one
``numpy.random.default_rng(seed)`` that draws ``permutation(n)`` once per
epoch, and per epoch a ``default_rng((seed, epoch))`` that draws three
bits per position, read as (rotate by 180 degrees, flip, flip the last
axis rather than the one before it).
"""

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch


def normalize(dynamic: np.ndarray, medians, stds) -> np.ndarray:
    """[V, T, H, W] raw -> (x - the variable's median) / its std, clipped
    to +-10."""
    x = dynamic.astype(np.float32).copy()
    for v, (m, s) in enumerate(zip(medians, stds)):
        x[v] = (x[v] - m) / s
    return np.clip(x, -10.0, 10.0)


def epoch_orders(seed: int, n: int, batch: int, epochs: int
                 ) -> List[np.ndarray]:
    """The [nb, batch] sample order of each of the first ``epochs``
    epochs."""
    rng = np.random.default_rng(seed)
    nb = n // batch
    return [rng.permutation(n)[:nb * batch].reshape(nb, batch)
            for _ in range(epochs)]


def epoch_bits(seed: int, epoch: int, nb: int, batch: int) -> np.ndarray:
    """[nb, batch, 3] augmentation bits of the (1-based) epoch."""
    rng = np.random.default_rng((seed, epoch))
    return rng.integers(0, 2, (nb, batch, 3)).astype(bool)


def _augment(a: np.ndarray, bits: Optional[np.ndarray]) -> np.ndarray:
    """Rotate the last two axes by 180 degrees if bits[0], then, if
    bits[1], flip the last axis (bits[2]) or the one before it."""
    if bits is None:
        return a
    if bits[0]:
        a = np.rot90(a, k=2, axes=(-1, -2))
    if bits[1]:
        a = np.flip(a, axis=-1 if bits[2] else -2)
    return a


def sample(x_norm: np.ndarray, extreme: np.ndarray, idx: int, dt: int,
           bits: Optional[np.ndarray]) -> Dict[str, np.ndarray]:
    """Sample ``idx``: x [V, 1, dt, H, W] (index 0 the target week idx +
    dt - 1), mask_extreme and mask_extreme_loss [H, W]."""
    x = np.flip(x_norm[:, idx:idx + dt], 1)[:, None]
    me = extreme[idx + dt - 1].astype(np.float32)
    me = np.where(me > 1, 0.0, me)
    mel = np.clip(extreme[idx:idx + dt].astype(np.float32).sum(0), 0, 1)
    return {k: np.ascontiguousarray(_augment(v, bits), np.float32)
            for k, v in (("x", x), ("mask_extreme", me),
                         ("mask_extreme_loss", mel))}


def to_device(s: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A sample as a batch of one on ``device``."""
    return {k: torch.from_numpy(v)[None].to(device) for k, v in s.items()}


class Counters:
    """The epoch counters of the evaluators, built from a step's logits
    z [1, 1, H, W], anomaly bits [1, V, dt, H, W] and the sample's target
    week t_index on the dataset's timeline."""

    KEYS = ("correct", "seen", "iou_de", "predicted", "seen_all")

    def __init__(self, V: int, T: int, H: int, W: int, device):
        self.counts = {k: 0 for k in self.KEYS}
        self.vote_sum = torch.zeros((V, T, H, W), dtype=torch.int32,
                                    device=device)
        self.vote_cnt = torch.zeros(T, dtype=torch.int32, device=device)
        self.n_steps = 0

    def add(self, z: torch.Tensor, bits: torch.Tensor,
            mask_extreme: torch.Tensor, t_index: int) -> None:
        pred1 = torch.sigmoid(z[:, 0]) > 0.5
        gt1 = mask_extreme == 1
        for k, v in (("correct", pred1 & gt1), ("seen", gt1),
                     ("iou_de", pred1 | gt1), ("predicted", pred1)):
            self.counts[k] += int(v.sum())
        self.counts["seen_all"] += mask_extreme.numel()
        dt = bits.shape[2]
        first = t_index - dt + 1
        # the bits of model time j belong to week t_index - j
        self.vote_sum[:, first:first + dt] += bits[0].flip(1).int()
        self.vote_cnt[first:first + dt] += 1
        self.n_steps += 1


def cosine_lr(epoch: int, base_lr: float, lr_min: float,
              warmup_lr_init: float, warmup_t: int, t_initial: int) -> float:
    """timm's cosine schedule with a linear warmup, at a whole epoch."""
    if epoch < warmup_t:
        return warmup_lr_init + epoch * (base_lr - warmup_lr_init) \
            / max(warmup_t, 1)
    return lr_min + 0.5 * (base_lr - lr_min) * (
        1.0 + np.cos(np.pi * epoch / t_initial))


def adam_step(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
              state: Dict[str, Tuple[torch.Tensor, torch.Tensor]], t: int,
              lr: float, beta1: float, beta2: float, weight_decay: float,
              eps: float = 1e-8) -> Dict[str, torch.Tensor]:
    """Adam with L2 weight decay added to the gradient, step t (1-based);
    returns the new parameters and updates the moments in ``state``."""
    out = {}
    for k, p in params.items():
        g = grads[k] + weight_decay * p
        m, v = state.get(k, (torch.zeros_like(p), torch.zeros_like(p)))
        m = beta1 * m + (1 - beta1) * g
        v = beta2 * v + (1 - beta2) * g * g
        state[k] = (m, v)
        mh = m / (1 - beta1 ** t)
        vh = v / (1 - beta2 ** t)
        out[k] = p - lr * mh / (vh.sqrt() + eps)
    return out
