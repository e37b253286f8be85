# ------------------------------------------------------------------
"""Host-side batch loader (counterpart of the numpy path of
idee_tpu/data/loader.py).

Batches are collated on the host from the dataset's numpy items, staged in
pinned memory and copied to the device with ``non_blocking=True``. The
steps never wait on the device, so while the card computes step k the
host already assembles and enqueues batch k+1.
"""
# ------------------------------------------------------------------

from typing import Dict, Iterator, Optional, Sequence

import numpy as np
import torch

from idee_tpu_torch import resolve_device


def collate(items: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    return {k: np.stack([it[k] for it in items]) for k in items[0]}


class DataLoader:
    """Iterates dict batches of tensors on ``device``.

    Args:
      dataset: indexable with __len__/__getitem__ returning dict[str, ndarray].
      batch_size: global batch size; items go in order and the trailing
        partial batch is dropped, as the JAX package's evaluation does.
      device: where batches go (default cuda; see resolve_device).
      keys: move only these batch entries to the device.
    """

    def __init__(self, dataset, batch_size: int = 1, device=None,
                 keys: Optional[Sequence[str]] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.device = resolve_device(device)
        self.keys = list(keys) if keys is not None else None

    def __len__(self):
        return len(self.dataset) // self.batch_size

    def _make_batch(self, b: int) -> Dict[str, torch.Tensor]:
        n = self.batch_size
        batch = collate([self.dataset[i] for i in range(b * n, (b + 1) * n)])
        if self.keys is not None:
            batch = {k: batch[k] for k in self.keys}
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out[k] = t
        return out

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        for b in range(len(self)):
            yield self._make_batch(b)
