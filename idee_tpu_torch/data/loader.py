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
      batch_size: global batch size.
      device: where batches go (default cuda; see resolve_device).
      keys: move only these batch entries to the device.
      shuffle: a new order every epoch, drawn as the JAX loader draws it
        (one ``np.random.default_rng(seed)`` for the loader's life,
        ``shuffle(arange(n))`` at the start of each epoch), so both visit
        the items in the same order.
      drop_last: drop the trailing partial batch.
    """

    def __init__(self, dataset, batch_size: int = 1, device=None,
                 keys: Optional[Sequence[str]] = None, shuffle: bool = False,
                 drop_last: bool = True, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.device = resolve_device(device)
        self.keys = list(keys) if keys is not None else None
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _index_batches(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(idx)
        for b in range(len(self)):
            yield idx[b * self.batch_size:(b + 1) * self.batch_size]

    def _make_batch(self, indices) -> Dict[str, torch.Tensor]:
        batch = collate([self.dataset[int(i)] for i in indices])
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
        for indices in self._index_batches():
            yield self._make_batch(indices)
