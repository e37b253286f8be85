# ------------------------------------------------------------------
"""Host-side batch loader (counterpart of the numpy path of
idee_tpu/data/loader.py).

Batches are collated on the host from the dataset's numpy items, staged in
pinned memory and copied to the device with ``non_blocking=True``. The
steps never wait on the device, so while the card computes step k the
host already assembles and enqueues batch k+1.

Batch assembly runs off the consumer's thread, as in the JAX loader:
``prefetch`` batches are built ahead by one background thread, or with
``workers`` > 0 by a pool of threads (the item pipelines read NetCDF files,
and h5py, scipy and numpy release the GIL while they read and copy).
Batches come out in order either way, with the values of the serial path
(``prefetch=0``): a dataset that augments at random (``draw_aug`` and
``item``) has its draws made in index order on the thread that hands out
the indices, never on the pool's threads. The copies go on the thread's current stream, which is
the default stream unless the caller made another current in that thread:
the same stream as the steps that read them, so they are ordered before
those steps. x is converted to ``x_dtype`` on the host before the pinned
copy, as the JAX drivers cast it: the drivers upload x in the compute
dtype, which halves its bytes at bfloat16. A dataset with ``get_batch``
(the synthetic one) builds a whole batch in one call of the host engine,
as the JAX loader does (idee_tpu/data/loader.py:86-88); others are
collated item by item.
"""
# ------------------------------------------------------------------

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
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
      prefetch: batches staged ahead by a background thread (0: built on
        the consumer's thread when asked for).
      workers: > 0 builds up to this many batches at once on a thread
        pool; at most prefetch + workers are staged ahead.
      x_dtype: the dtype x is converted to on the host before the copy
        (the model's compute dtype; float32 leaves it as built).
    """

    def __init__(self, dataset, batch_size: int = 1, device=None,
                 keys: Optional[Sequence[str]] = None, shuffle: bool = False,
                 drop_last: bool = True, seed: int = 0, prefetch: int = 2,
                 workers: int = 0, x_dtype: torch.dtype = torch.float32):
        self.dataset = dataset
        self.x_dtype = x_dtype
        self.batch_size = batch_size
        self.device = resolve_device(device)
        self.keys = list(keys) if keys is not None else None
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.workers = workers
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

    def _make_batch(self, indices, augs=None) -> Dict[str, torch.Tensor]:
        if hasattr(self.dataset, "get_batch"):
            # the host engine's one call per batch (idee_tpu_torch/native)
            batch = self.dataset.get_batch(indices, augs)
        elif augs is None:
            batch = collate([self.dataset[int(i)] for i in indices])
        else:
            batch = collate([self.dataset.item(int(i), a)
                             for i, a in zip(indices, augs)])
        if self.keys is not None:
            batch = {k: batch[k] for k in self.keys}
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if k == "x":
                t = t.to(self.x_dtype)
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out[k] = t
        return out

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        if self.workers > 0:
            return self._iter_pooled()
        if self.prefetch <= 0:
            return map(self._make_batch, self._index_batches())
        return self._iter_prefetched()

    def _iter_prefetched(self) -> Iterator[Dict[str, torch.Tensor]]:
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        done = object()
        stop = threading.Event()

        def work():
            try:
                for indices in self._index_batches():
                    if stop.is_set():
                        return
                    q.put(self._make_batch(indices))
            except Exception as e:  # raised again on the consumer's thread
                q.put(e)
            finally:
                q.put(done)

        t = threading.Thread(target=work, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            # a consumer that stops early must not leave the thread blocked
            # on a full queue: drain until it has seen ``stop`` and ended
            stop.set()
            while t.is_alive():
                try:
                    while True:
                        q.get_nowait()
                except queue.Empty:
                    pass
                t.join(timeout=0.1)

    def _iter_pooled(self) -> Iterator[Dict[str, torch.Tensor]]:
        window = max(self.prefetch, 1) + self.workers
        draw = getattr(self.dataset, "draw_aug", None)
        with ThreadPoolExecutor(max_workers=self.workers) as pool:
            pending = []
            try:
                for indices in self._index_batches():
                    # the dataset's one random stream, read in index order
                    augs = [draw() for _ in indices] if draw else None
                    pending.append(pool.submit(self._make_batch, indices,
                                               augs))
                    if len(pending) >= window:
                        yield pending.pop(0).result()
                while pending:
                    yield pending.pop(0).result()
            finally:
                for fut in pending:
                    fut.cancel()
