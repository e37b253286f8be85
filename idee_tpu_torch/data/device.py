# ------------------------------------------------------------------
"""Device-resident datasets: batches built on the card from an index
(counterpart of idee_tpu/data/device.py; reference per-item semantics:
dataset/Synthetic_dataset.py:310-385, dataset/CERRA_dataset.py:452-620).

The host DataLoader collates every item on the host and copies it to the
card each step. Here the data is uploaded once, and a batch is assembled
on the device from a [B] index: the window slice, the time flip, the
masks and the rot90/flip augmentation. Per step the host sends nothing;
per epoch it uploads the [nb, B] sample order and the [nb, B, 3] flip
bits. ``batch(idx, flips)`` reads device tensors only, so a train step
that calls it can be captured in a CUDA graph (train/steps.py).

The sample order is JAX's: one ``np.random.default_rng(seed)`` for the
loader's life and ``permutation(n)`` per epoch, the stream of the host
DataLoader, so a device epoch visits the items in its order. The flip
bits are not JAX's threefry bits (fold_in(key, epoch * 100003 + b)): they
come from a numpy Generator keyed by (seed, epoch), one row per position
in the epoch, drawn on the host (``epoch_flips``), so the per-step and the
captured paths draw the same bits. Three bits r per sample give the
host's composite (rot90 k=2 == flip H and W, then one random-axis flip):
flip H by r0 ^ (r1 & ~r2), flip W by r0 ^ (r1 & r2); in the host
datasets' terms (``draw_aug``), rotate = r0 and flip axis -1 with
r1 & r2, -2 with r1 & ~r2. Epochs take full batches only (drop_last).
Under data parallelism (``mesh``, parallel/mesh.py) every rank draws the
global order and flip bits and its batches hold the rank's rows of each.
Under a ``space`` axis (the spatial context active when the loader is
made, parallel/spatial.py) every rank holds the whole data, as JAX's one
unsharded cube (idee_tpu/data/device.py:92), and gathers only its H rows
[lo, hi) of each sample: for a sample whose bits flip H, the rows H-1-lo
down to H-hi. Its leaves are those of ``spatial.shard_rows`` of the
single-device batch, bit for bit; no whole-H batch is built.
"""
# ------------------------------------------------------------------

import os
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from idee_tpu_torch import resolve_device
from idee_tpu_torch.data.synthetic import _window_mean
from idee_tpu_torch.parallel import spatial


def _flip_bits(flips: Optional[torch.Tensor]):
    """(flip H, flip W) [B] bool of the samples' bits flips [B, 3], or
    (None, None) without them."""
    if flips is None:
        return None, None
    r0, r1, r2 = flips.unbind(-1)
    return r0 ^ (r1 & ~r2), r0 ^ (r1 & r2)


def _flip2(t: torch.Tensor, fh: Optional[torch.Tensor],
           fw: Optional[torch.Tensor]):
    """t [B, ...] flipped along H (-2) where fh [B] and then along W (-1)
    where fw (None: no flip along that axis), branch-free."""
    shape = (t.shape[0],) + (1,) * (t.dim() - 1)
    if fh is not None:
        t = torch.where(fh.view(shape), t.flip(-2), t)
    if fw is not None:
        t = torch.where(fw.view(shape), t.flip(-1), t)
    return t


def _augment(out: Dict[str, torch.Tensor], fh: Optional[torch.Tensor],
             fw: Optional[torch.Tensor]):
    """Each entry flipped where the samples' bits say (``_flip2``), or made
    contiguous without any."""
    if fh is None and fw is None:
        return {k: v.contiguous() for k, v in out.items()}
    return {k: _flip2(v, fh, fw) for k, v in out.items()}


def _take(t: torch.Tensor, dim: int, index: torch.Tensor,
          rows: Optional[torch.Tensor]) -> torch.Tensor:
    """t's slices at ``index`` [B, k] (int64) along ``dim``, dims (B, k)
    in its place; with ``rows`` [B, h] (int64), of H (t's dim -2) only
    those rows of each sample's slices, in that order."""
    B, k = index.shape
    if rows is None:
        return t.index_select(dim, index.reshape(-1)).unflatten(dim, (B, k))
    h_dim = t.dim() - 2
    at = [slice(None)] * t.dim()
    at[dim], at[h_dim] = index[:, :, None], rows[:, None, :]
    out = t[tuple(at)]
    # indices apart (slices between them): torch puts their [B, k, h] first
    return out if dim + 1 == h_dim else out.movedim(2, -2)


class _EpochLoader:
    """What both device loaders share: the order and flip streams, the
    epoch count, len and iteration over device batches."""

    def __init__(self, n: int, batch_size: int, seed: int, is_aug: bool,
                 device, mesh=None):
        self.mesh = mesh
        self.space = spatial.active()
        if mesh is not None:
            mesh.rows(batch_size)  # raises unless the ranks split it
            if mesh.space > 1 and self.space is None:
                raise ValueError(
                    f"device_data under a space axis of {mesh.space} ranks: "
                    "a rank gathers its H rows of the spatial context "
                    "active when its loader is made, and none is "
                    "(parallel/spatial.py::activate)")
        self._h = None  # the rank's H rows (``_space_rows``)
        self.n = n
        self.batch_size = batch_size
        self.seed = seed
        self.is_aug = is_aug
        self.device = resolve_device(device)
        self._rng = np.random.default_rng(seed)
        self._epoch = 0

    def __len__(self):
        return self.n // self.batch_size

    def epoch_order(self) -> Tuple[np.ndarray, int]:
        """Advance one epoch; returns its [nb, B] int64 sample order and the
        (1-based) epoch number. The same permutation stream as the host
        DataLoader's, so the order is the one the per-step path visits."""
        order = self._rng.permutation(self.n)
        self._epoch += 1
        nb = len(self)
        return (order[:nb * self.batch_size]
                .reshape(nb, self.batch_size).astype(np.int64), self._epoch)

    def epoch_flips(self, epoch: int) -> Optional[np.ndarray]:
        """The epoch's flip bits [nb, B, 3] (bool), row b for position b,
        from a numpy Generator keyed by (seed, epoch); None without
        augmentation."""
        if not self.is_aug:
            return None
        rng = np.random.default_rng((self.seed, epoch))
        return rng.integers(0, 2, (len(self), self.batch_size, 3)) \
            .astype(bool)

    def _space_rows(self, H: int) -> None:
        """Under a space context, the rank's rows [lo, hi) of the data's
        ``H`` rows on the device (raises unless the context is of ``H``
        rows)."""
        sc = self.space
        if sc is None:
            return
        if sc.H != H:
            raise ValueError(f"the spatial context splits {sc.H} rows, the "
                             f"loader's data has {H}")
        self._h = torch.arange(sc.lo, sc.hi, device=self.device)

    def _rows(self, B: int, fh: Optional[torch.Tensor]):
        """[B, h]: the global H rows of each sample that the rank's batch
        holds, in order: under a space context its rows [lo, hi), reversed
        from H-1-lo for the samples that flip H (``fh`` [B]); None (all of
        H) without one."""
        if self._h is None:
            return None
        if fh is None:
            return self._h.expand(B, -1)
        return torch.where(fh[:, None], (self.space.H - 1) - self._h,
                           self._h)

    def batch(self, idx: torch.Tensor, flips: Optional[torch.Tensor] = None):
        raise NotImplementedError

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        """The next epoch's device batches (the per-step loop)."""
        order, epoch = self.epoch_order()
        flips = self.epoch_flips(epoch)
        order = torch.from_numpy(order).to(self.device)
        if flips is not None:
            flips = torch.from_numpy(flips).to(self.device)
        rows = (slice(None) if self.mesh is None
                else self.mesh.rows(self.batch_size))
        for b in range(order.shape[0]):
            yield self.batch(order[b, rows],
                             None if flips is None else flips[b, rows])

    def close(self):  # the host DataLoader's interface
        pass


class DeviceLoader(_EpochLoader):
    """Device batches of a SyntheticDataset (JAX ``DeviceLoader``,
    idee_tpu/data/device.py:221-360).

    The normalised dynamic cube [V, T, H, W] is uploaded once in the
    compute ``dtype``, the extremes [T, H, W] in float32 and, with
    ``with_anomaly``, the anomaly bits [V, T, H, W] as uint8. A batch holds
    x [B, V, 1, dt, H, W] (time-reversed), mask_extreme (values > 1
    zeroed), mask_extreme_loss (the window's clipped union), timestep
    [B, 1] = idx + dt - 1 + t0 and, with_anomaly, mask_anomaly
    [B, V, dt, H, W] uint8 (time-reversed).
    """

    def __init__(self, ds, batch_size: int, seed: int = 0,
                 dtype: torch.dtype = torch.float32,
                 with_anomaly: bool = False, device=None, mesh=None):
        super().__init__(len(ds), batch_size, seed, bool(ds.is_aug), device,
                         mesh)
        self.ds = ds
        self.dt = ds.delta_t
        self.t0 = float(ds.timestep[0])
        dev = self.device
        self.dynamic = torch.from_numpy(np.ascontiguousarray(
            ds.datacube_dynamic, np.float32)).to(dtype).to(dev)
        self.extreme = torch.from_numpy(np.ascontiguousarray(
            ds.extreme, np.float32)).to(dev)
        self.anomaly = None
        if with_anomaly:
            self.anomaly = torch.from_numpy(np.ascontiguousarray(
                ds.anomaly, np.uint8)).to(dev)
        # window offsets: time-reversed (index 0 the target week) and in
        # time order
        self._back = torch.arange(self.dt - 1, -1, -1, device=dev)
        self._fwd = torch.arange(self.dt, device=dev)
        self._space_rows(self.dynamic.shape[2])

    def batch(self, idx: torch.Tensor, flips: Optional[torch.Tensor] = None):
        """The batch of samples ``idx`` [B] (int64, on the device), flipped
        by ``flips`` [B, 3] (bool) when given; under a space context the
        rank's H rows of it."""
        B, dt = idx.shape[0], self.dt
        fh, fw = _flip_bits(flips)
        rows = self._rows(B, fh)
        back = idx[:, None] + self._back
        x = _take(self.dynamic, 1, back, rows)              # [V, B, dt, h, W]
        ew = _take(self.extreme, 0, idx[:, None] + self._fwd, rows)
        me = ew[:, -1]
        out = {"x": x.transpose(0, 1).unsqueeze(2),
               "mask_extreme": torch.where(me > 1.0, 0.0, me),
               "mask_extreme_loss": ew.sum(1).clamp(0.0, 1.0)}
        if self.anomaly is not None:
            out["mask_anomaly"] = _take(self.anomaly, 1, back,
                                        rows).transpose(0, 1)
        # the rows already hold the H flips
        out = _augment(out, fh if rows is None else None, fw)
        out["timestep"] = (idx.float() + (dt - 1) + self.t0)[:, None]
        return out


class RealDeviceLoader(_EpochLoader):
    """Device batches of a ReanalysisDataset (JAX ``RealDeviceLoader``,
    idee_tpu/data/device.py:23-218).

    On the host, each unique main-file week is read and normalised once
    into a [V, 2, H, W] slab (``_normalized_week``: the item's global or
    weekly-climatology normalisation, clip +-10, nan fill and window mean,
    which act week by week), and each unique NOAA file list gets its three
    masks once (drought at 35 and at the dataset's threshold, cold
    surface). They go to the card with the item -> week maps ``main_idx``
    and ``noaa_idx`` [n, dt], which keep the dataset's year rollover and
    missing-week fallback. A batch holds what the train and val steps read:
    x [B, V, 2, dt, H, W] (index 0 the target week: no time flip on this
    path), mask_extreme, mask_extreme_loss (the window's union at 35),
    mask_cold_surface and mask_cold_surface_loss (the union without the
    target week); ``with_eval_masks`` adds the static mask_sea and
    mask_no_vegetation that the image panels read.
    """

    def __init__(self, ds, batch_size: int, seed: int = 0,
                 dtype: torch.dtype = torch.float32,
                 with_eval_masks: bool = False, device=None, mesh=None):
        super().__init__(len(ds), batch_size, seed, bool(ds.is_aug), device,
                         mesh)
        self.ds = ds
        dt = ds.delta_t
        main_slot, noaa_slot = {}, {}
        main_idx = np.empty((self.n, dt), np.int64)
        noaa_idx = np.empty((self.n, dt), np.int64)
        for i, (files_main, files_noaa, _) in enumerate(ds.files):
            for d in range(dt):
                main_idx[i, d] = main_slot.setdefault(files_main[d],
                                                      len(main_slot))
                noaa_idx[i, d] = noaa_slot.setdefault(tuple(files_noaa[d]),
                                                      len(noaa_slot))
        H, W = ds.n_lat_window, ds.n_lon_window
        V = len(ds.variables_dynamic)
        xw = np.empty((len(main_slot), V, 2, H, W), np.float32)
        for path, s in main_slot.items():
            xw[s] = self._normalized_week(path)
        d35 = np.empty((len(noaa_slot), H, W), np.uint8)
        dthr = np.empty_like(d35)
        cold = np.empty_like(d35)
        for files, s in noaa_slot.items():
            d35[s], cold[s] = ds.generate_mask(list(files), thr=35)
            dthr[s] = ds.generate_mask(list(files), thr=ds.threshold)[0]

        dev = self.device

        def put(a, dt_=None):
            t = torch.from_numpy(np.ascontiguousarray(a))
            return (t if dt_ is None else t.to(dt_)).to(dev)

        self.xw = put(xw, dtype)
        self.d35, self.dthr, self.cold = put(d35), put(dthr), put(cold)
        self.main_idx, self.noaa_idx = put(main_idx), put(noaa_idx)
        self.eval_masks = None
        if with_eval_masks:
            masks = ((ds.mask_water_scaled, ds.mask_no_vegetation_scaled)
                     if ds.is_reduce else
                     (ds.mask_water, ds.mask_no_vegetation))
            self.eval_masks = tuple(put(np.asarray(m, np.float32))
                                    for m in masks)
        self._space_rows(H)

    def _normalized_week(self, path: str) -> np.ndarray:
        """One week's normalised [V, 2, H, W] slab: the week's restriction
        of ReanalysisDataset.item's normalise / clip / nan-fill / reduce
        tail (every step of a window is normalised by its own week's
        statistics, so the tail acts week by week)."""
        ds = self.ds
        x = ds.load_datacube([path])  # [V, 2, 1, H, W]
        if ds.is_norm:
            if ds.is_clima_scale:
                wk = [ds._clima_week_lut[float(int(
                    os.path.basename(path)[4:7]))]]
                mean = np.flip(ds._clima_mean[:, :, wk], -2)
                std = np.flip(ds._clima_std[:, :, wk], -2)
                with np.errstate(all="ignore"):
                    x = (x - mean) / std
            else:
                m = ds._mean_var[:, None, None, None].astype(np.float32)
                s = ds._std_var[:, None, None, None].astype(np.float32)
                x = np.stack([(x[:, 0] - m) / s, x[:, 1] / s], axis=1)
            x = np.clip(x, -10.0, 10.0)
        x[np.isnan(x) | np.isinf(x)] = ds.nan_fill
        if ds.is_reduce:
            with np.errstate(all="ignore"):
                x = _window_mean(x, ds.window_size, (3, 4))
        return x[:, :, 0]

    def batch(self, idx: torch.Tensor, flips: Optional[torch.Tensor] = None):
        """The batch of samples ``idx`` [B] (int64, on the device), flipped
        by ``flips`` [B, 3] (bool) when given; under a space context the
        rank's H rows of it."""
        B = idx.shape[0]
        fh, fw = _flip_bits(flips)
        rows = self._rows(B, fh)
        mi = self.main_idx.index_select(0, idx)              # [B, dt]
        ni = self.noaa_idx.index_select(0, idx)
        x = _take(self.xw, 0, mi, rows)                  # [B, dt, V, 2, h, W]
        d35 = _take(self.d35, 0, ni, rows).float()           # [B, dt, h, W]
        cw = _take(self.cold, 0, ni, rows).float()
        out = {"x": x.permute(0, 2, 3, 1, 4, 5),
               "mask_extreme": _take(self.dthr, 0, ni[:, :1],
                                     rows)[:, 0].float(),
               "mask_extreme_loss": d35.sum(1).clamp(0.0, 1.0),
               "mask_cold_surface": cw[:, 0],
               # the cold-surface loss union leaves out the target week
               # (CERRA_dataset.py:594-595)
               "mask_cold_surface_loss": cw[:, 1:].sum(1).clamp(0.0, 1.0)}
        if self.eval_masks is not None:
            for k, m in zip(("mask_sea", "mask_no_vegetation"),
                            self.eval_masks):
                out[k] = m.expand(B, -1, -1) if rows is None else m[rows]
        return _augment(out, fh if rows is None else None, fw)
