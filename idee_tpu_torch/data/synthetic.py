# ------------------------------------------------------------------
"""Synthetic datacube pipeline (the port's numpy copy of
idee_tpu/data/synthetic.py; reference dataset/Synthetic_dataset.py).

The whole cube sits in host RAM; each item is a delta_t-week window,
time-reversed so index 0 is the target week Delta-t_0, plus the extreme
and anomaly masks and the consistent rot90/flip augmentation.

Sources: an in-memory ``SyntheticCube``, the ``datacube_<exp>.npz`` that
data/convert.py writes, or the reference's directory schema
(``datacube_<exp>.nc``, ``statistic_<exp>.json``, ``climatology_<exp>.nc``)
through data/netcdf.py: NetCDF3 natively, NetCDF4 where h5py is
installed. ``get_batch`` builds a whole collated batch in one call of the
host engine (idee_tpu_torch/native), bit-equal to collating ``item``s.
"""
# ------------------------------------------------------------------

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from idee_tpu_torch import native
from idee_tpu_torch.data.netcdf import NetCDFFile


@dataclass
class SyntheticCube:
    """In-memory synthetic datacube (pre-selection, raw units)."""

    dynamic: np.ndarray  # [V, T, H, W] float32
    anomaly: np.ndarray  # [V, T, H, W] {0,1}
    extreme: np.ndarray  # [T, H, W]
    variables: List[str]
    static: Optional[np.ndarray] = None  # [S, H, W] raw (pre-normalization)
    variables_static: List[str] = field(default_factory=list)
    # per-variable global stats (statistic_*.json schema)
    stats: Optional[Dict[str, Dict[str, float]]] = None
    # weekly pixel-wise climatology: median/std [V, 52, H, W]
    clima_median: Optional[np.ndarray] = None
    clima_std: Optional[np.ndarray] = None

    def time_slice(self, t0: int, t1: int) -> "SyntheticCube":
        """Weeks [t0, t1] (1-based inclusive) as a new cube. With an
        in-memory cube the dataset uses ``times=`` only as the absolute
        timestep offset, so a split is cut here."""
        return dataclasses.replace(
            self,
            dynamic=self.dynamic[:, t0 - 1:t1],
            anomaly=self.anomaly[:, t0 - 1:t1],
            extreme=self.extreme[t0 - 1:t1],
        )


def _week_of(timestep: np.ndarray) -> np.ndarray:
    """Absolute timestep (1-based) -> week-of-year index 0..51."""
    return ((timestep - 1) % 52).astype(np.float32)


def _window_mean(x: np.ndarray, w: int, axes: Tuple[int, int]) -> np.ndarray:
    """Non-overlapping window-mean downsampling over two spatial axes."""
    if w <= 1:
        return x
    shape = list(x.shape)
    h_ax, w_ax = axes
    H, W = shape[h_ax], shape[w_ax]
    y = x.reshape(shape[:h_ax] + [H // w, w] + [W // w, w])
    return np.nanmean(y, axis=(h_ax + 1, h_ax + 3))


def draw_aug(rng: np.random.Generator):
    """One item's augmentation, drawn from ``rng`` as the reference draws
    it: (rotate by 180 degrees, axis to flip counted from the end or 0).
    The datasets' ``item(index, aug)`` applies it."""
    rotate = bool(rng.integers(2))
    flip = int(rng.integers(1, 3)) if rng.integers(2) else 0
    return rotate, flip


def _static_layer(raw: np.ndarray) -> np.ndarray:
    """A cropped [H, W] static layer as the model reads it, [1, H, W]:
    flipped along y, normalised by its nanmean / nanstd, clipped to +-10
    (reference: dataset/Synthetic_dataset.py:180-191)."""
    data = np.flip(raw, -2)[None]
    data = (data - np.nanmean(data)) / np.nanstd(data)
    return np.clip(data, -10.0, 10.0)


def load_cube_netcdf(root: str, variables: List[str],
                     variables_static: List[str], times: Tuple[int, int],
                     x_min: int, x_max: int, y_min: int, y_max: int,
                     need_stats: bool, need_clima: bool) -> SyntheticCube:
    """Load datacube_<exp>.nc, and statistic_<exp>.json with
    ``need_stats`` and climatology_<exp>.nc with ``need_clima``, cropped
    to the (x, y) window and the weeks ``times`` (reference:
    dataset/Synthetic_dataset.py:163-283)."""
    exp = os.path.basename(os.path.normpath(root))
    path = os.path.join(root, f"datacube_{exp}.nc")
    xs, ys = slice(x_min, x_max), slice(y_min, y_max)

    with NetCDFFile(path) as f:
        n_time_total = np.asarray(f.coord("time")).shape[0]
        n_var_total = np.asarray(f.coord("var")).shape[0]
        tsl = f.range_slice("time", times[0], times[1])
        dyn = np.stack(
            [f.read(v, {0: tsl, 1: ys, 2: xs}) for v in variables], axis=0
        ).astype(np.float32)
        var_idx = f.label_indices("var", variables)
        # the (var, time) axis order of anomaly_extreme, by size: xarray
        # writes (var, time, y, x), the JAX package's h5py fixture
        # (time, var, y, x)
        anom = f.read("anomaly_extreme")
        v_ax = 0 if (anom.shape[0] == n_var_total
                     and anom.shape[1] == n_time_total) else 1
        anom = np.take(anom, var_idx, axis=v_ax)
        anom = np.take(anom, np.arange(tsl.start, tsl.stop), axis=1 - v_ax)
        if v_ax != 0:
            anom = anom.swapaxes(0, 1)
        anom = anom[..., ys, xs]
        extreme = f.read("extreme", {0: tsl, 1: ys, 2: xs})

        static = None
        if variables_static:
            # cropped as xarray's isel at open crops; in native byte order
            # (NetCDF3 stores big-endian), whose sums round as the .npz
            # path's do
            static = np.concatenate([
                _static_layer(raw.astype(raw.dtype.newbyteorder("=")))
                for raw in (f.read(v_s)[..., ys, xs]
                            for v_s in variables_static)])

    stats = None
    if need_stats:
        with open(os.path.join(root, f"statistic_{exp}.json")) as fh:
            raw = json.load(fh)
        stats = {v: {k: float(raw[k][v])
                     for k in ("min", "max", "mean", "median", "std")}
                 for v in variables}

    cm = cs = None
    if need_clima:
        with NetCDFFile(os.path.join(root, f"climatology_{exp}.nc")) as f:
            rows = {}
            for name in ("median", "std"):
                i = f.label_indices("climatology", [name])[0]
                rows[name] = np.stack([
                    f.read(v, {0: slice(i, i + 1), 2: ys, 3: xs})[0]
                    for v in variables]).astype(np.float32)
            cm, cs = rows["median"], rows["std"]

    return SyntheticCube(
        dynamic=dyn, anomaly=anom, extreme=extreme,
        variables=list(variables), static=static,
        variables_static=list(variables_static),
        stats=stats, clima_median=cm, clima_std=cs,
    )


def load_cube_npz(path: str, variables: List[str],
                  variables_static: List[str], times: Tuple[int, int],
                  x_min: int, x_max: int, y_min: int, y_max: int
                  ) -> SyntheticCube:
    """Load a cube from the framework-native .npz (idee_tpu/data/convert.py
    format; ``stats`` may also be a JSON string)."""
    # convert.py stores the stats dict as a pickled object array
    z = np.load(path, allow_pickle=True)
    all_vars = [str(v) for v in z["variables"]]
    vi = np.array([all_vars.index(v) for v in variables])
    t = z["timestep"]
    tm = (t >= times[0]) & (t <= times[1])
    sel = np.ix_(vi, np.nonzero(tm)[0], np.arange(y_min, y_max),
                 np.arange(x_min, x_max))
    static = None
    if variables_static and "static" in z:
        svars = [str(v) for v in z["variables_static"]]
        si = np.array([svars.index(v) for v in variables_static])
        raw = z["static"][si][:, y_min:y_max, x_min:x_max]
        static = np.concatenate([_static_layer(s) for s in raw])
    stats = None
    if "stats" in z:
        stats = z["stats"].item()
        if isinstance(stats, str):
            stats = json.loads(stats)
    cm = z["clima_median"][vi][:, :, y_min:y_max, x_min:x_max] \
        if "clima_median" in z else None
    cs = z["clima_std"][vi][:, :, y_min:y_max, x_min:x_max] \
        if "clima_std" in z else None
    return SyntheticCube(
        dynamic=z["dynamic"][sel].astype(np.float32),
        anomaly=z["anomaly"][sel],
        extreme=z["extreme"][np.nonzero(tm)[0], y_min:y_max, x_min:x_max],
        variables=list(variables), static=static,
        variables_static=list(variables_static),
        stats=stats, clima_median=cm, clima_std=cs,
    )


def cube_npz_path(root: str) -> str:
    """<root>/datacube_<basename(root)>.npz."""
    exp = os.path.basename(os.path.normpath(root))
    return os.path.join(root, f"datacube_{exp}.npz")


class SyntheticDataset:
    """Synthetic dataset with reference __getitem__ semantics
    (reference: dataset/Synthetic_dataset.py:88-405).

    Items are dicts of numpy arrays:
      x                 [V, 1, delta_t, H, W] float32 (time-reversed)
      static            [S, H, W] or absent
      week              [delta_t] week numbers (1-based, time-reversed)
      mask_extreme      [H, W] extreme at Delta-t_0 (values > 1 zeroed)
      mask_extreme_loss [H, W] union of extremes over the window
      mask_extreme_loss_t [delta_t, H, W] per-week extremes (time-reversed)
      mask_anomaly      [V, delta_t, H, W] GT drivers (time-reversed)
      timestep          [1] absolute timestep of the target week
    """

    def __init__(self, cube: Optional[SyntheticCube] = None,
                 root_datacube: Optional[str] = None,
                 times: Tuple[int, int] = (1, 52),
                 variables: Optional[List[str]] = None,
                 variables_static: Optional[List[str]] = None,
                 delta_t: int = 8, is_aug: bool = False,
                 is_clima_scale: bool = False, is_norm: bool = True,
                 is_replace_anomaly: bool = False,
                 window_size: int = 1,
                 x_min: int = 0, x_max: int = 200,
                 y_min: int = 0, y_max: int = 200,
                 seed: int = 0):
        variables = sorted(variables or [])
        variables_static = sorted(variables_static or [])
        self.delta_t = delta_t
        self.is_aug = is_aug
        self.variables_dynamic = variables
        self.variables_static = variables_static
        self.times = times
        self._rng = np.random.default_rng(seed)

        if cube is None:
            if root_datacube is None:
                raise ValueError("provide either cube= or root_datacube=")
            npz = cube_npz_path(root_datacube)
            if os.path.exists(npz):
                cube = load_cube_npz(npz, variables, variables_static, times,
                                     x_min, x_max, y_min, y_max)
            else:
                cube = load_cube_netcdf(
                    root_datacube, variables, variables_static, times,
                    x_min, x_max, y_min, y_max,
                    need_stats=is_norm and not is_clima_scale,
                    need_clima=(is_norm and is_clima_scale)
                    or is_replace_anomaly)
        self.cube = cube

        if cube.dynamic.shape[1] < delta_t:
            raise ValueError(
                f"time window {times} holds {cube.dynamic.shape[1]} steps, "
                f"fewer than delta_t={delta_t}; check --times_* and the cube")

        self._dynamic = cube.dynamic.astype(np.float32).copy()
        self._anomaly = cube.anomaly
        self._extreme = cube.extreme
        self._static = cube.static
        self._engine_arrays = None  # get_batch's float32 copies
        V, T = self._dynamic.shape[:2]
        self._timestep = np.arange(times[0], times[0] + T, dtype=np.float32)
        self._week = _week_of(self._timestep)

        if is_replace_anomaly:
            # the one-class and reconstruction baselines train on
            # "anomaly-free" data: pixels under extremes are overwritten
            # with draws from the pixel-wise weekly climatology
            # Normal(median, |std|) of the dataset's random stream, before
            # normalisation (reference: Baselines_Reconstruction/dataset/
            # Synthetic_dataset.py:205-219)
            if cube.clima_median is None:
                raise ValueError("cube lacks climatology for "
                                 "is_replace_anomaly")
            wk = self._week.astype(np.int32)
            sel = np.broadcast_to(self._extreme[None] > 0,
                                  self._dynamic.shape)
            med = cube.clima_median[:, wk]
            std = cube.clima_std[:, wk]
            self._dynamic[sel] = self._rng.normal(
                med[sel], np.abs(std[sel])).astype(np.float32)

        if is_norm:
            if is_clima_scale:
                if cube.clima_median is None:
                    raise ValueError("cube lacks climatology for "
                                     "is_clima_scale")
                wk = self._week.astype(np.int32)
                with np.errstate(divide="ignore", invalid="ignore"):
                    self._dynamic = ((self._dynamic - cube.clima_median[:, wk])
                                     / cube.clima_std[:, wk])
            else:
                if cube.stats is None:
                    raise ValueError("cube lacks statistics for global norm")
                for v, name in enumerate(self.variables_dynamic):
                    s = cube.stats[name]
                    self._dynamic[v] = (self._dynamic[v] - s["median"]) \
                        / s["std"]
            self._dynamic = np.clip(self._dynamic, -10.0, 10.0)

        if window_size > 1:
            self._dynamic = _window_mean(self._dynamic, window_size, (2, 3))
            self._anomaly = _window_mean(
                self._anomaly.astype(np.float32), window_size, (2, 3))
            self._extreme = _window_mean(
                self._extreme.astype(np.float32), window_size, (1, 2))
            if self._static is not None:
                self._static = _window_mean(self._static, window_size, (1, 2))

    @property
    def anomaly(self):
        return self._anomaly

    @property
    def extreme(self):
        return self._extreme

    @property
    def timestep(self):
        return self._timestep

    @property
    def datacube_dynamic(self):
        return self._dynamic

    def __len__(self):
        return self._dynamic.shape[1] - self.delta_t + 1

    def draw_aug(self):
        """The next item's augmentation (``draw_aug``) from the dataset's
        random stream; None without ``is_aug``."""
        return draw_aug(self._rng) if self.is_aug else None

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        return self.item(index, self.draw_aug())

    def get_batch(self, indices, augs=None) -> Dict[str, np.ndarray]:
        """The collated batch of ``indices`` in one call of the host engine
        (native.synth_batch; JAX ``get_batch``,
        idee_tpu/data/synthetic.py:346-390), bit-equal to
        ``collate([self.item(i, a) ...])``. ``augs``: one ``draw_aug()``
        per index; by default drawn here, in index order, as ``__getitem__``
        would draw them."""
        if augs is None:
            augs = [self.draw_aug() for _ in indices]
        if self._engine_arrays is None:
            # one assignment: a pool thread sees all three or none
            self._engine_arrays = tuple(
                np.ascontiguousarray(a, np.float32)
                for a in (self._dynamic, self._extreme, self._anomaly))
        dynamic, extreme, anomaly = self._engine_arrays
        B, dt = len(indices), self.delta_t
        base = np.asarray(indices, np.int64).reshape(B)
        fh = np.zeros(B, np.uint8)
        fw = np.zeros(B, np.uint8)
        for b, aug in enumerate(augs):
            # rotating by 180 degrees flips both axes; flip axis -1 is W,
            # -2 is H
            if aug is not None:
                rotate, flip = aug
                fh[b] = rotate != (flip == 2)
                fw[b] = rotate != (flip == 1)
        x, me, mel, mel_t, ma = native.synth_batch(
            dynamic, extreme, anomaly, base, fh, fw, dt)
        batch = {
            "x": x,
            "week": np.stack([np.flip(self._week[i:i + dt] + 1)
                              for i in base]).astype(np.float32),
            "mask_extreme": me, "mask_extreme_loss": mel,
            "mask_extreme_loss_t": mel_t, "mask_anomaly": ma,
            "timestep": self._timestep[base + dt - 1][:, None].astype(
                np.float32),
        }
        if self._static is not None:
            static = np.repeat(np.asarray(self._static, np.float32)[None], B,
                               axis=0)
            for b in range(B):
                if fh[b]:
                    static[b] = static[b, :, ::-1, :]
                if fw[b]:
                    static[b] = static[b, :, :, ::-1]
            batch["static"] = static
        return batch

    def item(self, index: int, aug) -> Dict[str, np.ndarray]:
        """Item ``index`` with the augmentation ``aug`` of draw_aug."""
        dt = self.delta_t
        x = np.flip(self._dynamic[:, index:index + dt], 1)[:, None]
        week = np.flip(self._week[index:index + dt] + 1)
        tstep = np.array([self._timestep[index + dt - 1]], np.float32)

        mask_extreme = self._extreme[index + dt - 1].copy()
        mask_extreme[mask_extreme > 1] = 0
        # union of extremes over the window, clamped to 1 (values > 1 count
        # as extreme here, unlike mask_extreme; reference: :346-349)
        mask_extreme_loss = np.clip(self._extreme[index:index + dt].sum(0),
                                    0, 1)
        mask_extreme_loss_t = np.flip(self._extreme[index:index + dt].copy(),
                                      0)
        mask_anomaly = np.flip(self._anomaly[:, index:index + dt], 1)
        static = self._static.copy() if self._static is not None else None

        if aug is not None:
            rotate, flip = aug
            if rotate:
                args = dict(k=2, axes=(-1, -2))
                x = np.rot90(x, **args)
                mask_extreme = np.rot90(mask_extreme, **args)
                mask_extreme_loss = np.rot90(mask_extreme_loss, **args)
                mask_extreme_loss_t = np.rot90(mask_extreme_loss_t, **args)
                mask_anomaly = np.rot90(mask_anomaly, **args)
                if static is not None:
                    static = np.rot90(static, **args)
            if flip:
                ax = flip
                x = np.flip(x, axis=-ax)
                mask_extreme = np.flip(mask_extreme, axis=-ax)
                mask_extreme_loss = np.flip(mask_extreme_loss, axis=-ax)
                mask_extreme_loss_t = np.flip(mask_extreme_loss_t, axis=-ax)
                mask_anomaly = np.flip(mask_anomaly, axis=-ax)
                if static is not None:
                    static = np.flip(static, axis=-ax)

        item = {
            "x": np.ascontiguousarray(x, np.float32),
            "week": np.ascontiguousarray(week, np.float32),
            "mask_extreme": np.ascontiguousarray(mask_extreme, np.float32),
            "mask_extreme_loss": np.ascontiguousarray(mask_extreme_loss,
                                                      np.float32),
            "mask_extreme_loss_t": np.ascontiguousarray(mask_extreme_loss_t,
                                                        np.float32),
            "mask_anomaly": np.ascontiguousarray(mask_anomaly, np.float32),
            "timestep": tstep,
        }
        if static is not None:
            item["static"] = np.ascontiguousarray(static, np.float32)
        return item
