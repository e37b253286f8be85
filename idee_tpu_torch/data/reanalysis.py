# ------------------------------------------------------------------
"""Real-world reanalysis pipelines, CERRA and ERA5-Land (the port's copy of
idee_tpu/data/reanalysis.py; reference dataset/CERRA_dataset.py and
dataset/ERA5_Land_dataset.py). One dataset class, parameterised by a
ReanalysisSpec, covers both.

Semantics, as in the JAX package:
* file-per-week layout root/<year>/<year><www>.nc with year-boundary
  rollover and missing-NOAA-week fallback (CERRA_dataset.py:204-283);
  skip rules: CERRA 1984 w < delta_t+36, 2021 w > 17;
  ERA5-Land 1981 w < delta_t+35, 2024 w > 14
* labels made on the fly from NOAA: VHI = alpha*VCI + (1-alpha)*TCI,
  drought = VHI < threshold (target week: config.threshold; loss union:
  35), minus cold-surface / no-vegetation / water pixels
  (CERRA_dataset.py:452-518)
* y axis: crop y = slice(H_grid - y_max, H_grid - y_min), then flip y
* normalisation: global mean/std (the `mean` channel is (x-mean)/std, the
  `std` channel x/std) or the weekly pixel climatology of the window's
  weeks; clip +-10, nan/inf -> nan_fill
* 2 channels per variable: statistic = [mean, std]

The VHI threshold runs in the host engine (idee_tpu_torch/native
``vhi_mask``), as in the JAX package; ``vhi_drought_plain`` is its numpy
version.
"""
# ------------------------------------------------------------------

import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from idee_tpu_torch import native
from idee_tpu_torch.config import CORDEX_REGIONS
from idee_tpu_torch.data.netcdf import NetCDFFile
from idee_tpu_torch.data.synthetic import _window_mean, draw_aug


def vhi_drought_plain(vhi: np.ndarray, cold: np.ndarray,
                      thr: float) -> np.ndarray:
    """The numpy version of the engine's VHI core as the label engine
    calls it: 1 where vhi < thr (a NaN VHI is no drought) and cold != 1,
    else 0, float32."""
    drought = (vhi < thr).astype(np.float32)
    drought[cold == 1] = 0
    return drought


@dataclass
class ReanalysisSpec:
    """Dataset-family geometry and file naming."""

    name: str
    grid_height: int          # full grid H (1069 for CERRA)
    grid_width: int
    stats_file: str           # global statistics json
    clima_file: str           # weekly pixel climatology NetCDF
    masks_file: str           # no-vegetation (+ ERA5: lsm) masks NetCDF
    static_file: Optional[str]  # CERRA static variables NetCDF (has lsm)
    water_from_masks: bool    # ERA5-Land: lsm lives in masks_file
    skip_rules: Dict[int, Tuple[int, int]]  # year -> (min_week, max_week)


def cerra_spec(delta_t: int) -> ReanalysisSpec:
    return ReanalysisSpec(
        name="CERRA", grid_height=1069, grid_width=1069,
        stats_file="CERRA_statistic_train.json",
        clima_file="CERRA_climatology_pixels_train.nc",
        masks_file="masks.nc",
        static_file="CERRA_static_variables.nc",
        water_from_masks=False,
        skip_rules={1984: (delta_t + 36, 52), 2021: (1, 17)},
    )


def era5_land_spec(region: str, delta_t: int) -> ReanalysisSpec:
    H, W = CORDEX_REGIONS[region]
    return ReanalysisSpec(
        name="ERA5_Land", grid_height=H, grid_width=W,
        stats_file=f"{region}_statistic_train.json",
        clima_file=f"{region}_climatology_pixels_train.nc",
        masks_file=f"{region}_masks.nc",
        static_file=None,
        water_from_masks=True,
        skip_rules={1981: (delta_t + 35, 52), 2024: (1, 14)},
    )


def week_nr(week: int) -> str:
    """Week 1..52 -> its three-digit file suffix."""
    return f"{week:03d}"


def _noaa_files(directory: str, files: List[str], wnr: str) -> List[str]:
    return [os.path.join(directory, f) for f in files if f[-9:-6] == wnr]


def _nc_files(directory: str) -> List[str]:
    return sorted(f for f in os.listdir(directory) if f.endswith(".nc"))


def build_week_index(root_main: str, root_noaa: str, years: List[str],
                     delta_t: int,
                     skip_rules: Dict[int, Tuple[int, int]]) -> List[Tuple]:
    """Per-target-week file lists with year rollover and missing-NOAA-week
    fallback (reference: CERRA_dataset.py:204-283).

    Returns [(files_main, files_noaa, weeks[float32])], where files_noaa is
    a list of delta_t *lists* (each holding >= 1 NOAA files to average).
    """
    index = []
    for year in sorted(years):
        year_dir_main = os.path.join(root_main, year)
        if not os.path.isdir(year_dir_main):
            raise ValueError(
                f"Year {year} does not exist in the {root_main} data")
        year_dir_noaa = os.path.join(root_noaa, year)
        if not os.path.isdir(year_dir_noaa):
            raise ValueError(f"Year {year} does not exist in the NOAA data")
        files = _nc_files(year_dir_noaa)
        lo, hi = skip_rules.get(int(year), (1, 52))

        for week in range(1, 53):
            if not _noaa_files(year_dir_noaa, files, week_nr(week)):
                continue
            if week < lo or week > hi:
                continue
            files_main, files_noaa, weeks = [], [], []
            for dt in range(delta_t):
                week_t = week - dt
                if week_t > 0:
                    year_t, dir_t, files_t = year, year_dir_noaa, files
                else:  # the window reaches into the previous year
                    week_t += 52
                    year_t = str(int(year) - 1)
                    dir_t = os.path.join(root_noaa, year_t)
                    files_t = _nc_files(dir_t)
                wtnr = week_nr(week_t)
                f_noaa = _noaa_files(dir_t, files_t, wtnr)
                if not f_noaa:
                    f_noaa = files_noaa[-1]  # missing-week fallback
                files_main.append(os.path.join(root_main, year_t,
                                               year_t + wtnr + ".nc"))
                files_noaa.append(f_noaa)
                weeks.append(week_t)
            index.append((files_main, files_noaa,
                          np.array(weeks, np.float32)))
    if not index:
        raise ValueError("No files were found in the root directories")
    return index


class ReanalysisDataset:
    """CERRA / ERA5-Land weekly dataset with on-the-fly VHI labels.

    Items are dicts of numpy arrays:
      x                      [V, 2, delta_t, H, W]  (mean, std channels;
                                                     time index 0 = target)
      week                   [delta_t]
      mask_extreme           [H, W] drought at the target week (thr=threshold)
      mask_extreme_loss      [H, W] drought union over the window (thr=35)
      mask_cold_surface      [H, W]
      mask_cold_surface_loss [H, W] union over steps 1..delta_t-1
      mask_sea               [H, W]
      mask_no_vegetation     [H, W]
      name_code              scalar <year><www> of the target week's file
    """

    def __init__(self, spec: ReanalysisSpec, root_main: str, root_noaa: str,
                 nan_fill: float = 0.0, delta_t: int = 4,
                 is_aug: bool = False, is_shuffle: bool = False,
                 is_clima_scale: bool = False, is_norm: bool = True,
                 variables: Optional[List[str]] = None,
                 variables_static: Optional[List[str]] = None,
                 years: Optional[List[str]] = None,
                 threshold: float = 26.0, alpha: float = 0.5,
                 window_size: int = 1,
                 x_min: int = 0, x_max: Optional[int] = None,
                 y_min: int = 0, y_max: Optional[int] = None,
                 seed: int = 0, cache_root: Optional[str] = None):
        self.spec = spec
        self.root_main = root_main
        self.root_noaa = root_noaa
        self.nan_fill = nan_fill
        self.delta_t = delta_t
        self.is_aug = is_aug
        self.is_norm = is_norm
        self.is_clima_scale = is_clima_scale
        self.threshold = threshold
        self.alpha = alpha
        self.window_size = window_size
        self.is_reduce = window_size > 1
        self._rng = np.random.default_rng(seed)

        self.variables_dynamic = sorted(variables or [])
        # the reference loads the static variables but its items do not
        # carry them (CERRA_dataset.py:361-398); neither do these
        self.variables_static = sorted(variables_static or [])
        self.years = sorted(years or [])

        self.x_min = x_min
        self.x_max = spec.grid_width if x_max is None else x_max
        self.y_min = y_min
        self.y_max = spec.grid_height if y_max is None else y_max
        self.n_lat = self.y_max - self.y_min
        self.n_lon = self.x_max - self.x_min
        self.n_lat_window = self.n_lat // window_size
        self.n_lon_window = self.n_lon // window_size

        self.files = build_week_index(root_main, root_noaa, self.years,
                                      delta_t, spec.skip_rules)
        if is_shuffle:
            self._rng.shuffle(self.files)

        # optional offline cache (data/convert.py::convert_reanalysis):
        # per-year mmap'd arrays replace the NetCDF reads and the VHI
        # recompute of each item
        self._cache = None
        if cache_root is not None:
            self._open_cache(cache_root)

        if is_norm:
            if is_clima_scale:
                self._load_climatology()
            else:
                self._load_statistics()
        self._load_valid_pixel_masks()

    # -- crop: y = slice(H_grid - y_max, H_grid - y_min), read as a slab --

    def _ysl(self) -> slice:
        return slice(self.spec.grid_height - self.y_max,
                     self.spec.grid_height - self.y_min)

    def _xsl(self) -> slice:
        return slice(self.x_min, self.x_max)

    def _read_crop(self, f: NetCDFFile, name: str) -> np.ndarray:
        return f.read(name, sel={-2: self._ysl(), -1: self._xsl()})

    # -- loaders --

    def _load_statistics(self):
        with open(os.path.join(self.root_main, self.spec.stats_file)) as fh:
            d = json.load(fh)
        self._mean_var = np.array([float(d["mean"][v])
                                   for v in self.variables_dynamic])
        self._std_var = np.array([float(d["std"][v])
                                  for v in self.variables_dynamic])

    def _load_climatology(self):
        """Weekly pixel climatology: per-variable arrays
        [climatology, statistic, week, y, x]."""
        path = os.path.join(self.root_main, self.spec.clima_file)
        with NetCDFFile(path) as f:
            clim_i = {c: i for i, c in
                      enumerate(f.coord("climatology").tolist())}
            weeks = np.asarray(f.coord("week"))
            self._clima_week_lut = {float(w): i for i, w in enumerate(weeks)}
            mean, std = [], []
            for v in self.variables_dynamic:
                a = self._read_crop(f, v)
                mean.append(a[clim_i["mean"]])
                std.append(a[clim_i["std"]])
            # [V, statistic(2), week, Hc, Wc]
            self._clima_mean = np.stack(mean).astype(np.float32)
            self._clima_std = np.stack(std).astype(np.float32)

    def _load_valid_pixel_masks(self):
        with NetCDFFile(os.path.join(self.root_noaa,
                                     self.spec.masks_file)) as f:
            nv = self._read_crop(f, "mask_no_vegetation")
            self.mask_no_vegetation = np.flip(nv, -2).astype(np.float32)
            if self.spec.water_from_masks:
                lsm = self._read_crop(f, "lsm")
        if not self.spec.water_from_masks:
            with NetCDFFile(os.path.join(self.root_main,
                                         self.spec.static_file)) as f:
                lsm = self._read_crop(f, "lsm")
        water = np.flip(lsm, -2).astype(np.float32)
        if not self.spec.water_from_masks:
            # CERRA's lsm is binarised before the inversion; ERA5-Land's is
            # a land fraction, inverted as it is
            water = np.where(water > 0.5, 1.0, 0.0).astype(np.float32)
        self.mask_water = (-1 * (water - 1)).astype(np.float32)

        if self.is_reduce:
            nvs = _window_mean(self.mask_no_vegetation, self.window_size,
                               (0, 1))
            self.mask_no_vegetation_scaled = np.where(nvs >= 0.5, 1.0, 0.0)
            ws = _window_mean(self.mask_water, self.window_size, (0, 1))
            self.mask_water_scaled = np.where(ws >= 0.5, 1.0, 0.0)

    # -- offline cache (data/convert.py::convert_reanalysis) --

    @staticmethod
    def _file_year_week(path: str) -> Tuple[str, int]:
        """root/<year>/<year><www>[...].nc -> (year, week)."""
        name = os.path.basename(path)
        return name[:4], int(name[4:7])

    def _open_cache(self, cache_root: str):
        meta_path = os.path.join(cache_root, "meta.json")
        if not os.path.exists(meta_path):
            return
        with open(meta_path) as fh:
            meta = json.load(fh)
        crop_ok = (meta["x_min"] == self.x_min and meta["x_max"] == self.x_max
                   and meta["y_min"] == self.y_min
                   and meta["y_max"] == self.y_max)
        vars_ok = set(self.variables_dynamic) <= set(meta["variables"])
        if not (crop_ok and vars_ok and
                float(meta["alpha"]) == float(self.alpha)):
            return  # geometry or alpha differ: the direct NetCDF path
        years_needed = set(self.years)
        for _, noaa, _ in self.files:  # the rollover may touch year - 1
            for lst in noaa:
                years_needed.add(self._file_year_week(lst[0])[0])
        cache = {"vi": np.array([meta["variables"].index(v)
                                 for v in self.variables_dynamic])}
        for year in years_needed:
            paths = {k: os.path.join(cache_root, f"{k}_{year}.npy")
                     for k in ("main", "noaa_vhi", "noaa_cold", "present")}
            if not all(os.path.exists(p) for p in paths.values()):
                return  # incomplete cache: the direct path
            cache[year] = {k: np.load(p, mmap_mode="r")
                           for k, p in paths.items()}
        self._cache = cache

    # -- label engine --

    def _finish_mask(self, vhi: np.ndarray, cold_sum: np.ndarray,
                     thr: float):
        """Week-level (vhi, summed cold masks) -> (drought, cold) in display
        orientation (reference: CERRA_dataset.py:478-518)."""
        cold = np.flip(cold_sum, 0).astype(np.float32).copy()
        cold[cold > 1] = 1

        if self.is_reduce:
            with np.errstate(all="ignore"):
                vhi = _window_mean(vhi, self.window_size, (0, 1))
            cold = cold.reshape(self.n_lat_window, self.window_size,
                                self.n_lon_window, self.window_size)
            cold = np.nanmin(cold, axis=(1, 3))
            cold = np.where(cold >= 0.5, 1.0, 0.0).astype(np.float32)
            noveg = self.mask_no_vegetation_scaled
            water = self.mask_water_scaled
        else:
            noveg = self.mask_no_vegetation
            water = self.mask_water

        # the engine's fused threshold with the cold exclusion (JAX
        # idee_tpu/data/reanalysis.py:370-377): it drops any cold != 0 and
        # the reference drops cold == 1, so it gets the binarised mask
        v = np.ascontiguousarray(np.flip(vhi, 0), np.float32)
        drought = native.vhi_mask(
            v, v, np.ascontiguousarray(cold == 1, np.float32), self.alpha,
            thr)
        drought[noveg == 1] = 0
        drought[water == 1] = 0
        return drought, cold

    def generate_mask(self, noaa_files: List[str], thr: float):
        """VHI drought mask + cold-surface mask for one week
        (reference: CERRA_dataset.py:452-518)."""
        if self._cache is not None:
            year, week = self._file_year_week(noaa_files[0])
            yc = self._cache[year]
            if yc["present"][week - 1, 1]:
                return self._finish_mask(
                    np.array(yc["noaa_vhi"][week - 1]),
                    np.array(yc["noaa_cold"][week - 1]), thr)

        vhi_list, cold_list = [], []
        for path in noaa_files:
            with NetCDFFile(path) as f:
                vci = self._read_crop(f, "VCI").astype(np.float32)
                tci = self._read_crop(f, "TCI").astype(np.float32)
                cold = self._read_crop(f, "mask_cold_surface").astype(
                    np.float32)
            vhi_list.append(self.alpha * vci + (1 - self.alpha) * tci)
            cold_list.append(cold)

        with np.errstate(all="ignore"):
            vhi = np.nanmean(np.stack(vhi_list), axis=0)
        return self._finish_mask(vhi, np.stack(cold_list).sum(0), thr)

    # -- data loading --

    def load_datacube(self, files_main: List[str]) -> np.ndarray:
        """delta_t weekly files -> [V, 2(mean,std), delta_t, H, W], y-flipped
        (reference: CERRA_dataset.py:525-551)."""
        if self._cache is not None:
            vi = self._cache["vi"]
            per_week = []
            for path in files_main:
                year, week = self._file_year_week(path)
                yc = self._cache[year]
                if not yc["present"][week - 1, 0]:
                    break  # a week missing from the cache: direct path
                per_week.append(np.array(yc["main"][week - 1][vi]))
            else:
                cube = np.stack(per_week, axis=2)  # [V, 2, dt, y, x]
                return np.flip(cube, -2).astype(np.float32)
        per_week = []
        for path in files_main:
            with NetCDFFile(path) as f:
                stat = [str(s) for s in f.coord("statistic").tolist()]
                mi, si = stat.index("mean"), stat.index("std")
                vars_ = []
                for v in self.variables_dynamic:
                    a = self._read_crop(f, v)  # [statistic, y, x]
                    vars_.append(np.stack([a[mi], a[si]]))
                per_week.append(np.stack(vars_))  # [V, 2, y, x]
        cube = np.stack(per_week, axis=2)  # [V, 2, dt, y, x]
        return np.flip(cube, -2).astype(np.float32)

    @property
    def input_size(self):
        """(T, H, W) of an item's x: the model's input geometry."""
        return (self.delta_t, self.n_lat_window, self.n_lon_window)

    def __len__(self):
        return len(self.files)

    def draw_aug(self):
        """The next item's augmentation (``draw_aug``) from the dataset's
        random stream; None without ``is_aug``."""
        return draw_aug(self._rng) if self.is_aug else None

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        return self.item(index, self.draw_aug())

    def item(self, index: int, aug) -> Dict[str, np.ndarray]:
        """Item ``index`` with the augmentation ``aug`` of draw_aug."""
        files_main, files_noaa, weeks = self.files[index]

        x = self.load_datacube(files_main)

        dl = np.zeros((self.delta_t, self.n_lat_window, self.n_lon_window),
                      np.float32)
        cl = np.zeros_like(dl)
        for d in range(self.delta_t):
            dl[d], cl[d] = self.generate_mask(files_noaa[d], thr=35)
        # the cold-surface loss union leaves out the target step
        # (reference: CERRA_dataset.py:594-595)
        mask_cold_loss = np.clip(cl[1:].sum(0), 0, 1)
        mask_drought_loss = np.clip(dl.sum(0), 0, 1)

        mask_drought, mask_cold = self.generate_mask(files_noaa[0],
                                                     thr=self.threshold)

        if self.is_reduce:
            mask_sea = self.mask_water_scaled.copy()
            mask_noveg = self.mask_no_vegetation_scaled.copy()
        else:
            mask_sea = self.mask_water.copy()
            mask_noveg = self.mask_no_vegetation.copy()

        if self.is_norm:
            if self.is_clima_scale:
                wk = [self._clima_week_lut[float(w)] for w in weeks]
                mean = np.flip(self._clima_mean[:, :, wk], -2)  # [V,2,dt,H,W]
                std = np.flip(self._clima_std[:, :, wk], -2)
                with np.errstate(all="ignore"):
                    x = (x - mean) / std
            else:
                # mean channel: (x - mean) / std; std channel: x / std
                # (reference: CERRA_dataset.py:618-620)
                m = self._mean_var[:, None, None, None].astype(np.float32)
                s = self._std_var[:, None, None, None].astype(np.float32)
                x = np.stack([(x[:, 0] - m) / s, x[:, 1] / s], axis=1)
            x = np.clip(x, -10.0, 10.0)

        x[np.isnan(x) | np.isinf(x)] = self.nan_fill

        if self.is_reduce:
            with np.errstate(all="ignore"):
                x = _window_mean(x, self.window_size, (3, 4))

        if aug is not None:
            rotate, flip = aug
            arrays = [x, mask_drought, mask_drought_loss, mask_cold,
                      mask_cold_loss, mask_sea, mask_noveg]
            if rotate:
                arrays = [np.rot90(a, k=2, axes=(-1, -2)) for a in arrays]
            if flip:
                arrays = [np.flip(a, axis=-flip) for a in arrays]
            (x, mask_drought, mask_drought_loss, mask_cold,
             mask_cold_loss, mask_sea, mask_noveg) = arrays

        return {
            "x": np.ascontiguousarray(x, np.float32),
            "week": np.ascontiguousarray(weeks, np.float32),
            "mask_extreme": np.ascontiguousarray(mask_drought, np.float32),
            "mask_extreme_loss": np.ascontiguousarray(mask_drought_loss,
                                                      np.float32),
            "mask_cold_surface": np.ascontiguousarray(mask_cold, np.float32),
            "mask_cold_surface_loss": np.ascontiguousarray(mask_cold_loss,
                                                           np.float32),
            "mask_sea": np.ascontiguousarray(mask_sea, np.float32),
            "mask_no_vegetation": np.ascontiguousarray(mask_noveg, np.float32),
            "name_code": np.float32(int(os.path.basename(
                files_main[0])[:-3])),
        }
