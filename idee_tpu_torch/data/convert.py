# ------------------------------------------------------------------
"""Offline dataset conversion, NetCDF -> numpy caches (the port's copy of
idee_tpu/data/convert.py).

* convert_synthetic: the synthetic cube (data, labels, statistics and
  climatology) into the one .npz that data/synthetic.py::load_cube_npz
  reads;
* convert_reanalysis: the CERRA / ERA5-Land weekly trees into per-year
  memory-mapped .npy caches (cropped mean/std channels) plus a precomputed
  VHI / cold-surface label cache; ReanalysisDataset(cache_root=...) then
  serves items from mmap reads without decoding NetCDF per item.
"""
# ------------------------------------------------------------------

import json
import os
from typing import List, Optional

import numpy as np

from idee_tpu_torch.data.netcdf import NetCDFFile
from idee_tpu_torch.data.reanalysis import ReanalysisSpec, week_nr


def convert_synthetic(root: str, out_path: Optional[str] = None,
                      variables: Optional[List[str]] = None) -> str:
    """Convert a reference-schema synthetic directory (datacube_<exp>.nc +
    statistic_<exp>.json + climatology_<exp>.nc) into datacube_<exp>.npz."""
    exp = os.path.basename(os.path.normpath(root))
    out_path = out_path or os.path.join(root, f"datacube_{exp}.npz")

    with NetCDFFile(os.path.join(root, f"datacube_{exp}.nc")) as f:
        time = np.asarray(f.coord("time"))
        all_vars = [str(v) for v in f.coord("var")]
        variables = variables or all_vars
        dyn = np.stack([f.read(v) for v in variables]).astype(np.float32)
        anom = f.read("anomaly_extreme")
        n_t, n_v = time.shape[0], len(all_vars)
        # normalise to (var, time, ...) axis order
        if not (anom.shape[0] == n_v and anom.shape[1] == n_t):
            anom = anom.swapaxes(0, 1)
        anom = anom[np.array([all_vars.index(v) for v in variables])]
        extreme = f.read("extreme")
        svars = [v for v in ("latitude", "longitude") if f.has(v)]
        static = np.stack([f.read(v) for v in svars]) if svars else None

    with open(os.path.join(root, f"statistic_{exp}.json")) as fh:
        raw = json.load(fh)
    stats = {v: {k: float(raw[k][v])
                 for k in ("min", "max", "mean", "median", "std")}
             for v in variables}

    payload = dict(
        dynamic=dyn, anomaly=anom.astype(np.uint8),
        extreme=extreme.astype(np.uint8),
        variables=np.array(variables), timestep=time.astype(np.float32),
        stats=np.array(stats, dtype=object),
    )
    if static is not None:
        payload["static"] = static.astype(np.float32)
        payload["variables_static"] = np.array(svars)
    clima = os.path.join(root, f"climatology_{exp}.nc")
    if os.path.exists(clima):
        with NetCDFFile(clima) as f:
            mi = f.label_indices("climatology", ["median"])[0]
            si = f.label_indices("climatology", ["std"])[0]
            payload["clima_median"] = np.stack(
                [f.read(v)[mi] for v in variables]).astype(np.float32)
            payload["clima_std"] = np.stack(
                [f.read(v)[si] for v in variables]).astype(np.float32)
    np.savez(out_path, **payload)
    return out_path


def convert_reanalysis(spec: ReanalysisSpec, root_main: str, root_noaa: str,
                       years: List[str], variables: List[str],
                       out_root: str, alpha: float = 0.5,
                       x_min: int = 0, x_max: Optional[int] = None,
                       y_min: int = 0, y_max: Optional[int] = None) -> str:
    """Weekly CERRA/ERA5-Land NetCDF trees -> per-year mmap caches.

    Written layout (all arrays in the raw cropped orientation: the dataset
    applies its y flips as on the direct NetCDF path):
      meta.json                      {family, variables, crop, alpha}
      main_<year>.npy                [52, V, 2(mean,std), H, W] float32,
                                     NaN where the week's file is missing
      noaa_vhi_<year>.npy            [52, H, W] nanmean over the week's
                                     NOAA files of alpha*VCI+(1-alpha)*TCI
      noaa_cold_<year>.npy           [52, H, W] sum of cold-surface masks
      present_<year>.npy             [52, 2] bool (main, noaa)

    alpha is baked into the VHI cache; ReanalysisDataset compares it with
    its own alpha and reads the NetCDF files when they differ.
    """
    variables = sorted(variables)
    x_max = spec.grid_width if x_max is None else x_max
    y_max = spec.grid_height if y_max is None else y_max
    crop = {-2: slice(spec.grid_height - y_max, spec.grid_height - y_min),
            -1: slice(x_min, x_max)}
    H, W = y_max - y_min, x_max - x_min
    V = len(variables)

    os.makedirs(out_root, exist_ok=True)
    for year in sorted(years):
        main = np.full((52, V, 2, H, W), np.nan, np.float32)
        vhi = np.full((52, H, W), np.nan, np.float32)
        cold = np.zeros((52, H, W), np.float32)
        present = np.zeros((52, 2), bool)

        ydir = os.path.join(root_main, year)
        ndir = os.path.join(root_noaa, year)
        noaa_files = sorted(f for f in os.listdir(ndir)
                            if f.endswith(".nc")) if os.path.isdir(ndir) \
            else []
        for week in range(1, 53):
            wnr = week_nr(week)
            path = os.path.join(ydir, f"{year}{wnr}.nc")
            if os.path.exists(path):
                with NetCDFFile(path) as f:
                    stat = [str(s) for s in f.coord("statistic").tolist()]
                    mi, si = stat.index("mean"), stat.index("std")
                    for vi, v in enumerate(variables):
                        a = f.read(v, sel=crop)
                        main[week - 1, vi, 0] = a[mi]
                        main[week - 1, vi, 1] = a[si]
                present[week - 1, 0] = True
            wk_files = [os.path.join(ndir, f) for f in noaa_files
                        if f[-9:-6] == wnr]
            if wk_files:
                vhis, colds = [], []
                for p in wk_files:
                    with NetCDFFile(p) as f:
                        vci = f.read("VCI", sel=crop).astype(np.float32)
                        tci = f.read("TCI", sel=crop).astype(np.float32)
                        colds.append(f.read("mask_cold_surface", sel=crop)
                                     .astype(np.float32))
                    vhis.append(alpha * vci + (1 - alpha) * tci)
                with np.errstate(all="ignore"):
                    vhi[week - 1] = np.nanmean(np.stack(vhis), axis=0)
                cold[week - 1] = np.stack(colds).sum(0)
                present[week - 1, 1] = True

        np.save(os.path.join(out_root, f"main_{year}.npy"), main)
        np.save(os.path.join(out_root, f"noaa_vhi_{year}.npy"), vhi)
        np.save(os.path.join(out_root, f"noaa_cold_{year}.npy"), cold)
        np.save(os.path.join(out_root, f"present_{year}.npy"), present)

    with open(os.path.join(out_root, "meta.json"), "w") as fh:
        json.dump({"family": spec.name, "variables": variables,
                   "alpha": alpha,
                   "x_min": x_min, "x_max": x_max,
                   "y_min": y_min, "y_max": y_max}, fh)
    return out_root
