# ------------------------------------------------------------------
"""Fake datasets for tests and the chip smoke run (the port's copy of
idee_tpu/data/fake.py: the same numpy draws in the same order give the
same arrays from the same seed).

* make_fake_cube: a synthetic datacube with the statistic/climatology
  schema of the real synthetic dataset, per-variable seasonal background
  plus planted anomaly blobs that precede extreme events;
* make_benchmark_cube: the accuracy benchmark's cube, causal
  anomaly-to-extreme structure with distractors; save_cube_npz /
  load_cube_npz cache a whole cube (the JAX package's format, so either
  package reads the other's file);
* write_synthetic_netcdf: a cube in the reference's directory schema
  (datacube / statistic / climatology), as NetCDF3;
* write_fake_reanalysis, write_structured_reanalysis: CERRA / ERA5-Land
  directory trees. The JAX package writes them as NetCDF4 through h5py;
  these write NetCDF3 (64-bit offset) through scipy, so they need no h5py,
  and string coordinates become char matrices.
"""
# ------------------------------------------------------------------

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from idee_tpu_torch.data.synthetic import SyntheticCube, cube_npz_path


def _with_statistics(dynamic, anomaly, extreme, variables, static,
                     variables_static) -> SyntheticCube:
    """The cube with the statistic / climatology schema of the reference's
    dataset: per-variable global stats, and the weekly pixel-wise median
    and std (+ 0.01) grouped by week of year (global ones for a week the
    cube does not reach)."""
    stats = {
        v: {
            "min": float(dynamic[i].min()),
            "max": float(dynamic[i].max()),
            "mean": float(dynamic[i].mean()),
            "median": float(np.median(dynamic[i])),
            "std": float(dynamic[i].std()),
        }
        for i, v in enumerate(variables)
    }
    n_vars, n_time, height, width = dynamic.shape
    wk = np.arange(n_time) % 52
    clima_median = np.zeros((n_vars, 52, height, width), np.float32)
    clima_std = np.ones((n_vars, 52, height, width), np.float32)
    for w in range(52):
        sel = dynamic[:, wk == w]
        if sel.shape[1] == 0:
            sel = dynamic
        clima_median[:, w] = np.median(sel, axis=1)
        clima_std[:, w] = sel.std(axis=1) + 1e-2
    return SyntheticCube(
        dynamic=dynamic, anomaly=anomaly, extreme=extreme,
        variables=variables, static=static,
        variables_static=variables_static, stats=stats,
        clima_median=clima_median, clima_std=clima_std)


def make_fake_cube(
    n_vars: int = 6,
    n_time: int = 104,
    height: int = 32,
    width: int = 32,
    n_static: int = 2,
    seed: int = 0,
    anomaly_rate: float = 0.05,
    variables: Optional[List[str]] = None,
) -> SyntheticCube:
    rng = np.random.default_rng(seed)
    variables = variables or [f"var_{i + 1:02d}" for i in range(n_vars)]

    week = (np.arange(n_time) % 52).astype(np.float32)
    season = np.sin(2 * np.pi * week / 52.0)[None, :, None, None]
    base = rng.normal(0.0, 1.0, (n_vars, 1, height, width)).astype(np.float32)
    noise = rng.normal(0.0, 0.3, (n_vars, n_time, height, width)).astype(np.float32)
    dynamic = base + season + noise

    # plant anomaly blobs; an extreme fires where >= half the variables are
    # anomalous at a pixel. Independent per-variable blobs alone almost
    # never overlap in >= half the variables, so in addition plant shared
    # "events": co-located blobs across a random majority of variables --
    # this guarantees extremes exist at every grid size/seed.
    anomaly = np.zeros((n_vars, n_time, height, width), np.uint8)
    n_blobs = max(1, int(anomaly_rate * n_time))
    need = max(2, n_vars // 2)

    def blob():
        t0 = int(rng.integers(0, max(n_time - 4, 1)))
        yy = int(rng.integers(0, max(height - 8, 1)))
        xx = int(rng.integers(0, max(width - 8, 1)))
        dt = int(rng.integers(2, 5))
        hh = int(rng.integers(4, 9))
        ww = int(rng.integers(4, 9))
        return t0, dt, yy, hh, xx, ww

    for v in range(n_vars):
        for _ in range(n_blobs * 4):
            t0, dt, yy, hh, xx, ww = blob()
            anomaly[v, t0:t0 + dt, yy:yy + hh, xx:xx + ww] = 1
    for _ in range(n_blobs * 4):
        t0, dt, yy, hh, xx, ww = blob()
        n_hit = int(rng.integers(need, n_vars + 1))
        for v in rng.choice(n_vars, size=n_hit, replace=False):
            anomaly[v, t0:t0 + dt, yy:yy + hh, xx:xx + ww] = 1
    dynamic = (dynamic + 3.0 * anomaly).astype(np.float32)  # anomalies shift the signal

    extreme = (anomaly.sum(0) >= need).astype(np.uint8)

    static = rng.normal(0.0, 1.0, (n_static, height, width)).astype(np.float32)
    svars = ["latitude", "longitude"][:n_static] + [
        f"static_{i}" for i in range(max(0, n_static - 2))
    ]

    return _with_statistics(dynamic, anomaly, extreme, variables, static,
                            svars)


def write_cube_npz(root: str, cube: SyntheticCube,
                   t0: int = 1) -> str:
    """Write ``cube`` as <root>/datacube_<basename(root)>.npz in the format
    load_cube_npz reads (stats as a JSON string, so no pickle); its first
    week gets absolute timestep ``t0``. Returns the path."""
    os.makedirs(root, exist_ok=True)
    path = cube_npz_path(root)
    T = cube.dynamic.shape[1]
    extras = {}
    if cube.static is not None:
        extras["static"] = cube.static
        extras["variables_static"] = np.array(cube.variables_static)
    if cube.clima_median is not None:
        extras["clima_median"] = cube.clima_median
        extras["clima_std"] = cube.clima_std
    np.savez(path, dynamic=cube.dynamic, anomaly=cube.anomaly,
             extreme=cube.extreme, variables=np.array(cube.variables),
             timestep=np.arange(t0, t0 + T, dtype=np.float32),
             stats=np.array(json.dumps(cube.stats)), **extras)
    return path


def make_benchmark_cube(
    n_vars: int = 6,
    n_time: int = 2080,
    height: int = 200,
    width: int = 200,
    n_static: int = 2,
    seed: int = 0,
    events_per_year: float = 8.0,
    distractors_per_year: float = 10.0,
    mag_lo: float = 2.0,
    mag_hi: float = 3.5,
    variables: Optional[List[str]] = None,
) -> SyntheticCube:
    """The accuracy benchmark's cube: the structure the reference model
    class is built to exploit (dataset/Synthetic_dataset.py and the
    training objective, models/losses.py:127-168), in place of the
    reference's 46 GB synthetic dataset:

    * per-variable weekly seasonal cycle with smooth spatial amplitude and
      phase fields, plus AR(1)-in-time spatially correlated noise;
    * "events": spatio-temporal ellipsoids where a random majority of the
      variables turn anomalous (signed 2-3.5 sigma shifts), each
      variable's anomaly leading the extreme by 0-3 weeks, within the
      delta_t=8 window;
    * the extreme mask is the event's spatial core for its duration;
    * single-variable distractor anomalies with no extreme, so the
      anomaly-extreme coupling (not mere deviation) must be learned.

    The anomaly masks mark exactly the planted anomalous regions, the
    extreme masks the cores.
    """
    rng = np.random.default_rng(seed)
    variables = variables or [f"var_{i + 1:02d}" for i in range(n_vars)]

    week = (np.arange(n_time) % 52).astype(np.float32)

    dynamic = np.empty((n_vars, n_time, height, width), np.float32)
    for v in range(n_vars):
        amp = 0.5 + 0.5 * np.abs(_smooth_field(rng, height, width, 30))
        phase = 0.8 * _smooth_field(rng, height, width, 30)
        dynamic[v] = amp[None] * np.sin(
            2 * np.pi * week[:, None, None] / 52.0 + phase[None])
    # AR(1) noise with spatially correlated innovations
    rho, sigma = 0.65, 0.55
    state = np.zeros((n_vars, height, width), np.float32)
    scale = sigma * np.sqrt(1.0 - rho * rho)
    for t in range(n_time):
        innov = np.stack([_smooth_field(rng, height, width, 6)
                          for _ in range(n_vars)])
        state = rho * state + scale * innov
        dynamic[:, t] += state

    anomaly = np.zeros((n_vars, n_time, height, width), np.uint8)
    extreme = np.zeros((n_time, height, width), np.uint8)
    need = max(2, n_vars // 2)

    yy = np.arange(height, dtype=np.float32)
    xx = np.arange(width, dtype=np.float32)

    def ellipse(cy, cx, ry, rx, theta):
        dy = yy[:, None] - cy
        dx = xx[None, :] - cx
        c, s = np.cos(theta), np.sin(theta)
        u = (c * dx + s * dy) / rx
        v_ = (-s * dx + c * dy) / ry
        return u * u + v_ * v_  # r^2 field

    def plant(vars_hit, t0, dur, cy, cx, ry, rx, theta, is_event):
        r2 = ellipse(cy, cx, ry, rx, theta)
        core = r2 <= 1.0
        halo = r2 <= 1.69  # anomalies spread ~30% beyond the extreme core
        if not halo.any():
            return
        shape = np.clip(1.0 - 0.3 * r2, 0.0, None) * halo
        for v in vars_hit:
            mag = float(rng.uniform(mag_lo, mag_hi)) * (
                1 if rng.random() < 0.5 else -1)
            lead = int(rng.integers(0, 4)) if is_event else 0
            lo = max(0, t0 - lead)
            hi = min(n_time, t0 + dur)
            if hi <= lo:
                continue
            dynamic[v, lo:hi] += mag * shape[None]
            anomaly[v, lo:hi] |= halo[None]
        if is_event:
            hi = min(n_time, t0 + dur)
            if hi > t0:
                extreme[t0:hi] |= core[None]

    def place():
        return dict(dur=int(rng.integers(2, 7)),
                    cy=float(rng.uniform(10, height - 10)),
                    cx=float(rng.uniform(10, width - 10)),
                    ry=float(rng.uniform(6, 20)), rx=float(rng.uniform(6, 20)),
                    theta=float(rng.uniform(0, np.pi)))

    for _ in range(int(events_per_year * n_time / 52.0)):
        m = int(rng.integers(need, n_vars + 1))
        hit = rng.choice(n_vars, size=m, replace=False)
        plant(hit, t0=int(rng.integers(4, n_time - 2)), **place(),
              is_event=True)
    for _ in range(int(distractors_per_year * n_time / 52.0)):
        hit = [int(rng.integers(n_vars))]
        plant(hit, t0=int(rng.integers(0, n_time - 2)), **place(),
              is_event=False)

    static = np.stack([_smooth_field(rng, height, width, 25)
                       for _ in range(n_static)])
    svars = ["latitude", "longitude"][:n_static] + [
        f"static_{i}" for i in range(max(0, n_static - 2))]

    return _with_statistics(dynamic, anomaly, extreme, variables, static,
                            svars)


def save_cube_npz(path: str, cube: SyntheticCube) -> None:
    """Cache a whole generated cube at ``path`` (the cube is deterministic
    in its seed; at 200x200 over 40 years it takes minutes to generate
    and seconds to load). Stats go in as a JSON string, so the file loads
    with ``allow_pickle=False``."""
    extras = {}
    if cube.static is not None:
        extras["static"] = cube.static
        extras["variables_static"] = np.array(cube.variables_static)
    np.savez(path, dynamic=cube.dynamic, anomaly=cube.anomaly,
             extreme=cube.extreme, variables=np.array(cube.variables),
             stats=np.array(json.dumps(cube.stats)),
             clima_median=cube.clima_median, clima_std=cube.clima_std,
             **extras)


def load_cube_npz(path: str) -> SyntheticCube:
    """The cube that save_cube_npz wrote."""
    z = np.load(path, allow_pickle=False)
    return SyntheticCube(
        dynamic=z["dynamic"], anomaly=z["anomaly"], extreme=z["extreme"],
        variables=[str(v) for v in z["variables"]],
        static=z["static"] if "static" in z else None,
        variables_static=([str(v) for v in z["variables_static"]]
                          if "variables_static" in z else []),
        stats=json.loads(str(z["stats"])),
        clima_median=z["clima_median"], clima_std=z["clima_std"])


def write_synthetic_netcdf(root: str, cube: SyntheticCube) -> None:
    """Write ``cube`` in the reference's directory schema under ``root``
    (exp = basename(root)): datacube_<exp>.nc with the coordinates time
    (1..T) and var, one [time, y, x] variable per dynamic variable,
    anomaly_extreme [var, time, y, x] (xarray's order), extreme and the
    [y, x] static layers; statistic_<exp>.json as {stat: {var: value}};
    climatology_<exp>.nc with the coordinate climatology (median, std)
    and one [climatology, week, y, x] variable per dynamic variable.
    NetCDF3, so the masks are stored as signed bytes (NetCDF3 has no
    unsigned byte)."""
    os.makedirs(root, exist_ok=True)
    exp = os.path.basename(os.path.normpath(root))
    T = cube.dynamic.shape[1]
    TYX = ("time",) + YX

    datacube = {"time": (("time",), np.arange(1, T + 1, dtype=np.float64)),
                "var": (("var",), np.array(cube.variables))}
    for i, v in enumerate(cube.variables):
        datacube[v] = (TYX, cube.dynamic[i])
    datacube["anomaly_extreme"] = (("var",) + TYX,
                                   cube.anomaly.astype(np.int8))
    datacube["extreme"] = (TYX, cube.extreme.astype(np.int8))
    if cube.static is not None:
        for i, v in enumerate(cube.variables_static):
            datacube[v] = (YX, cube.static[i])
    _write_nc3(os.path.join(root, f"datacube_{exp}.nc"), datacube)

    _write_json(os.path.join(root, f"statistic_{exp}.json"), {
        k: {v: cube.stats[v][k] for v in cube.variables}
        for k in ("min", "max", "mean", "median", "std")})

    clima = {"climatology": (("climatology",), np.array(["median", "std"]))}
    for i, v in enumerate(cube.variables):
        clima[v] = (("climatology", "week") + YX,
                    np.stack([cube.clima_median[i], cube.clima_std[i]]))
    _write_nc3(os.path.join(root, f"climatology_{exp}.nc"), clima)


# ------------------------------------------------------------------
# reanalysis trees


def _write_nc3(path: str,
              variables: Dict[str, Tuple[Sequence[str], np.ndarray]]) -> None:
    """Write {name: (dimension names, array)} as a NetCDF3 file (64-bit
    offset, so variables of more than 2 GB in all fit). String arrays
    become [n, nchar] char matrices, which NetCDFFile.coord decodes."""
    from scipy.io import netcdf_file

    with netcdf_file(path, "w", version=2) as f:
        for name, (dims, data) in variables.items():
            data = np.asarray(data)
            dims = tuple(dims)
            if data.dtype.kind in ("U", "S"):
                strs = [s.decode() if isinstance(s, bytes) else str(s)
                        for s in data.tolist()]
                chars = np.zeros((len(strs), max(map(len, strs))), "S1")
                for i, s in enumerate(strs):
                    chars[i, :len(s)] = list(s)
                data, dims = chars, dims + (f"nchar_{name}",)
            for d, n in zip(dims, data.shape):
                if d not in f.dimensions:
                    f.createDimension(d, n)
            f.createVariable(name, data.dtype, dims)[:] = data


def _smooth_field(rng, height, width, length):
    """Unit-variance Gaussian random field with correlation length `length`
    (spectral smoothing)."""
    f = rng.normal(size=(height, width))
    ky = np.fft.fftfreq(height)[:, None]
    kx = np.fft.fftfreq(width)[None, :]
    filt = np.exp(-0.5 * ((ky * length) ** 2 + (kx * length) ** 2)
                  * (2 * np.pi) ** 2)
    s = np.fft.ifft2(np.fft.fft2(f) * filt).real
    s = (s - s.mean()) / (s.std() + 1e-12)
    return s.astype(np.float32)


YX = ("y", "x")


def _tree_roots(root_main: str, root_noaa: str, era5_region: Optional[str]):
    """(root_main, root_noaa, file prefix, masks file name), directories
    made."""
    if era5_region:
        root_main = os.path.join(root_main, era5_region)
        root_noaa = os.path.join(root_noaa, era5_region)
        prefix, masks_name = era5_region + "_", era5_region + "_masks.nc"
    else:
        prefix, masks_name = "CERRA_", "masks.nc"
    os.makedirs(root_main, exist_ok=True)
    os.makedirs(root_noaa, exist_ok=True)
    return root_main, root_noaa, prefix, masks_name


def _write_json(path: str, obj) -> None:
    with open(path, "w") as fh:
        json.dump(obj, fh)


def write_structured_reanalysis(
    root_main: str,
    root_noaa: str,
    variables: Optional[List[str]] = None,
    years=("1989", "1990", "1991", "1992"),
    height: int = 512,
    width: int = 832,
    era5_region: Optional[str] = None,
    seed: int = 0,
    events_per_year: float = 12.0,
    distractors_per_year: float = 12.0,
    mag_lo: float = 2.0,
    mag_hi: float = 3.5,
    vhi_event_drop: float = 45.0,
    write_climatology: bool = False,
) -> dict:
    """Learnable CERRA/ERA5-Land-shaped tree at real-world geometry (the
    reference's published CERRA Europe crop is 512x832,
    dataset/CERRA_dataset.py:100-101).

    write_fake_reanalysis draws random VCI/TCI, so its drought labels are
    noise: fine for plumbing, useless for training. Here:
    * per-variable weekly `mean` channel: seasonal cycle with smooth
      amplitude/phase fields + AR(1) spatially correlated noise; `std`
      channel: smooth positive base + weekly noise;
    * droughts: spatio-temporal ellipsoids where VHI (written as VCI = TCI,
      so any alpha gives the same VHI) drops below the 26/35 thresholds,
      while a random majority of the variables turn anomalous (+-2-3.5
      sigma on the mean channel), each leading the drought by 0-3 weeks;
    * single-variable distractor anomalies with no VHI response;
    * cold-surface masks concentrated in winter weeks, static water and
      no-vegetation masks from thresholded smooth fields.

    Returns a summary dict (drought rate, event count).
    """
    rng = np.random.default_rng(seed)
    variables = sorted(variables or
                       ["al", "hcc", "lcc", "msl", "si10", "wdir10"])
    V = len(variables)
    years = [str(y) for y in years]
    n_time = 52 * len(years)
    need = max(2, V // 2)
    root_main, root_noaa, prefix, masks_name = _tree_roots(
        root_main, root_noaa, era5_region)

    week_of_year = (np.arange(n_time) % 52).astype(np.float32)

    # --- dynamic variables: seasonal + AR(1) noise (mean channel) ---
    mean_ch = np.empty((V, n_time, height, width), np.float32)
    for v in range(V):
        amp = 0.5 + 0.5 * np.abs(_smooth_field(rng, height, width, 60))
        phase = 0.8 * _smooth_field(rng, height, width, 60)
        mean_ch[v] = amp[None] * np.sin(
            2 * np.pi * week_of_year[:, None, None] / 52.0 + phase[None])
    rho, sigma = 0.65, 0.55
    state = np.zeros((V, height, width), np.float32)
    scale = sigma * np.sqrt(1.0 - rho * rho)
    for t in range(n_time):
        innov = np.stack([_smooth_field(rng, height, width, 12)
                          for _ in range(V)])
        state = rho * state + scale * innov
        mean_ch[:, t] += state

    # --- std channel: smooth positive base + weekly noise ---
    std_base = np.stack([0.8 + 0.4 * np.abs(_smooth_field(rng, height,
                                                          width, 40))
                         for _ in range(V)])  # [V, H, W]

    # --- VHI: smooth base ~55 + seasonal dip + AR(1) noise ---
    vhi_base = 55.0 + 8.0 * _smooth_field(rng, height, width, 80)
    vhi = np.empty((n_time, height, width), np.float32)
    vstate = np.zeros((height, width), np.float32)
    for t in range(n_time):
        vstate = 0.7 * vstate + 5.0 * np.sqrt(1 - 0.49) * _smooth_field(
            rng, height, width, 30)
        vhi[t] = (vhi_base + vstate
                  + 4.0 * np.sin(2 * np.pi * week_of_year[t] / 52.0))

    # --- plant droughts (events) and distractors ---
    yy = np.arange(height, dtype=np.float32)
    xx = np.arange(width, dtype=np.float32)

    def ellipse(cy, cx, ry, rx, theta):
        dy = yy[:, None] - cy
        dx = xx[None, :] - cx
        c, s = np.cos(theta), np.sin(theta)
        u = (c * dx + s * dy) / rx
        w_ = (-s * dx + c * dy) / ry
        return u * u + w_ * w_

    r_lo = max(6.0, 0.06 * min(height, width))
    r_hi = max(12.0, 0.2 * min(height, width))

    def plant(vars_hit, t0, dur, is_event):
        r2 = ellipse(float(rng.uniform(0.1 * height, 0.9 * height)),
                     float(rng.uniform(0.1 * width, 0.9 * width)),
                     float(rng.uniform(r_lo, r_hi)),
                     float(rng.uniform(r_lo, r_hi)),
                     float(rng.uniform(0, np.pi)))
        halo = r2 <= 1.69
        if not halo.any():
            return
        shape = np.clip(1.0 - 0.3 * r2, 0.0, None) * halo
        hi = min(n_time, t0 + dur)
        for v in vars_hit:
            mag = float(rng.uniform(mag_lo, mag_hi)) * (
                1 if rng.random() < 0.5 else -1)
            lead = int(rng.integers(0, 4)) if is_event else 0
            lo = max(0, t0 - lead)
            if hi <= lo:
                continue
            mean_ch[v, lo:hi] += mag * shape[None]
        if is_event and hi > t0:
            vhi[t0:hi] -= vhi_event_drop * np.clip(
                1.0 - 0.5 * r2, 0.0, None) * halo

    n_events = int(events_per_year * n_time / 52.0)
    for _ in range(n_events):
        m = int(rng.integers(need, V + 1))
        plant(rng.choice(V, size=m, replace=False),
              t0=int(rng.integers(4, n_time - 2)),
              dur=int(rng.integers(3, 11)), is_event=True)
    for _ in range(int(distractors_per_year * n_time / 52.0)):
        plant([int(rng.integers(V))], t0=int(rng.integers(0, n_time - 2)),
              dur=int(rng.integers(3, 11)), is_event=False)
    vhi = np.clip(vhi, 2.0, 98.0)

    # --- masks: water / no-vegetation static, cold seasonal ---
    water = (_smooth_field(rng, height, width, 100) > 0.9).astype(np.float32)
    noveg = ((_smooth_field(rng, height, width, 70) > 1.3)
             & (water == 0)).astype(np.float32)
    cold_field = _smooth_field(rng, height, width, 60)

    # --- weekly files ---
    for yi, year in enumerate(years):
        os.makedirs(os.path.join(root_main, year), exist_ok=True)
        os.makedirs(os.path.join(root_noaa, year), exist_ok=True)
        for week in range(1, 53):
            t = yi * 52 + week - 1
            wnr = f"{week:03d}"
            stds = (std_base + rng.normal(0, 0.1, (V, height, width))
                    ).astype(np.float32)
            _write_nc3(os.path.join(root_main, year, f"{year}{wnr}.nc"), {
                "statistic": (("statistic",), np.array(["mean", "std"])),
                **{name: (("statistic",) + YX,
                          np.stack([mean_ch[v, t], stds[v]]))
                   for v, name in enumerate(variables)}})
            # winter weeks get a cold band; rare cold elsewhere
            is_winter = week >= 45 or week <= 8
            thr_c = 1.2 if is_winter else 2.6
            cold = ((cold_field + 0.3 * rng.standard_normal()) > thr_c
                    ).astype(np.float32)
            # VCI == TCI -> VHI == vhi for any alpha
            _write_nc3(os.path.join(root_noaa, year, f"{year}{wnr}_00.nc"), {
                "VCI": (YX, vhi[t]), "TCI": (YX, vhi[t]),
                "mask_cold_surface": (YX, cold)})

    # --- global statistics of the mean channel (the std channel is
    # scaled by the same per-variable std, CERRA_dataset.py:618-620) ---
    _write_json(os.path.join(root_main, prefix + "statistic_train.json"), {
        "min": {v: float(mean_ch[i].min()) for i, v in enumerate(variables)},
        "max": {v: float(mean_ch[i].max()) for i, v in enumerate(variables)},
        "mean": {v: float(mean_ch[i].mean()) for i, v in enumerate(variables)},
        "std": {v: float(mean_ch[i].std()) for i, v in enumerate(variables)},
    })

    if write_climatology:
        wk = np.arange(n_time) % 52
        clima = {"climatology": (("climatology",), np.array(["mean", "std"])),
                 "week": (("week",), np.arange(1, 53, dtype=np.float64))}
        for v, name in enumerate(variables):
            cm = np.stack([mean_ch[v, wk == w].mean(0) for w in range(52)])
            cs = np.stack([mean_ch[v, wk == w].std(0) + 1e-2
                           for w in range(52)])
            # [climatology, statistic(mean,std-ch), week, y, x]; the std
            # channel's climatology reuses the mean channel's moments
            clima[name] = (("climatology", "statistic", "week") + YX,
                           np.stack([np.stack([cm, cm]),
                                     np.stack([cs, cs])]).astype(np.float32))
        _write_nc3(os.path.join(root_main,
                               prefix + "climatology_pixels_train.nc"), clima)

    masks = {"mask_no_vegetation": (YX, noveg)}
    if era5_region:
        masks["lsm"] = (YX, 1.0 - water)  # land fraction
    _write_nc3(os.path.join(root_noaa, masks_name), masks)
    if not era5_region:
        _write_nc3(os.path.join(root_main, "CERRA_static_variables.nc"), {
            "lsm": (YX, 1.0 - water),
            "orog": (YX, _smooth_field(rng, height, width, 50)),
            "latitude": (YX, np.tile(np.linspace(30, 70, height)[:, None],
                                     (1, width)).astype(np.float32)),
            "longitude": (YX, np.tile(np.linspace(-10, 40, width)[None],
                                      (height, 1)).astype(np.float32))})

    valid = np.clip(1.0 - water - noveg, 0.0, 1.0)
    drought = (vhi < 26.0) & (valid[None] > 0)
    return {
        "n_events": n_events,
        "drought_rate_valid": float(drought.sum()
                                    / max(valid.sum() * n_time, 1.0)),
        "water_frac": float(water.mean()),
        "noveg_frac": float(noveg.mean()),
        "variables": variables,
        "years": years,
        "height": height, "width": width,
    }


def write_fake_reanalysis(root_main: str, root_noaa: str,
                          variables: Optional[List[str]] = None,
                          years=("1990", "1991"), height: int = 16,
                          width: int = 16, era5_region: Optional[str] = None,
                          seed: int = 0,
                          missing_weeks=()) -> List[str]:
    """A CERRA/ERA5-Land-shaped tree of random values: weekly files
    root/<year>/<year><www>.nc with a 'statistic' (mean, std, min, max)
    axis, NOAA VCI/TCI/cold files, masks, statistics json and weekly
    climatology (schema per reference dataset/CERRA_dataset.py).

    missing_weeks: (year, week) pairs left out of the NOAA tree (the
    missing-week fallback). Returns the weekly main files written.
    """
    rng = np.random.default_rng(seed)
    variables = sorted(variables or ["t2m", "tp", "al"])
    root_main, root_noaa, prefix, masks_name = _tree_roots(
        root_main, root_noaa, era5_region)
    missing = set(missing_weeks)
    stat_axis = (("statistic",), np.array(["mean", "std", "min", "max"]))

    written = []
    for year in years:
        os.makedirs(os.path.join(root_main, year), exist_ok=True)
        os.makedirs(os.path.join(root_noaa, year), exist_ok=True)
        for week in range(1, 53):
            wnr = f"{week:03d}"
            main_path = os.path.join(root_main, year, f"{year}{wnr}.nc")
            _write_nc3(main_path, {
                "statistic": stat_axis,
                **{v: (("statistic",) + YX, rng.normal(
                    size=(4, height, width)).astype(np.float32))
                   for v in variables}})
            written.append(main_path)
            if (year, week) in missing:
                continue
            vci = rng.uniform(0, 100, (height, width)).astype(np.float32)
            tci = rng.uniform(0, 100, (height, width)).astype(np.float32)
            cold = (rng.random((height, width)) < 0.05).astype(np.float32)
            _write_nc3(os.path.join(root_noaa, year, f"{year}{wnr}_00.nc"), {
                "VCI": (YX, vci), "TCI": (YX, tci),
                "mask_cold_surface": (YX, cold)})

    _write_json(os.path.join(root_main, prefix + "statistic_train.json"),
                {k: {v: float(x) for v, x in
                     zip(variables, rng.uniform(0.5, 2.0, len(variables)))}
                 for k in ("min", "max", "mean", "std")})

    clima = {"climatology": (("climatology",), np.array(["mean", "std"])),
             "week": (("week",), np.arange(1, 53, dtype=np.float64))}
    for v in variables:
        data = rng.normal(size=(2, 2, 52, height, width)).astype(np.float32)
        data[1] = np.abs(data[1]) + 0.5  # std > 0
        clima[v] = (("climatology", "statistic", "week") + YX, data)
    _write_nc3(os.path.join(root_main, prefix + "climatology_pixels_train.nc"),
              clima)

    masks = {"mask_no_vegetation": (YX, (rng.random((height, width)) < 0.1)
                                    .astype(np.float32))}
    if era5_region:
        masks["lsm"] = (YX, rng.uniform(0, 1, (height, width)).astype(
            np.float32))
    _write_nc3(os.path.join(root_noaa, masks_name), masks)

    if not era5_region:
        _write_nc3(os.path.join(root_main, "CERRA_static_variables.nc"), {
            "lsm": (YX, (rng.random((height, width)) > 0.3).astype(
                np.float32)),
            "orog": (YX, rng.normal(size=(height, width)).astype(np.float32)),
            "latitude": (YX, np.tile(np.linspace(30, 70, height)[:, None],
                                     (1, width)).astype(np.float32)),
            "longitude": (YX, np.tile(np.linspace(-10, 40, width)[None],
                                      (height, 1)).astype(np.float32))})
    return written
