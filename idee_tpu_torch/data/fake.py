# ------------------------------------------------------------------
"""Fake synthetic-datacube generator for tests and the chip smoke run (the
port's copy of idee_tpu/data/fake.py::make_fake_cube: the same numpy draws
give the same cube from the same seed).

The cube has the statistic/climatology schema of the real synthetic
dataset: per-variable seasonal background plus planted anomaly blobs that
precede extreme events.
"""
# ------------------------------------------------------------------

import json
import os
from typing import List, Optional

import numpy as np

from idee_tpu_torch.data.synthetic import SyntheticCube, cube_npz_path


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

    # weekly pixel-wise climatology (grouped by week-of-year; robust to
    # n_time < 52)
    wk = (np.arange(n_time) % 52)
    clima_median = np.zeros((n_vars, 52, height, width), np.float32)
    clima_std = np.ones((n_vars, 52, height, width), np.float32)
    for w in range(52):
        sel = dynamic[:, wk == w]
        if sel.shape[1] == 0:
            sel = dynamic  # fallback: global stats for unseen weeks
        clima_median[:, w] = np.median(sel, axis=1)
        clima_std[:, w] = sel.std(axis=1) + 1e-2

    return SyntheticCube(
        dynamic=dynamic, anomaly=anomaly, extreme=extreme,
        variables=variables, static=static, variables_static=svars,
        stats=stats, clima_median=clima_median, clima_std=clima_std,
    )


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
