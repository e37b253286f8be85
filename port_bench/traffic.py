"""The benchmark's traffic: a synthetic weekly datacube drawn from the
seed, at the size a traffic file asks for.

``make_cube`` is a frozen copy of the port's ``data/fake.py::make_fake_cube``
(the same numpy draws in the same order): a per-variable seasonal
background with noise, anomaly blobs planted per variable and in shared
events across a majority of the variables, extremes where at least half
the variables are anomalous, and the per-variable global statistics. One
departure, which changes no value that is read: the weekly pixel-wise
climatology is not computed. The
benchmark normalises by the per-variable global statistics, as the smoke
run does: a cube shorter than two years holds one sample of each week of
the year, and its climatology-scaled inputs are exactly 0.
"""

from typing import Dict

import numpy as np


def make_cube(n_vars: int, n_time: int, height: int, width: int, seed: int,
              anomaly_rate: float = 0.05) -> Dict[str, np.ndarray]:
    """dynamic [V, T, H, W] float32, anomaly [V, T, H, W] uint8, extreme
    [T, H, W] uint8 and the per-variable ``stats`` (min, max, mean,
    median, std) of the variables var_01 ... var_V."""
    rng = np.random.default_rng(seed)
    week = (np.arange(n_time) % 52).astype(np.float32)
    season = np.sin(2 * np.pi * week / 52.0)[None, :, None, None]
    base = rng.normal(0.0, 1.0, (n_vars, 1, height, width)).astype(np.float32)
    noise = rng.normal(0.0, 0.3, (n_vars, n_time, height, width)
                       ).astype(np.float32)
    dynamic = base + season + noise

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
    dynamic = (dynamic + 3.0 * anomaly).astype(np.float32)
    extreme = (anomaly.sum(0) >= need).astype(np.uint8)

    # the per-variable global statistics (statistic_*.json schema)
    stats = {f"var_{v + 1:02d}": {
        "min": float(dynamic[v].min()), "max": float(dynamic[v].max()),
        "mean": float(dynamic[v].mean()),
        "median": float(np.median(dynamic[v])),
        "std": float(dynamic[v].std())} for v in range(n_vars)}
    return {"dynamic": dynamic, "anomaly": anomaly, "extreme": extreme,
            "stats": stats}
