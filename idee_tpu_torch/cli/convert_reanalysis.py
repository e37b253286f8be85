# ------------------------------------------------------------------
"""CLI: convert the CERRA / ERA5-Land weekly NetCDF trees (reference
layout root/<year>/<year><www>.nc plus the NOAA VCI/TCI/cold files,
dataset/CERRA_dataset.py:204-283) into the per-year mmap cache with
precomputed VHI labels (counterpart of scripts/convert_reanalysis.py;
data/convert.py::convert_reanalysis). Training then runs with
--cache_root <out> and decodes no NetCDF in the loop.

    python -m idee_tpu_torch.cli.convert_reanalysis --family CERRA \
        --root_main /data/CERRA --root_noaa /data/NOAA_CERRA \
        --years 1984-2021 --out /data/cache_cerra --variables t2m r2 tp \
        --x_min 234 --x_max 1066 --y_min 322 --y_max 834
    python -m idee_tpu_torch.cli.convert_reanalysis --family ERA5_Land \
        --region EUR-11 ...

--validate then reads the first year through the cache and through the
NetCDF files and compares a few items key by key.
"""
# ------------------------------------------------------------------

import argparse
import os
import time

import numpy as np

from idee_tpu_torch.data.convert import convert_reanalysis
from idee_tpu_torch.data.reanalysis import (ReanalysisDataset, cerra_spec,
                                            era5_land_spec)


def parse_years(spec):
    """["1984-1986", "1990"] -> ["1984", "1985", "1986", "1990"]."""
    out = []
    for part in spec:
        if "-" in part:
            lo, hi = part.split("-")
            out += [str(y) for y in range(int(lo), int(hi) + 1)]
        else:
            out.append(part)
    return out


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--family", choices=["CERRA", "ERA5_Land"],
                    required=True)
    ap.add_argument("--region", default="EUR-11",
                    help="CORDEX region (ERA5_Land only)")
    ap.add_argument("--root_main", required=True)
    ap.add_argument("--root_noaa", required=True)
    ap.add_argument("--years", nargs="+", required=True,
                    help="years or ranges, e.g. 1984-2021")
    ap.add_argument("--variables", nargs="+", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--alpha", type=float, default=0.5)
    ap.add_argument("--x_min", type=int, default=0)
    ap.add_argument("--x_max", type=int, default=None)
    ap.add_argument("--y_min", type=int, default=0)
    ap.add_argument("--y_max", type=int, default=None)
    ap.add_argument("--grid", default=None,
                    help="the native grid as HxW (e.g. 512x832), for "
                    "archives stored at a crop size (Config.grid_override)")
    ap.add_argument("--validate", action="store_true",
                    help="after converting, read the first year through "
                    "the cache and through the NetCDF files and compare "
                    "item by item")
    args = ap.parse_args(argv)

    if args.family == "CERRA":
        spec = cerra_spec(delta_t=8)
        root_main, root_noaa = args.root_main, args.root_noaa
    else:
        spec = era5_land_spec(args.region, delta_t=8)
        root_main = os.path.join(args.root_main, args.region)
        root_noaa = os.path.join(args.root_noaa, args.region)
    if args.grid:
        spec.grid_height, spec.grid_width = (
            int(v) for v in args.grid.split("x"))

    years = parse_years(args.years)
    t0 = time.time()
    out = convert_reanalysis(spec, root_main, root_noaa, years,
                             args.variables, args.out, alpha=args.alpha,
                             x_min=args.x_min, x_max=args.x_max,
                             y_min=args.y_min, y_max=args.y_max)
    print(f"cache written to {out} ({len(years)} years, "
          f"{time.time() - t0:.1f}s)")

    if args.validate:
        common = dict(spec=spec, root_main=root_main, root_noaa=root_noaa,
                      variables=args.variables, years=[years[0]],
                      is_aug=False, is_norm=True, is_clima_scale=False,
                      alpha=args.alpha, x_min=args.x_min, x_max=args.x_max,
                      y_min=args.y_min, y_max=args.y_max)
        direct = ReanalysisDataset(**common)
        cached = ReanalysisDataset(cache_root=out, **common)
        assert len(direct) == len(cached), (len(direct), len(cached))
        idxs = sorted({0, len(direct) // 2, len(direct) - 1})
        for i in idxs:
            a, b = direct[i], cached[i]
            for k in a:
                np.testing.assert_allclose(
                    a[k], b[k], rtol=1e-5, atol=1e-5,
                    err_msg=f"cache/direct mismatch at item {i} key {k}")
        print(f"validate: {len(idxs)} items compared across {len(a)} keys;"
              " the cache matches the NetCDF path")
    return out


if __name__ == "__main__":
    main()
