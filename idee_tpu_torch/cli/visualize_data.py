# ------------------------------------------------------------------
"""CLI: browse raw datacubes with matplotlib (counterpart of
scripts/visualize_data.py; reference
vis/visualize_{synthetic,CERRA,ERA5-Land,NOAA}_data.py).

    python -m idee_tpu_torch.cli.visualize_data --dataset synthetic \
        --root <dir> [--timestep 0] [--out panel.png]
    python -m idee_tpu_torch.cli.visualize_data --dataset cerra \
        --root <CERRA root> --year 1990 --week 1 --out week.png

Renders one panel per variable at the chosen timestep (for the synthetic
cube plus its extreme layer; for a reanalysis or NOAA week file every
variable, a (mean, std) variable by its mean), read through the port's
NetCDF reader (data/netcdf.py); saves to --out or shows interactively.
matplotlib is needed here only: nothing else in the package imports it.
"""
# ------------------------------------------------------------------

import argparse
import os

import numpy as np

from idee_tpu_torch.data.netcdf import NetCDFFile


def _figure(panels, cols_max: int, out):
    """One imshow per (title, [H, W] layer) in a grid; saved to ``out`` or
    shown."""
    import matplotlib

    if out:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = len(panels)
    cols = min(n, cols_max)
    rows = (n + cols - 1) // cols
    fig, axes = plt.subplots(rows, cols, figsize=(4 * cols, 3.2 * rows),
                             squeeze=False)
    for i, (title, layer) in enumerate(panels):
        ax = axes[i // cols][i % cols]
        im = ax.imshow(layer, cmap="cividis")
        ax.set_title(title)
        fig.colorbar(im, ax=ax, shrink=0.8)
    for j in range(n, rows * cols):
        axes[j // cols][j % cols].axis("off")
    fig.tight_layout()
    if out:
        fig.savefig(out, dpi=120)
        plt.close(fig)
        print(f"saved {out}")
    else:
        plt.show()


def vis_synthetic(root: str, timestep: int, out=None):
    exp = os.path.basename(os.path.normpath(root))
    with NetCDFFile(os.path.join(root, f"datacube_{exp}.nc")) as f:
        variables = [str(v) for v in f.coord("var")]
        layers = [f.read(v)[timestep] for v in variables]
        extreme = f.read("extreme")[timestep]
    _figure([(f"{name} @ t={timestep}", layer) for name, layer in
             zip(variables + ["extreme"], layers + [extreme])], 4, out)


def vis_reanalysis(root: str, year: int, week: int, out=None,
                   family: str = "CERRA"):
    path = os.path.join(root, str(year), f"{year}{week:03d}.nc")
    with NetCDFFile(path) as f:
        layers = {k: f.read(k) for k in f.keys() if k != "statistic"}
    panels = []
    for name, layer in layers.items():
        if layer.ndim < 2:
            continue  # a coordinate
        data = layer[0] if layer.ndim == 3 else layer  # the mean statistic
        panels.append((f"{family} {name} {year}w{week}",
                       np.asarray(data, np.float32)))
    _figure(panels, 3, out)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dataset", required=True,
                    choices=["synthetic", "cerra", "era5_land", "noaa"])
    ap.add_argument("--root", required=True)
    ap.add_argument("--timestep", type=int, default=0)
    ap.add_argument("--year", type=int, default=1990)
    ap.add_argument("--week", type=int, default=1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    if args.dataset == "synthetic":
        vis_synthetic(args.root, args.timestep, args.out)
    else:
        vis_reanalysis(args.root, args.year, args.week, args.out,
                       args.dataset.upper())


if __name__ == "__main__":
    main()
