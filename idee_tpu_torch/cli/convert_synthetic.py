# ------------------------------------------------------------------
"""CLI: convert a reference-schema synthetic NetCDF directory
(datacube_<exp>.nc, statistic_<exp>.json, climatology_<exp>.nc) into the
one .npz that SyntheticDataset reads first (counterpart of
scripts/convert_synthetic.py; data/convert.py::convert_synthetic).

    python -m idee_tpu_torch.cli.convert_synthetic --root <dir> [--out <path>]

Without --out the file is <root>/datacube_<exp>.npz. Reads NetCDF3, and
NetCDF4 where h5py is installed.
"""
# ------------------------------------------------------------------

import argparse

from idee_tpu_torch.data.convert import convert_synthetic


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--root", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    out = convert_synthetic(args.root, args.out)
    print(f"wrote {out}")
    return out


if __name__ == "__main__":
    main()
