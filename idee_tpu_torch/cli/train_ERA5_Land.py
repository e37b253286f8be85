# ------------------------------------------------------------------
"""CLI: train on the ERA5-Land dataset (counterpart of
scripts/train_ERA5_Land.py; reference train_ERA5_Land.py).

    python -m idee_tpu_torch.cli.train_ERA5_Land --name exp1 \
        --root_ERA5_Land /data/ERA5-Land --root_NOAA /data/NOAA_CORDEX \
        --region EUR-11 [--device cpu]

Every Config field is a flag (in_channels defaults to 2), plus
``--device`` (default cuda). Checkpoints, history.json and the log go to
<dir_log>/<name>/; a run with the same name resumes from its ``latest``
checkpoint.
"""
# ------------------------------------------------------------------

from idee_tpu_torch.cli.real import run


def main(argv=None):
    return run("ERA5_Land", train=True, argv=argv)


if __name__ == "__main__":
    main()
