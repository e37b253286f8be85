# ------------------------------------------------------------------
"""CLI: train on the CERRA dataset (counterpart of scripts/train_CERRA.py;
reference train_CERRA.py).

    python -m idee_tpu_torch.cli.train_CERRA --name exp1 \
        --root_CERRA /data/CERRA --root_NOAA_CERRA /data/NOAA_CERRA \
        [--device cpu]

Every Config field is a flag (in_channels defaults to 2), plus
``--device`` (default cuda). Checkpoints, history.json and the log go to
<dir_log>/<name>/; a run with the same name resumes from its ``latest``
checkpoint.
"""
# ------------------------------------------------------------------

from idee_tpu_torch.cli.real import run


def main(argv=None):
    return run("CERRA", train=True, argv=argv)


if __name__ == "__main__":
    main()
