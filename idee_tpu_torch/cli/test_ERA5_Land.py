# ------------------------------------------------------------------
"""CLI: test on the ERA5-Land dataset (counterpart of
scripts/test_ERA5_Land.py; reference test_ERA5_Land.py).

    python -m idee_tpu_torch.cli.test_ERA5_Land --name exp1 \
        --root_ERA5_Land /data/ERA5-Land --root_NOAA /data/NOAA_CORDEX \
        --region EUR-11 \
        --en_de_pretrained log/exp1/model_checkpoints/best_F1_model.pt \
        [--device cpu]

Every Config field is a flag (in_channels defaults to 2), plus
``--device`` (default cuda). Prints the 2-class evaluator over the valid
pixels of years_test.
"""
# ------------------------------------------------------------------

from idee_tpu_torch.cli.real import run


def main(argv=None):
    return run("ERA5_Land", train=False, argv=argv)


if __name__ == "__main__":
    main()
