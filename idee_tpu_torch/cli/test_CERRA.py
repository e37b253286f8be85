# ------------------------------------------------------------------
"""CLI: test on the CERRA dataset (counterpart of scripts/test_CERRA.py;
reference test_CERRA.py).

    python -m idee_tpu_torch.cli.test_CERRA --name exp1 \
        --root_CERRA /data/CERRA --root_NOAA_CERRA /data/NOAA_CERRA \
        --en_de_pretrained log/exp1/model_checkpoints/best_F1_model.pt \
        [--device cpu]

Every Config field is a flag (in_channels defaults to 2), plus
``--device`` (default cuda). Prints the 2-class evaluator over the valid
pixels of years_test.
"""
# ------------------------------------------------------------------

from idee_tpu_torch.cli.real import run


def main(argv=None):
    return run("CERRA", train=False, argv=argv)


if __name__ == "__main__":
    main()
