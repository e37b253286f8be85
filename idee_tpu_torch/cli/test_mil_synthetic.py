# ------------------------------------------------------------------
"""CLI: test a trained MIL baseline on the Synthetic dataset
(counterpart of scripts/test_mil_synthetic.py; reference
Baselines_MIL/test_mil_synthetic.py).

    python -m idee_tpu_torch.cli.test_mil_synthetic --name exp \
        --root_synthetic /data/synthetic_CERRA \
        --en_de_pretrained <log>/<name>/model_checkpoints/latest.pt \
        [--device cpu]

Takes the JAX script's flags (every field of the baseline config), plus
``--device`` (default cuda).
The variant comes from the MIL_VARIANT environment variable (deepmil,
arnet, rtfm or mgfn; default deepmil), as in the JAX script.
"""
# ------------------------------------------------------------------

import os

from idee_tpu_torch import config as config_file
from idee_tpu_torch.baselines.config import mil_config
from idee_tpu_torch.baselines.mil.driver import test_mil_synthetic
from idee_tpu_torch.cli import split_device


def main(argv=None):
    device, rest = split_device(argv)
    variant = os.environ.get("MIL_VARIANT", "deepmil")
    cfg = config_file.read_arguments(train=False, defaults=mil_config(),
                                     argv=rest)
    return test_mil_synthetic(cfg, variant, device=device)


if __name__ == "__main__":
    main()
