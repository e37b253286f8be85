# ------------------------------------------------------------------
"""CLI: train the MGFN MIL baseline on the Synthetic dataset
(counterpart of scripts/train_mgfn_synthetic.py; reference
Baselines_MIL/train_mgfn_synthetic.py).

    python -m idee_tpu_torch.cli.train_mgfn_synthetic --name exp \
        --root_synthetic /data/synthetic_CERRA \
        [--device cpu]

Takes the JAX script's flags (every field of the baseline config), plus
``--device`` (default cuda).
"""
# ------------------------------------------------------------------

from idee_tpu_torch import config as config_file
from idee_tpu_torch.baselines.config import mil_config
from idee_tpu_torch.baselines.mil.driver import train_mil_synthetic
from idee_tpu_torch.cli import split_device


def main(argv=None):
    device, rest = split_device(argv)
    cfg = config_file.read_arguments(train=True, defaults=mil_config(),
                                     argv=rest)
    return train_mil_synthetic(cfg, "mgfn", device=device)


if __name__ == "__main__":
    main()
