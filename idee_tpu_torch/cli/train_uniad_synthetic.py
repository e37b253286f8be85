# ------------------------------------------------------------------
"""CLI: train the UNIAD reconstruction baseline on the Synthetic dataset
(counterpart of scripts/train_uniad_synthetic.py; reference
Baselines_Reconstruction/train_uniad_synthetic.py).

    python -m idee_tpu_torch.cli.train_uniad_synthetic --name exp \
        --root_synthetic /data/synthetic_CERRA \
        [--device cpu]

Takes the JAX script's flags (every field of the baseline config), plus
``--device`` (default cuda).
"""
# ------------------------------------------------------------------

from idee_tpu_torch import config as config_file
from idee_tpu_torch.baselines.config import recon_config
from idee_tpu_torch.baselines.recon.driver import train_recon_synthetic
from idee_tpu_torch.cli import split_device


def main(argv=None):
    device, rest = split_device(argv)
    cfg = config_file.read_arguments(train=True, defaults=recon_config(),
                                     argv=rest)
    return train_recon_synthetic(cfg, "uniad", device=device)


if __name__ == "__main__":
    main()
