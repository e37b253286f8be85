# ------------------------------------------------------------------
"""CLI: train on the Synthetic dataset (counterpart of
scripts/train_synthetic.py; reference train_synthetic.py).

    python -m idee_tpu_torch.cli.train_synthetic --name exp1 \
        --root_synthetic /data/synthetic_CERRA --encoder Mamba [--device cpu]

Takes the same flags as the JAX script (every Config field), plus
``--device`` (default cuda). Checkpoints, history.json and the log go to
<dir_log>/<name>/; a run with the same name resumes from its ``latest``
checkpoint.
"""
# ------------------------------------------------------------------

from idee_tpu_torch import config as config_file
from idee_tpu_torch.cli import split_device
from idee_tpu_torch.config import SYNTHETIC_VARIABLES, Config
from idee_tpu_torch.train.driver import train_synthetic


def main(argv=None):
    device, rest = split_device(argv)
    defaults = Config(variables=list(SYNTHETIC_VARIABLES), in_channels=1,
                      encoder="CNN_3D")
    cfg = config_file.read_arguments(train=True, defaults=defaults,
                                     argv=rest)
    return train_synthetic(cfg, device=device)


if __name__ == "__main__":
    main()
