# ------------------------------------------------------------------
"""CLI: evaluate on the Synthetic test split (counterpart of
scripts/test_synthetic.py; reference test_synthetic.py).

    python -m idee_tpu_torch.cli.test_synthetic --name exp1 \
        --root_synthetic /data/synthetic_CERRA --encoder Mamba \
        --en_de_pretrained params.npz [--device cpu]

Takes the same flags as the JAX script (every Config field), plus
``--device`` (default cuda).
"""
# ------------------------------------------------------------------

from idee_tpu_torch import config as config_file
from idee_tpu_torch.cli import split_device
from idee_tpu_torch.config import SYNTHETIC_VARIABLES, Config
from idee_tpu_torch.train.evaluate import test_synthetic


def main(argv=None):
    device, rest = split_device(argv)
    defaults = Config(variables=list(SYNTHETIC_VARIABLES), in_channels=1,
                      encoder="CNN_3D")
    cfg = config_file.read_arguments(train=False, defaults=defaults,
                                     argv=rest)
    return test_synthetic(cfg, device=device)


if __name__ == "__main__":
    main()
