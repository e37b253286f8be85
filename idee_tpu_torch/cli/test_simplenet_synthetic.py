# ------------------------------------------------------------------
"""CLI: test the SimpleNet one-class baseline on the Synthetic dataset
(counterpart of scripts/test_simplenet_synthetic.py; reference
Baselines_OneClass/test_simplenet_synthetic.py).

    python -m idee_tpu_torch.cli.test_simplenet_synthetic --name exp \
        --root_synthetic /data/synthetic_CERRA \
        --model_pretrained <core run>/model_checkpoints/latest.pt \
        --en_de_pretrained <log>/<name>/model_checkpoints/latest.pt \
        [--device cpu]

Takes the JAX script's flags (every field of the baseline config), plus
``--device`` (default cuda).
"""
# ------------------------------------------------------------------

from idee_tpu_torch import config as config_file
from idee_tpu_torch.baselines.config import oneclass_config
from idee_tpu_torch.baselines.oneclass.driver import test_simplenet_synthetic
from idee_tpu_torch.cli import split_device


def main(argv=None):
    device, rest = split_device(argv)
    cfg = config_file.read_arguments(train=False, defaults=oneclass_config(),
                                     argv=rest)
    return test_simplenet_synthetic(cfg, device=device)


if __name__ == "__main__":
    main()
