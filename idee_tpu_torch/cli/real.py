# ------------------------------------------------------------------
"""Shared entry of the CERRA / ERA5-Land CLIs (train_CERRA, test_CERRA,
train_ERA5_Land, test_ERA5_Land; counterparts of the scripts of the same
names in scripts/). Every Config field is a flag, with the real-world
default in_channels=2 (mean and std channels), plus ``--device`` (default
cuda)."""
# ------------------------------------------------------------------

from idee_tpu_torch import config as config_file
from idee_tpu_torch.cli import split_device
from idee_tpu_torch.config import Config
from idee_tpu_torch.train.driver_real import test_real, train_real


def run(family: str, train: bool, argv=None):
    """Train (history dict) or test (metrics dict) on ``family``."""
    device, rest = split_device(argv)
    cfg = config_file.read_arguments(train=train,
                                     defaults=Config(in_channels=2),
                                     argv=rest)
    if train:
        return train_real(cfg, family, device=device)
    return test_real(cfg, family, device=device)
