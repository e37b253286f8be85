# ------------------------------------------------------------------
"""Logging / seeding / timing utilities (the port's copy of
idee_tpu/utils/logging.py; reference: utils/utils_train.py:29-66)."""
# ------------------------------------------------------------------

import logging
import os
import random
from typing import Optional

import numpy as np


def get_logger(config) -> logging.Logger:
    """File logger under log/<name>/log_file.txt
    (reference: utils/utils_train.py:45-66)."""
    dir_log = os.path.join(config.dir_log, config.name)
    os.makedirs(dir_log, exist_ok=True)
    if getattr(config, "phase", "train") == "train":
        os.makedirs(os.path.join(dir_log, "model_checkpoints"), exist_ok=True)

    logger = logging.getLogger("Trainer")
    logger.setLevel(logging.INFO)
    logger.propagate = False  # log_string already mirrors to stdout
    for h in logger.handlers:
        h.close()
    logger.handlers = []
    fmt = logging.Formatter(
        "%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    fh = logging.FileHandler(os.path.join(dir_log, "log_file.txt"))
    fh.setLevel(logging.INFO)
    fh.setFormatter(fmt)
    logger.addHandler(fh)
    return logger


def log_string(logger: Optional[logging.Logger], s: str):
    if logger is not None:
        logger.info(s)
    print(s)


def fix_seed(seed: int):
    """Seed the host RNGs (python, numpy). Torch randomness in this package
    comes from explicit torch.Generators."""
    random.seed(seed)
    np.random.seed(seed)

