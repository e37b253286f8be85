# ------------------------------------------------------------------
"""Logging / seeding / timing utilities and the TensorBoard writer (the
port's copy of idee_tpu/utils/logging.py; reference:
utils/utils_train.py:29-66)."""
# ------------------------------------------------------------------

import logging
import os
import random
import time
from typing import Optional

import numpy as np
import torch


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


class SummaryWriter:
    """TensorBoard writer (reference: train_synthetic.py:37,310-319 uses
    torch.utils.tensorboard). Wraps torch's writer when the tensorboard
    package is installed and is a no-op otherwise, so training never
    depends on it; a ``log_dir`` of None (a data-parallel rank other than
    0) makes the no-op writer too."""

    def __init__(self, log_dir: Optional[str]):
        self._w = None
        if log_dir is None:
            return
        try:
            from torch.utils.tensorboard import SummaryWriter as TBWriter
        except ImportError:  # tensorboard is optional
            return
        self._w = TBWriter(log_dir=log_dir)

    def add_scalars(self, tag: str, scalars: dict, step: int):
        if self._w is not None:
            self._w.add_scalars(tag, scalars, step)

    def add_images(self, tag: str, images, step: int,
                   dataformats: str = "HWC"):
        if self._w is not None:
            self._w.add_images(tag, images, step, dataformats=dataformats)

    def flush(self):
        if self._w is not None:
            self._w.flush()

    def close(self):
        if self._w is not None:
            self._w.close()


class StepTimer:
    """Steps/s over the steps after the first ``warmup``. CUDA runs
    asynchronously, so in a process that uses the card the clock is read
    only after the device has finished the work enqueued so far
    (``torch.cuda.synchronize``): once when the warmup ends and once when
    the rate is read, never per step."""

    def __init__(self, warmup: int = 3):
        self.warmup = warmup
        self.count = 0
        self._t0 = None

    @staticmethod
    def _now() -> float:
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        return time.perf_counter()

    def tick(self):
        self.count += 1
        if self.count == self.warmup:
            self._t0 = self._now()

    @property
    def steps_per_sec(self) -> float:
        if self._t0 is None or self.count <= self.warmup:
            return float("nan")
        return (self.count - self.warmup) / (self._now() - self._t0)
