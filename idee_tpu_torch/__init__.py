# ------------------------------------------------------------------
"""IDEE on PyTorch and CUDA: the port of ``idee_tpu`` to an NVIDIA H100.

The JAX package ``idee_tpu`` is the reference; this package mirrors its
layout and names (config, nn, quant, models, losses, train, data, kernels,
utils) and imports nothing of it. Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``.
"""
# ------------------------------------------------------------------

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. There is no silent fallback: asking for CUDA on a machine
    without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "on the CPU")
    return dev
