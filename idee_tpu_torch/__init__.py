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
    if dev.type == "cuda":
        # every entry point passes here: float32 convolutions and products
        # run in float32, not TF32 (cuDNN's default), and bf16 products
        # reduce in float32 as JAX's do on the TPU (cuBLAS may otherwise
        # reduce in bf16)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
    return dev
