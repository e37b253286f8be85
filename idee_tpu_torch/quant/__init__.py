# ------------------------------------------------------------------
"""Quantization bottlenecks (codebooks; counterpart of
idee_tpu/quant/__init__.py).

The codebook index per (variable, time, pixel) is the anomaly / driver
mask: with codebook_size=2 the LFQ index in {0, 1} is the anomaly bit.
Every quantizer maps x [B, N, dim] to (quantized [B, N, dim], indices
[B, N], aux_loss) in float32 and has indices_to_codes(indices). Five
variants, chosen by ``cfg.codebook`` through ``get_quantizer``: LFQ (the
default), VQ (learnable or EMA codebook), FSQ, LatentQuantize, Random_VQ.
"""
# ------------------------------------------------------------------

from idee_tpu_torch.quant.fsq import FSQ
from idee_tpu_torch.quant.latent_quantize import LatentQuantize
from idee_tpu_torch.quant.lfq import LFQ
from idee_tpu_torch.quant.random_vq import Random_VQ
from idee_tpu_torch.quant.vq import VQ

QUANTIZERS = {"LFQ": LFQ, "VQ": VQ, "FSQ": FSQ,
              "LatentQuantize": LatentQuantize, "Random_VQ": Random_VQ}


def get_quantizer(name: str):
    """String-keyed registry (reference: models/build.py:17-20)."""
    if name not in QUANTIZERS:
        raise NotImplementedError(
            f"codebook {name!r} not implemented; available: "
            f"{sorted(QUANTIZERS)}")
    return QUANTIZERS[name]
