"""The model's weights, drawn from the seed on the device.

One normal draw of every parameter's elements together, from a
``torch.Generator`` on the device, then each parameter is mean + std * z
with the (mean, std) that the configuration file's ``init`` gives for the
longest dotted suffix of its name that it lists (at least the last part).
Both the program and the reference are handed these tensors.
"""

import math
from typing import Dict, Sequence, Tuple

import torch


def make_weights(shapes: Dict[str, Tuple[int, ...]],
                 init: Dict[str, Sequence[float]], seed: int,
                 device) -> Dict[str, torch.Tensor]:
    gen = torch.Generator(device=device).manual_seed(seed)
    total = sum(math.prod(s) for s in shapes.values())
    z = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape in shapes.items():
        parts = name.split(".")
        key = next((".".join(parts[i:]) for i in range(len(parts))
                    if ".".join(parts[i:]) in init), None)
        if key is None:
            raise KeyError(f"no init for parameter {name!r} in the "
                           "configuration's init table")
        mean, std = init[key]
        n = math.prod(shape)
        out[name] = (z[at:at + n] * std + mean).reshape(shape)
        at += n
    return out
