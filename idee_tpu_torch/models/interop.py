# ------------------------------------------------------------------
"""Carry the JAX package's parameters into the port.

The port keeps the JAX package's module names and parameter shapes
(per-variable weights stacked on axis 0), so a flax parameter tree maps
onto a port ``state_dict`` leaf by leaf: the path joins with '.', and the
only transposes are for the two layers the port keeps in torch's own
layout:

  flax nn.Conv  .../Conv3d_{i}/Conv_0/kernel [kd, kh, kw, in, out]
      -> .../conv{i+1}.weight [out, in, kd, kh, kw]
  flax nn.Dense .../project_{in,out}/kernel [in, out]
      -> .../project_{in,out}.weight [out, in]

Trees arrive as nested dicts of numpy arrays (``jax.device_get`` of the
flax params), or as the JAX variables dict {"params": ..., "codebook":
...}, or as a ``.npz`` keyed by '/'-joined flax paths (``load_flax_npz``).
The "codebook" collection (VQ's embed / cluster_size / embed_avg /
initted, Random_VQ's rand_projs and its inner VQ's state) maps onto the
port's buffers by the same path rule as the parameters.
"""
# ------------------------------------------------------------------

import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

_FLAX_CONV = re.compile(r"^Conv3d_(\d+)$")
_DENSE_TORCH_LAYOUT = ("project_in", "project_out")


def flatten_flax(tree: Mapping, prefix: Tuple[str, ...] = ()
                 ) -> Dict[Tuple[str, ...], np.ndarray]:
    """Nested flax tree -> {path tuple: numpy leaf}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(flatten_flax(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = np.asarray(v)
    return out


def _convert_leaf(path: Tuple[str, ...], value: np.ndarray):
    """One flax leaf -> (port state_dict key, value)."""
    if (len(path) >= 3 and path[-2] == "Conv_0"
            and _FLAX_CONV.match(path[-3])):
        i = int(_FLAX_CONV.match(path[-3]).group(1))
        key = path[:-3] + (f"conv{i + 1}",)
        if path[-1] == "kernel":
            return ".".join(key + ("weight",)), value.transpose(4, 3, 0, 1, 2)
        return ".".join(key + (path[-1],)), value
    if len(path) >= 2 and path[-2] in _DENSE_TORCH_LAYOUT:
        if path[-1] == "kernel":
            return ".".join(path[:-1] + ("weight",)), value.T
        return ".".join(path), value
    return ".".join(path), value


_COLLECTIONS = ("params", "codebook")


def _leaves(tree: Mapping) -> Dict[Tuple[str, ...], np.ndarray]:
    """The leaves of a params sub-tree, or of a variables dict's "params"
    and "codebook" collections together (their paths are disjoint)."""
    if not any(isinstance(tree.get(k), Mapping) for k in _COLLECTIONS):
        return flatten_flax(tree)
    leaves = {}
    for name in _COLLECTIONS:
        for path, v in flatten_flax(tree.get(name, {})).items():
            if path in leaves:
                raise ValueError(f"{'/'.join(path)} is in two collections")
            leaves[path] = v
    return leaves


def flax_to_state_dict(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Flax params (any sub-tree), or a variables dict with its "codebook"
    collection -> the matching port module's state_dict (float32
    tensors)."""
    sd = {}
    for path, value in _leaves(tree).items():
        key, v = _convert_leaf(path, value)
        sd[key] = torch.from_numpy(np.array(v, dtype=np.float32))  # a copy
    return sd


def load_flax_params(cfg, flax_params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX VQModel's params, or its variables dict {"params": ...,
    "codebook": ...} -> the port VQModel's state_dict, checked strictly
    against the port model built from ``cfg`` (every key present, buffers
    included, no extra key, every shape equal)."""
    from idee_tpu_torch.models.vq_model import build_model

    sd = flax_to_state_dict(flax_params)
    want = {k: tuple(v.shape) for k, v in build_model(cfg).state_dict()
            .items()}
    missing, extra = sorted(set(want) - set(sd)), sorted(set(sd) - set(want))
    if missing or extra:
        raise ValueError(f"flax params do not match the port model: "
                         f"missing={missing} extra={extra}")
    for k, v in sd.items():
        if tuple(v.shape) != want[k]:
            raise ValueError(f"{k}: flax gives {tuple(v.shape)}, the port "
                             f"model wants {want[k]}")
    return sd


def load_flax_npz(path: str) -> Dict:
    """A .npz keyed by '/'-joined flax paths -> nested flax tree."""
    tree: Dict = {}
    with np.load(path, allow_pickle=False) as z:
        for key in z.files:
            node = tree
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = z[key]
    return tree


def save_flax_npz(path: str, flax_params: Mapping) -> None:
    """Inverse of load_flax_npz. A variables dict keeps its collections as
    the first path component when it has a "codebook" one; bare params
    (or {"params": ...} alone) are written by their paths."""
    tree = flax_params
    if any(isinstance(tree.get(k), Mapping) for k in _COLLECTIONS):
        tree = {k: tree[k] for k in _COLLECTIONS if k in tree}
        if list(tree) == ["params"]:
            tree = tree["params"]
    np.savez(path, **{"/".join(p): v for p, v in flatten_flax(tree).items()})
