# ------------------------------------------------------------------
"""Carry the JAX package's parameters into the port.

The port keeps the JAX package's module names and parameter shapes
(per-variable weights stacked on axis 0), so a flax parameter tree maps
onto a port ``state_dict`` leaf by leaf: the path joins with '.', and the
classifier head's flax level pair ``Conv3d_{i}/Conv_0`` is named
``conv{i+1}``. One layout rule covers every layer the port keeps in
torch's own layout (the classifier's and the baselines' convolutions,
STEAL's transposed ones, the quantizers' ``project_in`` / ``project_out``
linears): a flax ``kernel [*k, in, out]`` whose key the target module
lacks goes to its ``weight [out, in, *k]``. Every other leaf, the JAX
layout (Dense kernel [in, out] included), carries across unchanged.

Trees arrive as nested dicts of numpy arrays (``jax.device_get`` of the
flax params), or as the JAX variables dict {"params": ..., "codebook":
..., "batch_stats": ...}, or as a ``.npz`` keyed by '/'-joined flax paths
(``load_flax_npz``). The "codebook" collection (VQ's embed / cluster_size
/ embed_avg / initted, Random_VQ's rand_projs and its inner VQ's state)
maps onto the port's buffers by the same path rule as the parameters;
"batch_stats" (flax BatchNorm's mean / var) onto the port BatchNorm's
buffers of the same names. A tree without "batch_stats" (the JAX
package's params alone) leaves those buffers at their initial values.
"""
# ------------------------------------------------------------------

import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

_FLAX_CONV = re.compile(r"^Conv3d_(\d+)$")


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


def _port_key(path: Tuple[str, ...]) -> str:
    """One flax leaf's path -> the port's state_dict key."""
    if (len(path) >= 3 and path[-2] == "Conv_0"
            and _FLAX_CONV.match(path[-3])):
        i = int(_FLAX_CONV.match(path[-3]).group(1))
        path = path[:-3] + (f"conv{i + 1}", path[-1])
    return ".".join(path)


_COLLECTIONS = ("params", "codebook", "batch_stats")


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


def flax_to_state_dict(tree: Mapping, target: Mapping
                       ) -> Dict[str, torch.Tensor]:
    """Flax params (any sub-tree), or a variables dict with its "codebook"
    or "batch_stats" collection -> the state_dict of the port module whose
    state_dict (or its keys) is ``target``, as float32 tensors. A flax
    ``kernel`` whose key ``target`` lacks goes to the ``weight`` there,
    [*k, in, out] -> [out, in, *k]."""
    sd = {}
    for path, value in _leaves(tree).items():
        key, v = _port_key(path), value
        if path[-1] == "kernel" and key not in target:
            key = key[:-len("kernel")] + "weight"
            v = np.moveaxis(v, (-1, -2), (0, 1))
        sd[key] = torch.from_numpy(np.array(v, dtype=np.float32))  # a copy
    return sd


def _batch_stat_keys(model) -> set:
    from idee_tpu_torch.nn.layers import BatchNorm

    return {f"{name}.{stat}" if name else stat
            for name, mod in model.named_modules()
            if isinstance(mod, BatchNorm) for stat in ("mean", "var")}


def load_flax_params(cfg, flax_params: Mapping,
                     model=None) -> Dict[str, torch.Tensor]:
    """The JAX model's params, or its variables dict {"params": ...,
    "codebook": ..., "batch_stats": ...} -> the port model's state_dict,
    checked strictly against ``model`` (default: the port VQModel built
    from ``cfg``): every key present, buffers included, no extra key,
    every shape equal. Only a tree without "batch_stats" may lack the
    BatchNorm statistics, which then keep ``model``'s own."""
    if model is None:
        from idee_tpu_torch.models.vq_model import build_model

        model = build_model(cfg)
    own = model.state_dict()
    sd = flax_to_state_dict(flax_params, own)
    want = {k: tuple(v.shape) for k, v in own.items()}
    if not (isinstance(flax_params.get("batch_stats"), Mapping)
            or any(k in sd for k in _batch_stat_keys(model))):
        for k in _batch_stat_keys(model):
            sd[k] = own[k].detach().clone()
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
