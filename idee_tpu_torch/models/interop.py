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

The reference's own PyTorch checkpoints (the upstream IDEE's ``.pth``
pickles of ``{epoch, ..., model_state_dict}``, reference
utils/utils_train.py:562-584) come in and go out through the port's copy
of the JAX package's key map (idee_tpu/models/interop.py:39-533):
``import_torch_state_dict`` / ``export_torch_state_dict`` and their
``*_file`` forms. The reference keeps one torch module per variable
(``encoder.layers_var.{v}...``, ``cls.layers.{v}...``); the port stacks
the per-variable weights on axis 0, so the conversion is a stack or
unstack plus the torch <-> flax axis transposes:

  torch Conv3d  [out, in, kd, kh, kw]  <->  flax [kd, kh, kw, in, out]
  torch Linear  [out, in]              <->  flax [in, out]
  torch Conv1d  [ch, 1, k] (depthwise) <->  flax [k, 1, ch]

The map walks a flax-path view of the port model's own state_dict
(``state_dict_to_flax``, the inverse of the rules above), so every entry
is covered exactly once or the conversion raises.
"""
# ------------------------------------------------------------------

import math
import re
from typing import Dict, List, Mapping, NamedTuple, Tuple

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


def _tree(leaves: Mapping[Tuple[str, ...], np.ndarray]) -> dict:
    """{path tuple: leaf} -> nested flax tree (inverse of flatten_flax)."""
    tree: dict = {}
    for path, v in leaves.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return tree


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
    with np.load(path, allow_pickle=False) as z:
        return _tree({tuple(key.split("/")): z[key] for key in z.files})


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


# ---------------------------------------------------------------- reference
# checkpoints: the port's copy of idee_tpu/models/interop.py:39-533

# buffers in the reference state_dict that carry no learned information
# (LFQ bit mask, Swin relative_position_index tables)
IGNORED_TORCH_SUFFIXES = (
    "vq.mask",            # LFQ.py:134 persistent bit-weights buffer
    "relative_position_index",  # Swin_3D.py WindowAttention3D buffer
    "num_batches_tracked",
    "vq.zero",            # non-persistent in the reference; tolerated
    "vq.codebook",
)


class MapEntry(NamedTuple):
    flax_path: Tuple[str, ...]   # path into the flax-path view
    torch_keys: Tuple[str, ...]  # V keys for *_stack kinds, 1 otherwise
    kind: str


def _t2f(kind: str, arrs: List[np.ndarray]) -> np.ndarray:
    if kind == "conv_stack":
        return np.stack([a.transpose(2, 3, 4, 1, 0) for a in arrs])
    if kind == "conv":
        return arrs[0].transpose(2, 3, 4, 1, 0)
    if kind == "dense_stack":
        return np.stack([a.T for a in arrs])
    if kind == "dense":
        return arrs[0].T
    if kind in ("vec_stack", "raw_stack"):
        return np.stack(arrs)
    if kind == "vec":
        return arrs[0]
    if kind == "mamba_conv_stack":
        # torch depthwise Conv1d [ch, 1, k] -> ours [k, 1, ch]
        return np.stack([a.transpose(2, 1, 0) for a in arrs])
    raise ValueError(f"unknown kind {kind}")


def _f2t(kind: str, arr: np.ndarray, n: int) -> List[np.ndarray]:
    arr = np.asarray(arr)
    if kind == "conv_stack":
        return [arr[v].transpose(4, 3, 0, 1, 2) for v in range(n)]
    if kind == "conv":
        return [arr.transpose(4, 3, 0, 1, 2)]
    if kind == "dense_stack":
        return [arr[v].T for v in range(n)]
    if kind == "dense":
        return [arr.T]
    if kind in ("vec_stack", "raw_stack"):
        return [arr[v] for v in range(n)]
    if kind == "vec":
        return [arr]
    if kind == "mamba_conv_stack":
        return [arr[v].transpose(2, 1, 0) for v in range(n)]
    raise ValueError(f"unknown kind {kind}")


def _keys(template: str, V: int) -> Tuple[str, ...]:
    return tuple(template.format(v=v) for v in range(V))


def _proj_head_entries(head: dict, head_name: str, V: int) -> List[MapEntry]:
    """GroupedProjHead <-> proj_var Sequential[0]/[2] (reference
    Swin_3D.py:559-592 et al.)."""
    out = []
    for ours, seq in (("proj1", 0), ("proj2", 2)):
        sub = head[ours]
        out.append(MapEntry(("encoder", head_name, ours, "kernel"),
                            _keys(f"encoder.proj_var.{{v}}.{seq}.weight", V),
                            "conv_stack"))
        if "bias" in sub:
            out.append(MapEntry(("encoder", head_name, ours, "bias"),
                                _keys(f"encoder.proj_var.{{v}}.{seq}.bias", V),
                                "vec_stack"))
    return out


def _cnn_entries(enc: dict, V: int) -> List[MapEntry]:
    """CNN_3D encoder (reference models/encoder/CNN_3D.py)."""
    out = []
    for name in sorted(enc):
        sub = enc[name]
        if name == "proj_head":
            out += _proj_head_entries(sub, "proj_head", V)
            continue
        if not name.startswith("block"):
            raise ValueError(f"unmapped CNN_3D encoder module {name}")
        i = int(name[len("block"):])
        pre = f"encoder.layers_var.{{v}}.{i}"
        if "down_proj" in sub:
            # reference CNN PatchEmbed3D: bias=False, non-affine norm
            # (CNN_3D.py:38-40)
            out.append(MapEntry(("encoder", name, "down_proj", "kernel"),
                                _keys(f"{pre}.downsample.proj.weight", V),
                                "conv_stack"))
        for leaf in sub:
            if leaf == "down_proj":
                continue
            if leaf in ("conv1", "conv2"):
                out.append(MapEntry(("encoder", name, leaf, "kernel"),
                                    _keys(f"{pre}.{leaf}.weight", V),
                                    "conv_stack"))
            elif leaf in ("norm1", "norm2"):
                out.append(MapEntry(("encoder", name, leaf, "scale"),
                                    _keys(f"{pre}.{leaf}.weight", V),
                                    "vec_stack"))
                out.append(MapEntry(("encoder", name, leaf, "bias"),
                                    _keys(f"{pre}.{leaf}.bias", V),
                                    "vec_stack"))
            else:
                raise ValueError(f"unmapped CNN_3D leaf {name}/{leaf}")
    return out


def _downsample_entries(stage_name: str, sub: dict, si: int,
                        V: int) -> List[MapEntry]:
    """PackedPatchEmbed3D <-> reference PatchEmbed3D (Swin_3D.py:449-491;
    proj bias=True, norm elementwise_affine=False -> no norm params)."""
    out = [MapEntry(("encoder", stage_name, "downsample", "proj", "kernel"),
                    _keys(f"encoder.layers_var.{{v}}.{si}"
                          ".downsample.proj.weight", V), "conv_stack")]
    if "bias" in sub["proj"]:
        out.append(MapEntry(
            ("encoder", stage_name, "downsample", "proj", "bias"),
            _keys(f"encoder.layers_var.{{v}}.{si}.downsample.proj.bias", V),
            "vec_stack"))
    extra = set(sub) - {"proj"}
    if extra:
        raise ValueError(f"unmapped downsample leaves {extra}")
    return out


def _mlp_entries(path: Tuple[str, ...], leaf: str, pre: str,
                 V: int) -> List[MapEntry]:
    tname = "mlp.fc1" if leaf == "mlp_fc1" else "mlp.fc2"
    return [MapEntry(path + (leaf, "kernel"),
                     _keys(f"{pre}.{tname}.weight", V), "dense_stack"),
            MapEntry(path + (leaf, "bias"),
                     _keys(f"{pre}.{tname}.bias", V), "vec_stack")]


def _swin_entries(enc: dict, V: int) -> List[MapEntry]:
    """Swin_3D encoder (reference models/encoder/Swin_3D.py)."""
    out = []
    for name in sorted(enc):
        sub = enc[name]
        if name == "proj":
            out += _proj_head_entries(sub, "proj", V)
            continue
        if not name.startswith("stage"):
            raise ValueError(f"unmapped Swin_3D encoder module {name}")
        si = int(name[len("stage"):])
        for bname in sorted(sub):
            bsub = sub[bname]
            if bname == "downsample":
                out += _downsample_entries(name, bsub, si, V)
                continue
            if not bname.startswith("block"):
                raise ValueError(f"unmapped Swin_3D stage module {bname}")
            d = int(bname[len("block"):])
            pre = f"encoder.layers_var.{{v}}.{si}.blocks.{d}"
            for leaf in bsub:
                if leaf == "attn":
                    attn = bsub[leaf]
                    path = ("encoder", name, bname, "attn")
                    for aleaf in attn:
                        if aleaf == "relative_position_bias_table":
                            out.append(MapEntry(
                                path + (aleaf,),
                                _keys(f"{pre}.attn."
                                      "relative_position_bias_table", V),
                                "raw_stack"))
                        elif aleaf in ("qkv", "proj"):
                            out.append(MapEntry(
                                path + (aleaf, "kernel"),
                                _keys(f"{pre}.attn.{aleaf}.weight", V),
                                "dense_stack"))
                            if "bias" in attn[aleaf]:
                                out.append(MapEntry(
                                    path + (aleaf, "bias"),
                                    _keys(f"{pre}.attn.{aleaf}.bias", V),
                                    "vec_stack"))
                        else:
                            raise ValueError(f"unmapped attn leaf {aleaf}")
                elif leaf in ("mlp_fc1", "mlp_fc2"):
                    out += _mlp_entries(("encoder", name, bname), leaf, pre,
                                        V)
                else:
                    raise ValueError(f"unmapped Swin_3D leaf {bname}/{leaf}")
    return out


def _mamba_entries(enc: dict, V: int) -> List[MapEntry]:
    """Mamba encoder (reference models/encoder/Mamba.py; the ssm submodule
    follows the mamba_ssm.Mamba v1 state dict: in_proj / conv1d / x_proj /
    dt_proj / A_log / D / out_proj, biases per mamba-v1 defaults)."""
    out = []
    for name in sorted(enc):
        sub = enc[name]
        if name == "proj":
            out += _proj_head_entries(sub, "proj", V)
            continue
        if not name.startswith("stage"):
            raise ValueError(f"unmapped Mamba encoder module {name}")
        si = int(name[len("stage"):])
        for bname in sorted(sub):
            bsub = sub[bname]
            if bname == "downsample":
                out += _downsample_entries(name, bsub, si, V)
                continue
            if not bname.startswith("block"):
                raise ValueError(f"unmapped Mamba stage module {bname}")
            d = int(bname[len("block"):])
            pre = f"encoder.layers_var.{{v}}.{si}.blocks.{d}"
            for leaf in bsub:
                if leaf == "ssm":
                    ssm = bsub[leaf]
                    path = ("encoder", name, bname, "ssm")
                    for sleaf in ssm:
                        if sleaf in ("in_proj", "x_proj", "dt_proj",
                                     "out_proj"):
                            out.append(MapEntry(
                                path + (sleaf, "kernel"),
                                _keys(f"{pre}.ssm.{sleaf}.weight", V),
                                "dense_stack"))
                            if "bias" in ssm[sleaf]:
                                out.append(MapEntry(
                                    path + (sleaf, "bias"),
                                    _keys(f"{pre}.ssm.{sleaf}.bias", V),
                                    "vec_stack"))
                        elif sleaf == "conv1d_kernel":
                            out.append(MapEntry(
                                path + (sleaf,),
                                _keys(f"{pre}.ssm.conv1d.weight", V),
                                "mamba_conv_stack"))
                        elif sleaf == "conv1d_bias":
                            out.append(MapEntry(
                                path + (sleaf,),
                                _keys(f"{pre}.ssm.conv1d.bias", V),
                                "vec_stack"))
                        elif sleaf in ("A_log", "D"):
                            out.append(MapEntry(
                                path + (sleaf,),
                                _keys(f"{pre}.ssm.{sleaf}", V), "raw_stack"))
                        else:
                            raise ValueError(f"unmapped ssm leaf {sleaf}")
                elif leaf in ("mlp_fc1", "mlp_fc2"):
                    out += _mlp_entries(("encoder", name, bname), leaf, pre,
                                        V)
                else:
                    raise ValueError(f"unmapped Mamba leaf {bname}/{leaf}")
    return out


def _vq_entries(vq: dict) -> List[MapEntry]:
    """LFQ projections (reference models/codebook/LFQ.py:98-100)."""
    out = []
    for name in sorted(vq):
        if name not in ("project_in", "project_out"):
            raise ValueError(f"unmapped vq module {name} (only reference "
                             "LFQ checkpoints are interoperable; the "
                             "reference hard-codes LFQ, models/build.py:87)")
        out.append(MapEntry(("vq", name, "kernel"),
                            (f"vq.{name}.weight",), "dense"))
        if "bias" in vq[name]:
            out.append(MapEntry(("vq", name, "bias"),
                                (f"vq.{name}.bias",), "vec"))
    return out


def _cls_entries(cls: dict, V: int) -> List[MapEntry]:
    """CNN_3D classifier (reference models/classifier/CNN_3D.py:17-93)."""
    out = []
    for name in sorted(cls):
        sub = cls[name]
        if name == "head_joint":
            for i in range(3):
                conv = sub[f"Conv3d_{i}"]["Conv_0"]
                out.append(MapEntry(
                    ("cls", "head_joint", f"Conv3d_{i}", "Conv_0", "kernel"),
                    (f"cls.conv{i + 1}.weight",), "conv"))
                if "bias" in conv:
                    out.append(MapEntry(
                        ("cls", "head_joint", f"Conv3d_{i}", "Conv_0",
                         "bias"),
                        (f"cls.conv{i + 1}.bias",), "vec"))
        elif name == "heads_var":
            for k in range(1, 4):
                out.append(MapEntry(
                    ("cls", "heads_var", f"conv{k}", "kernel"),
                    _keys(f"cls.layers.{{v}}.conv{k}.weight", V),
                    "conv_stack"))
                if "bias" in sub[f"conv{k}"]:
                    out.append(MapEntry(
                        ("cls", "heads_var", f"conv{k}", "bias"),
                        _keys(f"cls.layers.{{v}}.conv{k}.bias", V),
                        "vec_stack"))
        else:
            raise ValueError(f"unmapped cls module {name}")
    return out


_ENCODER_WALKERS = {
    "CNN_3D": _cnn_entries,
    "Swin_3D": _swin_entries,
    "Mamba": _mamba_entries,
}


def state_dict_to_flax(sd: Mapping[str, torch.Tensor]) -> dict:
    """A port VQModel state_dict -> the nested flax tree of the JAX
    package's names and layouts (the inverse of ``flax_to_state_dict``):
    a torch-layout ``weight [out, in, *k]`` becomes ``kernel [*k, in,
    out]``, and a torch-layout ``conv{i+1}`` the flax pair
    ``Conv3d_{i}/Conv_0``. Raises unless the tree maps back onto ``sd``'s
    keys."""
    leaves = {}
    for key, t in sd.items():
        path = tuple(key.split("."))
        v = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
            else np.asarray(t)
        conv = re.match(r"^conv(\d+)$", path[-2]) if len(path) > 1 else None
        if conv and ".".join(path[:-1] + ("weight",)) in sd:
            path = path[:-2] + (f"Conv3d_{int(conv.group(1)) - 1}",
                                "Conv_0", path[-1])
        if path[-1] == "weight":
            path = path[:-1] + ("kernel",)
            v = np.moveaxis(v, (0, 1), (-1, -2))
        leaves[path] = v
    # keys sorted at every level, as jax.tree_util orders a dict: the map,
    # and so an export, lists its keys in the order of the JAX package's
    tree = _tree(dict(sorted(leaves.items())))
    back = flax_to_state_dict(tree, sd)
    if set(back) != set(sd):
        raise ValueError(f"state_dict keys without a flax path: "
                         f"{sorted(set(sd) ^ set(back))}")
    return tree


def build_param_map(cfg, tree: dict) -> List[MapEntry]:
    """The complete flax <-> reference torch key map of a VQModel's flax
    tree (``state_dict_to_flax``). Walks the actual tree, not a fixed
    schema, so any structural drift fails loudly instead of silently
    skipping weights."""
    V = cfg.in_channels_dynamic
    if cfg.encoder not in _ENCODER_WALKERS:
        raise NotImplementedError(f"no torch interop for {cfg.encoder}")
    entries = _ENCODER_WALKERS[cfg.encoder](tree["encoder"], V)
    entries += _vq_entries(tree["vq"])
    entries += _cls_entries(tree["cls"], V)

    # completeness: every leaf of the tree must be covered exactly once
    covered = [e.flax_path for e in entries]
    leaves = set(flatten_flax(tree))
    if len(covered) != len(set(covered)) or set(covered) != leaves:
        missing = leaves - set(covered)
        extra = set(covered) - leaves
        raise ValueError(f"param map incomplete: missing={sorted(missing)} "
                         f"extra={sorted(extra)}")
    return entries


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def import_torch_state_dict(cfg, sd: Mapping,
                            model=None) -> Dict[str, torch.Tensor]:
    """Reference torch ``model_state_dict`` -> the port model's state_dict
    (float32 tensors on the host), checked strictly against ``model``
    (default: the port VQModel built from ``cfg``).

    Every model parameter must be present (strict, like the reference's own
    ``load_state_dict``, models/build.py:126); a ``module.`` prefix
    (DataParallel) is stripped and the known constant buffers are ignored.
    Values arrive as torch tensors or numpy arrays. A missing or unconsumed
    key raises."""
    ref = {}
    for k, v in sd.items():
        if k.startswith("module."):  # DataParallel save (build.py:123-124)
            k = k[len("module."):]
        ref[k] = (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                  else np.asarray(v))

    if model is None:
        from idee_tpu_torch.models.vq_model import build_model

        model = build_model(cfg)
    template = state_dict_to_flax(model.state_dict())
    entries = build_param_map(cfg, template)
    leaves = {}
    for e in entries:
        try:
            arrs = [ref.pop(k) for k in e.torch_keys]
        except KeyError as err:
            raise KeyError(f"reference checkpoint is missing {err} "
                           f"(needed for {'/'.join(e.flax_path)})") from None
        value = _t2f(e.kind, arrs).astype(np.float32)
        want = _get(template, e.flax_path).shape
        if value.shape != tuple(want):
            raise ValueError(f"{'/'.join(e.flax_path)}: torch keys "
                             f"{e.torch_keys[0]}... give {value.shape}, "
                             f"model wants {tuple(want)}")
        leaves[e.flax_path] = value

    leftovers = [k for k in ref if not k.endswith(IGNORED_TORCH_SUFFIXES)]
    if leftovers:
        raise ValueError(f"unconsumed reference keys: {sorted(leftovers)}")
    sd = load_flax_params(cfg, _tree(leaves), model)
    return {k: sd[k] for k in model.state_dict()}  # in the model's order


def export_torch_state_dict(cfg, model_or_state_dict
                            ) -> Dict[str, np.ndarray]:
    """A port VQModel (or its state_dict) -> the reference torch
    ``model_state_dict`` (float32 numpy values; callers wrap them in torch
    tensors for ``torch.save``), in the order of the key map, then the
    persistent buffers."""
    from idee_tpu_torch.nn.swin3d import relative_position_index

    own = model_or_state_dict
    if isinstance(own, torch.nn.Module):
        own = own.state_dict()
    tree = state_dict_to_flax(own)
    entries = build_param_map(cfg, tree)
    sd: Dict[str, np.ndarray] = {}
    for e in entries:
        arr = np.asarray(_get(tree, e.flax_path), dtype=np.float32)
        for k, part in zip(e.torch_keys, _f2t(e.kind, arr,
                                              len(e.torch_keys))):
            sd[k] = np.ascontiguousarray(part)
    # persistent buffers, so the reference's strict load_state_dict
    # (models/build.py:126) accepts the export as-is:
    # the LFQ bit mask (LFQ.py:134) ...
    cd = max(1, int(round(math.log2(cfg.codebook_size))))
    sd["vq.mask"] = (2 ** np.arange(cd - 1, -1, -1)).astype(np.int64)
    # ... and the Swin relative_position_index tables (Swin_3D.py:134-135),
    # deterministic in the per-stage window size
    if cfg.encoder == "Swin_3D":
        for e in entries:
            if e.flax_path[-1] != "relative_position_bias_table":
                continue
            si = int(e.flax_path[1][len("stage"):])
            rpi = relative_position_index(
                tuple(cfg.en_window_size[si])).astype(np.int64)
            for k in e.torch_keys:
                sd[k.replace("relative_position_bias_table",
                             "relative_position_index")] = rpi
    return sd


def import_checkpoint_file(cfg, path: str, allow_pickle: bool = False,
                           model=None) -> Dict[str, torch.Tensor]:
    """A reference ``*.pth`` checkpoint file -> the port model's
    state_dict (``import_torch_state_dict``).

    Reference checkpoints (utils/utils_train.py:562-584) are plain tensor
    dicts and load under ``weights_only=True``. Loading with
    ``weights_only=False`` executes arbitrary pickle code from the file, so
    that is done only for the specific "weights-only load failed" error
    and only when the caller passed ``allow_pickle=True`` (the CLI flag
    ``--allow_pickle``); every other exception (missing file, corrupt
    archive) propagates unchanged."""
    import pickle

    try:
        payload = torch.load(path, map_location="cpu", weights_only=True)
    except (pickle.UnpicklingError, RuntimeError) as e:
        if not allow_pickle:
            raise RuntimeError(
                f"{path}: not loadable with weights_only=True ({e}). "
                "If you trust this file, re-run with allow_pickle=True "
                "(--allow_pickle) to permit full unpickling, which can "
                "execute code embedded in the checkpoint.") from e
        print(f"[interop] WARNING: unpickling {path} with "
              "weights_only=False (arbitrary code execution possible)")
        payload = torch.load(path, map_location="cpu", weights_only=False)
    sd = payload.get("model_state_dict", payload) \
        if isinstance(payload, dict) else payload
    return import_torch_state_dict(cfg, sd, model)


def export_checkpoint_file(cfg, model_or_state_dict, path: str,
                           epoch: int = 0,
                           mean_loss_train: float = float("nan"),
                           mean_loss_validation: float = float("nan")):
    """Write a port model as a reference-format torch checkpoint
    (utils/utils_train.py:562-584 schema, minus the optimizer state)."""
    sd = {k: torch.from_numpy(v) for k, v in export_torch_state_dict(
        cfg, model_or_state_dict).items()}
    torch.save({
        "epoch": epoch,
        "mean_loss_train": mean_loss_train,
        "mean_loss_validation": mean_loss_validation,
        "model_state_dict": sd,
    }, path)
