"""The reference's training steps and evaluation epoch, and its count of
the model's floating-point operations.

``train_steps`` follows the first epoch of training from the benchmark's
weights: the samples in the first epoch's order, forward, loss,
gradients and Adam at the first epoch's learning rate. ``eval_epoch``
runs every sample of the dataset once in evaluation mode. Both add their
outputs to the epoch counters (reference/data.py::Counters), and run on
the device of the weights they are given.
"""

import contextlib
import math
from typing import Dict, List

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from port_bench.reference import data, model


@contextlib.contextmanager
def precision(name: str):
    """The card's libraries in float32 (TF32 off), or in TF32 for the
    "tf32" control; restored afterwards."""
    m, c = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    on = name == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield model.Precision(name)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def train_steps(P0: Dict[str, torch.Tensor], cfg: dict, x_norm: np.ndarray,
                extreme: np.ndarray, seed: int, batch: int,
                prec_name: str = "float32") -> dict:
    """Every step of the first epoch. Returns each step's loss components
    and joint-head logits, the first step's gradient as Adam takes it
    (with the L2 term) and the norms of its plain gradient, the
    parameters after the epoch, and the epoch's counters."""
    if batch != 1:
        raise ValueError("the reference steps batches of one sample")
    device = next(iter(P0.values())).device
    dt = cfg["delta_t"]
    n = x_norm.shape[1] - dt + 1
    order = data.epoch_orders(seed, n, batch, 1)[0]
    bits = data.epoch_bits(seed, 1, order.shape[0], batch)
    V, T, H, W = x_norm.shape
    counters = data.Counters(V, T, H, W, device)
    lr = data.cosine_lr(0, cfg["lr"], cfg["lr_min"], cfg["lr_warmup"],
                        cfg["lr_warmup_epochs"], cfg["n_epochs"])
    P = {k: v.detach().clone() for k, v in P0.items()}
    adam: Dict = {}
    losses: List[Dict[str, float]] = []
    logits: List[torch.Tensor] = []
    first_grad = grad_norm = None
    with precision(prec_name) as prec:
        for t in range(order.shape[0]):
            idx = int(order[t, 0])
            b = data.to_device(data.sample(x_norm, extreme, idx, dt,
                                           bits[t, 0]), device)
            leaves = {k: v.requires_grad_(True) for k, v in P.items()}
            out = model.forward(leaves, cfg, b["x"], b["mask_extreme_loss"],
                                train=True, prec=prec)
            comps = model.total_loss(out, b["mask_extreme"],
                                     cfg["lambda_anomaly"])
            grads = dict(zip(leaves, torch.autograd.grad(
                comps["loss"], list(leaves.values()))))
            losses.append({k: float(v.detach()) for k, v in comps.items()})
            logits.append(out.z.detach().clone())
            with torch.no_grad():
                counters.add(out.z, out.bits, b["mask_extreme"][0],
                             idx + dt - 1)
                if t == 0:
                    first_grad = {k: grads[k] + cfg["weight_decay"] * P0[k]
                                  for k in P}
                    grad_norm = {k: float(g.norm()) for k, g in grads.items()}
                P = data.adam_step({k: v.detach() for k, v in P.items()},
                                   grads, adam, t + 1, lr, cfg["beta1"],
                                   cfg["beta2"], cfg["weight_decay"])
            del out, comps, grads, leaves
    return {"losses": losses, "z": logits, "first_grad": first_grad,
            "grad_norm": grad_norm, "params": P, "counters": counters}


@torch.no_grad()
def eval_epoch(P: Dict[str, torch.Tensor], cfg: dict, x_norm: np.ndarray,
               extreme: np.ndarray, prec_name: str = "float32") -> dict:
    """Every sample once in evaluation mode: each sample's loss components
    and joint-head logits (by sample index), their sums over the samples,
    and the counters."""
    device = next(iter(P.values())).device
    dt = cfg["delta_t"]
    V, T, H, W = x_norm.shape
    counters = data.Counters(V, T, H, W, device)
    sums: Dict[str, float] = {}
    losses: List[Dict[str, float]] = []
    logits: List[torch.Tensor] = []
    with precision(prec_name) as prec:
        for idx in range(T - dt + 1):
            b = data.to_device(data.sample(x_norm, extreme, idx, dt, None),
                               device)
            out = model.forward(P, cfg, b["x"], b["mask_extreme_loss"],
                                train=False, prec=prec)
            comps = model.total_loss(out, b["mask_extreme"],
                                     cfg["lambda_anomaly"])
            losses.append({k: float(v) for k, v in comps.items()})
            logits.append(out.z.clone())
            for k, v in losses[-1].items():
                sums[k] = sums.get(k, 0.0) + v
            counters.add(out.z, out.bits, b["mask_extreme"][0], idx + dt - 1)
            del out, comps
    return {"loss_sums": sums, "losses": losses, "z": logits,
            "n_samples": T - dt + 1, "counters": counters}


def _conv_backward_flops(grad_out_shape, x_shape, w_shape, bias, stride,
                         padding, dilation, transposed, output_padding,
                         groups, output_mask, out_shape=None) -> int:
    """A convolution's backward: each of the input and the weight
    gradients costs the forward's 2 x outputs x (inputs a group) x taps.
    (PyTorch's own formula counts a grouped weight gradient once per
    group.)"""
    if transposed:
        raise NotImplementedError("transposed convolutions are not counted")
    forward = 2 * math.prod(grad_out_shape) * math.prod(w_shape[1:])
    return forward * (int(output_mask[0]) + int(output_mask[1]))


def flops_per_sample(cfg: dict, traffic: dict) -> int:
    """The model's floating-point operations for one sample of the
    traffic (forward, and for training the backward too), counted over
    this reference on the meta device: products and convolutions only."""
    V, dt = cfg["in_channels_dynamic"], cfg["delta_t"]
    H, W = traffic["height"], traffic["width"]
    train = traffic["mode"] == "train"
    shapes = model.shapes_for_input(cfg, cfg["in_channels"], (dt, H, W))
    P = {k: torch.zeros(s, device="meta", requires_grad=train)
         for k, s in shapes.items()}
    x = torch.zeros((1, V, cfg["in_channels"], dt, H, W), device="meta")
    mask = torch.zeros((1, H, W), device="meta")
    counter = FlopCounterMode(display=False, custom_mapping={
        torch.ops.aten.convolution_backward: _conv_backward_flops})
    with counter, torch.set_grad_enabled(train):
        out = model.forward(P, cfg, x, mask, train=train)
        loss = model.total_loss(out, mask, cfg["lambda_anomaly"])["loss"]
        if train:
            torch.autograd.grad(loss, list(P.values()))
    return int(counter.get_total_flops())
