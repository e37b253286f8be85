# ------------------------------------------------------------------
"""CLI: does this encoder fit at this geometry? (counterpart of
scripts/memory_fit.py, without its --topology, which probes TPU slices.)

JAX compiles the train step ahead of time and reads XLA's memory
analysis. Here one full train step (forward, losses, backward, Adam, the
metric and vote counters) runs on the card from random inputs of the
geometry, from a fresh model and optimizer, and the probe reads the
allocator's peak (``torch.cuda.max_memory_allocated`` and
``max_memory_reserved``, reset first) against the card's
``total_memory``. (Adam's moments, made in the step's update, are two
copies of the parameters: megabytes beside the activations.) An
out-of-memory error is the probe's answer (``fits: false``, ``error:
"oom"``), as JAX reads a failed compile; any other error propagates.

    python -m idee_tpu_torch.cli.memory_fit --family real \
        --encoder Swin_3D --batch 1 --hw 512x832 [--remat]
    python -m idee_tpu_torch.cli.memory_fit --family synthetic \
        --encoder Swin_3D --batch 2 --hw 200

prints one JSON line per probe: {peak_gb, reserved_gb, total_gb, fits}
(GB = 10^9 bytes; ``peak_gb`` counts what the probe allocated, above
what the process held when it began). ``--family real`` is the reference
CERRA configuration (6 variables x (mean, std) channels, delta_t 8);
``--remat`` sets ``en_use_checkpoint``. With ``--device cpu`` the step
runs on the CPU and no memory is measured (the sizes are null).

``--mesh DxS`` probes a rank of a data x space mesh (parallel/mesh.py,
the counterpart of scripts/memory_fit.py's ``--mesh``): started under
``torchrun --nproc_per_node D*S``, each rank trains on its rows of the
global batch of ``--batch`` and its H rows (parallel/spatial.py), and
prints its own row with its rank and rows. Two ranks on one card need
``--backend gloo`` and ``--device cuda:0``:

    torchrun --nproc_per_node 2 -m idee_tpu_torch.cli.memory_fit \
        --family real --encoder CNN_3D --hw 512x832 --mesh 1x2 \
        --backend gloo --device cuda:0
"""
# ------------------------------------------------------------------

import argparse
import gc
import json
import math
from typing import Dict, Tuple

import torch

from idee_tpu_torch import resolve_device
from idee_tpu_torch.config import Config, synthetic_config
from idee_tpu_torch.models.vq_model import build_model, compute_dtype
from idee_tpu_torch.parallel import spatial
from idee_tpu_torch.parallel.mesh import make_mesh
from idee_tpu_torch.train.state import create_train_state

GB = 1e9
# the synthetic probe's vote timeline: a 64-week split
N_WEEKS = 64


def probe_config(family: str, encoder: str, batch: int, H: int, W: int,
                 dtype: str, remat: bool) -> Config:
    if family == "real":
        # the reference CERRA configuration: 6 vars x (mean, std) channels
        return Config(encoder=encoder, dtype=dtype, batch_size=batch,
                      in_channels=2, in_channels_dynamic=6, delta_t=8,
                      x_max=W, y_max=H, en_use_checkpoint=remat)
    if family == "synthetic":
        return synthetic_config(encoder=encoder, dtype=dtype,
                                batch_size=batch, x_max=W, y_max=H,
                                en_use_checkpoint=remat)
    raise ValueError(f"family {family!r}: want 'real' or 'synthetic'")


def random_batch(cfg: Config, family: str, H: int, W: int, device,
                 seed: int = 0, mesh=None) -> Dict[str, torch.Tensor]:
    """A batch of the geometry from a seeded generator: x normal in the
    compute dtype, {0, 1} masks, and (synthetic) the target weeks. Under
    a ``mesh`` the rank's rows of it (and its H rows under the active
    spatial context)."""
    g = torch.Generator().manual_seed(seed)
    B, C = cfg.batch_size, cfg.in_channels
    x = torch.randn((B, cfg.in_channels_dynamic, C, cfg.delta_t, H, W),
                    generator=g)
    keys = ["mask_extreme", "mask_extreme_loss"]
    if family == "real":
        keys += ["mask_cold_surface", "mask_cold_surface_loss"]
    batch = {"x": x.to(compute_dtype(cfg))}
    for k in keys:
        batch[k] = (torch.rand((B, H, W), generator=g) < 0.1).float()
    if family == "synthetic":
        batch["timestep"] = torch.randint(
            cfg.delta_t, N_WEEKS + 1, (B, 1), generator=g).float()
    if mesh is not None:
        rows = mesh.rows(B)
        batch = spatial.shard_rows({k: v[rows] for k, v in batch.items()},
                                   spatial.active())
    return {k: v.contiguous().to(device) for k, v in batch.items()}


def _step_and_metrics(model, cfg: Config, family: str, device):
    if family == "real":
        from idee_tpu_torch.train.steps_real import (init_epoch_metrics_real,
                                                     make_train_step_real)

        return make_train_step_real(model, cfg), \
            init_epoch_metrics_real(device)
    from idee_tpu_torch.train.steps import (init_epoch_metrics,
                                            make_train_step)

    return make_train_step(model, cfg, t0=1.0), init_epoch_metrics(
        (cfg.in_channels_dynamic, N_WEEKS, cfg.y_max, cfg.x_max), device)


def probe(family: str, encoder: str, batch: int, H: int, W: int,
          dtype: str = "float32", remat: bool = False,
          device=None, mesh=None) -> dict:
    """One probe's row: the train step's peak memory at the geometry (on
    ``mesh``'s rank, of its share of it, under a ``mesh``)."""
    dev = resolve_device(device if mesh is None else mesh.device)
    row = {"family": family, "encoder": encoder, "batch": batch,
           "hw": f"{H}x{W}", "dtype": dtype, "remat": remat,
           "device": dev.type}
    cfg = probe_config(family, encoder, batch, H, W, dtype, remat)
    with spatial.activate(mesh, H, spatial.model_row_align(cfg)) as ctx:
        if mesh is not None:
            row.update(mesh=f"{mesh.data}x{mesh.space}", rank=mesh.rank,
                       rows=None if ctx is None else [ctx.lo, ctx.hi])
        return _probe(cfg, family, H, W, dev, row, mesh)


def _probe(cfg: Config, family: str, H: int, W: int, dev, row: dict,
           mesh) -> dict:
    on_card = dev.type == "cuda"
    if on_card:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    try:
        model = build_model(cfg, torch.Generator().manual_seed(0))
        state = create_train_state(cfg, model, dev, steps_per_epoch=100)
        step, metrics = _step_and_metrics(model, cfg, family, dev)
        data = random_batch(cfg, family, H, W, dev, mesh=mesh)
        state, metrics = step(state, metrics, data)
        loss = float(metrics["loss_sums"]["loss"])  # waits for the card
        row["loss_finite"] = math.isfinite(loss)
        error = None
    except torch.cuda.OutOfMemoryError:
        error = "oom"
    finally:
        state = model = step = metrics = data = None
    if on_card:
        total = torch.cuda.get_device_properties(dev).total_memory
        peak = torch.cuda.max_memory_allocated(dev) - base
        reserved = torch.cuda.max_memory_reserved(dev)
        gc.collect()
        torch.cuda.empty_cache()
        row.update(peak_gb=peak / GB, reserved_gb=reserved / GB,
                   total_gb=total / GB, fits=error is None,
                   peak_bytes=peak)
    else:
        row.update(peak_gb=None, reserved_gb=None, total_gb=None,
                   fits=None)
    if error is not None:
        row["error"] = error
    return row


def parse_hw(text: str) -> Tuple[int, int]:
    """"HxW" or one square size."""
    if "x" in text:
        H, W = (int(v) for v in text.split("x"))
        return H, W
    return int(text), int(text)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--family", default="real",
                    choices=["real", "synthetic"])
    ap.add_argument("--encoder", default="Swin_3D")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--hw", default="512x832",
                    help="HxW (e.g. 512x832) or one square size")
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--remat", action="store_true",
                    help="recompute the encoder blocks in the backward "
                    "(en_use_checkpoint)")
    ap.add_argument("--device", default=None)
    ap.add_argument("--mesh", default=None,
                    help="DxS: probe this rank of a data x space mesh "
                    "(under torchrun --nproc_per_node D*S)")
    ap.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                    help="the mesh's backend (default nccl on a card); "
                    "gloo for several ranks on one card")
    args = ap.parse_args(argv)
    H, W = parse_hw(args.hw)
    mesh = None
    if args.mesh:
        mesh = make_mesh([int(v) for v in args.mesh.split("x")],
                         ["data", "space"], device=args.device,
                         backend=args.backend)
    try:
        row = probe(args.family, args.encoder, args.batch, H, W, args.dtype,
                    args.remat, args.device, mesh)
    finally:
        if mesh is not None:
            mesh.close()
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    main()
