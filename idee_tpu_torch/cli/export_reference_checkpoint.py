# ------------------------------------------------------------------
"""CLI: export a port checkpoint into the reference torch format
(counterpart of scripts/export_reference_checkpoint.py).

Writes a *.pth pickle with the reference's checkpoint schema ({epoch,
mean_loss_*, model_state_dict}; utils/utils_train.py:562-584) that the
reference's own models/build.py:120-127 loads, so a model trained on the
port can be evaluated independently with the original torch tooling. The
weights are loaded strictly into the model on the device first.

    # from a run directory (config.json + model_checkpoints/<alias>.pt)
    python -m idee_tpu_torch.cli.export_reference_checkpoint \
        --run_dir log/exp1 --alias best_F1_model --out exp1_best_F1.pth
    # or from an explicit checkpoint (a port .pt or the JAX package's
    # params as a flax-path .npz) and config flags
    python -m idee_tpu_torch.cli.export_reference_checkpoint \
        --checkpoint imported.pt --encoder Swin_3D --out swin.pth
"""
# ------------------------------------------------------------------

import argparse
import json
import os
import time

import torch

from idee_tpu_torch import resolve_device
from idee_tpu_torch.config import Config, load_config, read_arguments
from idee_tpu_torch.models.interop import export_checkpoint_file
from idee_tpu_torch.models.vq_model import build_model
from idee_tpu_torch.train.checkpoint import load_pretrained_weights


def _meta(path: str) -> dict:
    """The epoch meta of a checkpoint the port's trainer wrote, else {}."""
    if path.endswith(".npz"):
        return {}
    return torch.load(path, map_location="cpu",
                      weights_only=True).get("meta", {})


def main(argv=None):
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--run_dir", default=None,
                    help="training run dir (log/<name>)")
    ap.add_argument("--alias", default="best_F1_model")
    ap.add_argument("--checkpoint", default=None,
                    help="explicit checkpoint path (overrides "
                    "--run_dir/--alias)")
    ap.add_argument("--out", required=True, help="output .pth path")
    ap.add_argument("--device", default=None)
    args, rest = ap.parse_known_args(argv)

    dev = resolve_device(args.device)
    base = Config()
    if args.run_dir:
        for name in ("config.json", "config.pkl"):
            snap = os.path.join(args.run_dir, name)
            if os.path.exists(snap):
                base = load_config(snap)
                break
    cfg = read_arguments(train=False, print_=False, save=False, argv=rest,
                         defaults=base)

    path = args.checkpoint
    if path is None:
        if not args.run_dir:
            ap.error("pass --run_dir or --checkpoint")
        path = os.path.join(args.run_dir, "model_checkpoints",
                            f"{args.alias}.pt")
    t0 = time.perf_counter()
    model = build_model(cfg)
    model.to(dev).load_state_dict(load_pretrained_weights(cfg, path, model))
    meta = _meta(path)
    export_checkpoint_file(
        cfg, model, args.out, epoch=int(meta.get("epoch", 0)),
        mean_loss_train=float(meta.get("mean_loss_train", float("nan"))),
        mean_loss_validation=float(meta.get("mean_loss_validation",
                                            float("nan"))))
    result = {"out": os.path.abspath(args.out), "encoder": cfg.encoder,
              "epoch": int(meta.get("epoch", 0)),
              "bytes": os.path.getsize(args.out),
              "seconds": time.perf_counter() - t0}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
