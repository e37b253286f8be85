# ------------------------------------------------------------------
"""CLI: import a reference torch checkpoint (*.pth) into the port
(counterpart of scripts/import_reference_checkpoint.py, which writes an
orbax tree).

The reference distributes pretrained models as torch pickles of
{epoch, ..., model_state_dict, ...} (utils/utils_train.py:562-584). This
converts one into the port's pretrained format, a ``torch.save`` of
{"model": state_dict, "meta": ...}, which ``--en_de_pretrained`` of the
train and test CLIs reads (train/checkpoint.py::load_pretrained_weights).
The converted weights are loaded strictly into the model on the device
before they are written.

The model configuration must match the checkpoint: pass it as the usual
flags (every Config field) or with --config_pkl, a run's config.json /
config.pkl snapshot (the reference's argparse Namespace pickles load too;
flags still override).

    python -m idee_tpu_torch.cli.import_reference_checkpoint \
        --checkpoint best_F1_model.pth --out imported.pt \
        --encoder Swin_3D --in_channels_dynamic 6 [--device cpu]
    python -m idee_tpu_torch.cli.test_synthetic ... \
        --en_de_pretrained imported.pt
"""
# ------------------------------------------------------------------

import argparse
import json
import os
import time

import torch

from idee_tpu_torch import resolve_device
from idee_tpu_torch.config import Config, load_config, read_arguments
from idee_tpu_torch.models.interop import import_checkpoint_file
from idee_tpu_torch.models.vq_model import build_model


def main(argv=None):
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--checkpoint", required=True, help="reference .pth")
    ap.add_argument("--out", required=True,
                    help="the port's pretrained-weights file to write")
    ap.add_argument("--config_pkl", default=None,
                    help="config.pkl/.json snapshot to take the model "
                    "configuration from (flags still override)")
    ap.add_argument("--allow_pickle", action="store_true",
                    help="permit full unpickling if weights_only=True "
                    "fails (executes code embedded in the checkpoint; only "
                    "for files you trust)")
    ap.add_argument("--device", default=None)
    args, rest = ap.parse_known_args(argv)

    dev = resolve_device(args.device)
    base = load_config(args.config_pkl) if args.config_pkl else Config()
    cfg = read_arguments(train=False, print_=False, save=False, argv=rest,
                         defaults=base)

    t0 = time.perf_counter()
    model = build_model(cfg)
    sd = import_checkpoint_file(cfg, args.checkpoint,
                                allow_pickle=args.allow_pickle, model=model)
    model.to(dev).load_state_dict(sd)
    out = os.path.abspath(args.out)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    torch.save({"model": {k: v.detach().cpu()
                          for k, v in model.state_dict().items()},
                "meta": {"source": os.path.abspath(args.checkpoint)}}, out)
    result = {"out": out, "encoder": cfg.encoder, "codebook": cfg.codebook,
              "parameters": sum(v.numel() for v in sd.values()),
              "seconds": time.perf_counter() - t0}
    print(json.dumps(result))
    print("use it with:  --en_de_pretrained " + out)
    return result


if __name__ == "__main__":
    main()
