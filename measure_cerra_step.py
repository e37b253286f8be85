# ------------------------------------------------------------------
"""Peak device memory and steady train steps/s of one Mamba ``train_real``
step at the full 512x832 CERRA crop (the reference's published Europe
grid), with the encoder blocks' recompute (``en_use_checkpoint``) and
without it.

    python3 measure_cerra_step.py

Writes a random CERRA tree of the 512x832 grid for year 1984
(data/fake.py::write_fake_reanalysis, seed 0; the skip rule leaves 9
target weeks) under the git-ignored build/, runs ``train_real`` for one
epoch (9 train and 9 val steps of batch 1, no augmentation, the config's
defaults otherwise) once per variant, and removes the tree. Prints the
card's name and power limit, then one JSON line per variant: the epoch's
steps/s (StepTimer, after 3 warm-up steps) and ``max_memory_allocated``;
when the card runs out of memory, the error and the peak allocated before
it. Needs a CUDA card.
"""
# ------------------------------------------------------------------

import gc
import json
import os
import shutil
import subprocess
import tempfile

import torch

from idee_tpu_torch.config import CERRA_VARIABLES, Config
from idee_tpu_torch.data.fake import write_fake_reanalysis
from idee_tpu_torch.train.driver_real import train_real

GRID = (512, 832)
YEAR = "1984"
BUILD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")


def run_variant(cfg: Config, use_checkpoint: bool) -> dict:
    cfg = cfg.replace(en_use_checkpoint=use_checkpoint,
                      name=f"measure_cerra_step_ckpt{int(use_checkpoint)}")
    shutil.rmtree(cfg.log_dir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out = {"en_use_checkpoint": use_checkpoint, "hw": list(GRID),
           "encoder": cfg.encoder, "loader_workers": cfg.loader_workers}
    try:
        hist = train_real(cfg, "CERRA", device="cuda")
        torch.cuda.synchronize()
        out.update(steps_per_sec=hist["steps_per_sec"][-1],
                   train_loss=hist["train_loss"][-1], out_of_memory=False)
        del hist
    except torch.OutOfMemoryError as e:
        out.update(out_of_memory=True, error=str(e).splitlines()[0])
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    out["max_memory_reserved"] = torch.cuda.max_memory_reserved()
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("measure_cerra_step: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    os.makedirs(BUILD, exist_ok=True)
    root = tempfile.mkdtemp(prefix="measure_cerra_step_", dir=BUILD)
    try:
        write_fake_reanalysis(os.path.join(root, "CERRA"),
                              os.path.join(root, "NOAA_CERRA"),
                              variables=CERRA_VARIABLES, years=(YEAR,),
                              height=GRID[0], width=GRID[1], seed=0)
        cfg = Config(root_CERRA=os.path.join(root, "CERRA"),
                     root_NOAA_CERRA=os.path.join(root, "NOAA_CERRA"),
                     years_train=[YEAR], years_val=[YEAR],
                     grid_override=GRID, x_max=GRID[1], y_max=GRID[0],
                     n_epochs=1, batch_size=1, is_aug=False,
                     dir_log=os.path.join(BUILD, "measure_cerra_step_log"))
        for use_checkpoint in (True, False):
            print(json.dumps(run_variant(cfg, use_checkpoint)), flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    main()
