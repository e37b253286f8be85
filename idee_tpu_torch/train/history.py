# ------------------------------------------------------------------
"""Per-epoch scalar history: resume-safe seeding + atomic flush (the port's
copy of idee_tpu/train/history.py).

The training driver flushes ``history.json`` every epoch, so a run killed by a
wall-clock limit loses at most the epoch in flight. On auto-resume the
previous run's file is reloaded and truncated to the epochs that the
resumed checkpoint covers; the write goes to a temporary file that is then
renamed, so a kill mid-write never leaves a torn file.
"""
# ------------------------------------------------------------------

import json
import os


def seed_history(log_dir, keys, start_epoch):
    """A history dict, pre-filled from a prior run on resume: with
    ``start_epoch > 0`` each series of ``log_dir/history.json`` is loaded
    and truncated to ``start_epoch`` entries; a missing or corrupt file
    yields empty series."""
    hist = {k: [] for k in keys}
    if start_epoch <= 0:
        return hist
    path = os.path.join(log_dir, "history.json")
    try:
        with open(path) as fh:
            prev = json.load(fh)
    except (OSError, ValueError):
        return hist
    for k in keys:
        vals = prev.get(k)
        if isinstance(vals, list):
            hist[k] = vals[:start_epoch]
    return hist


def flush_history(log_dir, history):
    """Atomically write ``log_dir/history.json`` (tmp + os.replace),
    leaving out the non-serializable ``state`` entry."""
    payload = {k: v for k, v in history.items() if k != "state"}
    path = os.path.join(log_dir, "history.json")
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(payload, fh, indent=1)
    os.replace(tmp, path)
