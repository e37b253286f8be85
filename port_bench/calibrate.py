"""The readings that the limits of ``correct`` are set from, for one cell,
in one process:

    python3 port_bench/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--control 4,5,6] [--fault 7,8,9] [--out file.json]

For each ``--seeds`` seed, the program's sound run: set-up and one
window epoch (no timing), compared with the reference as a run compares
it. For each ``--control`` seed, the control: the reference computed one
precision below the configuration's (TF32 for float32, float8 for
bfloat16) put in the program's place. For each ``--fault`` seed (training
cells), the program with its answers altered where they are produced:
the joint head's logits negated and the driver bits inverted in every
forward. Prints one JSON line per
reading and, with ``--out``, writes them all.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from port_bench import harness  # noqa: E402
from port_bench.reference import data as ref_data  # noqa: E402
from port_bench.reference import steps as ref_steps  # noqa: E402

LOWER = {"float32": "tf32", "bfloat16": "fp8"}


def _seeds(text: str):
    return [int(s) for s in text.split(",") if s]


def program_numbers(cell, seed: int, device, detail: dict,
                    fault: bool = False) -> dict:
    """A run's numbers without the timed window: set-up and one more
    epoch."""
    factory = altered_answer if fault else None
    result = harness.run(cell, seed, 0.0, False, device, time.perf_counter(),
                         system_factory=factory, detail=detail)
    return result["readings"]


def altered_answer(*args):
    """The program with its answers altered where the model produces them:
    the joint head's logits negated and the driver bits inverted."""
    from port_bench.system import System

    prog = System(*args)
    forward = prog.forward

    def altered(*a, **k):
        out = forward(*a, **k)
        return out._replace(z=-out.z, anomaly=1 - out.anomaly)

    prog.forward = altered
    return prog


def _counter_metrics(c) -> dict:
    return {"counts": dict(c.counts), "n_steps": c.n_steps,
            "vote_sum": c.vote_sum.cpu().numpy(),
            "vote_cnt": c.vote_cnt.cpu().numpy()}


def _running(losses) -> list:
    """Per-step loss components -> the epoch's running sums after each."""
    out, total = [], {}
    for comps in losses:
        total = {k: total.get(k, 0.0) + v for k, v in comps.items()}
        out.append(dict(total))
    return out


def control_numbers(cell, seed: int, device, detail: dict) -> dict:
    """The reference one precision below, judged as the program is."""
    cfg = cell.cfg
    low = LOWER[cfg["dtype"]]
    inputs = harness.Inputs(cell, seed, device)
    x_norm = inputs.normalized()
    extreme = inputs.cube["extreme"]
    if cell.mode == "train":
        got = harness._to_host(ref_steps.train_steps(
            inputs.weights, cfg, x_norm, extreme, seed, 1, low))
        record = {"losses": _running(got["losses"]), "z": got["z"],
                  "exp_avg": {k: (1 - cfg["beta1"]) * v
                              for k, v in got["first_grad"].items()},
                  "params": got["params"],
                  "metrics": _counter_metrics(got["counters"])}
        return harness.compare(cell, inputs, seed, record, [], None,
                               detail=detail)
    got = harness._to_host(ref_steps.eval_epoch(inputs.weights, cfg, x_norm,
                                                extreme, low))
    order = ref_data.epoch_orders(seed, got["n_samples"], 1, 1)[0][:, 0]
    m = dict(_counter_metrics(got["counters"]), loss_sums=got["loss_sums"])
    record = {"losses": _running([got["losses"][i] for i in order]),
              "z": [got["z"][i] for i in order], "metrics": m}
    return harness.compare(cell, inputs, seed, record, [m], m, detail=detail)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control", default="")
    ap.add_argument("--fault", default="")
    ap.add_argument("--out")
    args = ap.parse_args()
    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    device = "cuda:0"
    rows = []
    for kind, seeds in (("program", _seeds(args.seeds)),
                        ("control", _seeds(args.control)),
                        ("fault", _seeds(args.fault))):
        for seed in seeds:
            t0 = time.perf_counter()
            detail: dict = {}
            if kind == "control":
                nums = control_numbers(cell, seed, device, detail)
            else:
                nums = program_numbers(cell, seed, device, detail,
                                       kind == "fault")
            row = {"cell": cell.name, "kind": kind, "seed": seed,
                   "seconds": time.perf_counter() - t0, "numbers": nums,
                   "detail": detail}
            rows.append(row)
            print(json.dumps(row), flush=True)
            torch.cuda.empty_cache()
    summary = {}
    for kind in ("program", "control", "fault"):
        got = [r["numbers"] for r in rows if r["kind"] == kind]
        if got:
            summary[kind] = {k: [float(np.min([g[k] for g in got])),
                                 float(np.max([g[k] for g in got]))]
                             for k in got[0]}
    print(json.dumps({"cell": cell.name, "min_max": summary}))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"rows": rows, "min_max": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
