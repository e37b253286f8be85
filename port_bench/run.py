"""Run one cell of the port's benchmark once and print its result line.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout that holds BENCHMARK.json, port_bench/ and
the port (idee_tpu_torch). Makes the cube and the weights from the seed,
sets up the program (the first epoch, with its warm-up steps and the CUDA
graph capture), measures whole epochs until ``--seconds`` have passed
(with ``--trace 1`` under the profiler, for the per-layer metrics), then
compares what the program produced with the plain reference and prints,
as the last line of standard output, one JSON object: correct, attempted,
failed, metrics, device, breakdown (traced runs) and the numbers compared
with their limits. Those numbers are also the last lines of standard
error. Exits 3 without a result when the card is missing, and 4 when a
module of JAX or of the JAX package was loaded.

The bytecode of every module a run imports is cached in the checkout
(.cache/pycache): where the installed packages hold no bytecode of their
own and writing it is switched off (PYTHONDONTWRITEBYTECODE), every run
would compile thousands of modules anew, seconds of its set-up.
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.pycache_prefix = str(ROOT / ".cache" / "pycache")
sys.dont_write_bytecode = False

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402

sys.path.insert(0, str(ROOT))


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        out = f"nvidia-smi unavailable ({e})"
    return "card: " + out.replace("\n", "; ")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from port_bench import harness

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"needs {cell.chips} CUDA device(s); "
              f"cuda available: {torch.cuda.is_available()}",
              file=sys.stderr)
        return 3
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         "cuda:0", T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {bad}",
              file=sys.stderr)
        return 4
    print(card_line())
    parts = result.pop("setup_parts")
    print("setup parts (s): " + ", ".join(f"{k} {v:.3f}"
                                          for k, v in parts.items()),
          file=sys.stderr)
    checks = result.pop("checks")
    for k, v in result.pop("readings").items():
        if k not in checks:
            print(f"reading {k} {v!r} (not compared)", file=sys.stderr)
    for k, v in checks.items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    line = {k: result[k] for k in ("correct", "attempted", "failed",
                                   "metrics", "device")}
    if "breakdown" in result:
        line["breakdown"] = result["breakdown"]
    line["setup_parts"] = parts
    line["checks"] = checks
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
