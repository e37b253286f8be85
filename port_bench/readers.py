"""What the per-layer metrics' readers (port_bench/metrics/<name>.py) have
in common. A reader is ``read(ctx) -> float or None``: None where the
traced window gives it nothing to read, and the harness then leaves the
metric out. ``ctx`` is a ``Context`` of the traced run. Which cells a
metric is read in is BENCHMARK.json's ``workloads`` of the metric.
"""

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from port_bench import bounds
from port_bench.trace import Summary


@dataclass
class Context:
    cfg: dict          # the configuration's fields
    traffic: dict      # the traffic's parameters
    workload: dict     # the cell's own file
    summary: Summary   # the traced window
    samples: int       # samples completed in the traced window
    peak_bytes: int    # the device's peak allocation, set-up and window


def mfu(ctx: Context) -> Optional[float]:
    """The step's model FLOPs (counted over the reference, in the cell's
    file) over the window, as a share of the peak of the compute dtype."""
    if not ctx.samples or not ctx.summary.window_s:
        return None
    peak = bounds.PEAK_FLOPS[ctx.cfg["dtype"]]
    flops = ctx.workload["flops_per_sample"] * ctx.samples
    return 100.0 * flops / ctx.summary.window_s / peak


def roofline(ctx: Context, kernels: Dict[str, List[str]],
             least: Callable[[dict, dict], Dict[str, float]]
             ) -> Optional[float]:
    """Kernels' least time at the cell's shapes over their device time in
    the window. ``kernels``: each family's kernel names in the trace (a
    family's launches are counted by its first name; the others' time is
    part of its work); ``least(cfg, traffic)``: each family's least
    seconds in one step, one launch of the first name per encoder
    block."""
    per_step = least(ctx.cfg, ctx.traffic)
    blocks = sum(ctx.cfg["en_depths"])
    spent = bound = 0.0
    for fam, names in kernels.items():
        n, s = ctx.summary.kernel_time(names[0])
        if n == 0:
            continue
        for other in names[1:]:
            s += ctx.summary.kernel_time(other)[1]
        bound += n / blocks * per_step[fam]
        spent += s
    if spent == 0.0:
        return None
    return 100.0 * bound / spent


def idle_share(ctx: Context) -> Optional[float]:
    """The window's share in which no operation ran on the device."""
    s = ctx.summary
    if not s.window_s:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)


def peak_mem_gb(ctx: Context) -> Optional[float]:
    """The device's peak allocation over set-up and window, in GB."""
    if not ctx.peak_bytes:
        return None
    return ctx.peak_bytes / 1e9
