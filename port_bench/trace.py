"""What a traced window's profiler timeline says: the device's busy time
as the union of its activity intervals (overlapping kernels count once),
each kernel's launches and time, and the idle gaps with the benchmark's
own host span that was open when each began.

The harness marks its host work with ``torch.profiler.record_function``
spans named ``port_bench.<what>``; ``port_bench.window`` spans the
measured window.
"""

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

PREFIX = "port_bench."
WINDOW = PREFIX + "window"

Interval = Tuple[int, int]


def union(intervals: Sequence[Interval]) -> List[Interval]:
    """The intervals merged where they overlap or touch, in order."""
    out: List[List[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def clip(intervals: Sequence[Interval], lo: int, hi: int) -> List[Interval]:
    return [(max(a, lo), min(b, hi)) for a, b in intervals
            if b > lo and a < hi]


def short_name(name: str) -> str:
    """A kernel's name without its argument list and return type."""
    name = name.replace("(anonymous namespace)", "anon").split("(")[0]
    return name[5:] if name.startswith("void ") else name


def kernel_match(name: str, kernel: str) -> bool:
    """True when ``name`` is a launch of the kernel ``kernel`` (any
    template instance)."""
    return re.search(rf"(^|[\s:]){re.escape(kernel)}(<|\(|$)",
                     name) is not None


@dataclass
class Summary:
    window_s: float
    busy_s: float
    kernels: Dict[str, Tuple[int, float]] = field(default_factory=dict)
    gaps: List[Tuple[str, float]] = field(default_factory=list)

    def kernel_time(self, kernel: str) -> Tuple[int, float]:
        """(launches, seconds) of every instance of ``kernel``."""
        n, s = 0, 0.0
        for name, (c, t) in self.kernels.items():
            if kernel_match(name, kernel):
                n, s = n + c, s + t
        return n, s

    def breakdown(self) -> dict:
        merged: Dict[str, float] = {}
        for name, (_, t) in self.kernels.items():
            k = short_name(name)
            merged[k] = merged.get(k, 0.0) + t
        top = sorted(merged.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, t] for k, t in top],
                "idle_gaps": [[k, t] for k, t in self.gaps]}


def _on_device(ev) -> bool:
    return "CUDA" in str(ev.device_type())


def _is_activity(ev) -> bool:
    """A kernel, copy or fill on the device (not the device-side copy of
    a host span)."""
    if getattr(ev, "is_user_annotation", lambda: False)():
        return False
    return not ev.name().startswith(PREFIX)


def summarize(events) -> Summary:
    """Reads kineto events (``prof.profiler.kineto_results.events()``:
    name(), device_type(), start_ns(), duration_ns())."""
    window: Optional[Interval] = None
    spans: List[Tuple[int, int, str]] = []
    device: List[Tuple[int, int, str]] = []
    for ev in events:
        name = ev.name()
        a = ev.start_ns()
        b = a + ev.duration_ns()
        if _on_device(ev):
            if _is_activity(ev):
                device.append((a, b, name))
        elif name == WINDOW:
            window = (a, b)
        elif name.startswith(PREFIX):
            spans.append((a, b, name[len(PREFIX):]))
    if window is None:
        raise RuntimeError("the trace holds no port_bench.window span")
    lo, hi = window
    kernels: Dict[str, Tuple[int, float]] = {}
    for a, b, name in device:
        if lo <= a < hi:
            c = kernels.get(name, (0, 0.0))
            kernels[name] = (c[0] + 1, c[1] + (b - a) * 1e-9)
    busy = union(clip([(a, b) for a, b, _ in device], lo, hi))
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    idle = sorted(((b - a, a) for a, b in zip(edges[0::2], edges[1::2])
                   if b > a), reverse=True)[:10]
    gaps = [(_host_span(spans, a), n * 1e-9) for n, a in idle]
    return Summary(window_s=(hi - lo) * 1e-9,
                   busy_s=sum(b - a for a, b in busy) * 1e-9,
                   kernels=kernels, gaps=gaps)


def _host_span(spans: List[Tuple[int, int, str]], t: int) -> str:
    """The innermost benchmark span open at ``t`` (the shortest that
    covers it), or "other"."""
    best = None
    for a, b, name in spans:
        if a <= t < b and (best is None or b - a < best[0]):
            best = (b - a, name)
    return best[1] if best else "other"
