# ------------------------------------------------------------------
"""Named spans of the port's step, and the trainers' ``profile_dir``
hook.

``span(name, device)`` opens the host range ``idee.<name>``
(``torch.profiler.record_function``, which costs nothing while no
profiler runs) and, on a CUDA device, launches an empty kernel
``idee_span_<name>_begin`` on entry and ``idee_span_<name>_end`` on exit,
on the current stream (kernels/csrc/span_marks.cu, <<<1, 1>>>). Under
CUDA-graph capture each mark becomes a kernel node of the graph, so every
replay emits them on the device trace's clock, where no Python runs and
no host range opens. On the CPU no mark is launched. The marks are always
on: a traced run replays the same graph as an untraced one.

The step's spans, in the order a train step opens them (train/steps.py,
train/steps_real.py, models/vq_model.py):

    step                  FusedEpoch's step, or a per-step loop's
      data                the batch gathered on the device
      encoder
      quantizer           the codebook and its output projection
      classifier
      loss                twice a step: the anomaly L1 in the forward,
                          then the total loss
      backward            zero_grad and loss.backward()
        encoder_backward  from the gradient's arrival at the encoder's
                          output to the end of the backward
      grad_sync           the gradient average, under a mesh only
      optimizer           state.update()
      accumulate          counters, loss sums and votes

Host ranges alone (``host_range``) mark the epoch's host work: ``order``,
``upload``, ``zero``, ``replays`` and ``metrics_to_host``.

``read_spans`` pairs the marks of a profiler's events: a span's device
time runs from the end of its begin mark to the start of its end mark.
"""
# ------------------------------------------------------------------

import contextlib
import ctypes
import os
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import torch

from idee_tpu_torch.kernels import build
from idee_tpu_torch.utils.logging import log_string

PREFIX = "idee."        # host ranges
MARK = "idee_span_"     # mark kernels: idee_span_<name>_begin / _end
SOURCE = "span_marks"   # kernels/csrc/span_marks.cu
NAMES = ("step", "data", "encoder", "quantizer", "classifier", "loss",
         "backward", "encoder_backward", "grad_sync", "optimizer",
         "accumulate")
# the span each one lies in
PARENT = {**{n: "step" for n in NAMES if n != "step"},
          "encoder_backward": "backward"}

Interval = Tuple[int, int]

# spans begun by a gradient hook (``begin_on_grad``) while the backward
# span is open, ended with it; None while no backward span is open. Kept
# here because the hook runs on autograd's device thread, where nothing
# of the step that opened the backward span is in reach.
_late: Optional[List[tuple]] = None


def _check(name: str) -> None:
    """Only the spans that csrc/span_marks.cu declares have marks."""
    if name not in NAMES:
        raise ValueError(f"no span {name!r}: the spans are {NAMES}")


def _mark(name: str, edge: str, device: torch.device) -> None:
    fn = build.c_function(SOURCE, f"idee_span_launch_{name}_{edge}",
                          [ctypes.c_void_p])
    build.call(fn, f"{MARK}{name}_{edge}", device, [])


def host_range(name: str):
    """The host range ``idee.<name>`` alone, with no device mark."""
    return torch.profiler.record_function(PREFIX + name)


@contextlib.contextmanager
def span(name: str, device) -> Iterator[None]:
    """The span ``name`` (one of NAMES) around the block: its host range,
    and on a CUDA ``device`` its begin and end marks."""
    _check(name)
    device = torch.device(device)
    on_card = device.type == "cuda"
    with host_range(name):
        if on_card:
            _mark(name, "begin", device)
        yield
        if on_card:
            _mark(name, "end", device)


@contextlib.contextmanager
def backward(device) -> Iterator[None]:
    """The ``backward`` span; a span that a gradient hook begins inside it
    (``begin_on_grad``) ends just before it."""
    global _late
    with span("backward", device):
        _late = []
        try:
            yield
        finally:
            late, _late = _late, None
        for name, dev, rng in reversed(late):
            if dev.type == "cuda":
                _mark(name, "end", dev)
            rng.__exit__(None, None, None)


def begin_on_grad(t: torch.Tensor, name: str) -> None:
    """Where gradients flow into ``t``, the span ``name`` begins when they
    reach it inside an open ``backward`` span (on the stream the backward
    runs on), and ends with that span. No hook is registered where ``t``
    takes no gradient."""
    _check(name)
    if not t.requires_grad:
        return
    device = t.device

    def hook(grad):
        if _late is None:
            return None
        rng = host_range(name)
        rng.__enter__()
        if device.type == "cuda":
            _mark(name, "begin", device)
        _late.append((name, device, rng))
        return None

    t.register_hook(hook)


# ---------------------------------------------------------------- reading

def mark_of(kernel: str) -> Optional[Tuple[str, str]]:
    """(span, "begin" or "end") of a mark kernel's name, else None."""
    if not kernel.startswith(MARK):
        return None
    name, _, edge = kernel[len(MARK):].rpartition("_")
    return (name, edge) if edge in ("begin", "end") and name else None


def _on_device(ev) -> bool:
    return "CUDA" in str(ev.device_type())


def device_marks(events, window: Optional[Interval] = None
                 ) -> List[Tuple[int, int, str]]:
    """(start ns, end ns, kernel name) of every mark kernel in kineto
    events (``prof.profiler.kineto_results.events()``); with ``window``,
    of those that start inside it."""
    out = []
    for ev in events:
        name = ev.name()
        if _on_device(ev) and mark_of(name) is not None:
            a = ev.start_ns()
            if window is None or window[0] <= a < window[1]:
                out.append((a, a + ev.duration_ns(), name))
    return out


def pair_marks(marks: Iterable[Tuple[int, int, str]]
               ) -> Dict[str, List[Interval]]:
    """Each span's instances (start ns, end ns), in device order: a begin
    mark pairs with the next end mark of its name, and the instance runs
    from the end of the begin mark to the start of the end mark. Raises
    where a name's marks do not pair."""
    out: Dict[str, List[Interval]] = {}
    begun: Dict[str, int] = {}
    for a, b, kernel in sorted(marks):
        name, edge = mark_of(kernel)
        if edge == "begin":
            if name in begun:
                raise ValueError(f"span {name}: a begin mark at {a} ns "
                                 "while one is open")
            begun[name] = b
        else:
            if name not in begun:
                raise ValueError(f"span {name}: an end mark at {a} ns "
                                 "with no begin")
            out.setdefault(name, []).append((begun.pop(name), a))
    if begun:
        raise ValueError(f"spans {sorted(begun)}: begin marks with no end")
    return out


def read_spans(events, window: Optional[Interval] = None
               ) -> Dict[str, List[Interval]]:
    """The spans of kineto events, paired from their device marks (with
    ``window``, those that start inside it)."""
    return pair_marks(device_marks(events, window))


def busy_ns(events, within: Optional[Iterable[Interval]] = None) -> int:
    """The union of the device's activity intervals in kineto events
    (kernels, copies, fills; not the device side of host ranges), in ns;
    with ``within``, only its parts inside those intervals (which must
    not overlap)."""
    merged: List[List[int]] = []
    for a, b in sorted((ev.start_ns(), ev.start_ns() + ev.duration_ns())
                       for ev in events
                       if _on_device(ev) and not ev.is_user_annotation()
                       and not ev.name().startswith(PREFIX)):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    if within is None:
        return sum(b - a for a, b in merged)
    return sum(max(0, min(b, hi) - max(a, lo))
               for lo, hi in within for a, b in merged)


def host_ranges(events) -> Dict[str, List[Interval]]:
    """Each ``idee.<name>`` host range's instances (start ns, end ns) in
    kineto events, by name, in order."""
    out: Dict[str, List[Interval]] = {}
    for ev in events:
        name = ev.name()
        if not _on_device(ev) and name.startswith(PREFIX):
            a = ev.start_ns()
            out.setdefault(name[len(PREFIX):], []).append(
                (a, a + ev.duration_ns()))
    return {k: sorted(v) for k, v in out.items()}


# ---------------------------------------------------------------- the hook

class StepTrace:
    """The ``profile_dir`` hook of the trainers (JAX's jax.profiler trace
    of steps 2-7 of the first epoch, idee_tpu/train/driver.py:214-246):
    torch.profiler with CUDA activity on a card and CPU activity
    otherwise, written as a Chrome trace ``<directory>/<name>.trace.json``.
    ``steps(batches)`` yields a per-step loop's batches and traces their
    steps FIRST to LAST (the first two build and warm up); a shorter
    epoch's end closes the trace. ``whole()`` traces everything run inside
    it: the fused path's first epoch, its warm-up steps, capture and
    replays, whose spans the marks show."""

    FIRST, LAST = 2, 7

    def __init__(self, directory: str, name: str, device: torch.device,
                 logger=None):
        from torch.profiler import ProfilerActivity, profile

        self.path = os.path.join(directory, f"{name}.trace.json")
        self.directory = directory
        self.device = device
        self.logger = logger
        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities)
        self._active = False

    def _start(self):
        self._sync()
        self._prof.start()
        self._active = True

    def steps(self, batches):
        """``batches``, step i's trace starting when batch FIRST is handed
        out and ending when the step after batch LAST asks for the next."""
        try:
            for i, batch in enumerate(batches):
                if i == self.FIRST:
                    self._start()
                yield batch
                if i == self.LAST:
                    self.close()
        finally:
            self.close()

    @contextlib.contextmanager
    def whole(self) -> Iterator[None]:
        """Traces the block whole."""
        self._start()
        try:
            yield
        finally:
            self.close()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def close(self):
        if not self._active:
            return
        self._sync()
        self._prof.stop()
        self._active = False
        os.makedirs(self.directory, exist_ok=True)
        self._prof.export_chrome_trace(self.path)
        log_string(self.logger, f"profiler trace -> {self.directory}")
