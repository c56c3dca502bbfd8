"""Spans, phase timers and counters of the port.

`phase(name)` is a span around one piece of the pipeline. It accumulates
wall time, a call count and self time (its time less the time its child
spans cover) per name into a process-wide registry, which `timings()`
reads and `report()` renders as the table the CLI logs at the end of a
run. Each span is also kept as a record (`Span`) in a bounded ring that
`spans()` reads: its name, its id, its parent's (from a per-thread stack),
the id of the top-level span it belongs to (one id for all the spans of
one `SearchEngine.search` call), and its start and end on
`time.perf_counter()`. A phase that ends in a host read of device results
(the scan returns numpy) includes the device time it waited for.

Tracing is on while a torch profiler records in this process (torch's
`autograd.profiler._is_profiler_enabled`: the CLI's --trace, a benchmark's
profiled window). Then each span is also a profiler range "mst.<name>",
so the device's idle gaps in the profiler's trace can be put down to the
program's spans (the ranges are host ops, with no mirror on the device's
timeline), and a span given a CUDA `device` records a pair of CUDA events
on that device's current stream. The pair is kept pending and read as the
span's device seconds once its end event has completed (polled as a
top-level span closes), or when `spans()` or `timings()` is read. A span
given a `device` (the scan's phases) is recorded only while tracing; with
no profiler it costs one flag check. No span enters a profiler range,
records an event or waits on the device while tracing is off.

`count(name)` bumps a named counter under the registry's lock (the kernel
wrappers' launches, e.g. `ops.blockmax.LAUNCHES`, "blockmax.launches"),
read by `counter(name)` and `counters()`. A counter is declared first
(`declare(name)`, which the wrapper's module does at import): counting or
reading a name nothing declared raises KeyError, so a misspelt name fails
where it is read. `trace(dir)` records a torch.profiler trace of a run (the
CLI's --trace) as a Chrome trace file.
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import os
import threading
import time
from collections import defaultdict, deque
from typing import NamedTuple

import torch
from torch.autograd import profiler as _autograd_profiler

logger = logging.getLogger(__name__)

RING = 1 << 16          # span records kept; the oldest go first

_lock = threading.Lock()
_acc: dict[str, list] = defaultdict(lambda: [0.0, 0, 0.0, 0.0])  # seconds, calls, self, device
_ring: deque = deque(maxlen=RING)
_pending: deque = deque()       # device spans whose end event has not been read yet
_counts: dict[str, int] = {}
_ids = itertools.count(1)
_local = threading.local()
# A profiler range recorded as a host op: unlike record_function's user
# annotations, CUPTI gives it no mirror on the device's timeline, so the
# trace's device busy time stays the device's own work.
_HostRange = torch._C._profiler._RecordFunctionFast


class Timing(NamedTuple):
    """One name's totals: host seconds, calls, self seconds (less the time
    its child spans cover) and device seconds (of the spans timed on a
    card while tracing)."""
    seconds: float
    calls: int
    self_s: float
    device_s: float


class Span:
    """One span: a context manager while open, then the record `spans()`
    returns. `device_s` is None where no device time was recorded (tracing
    off, a CPU device) or has not been read yet."""

    __slots__ = ("name", "id", "parent", "root", "start", "end", "device_s",
                 "_device", "_child", "_range", "_events")

    def __init__(self, name: str, device=None):
        self.name = name
        self._device = device
        self.device_s = None

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        up = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = up.id if up else None
        self.root = up.root if up else self.id
        self._child = 0.0
        self._range = self._events = None
        if _autograd_profiler._is_profiler_enabled:
            self._range = _HostRange("mst." + self.name)
            self._range.__enter__()
            dev = self._device
            if dev is not None and dev.type == "cuda":
                self._events = (torch.cuda.Event(enable_timing=True),
                                torch.cuda.Event(enable_timing=True))
                self._events[0].record(torch.cuda.current_stream(dev))
        stack.append(self)
        self.start = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.end = time.perf_counter()
        events = self._events
        if events is not None:
            events[1].record(torch.cuda.current_stream(self._device))
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
        self._range = self._events = self._device = None
        stack = _local.stack
        stack.pop()
        dt = self.end - self.start
        if stack:
            stack[-1]._child += dt
        with _lock:
            acc = _acc[self.name]
            acc[0] += dt
            acc[1] += 1
            acc[2] += dt - self._child
            _ring.append(self)
            if events is not None:
                _pending.append((self, *events))
            if _pending and not stack:
                _read_device(wait=False)
        return False


_OFF = contextlib.nullcontext()     # a device span while tracing is off


def phase(name: str, device=None):
    """A span named `name` (`with phase("db_scan"): ...`). With a `device`
    (a torch.device whose current stream runs the span's work) the span is
    recorded only while tracing, and on a CUDA device also times that
    stream with a pair of events."""
    if device is not None and not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return Span(name, device)


def _read_device(wait: bool) -> None:
    """Turn pending event pairs into device seconds, oldest first: those
    whose end event has completed, or (wait) all of them. Under _lock."""
    while _pending:
        rec, e0, e1 = _pending[0]
        if wait:
            e1.synchronize()
        elif not e1.query():
            return
        rec.device_s = e0.elapsed_time(e1) * 1e-3
        _acc[rec.name][3] += rec.device_s
        _pending.popleft()


def spans() -> list:
    """The records in the ring, oldest first, their device seconds read."""
    with _lock:
        _read_device(wait=True)
        return list(_ring)


def timings() -> dict[str, Timing]:
    with _lock:
        _read_device(wait=True)
        return {k: Timing(*v) for k, v in _acc.items()}


def reset() -> None:
    """Clear the timings and the ring (the counters stay)."""
    with _lock:
        _acc.clear()
        _ring.clear()
        _pending.clear()


def declare(name: str) -> str:
    """Declare a counter (a kernel wrapper does, at import, and keeps the
    name as a module constant) and return its name."""
    with _lock:
        _counts.setdefault(name, 0)
    return name


def count(name: str) -> None:
    """Bump a declared counter (KeyError for a name nothing declared)."""
    with _lock:
        _counts[name] += 1


def counter(name: str) -> int:
    """A declared counter's count (KeyError for a name nothing declared)."""
    with _lock:
        return _counts[name]


def counters() -> dict[str, int]:
    with _lock:
        return dict(_counts)


def reset_counters() -> None:
    """Set every declared counter to 0."""
    with _lock:
        for name in _counts:
            _counts[name] = 0


def report(log=None) -> str:
    """Render (and optionally log) the accumulated phase table."""
    rows = sorted(timings().items(), key=lambda kv: -kv[1].seconds)
    if not rows:
        return ""
    width = max(len(k) for k, _ in rows)
    lines = ["phase timings:"]
    for name, t in rows:
        dev = f", device {t.device_s:.3f} s" if t.device_s else ""
        lines.append(f"  {name:<{width}}  {t.seconds:9.3f} s  (self {t.self_s:.3f} s"
                     f"{dev}; {t.calls} calls)")
    text = "\n".join(lines)
    if log is not None:
        log.info("%s", text)
    return text


@contextlib.contextmanager
def trace(trace_dir: str | None):
    """Record a torch.profiler trace (host ops, and the card's kernels and
    copies where there is a card) into trace_dir as a Chrome trace JSON
    (chrome://tracing, Perfetto); a no-op when trace_dir is None."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(trace_dir, f"trace_{os.getpid()}_{time.strftime('%Y%m%d_%H%M%S')}.json")
    prof.export_chrome_trace(path)
    logger.info("device trace written to %s", path)
