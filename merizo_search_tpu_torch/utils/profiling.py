"""Wall-clock phase timers for the pipeline.

`phase(name)` accumulates wall time and a call count per pipeline phase into
a process-wide registry; `report()` renders the table the CLI logs at the
end of a run. A phase that ends in a host read of device results (the scan
returns numpy) includes the device time it waited for. `trace(dir)` records
a torch.profiler trace of a run (the CLI's --trace) as a Chrome trace file.
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
from collections import defaultdict

logger = logging.getLogger(__name__)

_lock = threading.Lock()
_acc: dict[str, list] = defaultdict(lambda: [0.0, 0])   # name -> [seconds, calls]


@contextlib.contextmanager
def phase(name: str):
    """Accumulate wall time for a named pipeline phase."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        with _lock:
            _acc[name][0] += dt
            _acc[name][1] += 1


def timings() -> dict[str, tuple[float, int]]:
    with _lock:
        return {k: (v[0], v[1]) for k, v in _acc.items()}


def reset() -> None:
    with _lock:
        _acc.clear()


def report(log=None) -> str:
    """Render (and optionally log) the accumulated phase table."""
    rows = sorted(timings().items(), key=lambda kv: -kv[1][0])
    if not rows:
        return ""
    width = max(len(k) for k, _ in rows)
    lines = ["phase timings:"]
    for name, (sec, calls) in rows:
        lines.append(f"  {name:<{width}}  {sec:9.3f} s  ({calls} calls)")
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
    import torch
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
