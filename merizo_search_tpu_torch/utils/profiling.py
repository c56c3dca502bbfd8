"""Wall-clock phase timers for the pipeline.

`phase(name)` accumulates wall time and a call count per pipeline phase into
a process-wide registry; `report()` renders the table the CLI logs at the
end of a run. A phase that ends in a host read of device results (the scan
returns numpy) includes the device time it waited for.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict

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
