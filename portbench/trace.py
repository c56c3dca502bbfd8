"""Reduces a profiled sub-window to what the per-layer metrics read.

The profiler (torch.profiler, CUPTI on the card) records the device's
kernels, copies and sets, the host's ops and runtime calls, and the
benchmark's own host spans as ranges named "portbench.<span>";
"portbench.window" brackets the sub-window. All are read in the
profiler's one timebase (microseconds).
"""

from __future__ import annotations

from dataclasses import dataclass, field

SPAN = "portbench."
WINDOW = "portbench.window"
CALL = "portbench.call"


@dataclass
class Trace:
    window_s: float = 0.0          # the profiled sub-window
    busy_s: float = 0.0            # union of the device's operations in it
    calls: int = 0                 # whole calls in it
    device_ops: dict = field(default_factory=dict)   # operation name -> seconds
    idle_by_span: dict = field(default_factory=dict)  # host span[/op] -> idle seconds

    def op_seconds(self, names) -> float:
        """Seconds of the device operations whose names contain any of `names`."""
        return sum(s for op, s in self.device_ops.items() if any(n in op for n in names))


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _innermost(host, points):
    """For each point (sorted), the innermost host range around it: a sweep
    over the ranges of one thread, sorted by start, which nest."""
    host = sorted(host, key=lambda r: (r[0], -r[1]))
    stack, j, out = [], 0, []
    for p in points:
        while j < len(host) and host[j][0] <= p:
            while stack and stack[-1][1] < host[j][0]:
                stack.pop()
            stack.append(host[j])
            j += 1
        while stack and stack[-1][1] < p:
            stack.pop()
        out.append(list(stack))
    return out


def _gap_name(around) -> str:
    """A gap's name: the innermost benchmark span around it ("between
    calls" where there is none), then the innermost host op of the
    profiler's inside that span, if any."""
    spans = [r for r in around if r[2].startswith(SPAN) and r[2] != WINDOW]
    name = spans[-1][2][len(SPAN):] if spans else "between calls"
    if around and not around[-1][2].startswith(SPAN):
        name += "/" + around[-1][2]
    return name


def summarize(prof) -> Trace:
    """The sub-window's device busy time, its operations by name, the calls
    in it, and its idle time by what the host was doing around each gap."""
    from torch.autograd import DeviceType
    events = list(prof.events())
    win = [e for e in events if e.name == WINDOW and e.device_type != DeviceType.CUDA]
    if not win:
        return Trace()
    w0, w1 = win[0].time_range.start, win[0].time_range.end
    dev, host, calls = [], [], 0
    ops: dict = {}
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA and not e.name.startswith(SPAN):
            # (a host range's mirror on the device timeline is no device work)
            a, b = max(a, w0), min(b, w1)
            if b > a:
                dev.append((a, b))
                ops[e.name] = ops.get(e.name, 0.0) + (b - a) * 1e-6
        elif e.device_type != DeviceType.CUDA and (e.thread == win[0].thread
                                                   or e.name.startswith("cuda")):
            # (the runtime's calls may carry the thread's system id)
            host.append((a, b, e.name))
            calls += e.name == CALL
    busy = _union(dev)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(g0, g1) for g0, g1 in zip(edges[0::2], edges[1::2]) if g1 > g0]
    idle: dict = {}
    for (g0, g1), around in zip(gaps, _innermost(host, [0.5 * (g0 + g1) for g0, g1 in gaps])):
        name = _gap_name(around)
        idle[name] = idle.get(name, 0.0) + (g1 - g0) * 1e-6
    return Trace(window_s=(w1 - w0) * 1e-6, busy_s=sum(b - a for a, b in busy) * 1e-6,
                 calls=calls, device_ops=ops, idle_by_span=idle)


def breakdown(tr: Trace, n: int = 10) -> dict:
    """The result line's breakdown: the device operations that took most
    time, and the idle time by what the host was doing, each [name, s]."""
    top = sorted(tr.device_ops.items(), key=lambda kv: -kv[1])[:n]
    gaps = sorted(tr.idle_by_span.items(), key=lambda kv: -kv[1])[:n]
    return {"device_ops": [[k, v] for k, v in top], "idle_gaps": [[k, v] for k, v in gaps]}
