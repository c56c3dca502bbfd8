"""The readers of the program's own spans (`search_host_ms`, `phase_b_ms`):
which calls' records each reads, what each reads without the records it
needs, a traced CPU run of the small TED cell, and (marked `gpu`) a traced
run at the cell's size whose spans agree with the device trace."""

import json
import statistics
import time
from types import SimpleNamespace

import pytest

from pb_small import ROOT, TED, cpu_run

from portbench import core, program_spans, trace

SCAN = ("scan.phase_a", "scan.phase_b", "scan.phase_c", "scan.final", "scan.dequant")
LATENCY_MS = 0.03   # phase A's device span over its kernel and its launch's host time


def _reader(name):
    return core.load_module(f"{ROOT}/portbench/metrics/{name}.py", "pb_test_" + name)


def _rec(name, start, end, device_s=None):
    return SimpleNamespace(name=name, start=start, end=end, device_s=device_s)


def _hand_made():
    """Six calls of 1-2 s, calls 2 and 3 profiled. Each call: a "search"
    span with a "search.copy_back" child of 0.1 s a call index (copy_back
    ends the call), and a "scan.phase_b" span whose device seconds are
    0.01 s a call index where the profiler ran. Before the window, a
    set-up call and the profiler's warm-up call with a phase B of 5 s."""
    run = core.Run(cell=None, driver=None)
    run.calls = [(0, 1, 8), (1, 2, 8), (5, 7, 8), (7, 9, 8), (12, 13, 8), (13, 14, 8)]
    run.traced = (2, 4)
    recs = [_rec("search", -9.0, -8.0), _rec("scan.phase_b", -4.0, -3.9, 5.0),
            _rec("search", -4.1, -3.0)]
    for i, (c0, c1, _) in enumerate(run.calls):
        dev = 0.01 * i if 2 <= i < 4 else None
        recs += [_rec("scan.phase_b", c0 + 0.2, c0 + 0.3, dev),
                 _rec("search.copy_back", c1 - 0.01 - 0.1 * i, c1 - 0.01),
                 _rec("search", c0 + 0.01, c1 - 0.01)]
    return run, sorted(recs, key=lambda r: r.end)


@pytest.mark.parametrize("name, want", [
    # untraced calls 0, 1, 4, 5: (call length - 0.02) less 0.1 * i
    ("search_host_ms", 1e3 * ((0.98 - 0.0) + (0.98 - 0.1) + (0.98 - 0.4) + (0.98 - 0.5)) / 4),
    # traced calls 2 and 3, the warm-up's 5 s left out
    ("phase_b_ms", 1e3 * (0.02 + 0.03) / 2),
])
def test_each_reader_picks_its_calls_records(monkeypatch, name, want):
    run, recs = _hand_made()
    monkeypatch.setattr(program_spans, "records", lambda: recs)
    assert _reader(name).read(run) == pytest.approx(want)
    # the ring no longer holds the window's first call: nothing to read
    monkeypatch.setattr(program_spans, "records", lambda: [r for r in recs if r.start > 0.5])
    assert _reader(name).read(run) is None
    # a program that keeps no spans (the parent of this reader)
    monkeypatch.setattr(program_spans, "records", lambda: None)
    assert _reader(name).read(run) is None


def test_phase_b_reads_nothing_without_device_time(monkeypatch):
    run, recs = _hand_made()
    for r in recs:
        r.device_s = None
    monkeypatch.setattr(program_spans, "records", lambda: recs)
    assert _reader("phase_b_ms").read(run) is None


def test_a_traced_cpu_run_reads_the_host_span_and_no_device_time():
    run, compared, correct = cpu_run(TED, 2 ** 32 + 17, trace=True)
    assert correct, compared
    got = core.read_metrics(run, ["search_host_ms", "phase_b_ms"])
    assert set(got) == {"search_host_ms"}
    assert 0 < got["search_host_ms"]["value"] < 1e3 * run.untraced_call_s()


@pytest.mark.gpu
def test_the_spans_agree_with_the_device_trace_at_the_cells_size():
    """On the card: the "search" span against the time a call outside the
    profiled sub-window (3%); phase A's device span holds its kernel's
    time, and exceeds it by at most the host time of its launch; the
    scan's device spans sum to the device's busy time (10%) once phase A's
    excess over its kernel is taken out. Phase A is the one span the card
    reaches with nothing queued, so its start event fires at once and the
    host's delay before the kernel starts counts as device time. That
    delay lies inside the span's own host time (`mst_blockmax_scan`'s
    call); LATENCY_MS allows the launch's latency on the card and the two
    event records, a few us each."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell = core.resolve(ROOT, core.load_spec(ROOT), TED)
    dev = torch.device("cuda", 0)
    run, _ = core.run_cell(cell, 2 ** 32 + 29, 10.0, True, dev, time.perf_counter())
    torch.cuda.synchronize(dev)
    run.trace = tr = trace.summarize(run.trace)
    recs = program_spans.records()
    a, b = run.traced
    inside = program_spans.by_call(run, recs, range(a, b), SCAN)
    outside = program_spans.by_call(run, recs, [i for i in range(len(run.calls))
                                                if not a <= i < b], ("search",))
    dev_ms = {n: [1e3 * sum(r.device_s for r in c[n]) for c in inside] for n in SCAN}
    kernel_ms = 1e3 * tr.op_seconds(("blockmax_kernel",)) / tr.calls
    launch_ms = statistics.fmean(1e3 * (r.end - r.start) for c in inside
                                 for r in c["scan.phase_a"])
    excess_s = 1e-3 * sum(dev_ms["scan.phase_a"]) - 1e-3 * kernel_ms * tr.calls
    search_s = [r.end - r.start for c in outside for r in c["search"]]
    out = {"traced_calls": b - a, "trace_calls": tr.calls, "window_s": tr.window_s,
           "busy_s": tr.busy_s, "blockmax_kernel_ms": kernel_ms, "phase_a_excess_s": excess_s,
           "phase_a_launch_host_ms": launch_ms,
           "phase_ms": {n: [statistics.fmean(v), statistics.median(v), max(v)]
                        for n, v in dev_ms.items()},
           "search_ms": 1e3 * statistics.fmean(search_s),
           "untraced_call_ms": 1e3 * run.untraced_call_s(),
           "phases": {k: [v[0], v[1]] for k, v in run.phases.items()},
           "metrics": core.read_metrics(run, cell.per_layer)}
    print("SPANS_AGREE " + json.dumps(out))
    assert tr.calls == b - a
    assert out["search_ms"] == pytest.approx(out["untraced_call_ms"], rel=0.03)
    phase_a_ms = statistics.fmean(dev_ms["scan.phase_a"])
    assert 0.99 * kernel_ms <= phase_a_ms <= kernel_ms + launch_ms + LATENCY_MS
    total_s = 1e-3 * sum(sum(v) for v in dev_ms.values())
    assert total_s - excess_s == pytest.approx(tr.busy_s, rel=0.10)
