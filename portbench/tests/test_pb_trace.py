"""The reductions a traced run's per-layer metrics read: idle gaps named by
the host ranges around them, and the time a call outside the profiled
sub-window."""

from pb_small import ROOT  # noqa: F401  (puts the checkout on sys.path)

from portbench import core, trace


def test_a_gap_is_named_by_its_span_and_innermost_op():
    host = [(0, 100, trace.WINDOW), (10, 50, trace.CALL), (20, 40, "aten::to"),
            (25, 35, "cudaMemcpyAsync"), (60, 90, trace.CALL)]
    around = trace._innermost(host, [5, 15, 30, 38, 55, 70])
    assert [trace._gap_name(a) for a in around] == [
        "between calls", "call", "call/cudaMemcpyAsync", "call/aten::to",
        "between calls", "call"]


def test_a_calls_time_leaves_out_the_profiled_calls_and_the_profilers_start_and_stop():
    run = core.Run(cell=None, driver=None)
    # calls of 1 s; the profiler's start costs 5 s before call 2, its stop
    # 7 s after call 3; calls 2 and 3 are profiled and take 2 s each
    run.calls = [(0, 1, 8), (1, 2, 8), (7, 9, 8), (9, 11, 8), (18, 19, 8), (19, 20, 8)]
    run.traced = (2, 4)
    assert run.untraced_call_s() == 1.0
    run.traced = (0, 0)
    assert run.untraced_call_s() == 20 / 6
