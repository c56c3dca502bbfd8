"""Host milliseconds a call in the program's `SearchEngine.search`: its
"search" span less its "search.copy_back" child (the host waiting for the
device's top-k), from the program's span records (program_span), averaged
over the window's calls outside the profiled sub-window, whose profiler
slows the host. None where the program keeps no spans or its ring no
longer holds the window's first call."""

from portbench import program_spans

NAMES = ("search", "search.copy_back")


def read(run):
    recs = program_spans.records()
    if recs is None:
        return None
    a, b = run.traced
    per = program_spans.by_call(run, recs, [i for i in range(len(run.calls))
                                            if not a <= i < b], NAMES)
    if per is None:
        return None
    host = [sum(r.end - r.start for r in c["search"])
            - sum(r.end - r.start for r in c["search.copy_back"])
            for c in per if c["search"]]
    return 1e3 * sum(host) / len(host) if host else None
