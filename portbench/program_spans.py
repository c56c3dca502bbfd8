"""The program's own span records (`utils/profiling.spans` of the port)
matched to a run's calls, for the readers of `program_span` metrics.

A record has a `name`, `start` and `end` on `time.perf_counter()` (the
clock of `Run.calls`) and `device_s` (None where no device time was
taken). A record belongs to the call whose start and end enclose its
start.
"""

from __future__ import annotations

import bisect


def records():
    """The program's span records, oldest first, or None where the program
    keeps none (a port without `profiling.spans`)."""
    try:
        from merizo_search_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "spans", None)
    return read() if read is not None else None


def by_call(run, recs, calls, names) -> list | None:
    """For each call index in `calls`, {name: [records named so that start
    in it]} for each of `names`. None where the ring no longer holds the
    window's first call (its oldest record starts after that call's start)."""
    if not recs or not run.calls or recs[0].start > run.calls[0][0]:
        return None
    mine = sorted((r for r in recs if r.name in names), key=lambda r: r.start)
    starts = [r.start for r in mine]
    out = []
    for i in calls:
        c0, c1 = run.calls[i][0], run.calls[i][1]
        got = {n: [] for n in names}
        for r in mine[bisect.bisect_left(starts, c0):bisect.bisect_right(starts, c1)]:
            got[r.name].append(r)
        out.append(got)
    return out
