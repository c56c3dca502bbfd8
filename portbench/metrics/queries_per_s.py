"""Queries answered in the window (their results in host memory) over the
window's seconds, from the first call's start to the last call's end
(host clock)."""


def read(run):
    return run.answered / run.window_s if run.window_s > 0 else None
