"""The share of the profiled sub-window in which no kernel, copy or set
runs on the card (torch.profiler's device trace). The profiler records
every host op there and lengthens the host's part of each call, so this
reads somewhat above the idle share of calls that are not profiled."""


def read(run):
    tr = run.trace
    if tr is None or tr.busy_s <= 0 or tr.window_s <= 0:
        return None
    return 1.0 - tr.busy_s / tr.window_s
