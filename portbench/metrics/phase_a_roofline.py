"""Phase A's share of its roofline, in %: the least time of phase A's work
on the cell's shapes (the driver's `phase_a_work`: bytes and operations at
the published peaks, peaks.py) over phase A's device time a call in the
profiled sub-window. Phase A is the device operations named below."""

from portbench.peaks import bound_s

KERNELS = ("blockmax_kernel",)


def read(run):
    tr = run.trace
    work = getattr(run.driver, "phase_a_work", None)
    if tr is None or not tr.calls or work is None:
        return None
    t = tr.op_seconds(KERNELS) / tr.calls
    if t <= 0:
        return None
    return 100.0 * bound_s(*work()) / t
