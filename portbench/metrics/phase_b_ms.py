"""Device milliseconds a call in the fused scan's phase B
(`ops/fused_scan.py`: `select_blocks`' top-k over the block maxima and
`selected_scales`): the device seconds of the program's "scan.phase_b"
spans (program_span, CUDA events on the scan's stream, taken only while a
profiler runs), averaged over the calls of the profiled sub-window. None
where the program keeps no spans, took no device time (the CPU) or its
ring no longer holds the window's first call."""

from portbench import program_spans

NAME = "scan.phase_b"


def read(run):
    recs = program_spans.records()
    a, b = run.traced
    if recs is None or b <= a:
        return None
    per = program_spans.by_call(run, recs, range(a, b), (NAME,))
    if per is None:
        return None
    secs = [sum(r.device_s for r in c[NAME]) for c in per
            if c[NAME] and all(r.device_s is not None for r in c[NAME])]
    return 1e3 * sum(secs) / len(secs) if secs else None
