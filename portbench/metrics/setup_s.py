"""Seconds from the benchmark's start to the first timed call: the
program's import, the kernels' build or load, the inputs made from the
seed, the system built over them and its warm-up (host clock)."""


def read(run):
    return run.setup_s
