"""The whole call's share of the card's peak, in %: the least time of one
call's work at the published peaks (the driver's `least_call_s`) over the
measured time a call (host clock). That time is read from the run's calls
outside the profiled sub-window (`Run.untraced_call_s`), since the
profiler slows the host's part of each call inside it."""


def read(run):
    t = run.untraced_call_s()
    return 100.0 * run.driver.least_call_s() / t if t else None
