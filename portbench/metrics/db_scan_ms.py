"""Milliseconds a call in the program's `db_scan` phase
(`utils/profiling.phase` in `pipeline.dbsearch`: `SearchEngine.search`,
ending in the top-k in host memory), over the window."""


def read(run):
    sec, calls = run.phases.get("db_scan", (0.0, 0))
    return sec / calls * 1e3 if calls else None
