"""Milliseconds a call in the program's `embed_queries` phase
(`utils/profiling.phase` in `pipeline.dbsearch`: the Foldclass forward of
the call's queries, ending in their embeddings in host memory), over the
window."""


def read(run):
    sec, calls = run.phases.get("embed_queries", (0.0, 0))
    return sec / calls * 1e3 if calls else None
