"""Host milliseconds a request in the program's ``plan`` spans
(``BitmapIndex.explain``: member statistics, the plan memo, the planner)."""
from bench.tracing import host_ms_per_query


def read(run, prof):
    return host_ms_per_query(run, "plan")
