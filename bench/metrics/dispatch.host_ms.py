"""Host milliseconds a request in the program's ``dispatch`` spans
(``run_plan``: the enqueue of the kernels, not their device time)."""
from bench.tracing import host_ms_per_query


def read(run, prof):
    return host_ms_per_query(run, "dispatch")
