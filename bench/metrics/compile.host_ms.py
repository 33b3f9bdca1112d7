"""Host milliseconds a request in the program's ``compile`` spans, which
open only when the compiled-circuit cache misses."""
from bench.tracing import host_ms_per_query


def read(run, prof):
    return host_ms_per_query(run, "compile")
