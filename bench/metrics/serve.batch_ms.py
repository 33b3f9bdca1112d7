"""Mean wall milliseconds of the server's ``serve_batch`` spans: one
bucket's ``execute_many`` and the device synchronise after it."""
from bench.tracing import spans_named


def read(run, prof):
    spans = spans_named(run.tracer.spans, "serve_batch")
    if not spans:
        return None
    return 1e3 * sum(s.wall_s for s in spans) / len(spans)
