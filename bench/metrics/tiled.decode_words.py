"""Container words the tiled route decodes a request (``ExecInfo``
``decode_words``, carried on the program's ``decode`` spans)."""
from bench.tracing import spans_named


def read(run, prof):
    spans = spans_named(run.tracer.spans, "decode")
    if not spans or not run.traced:
        return None
    return sum(int(s.attrs.get("decode_words") or 0) for s in spans) / len(run.traced)
