"""Host milliseconds from the start of a request's ``execute`` span to the
start of its first ``launch`` span (K1's launch): the host time in which
the request has put nothing on the card, as a mean over the traced
requests that launch K1."""
from bench.spans import mean_offset_ms


def read(run, prof):
    return mean_offset_ms(run.tracer.spans, "execute", "launch")
