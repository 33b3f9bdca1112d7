"""Device milliseconds a request of the tiled route's event stage: the
operations launched inside the program's ``repro.events`` ranges
(``tiled_scan.event_runner``), over the traced requests."""
from bench.spans import device_ms_per_query


def read(run, prof):
    return device_ms_per_query(run, "events")
