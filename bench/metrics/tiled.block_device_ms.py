"""Device milliseconds a request of the tiled route's block kernel (K2):
the operations launched inside the program's ``repro.block`` ranges
(``tiled_scan.block_runner``), over the traced requests."""
from bench.spans import device_ms_per_query


def read(run, prof):
    return device_ms_per_query(run, "block")
