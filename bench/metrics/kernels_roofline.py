"""Share of the least time the traced requests need at the H100's HBM3
bandwidth (``bench/roofline.py``: the columns each reads, best compressed,
and its result), in the device's busy time over the traced stretch."""
from bench import roofline, templates


def read(run, prof):
    if prof is None or prof["busy_s"] <= 0 or not run.traced:
        return None
    per_col = roofline.tile_bytes(run.ref_columns(), int(run.cfg["tile_words"])).sum(1).tolist()
    need = sum(roofline.query_bytes(templates.columns_read(s), per_col, run.n_words)
               for s in run.traced)
    return 100.0 * need / roofline.PEAK_BYTES_PER_S / prof["busy_s"]
