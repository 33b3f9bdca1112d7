"""Share of the traced stretch in which no operation ran on the device."""


def read(run, prof):
    if prof is None or prof["device_intervals"] == 0 or prof["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
