"""Compactions of the live index over the traced stretch
(``delta_stats()["compactions"]``, end minus start)."""


def read(run, prof):
    on, off = run.layer.get("compactions_on"), run.layer.get("compactions_off")
    if on is None or off is None:
        return None
    return off - on
