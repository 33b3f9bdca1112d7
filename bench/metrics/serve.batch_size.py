"""Queries a micro-batch over the traced stretch, from the server's
``executed`` and ``batches`` counters (``QueryServer.info()``)."""


def read(run, prof):
    on, off = run.layer.get("server_on"), run.layer.get("server_off")
    if on is None or off is None or off["batches"] == on["batches"]:
        return None
    return (off["executed"] - on["executed"]) / (off["batches"] - on["batches"])
