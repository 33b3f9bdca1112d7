"""Readings of the program's own spans (``repro_torch.obs``): host offsets
inside one request's span tree, and the device time of the work launched
inside a span, which the program opens as a profiler range named
``repro.<span name>``.

A reading that finds no such span or range returns None, so a program
without them (or a run without a device) reports nothing.
"""
from __future__ import annotations

import torch

#: the program's range names are this plus the span's name (spelled out, not
#: imported, so that a program without ranges still loads this module)
RANGE_PREFIX = "repro."


def mean_offset_ms(roots, root_name: str, name: str):
    """Host milliseconds from the start of each ``root_name`` root to the
    start of its first ``name`` span, as a mean over the roots that hold
    one (``Span.find`` searches depth first: in start order)."""
    offsets = []
    for root in roots:
        if root.name != root_name:
            continue
        sp = root.find(name)
        if sp is not None:
            offsets.append(sp.t0 - root.t0)
    if not offsets:
        return None
    return 1e3 * sum(offsets) / len(offsets)


def range_device_us(events, name: str):
    """Device microseconds of the operations launched inside the ``repro.<name>``
    ranges of one profiler session's ``events``.

    torch links each device operation, by correlation id, to the innermost
    host operation or range open at its launch (``FunctionEvent.kernels``);
    an operation counts when that host event is the range or lies inside it
    (its ``cpu_parent`` chain).  Where no operation is linked to the range,
    its device-side annotation (``is_user_annotation``) stands in.  None
    when the session saw no device, or no such range."""
    target = RANGE_PREFIX + name
    device = ranged = False
    linked = annotated = 0.0
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CPU:
            device = True
            if getattr(e, "is_user_annotation", False) and e.name == target:
                annotated += e.time_range.end - e.time_range.start
            continue
        if e.name == target:
            ranged = True
        if not e.kernels:
            continue
        p = e
        while p is not None and p.name != target:
            p = p.cpu_parent
        if p is not None:
            linked += sum(k.duration for k in e.kernels)
    if not (device and ranged):
        return None
    return linked if linked > 0 else annotated


def device_ms_per_query(run, name: str):
    """Device milliseconds a traced request in the ``repro.<name>`` ranges."""
    if run.tracer.prof is None or not run.traced:
        return None
    us = range_device_us(run.tracer.prof.events(), name)
    return None if us is None else 1e-3 * us / len(run.traced)
