"""The only place the harness touches the program (``repro_torch``): specs
become its queries, packed words become its index, and an index becomes a
server or a live index.  A loop reaches these factories as ``run.program``,
so a stand-in module with the same names (``bench/control.py``) replaces
the program under an unchanged loop.  Imported lazily, so the reference and
the generators never load the program."""
from __future__ import annotations


def column_names(n: int) -> tuple:
    return tuple(f"c{i}" for i in range(n))


def to_query(spec: dict, names: tuple):
    from repro_torch.query import AndNot, Col, Interval, Threshold, Weighted

    over = tuple(names[c] for c in spec["members"])
    kind = spec["kind"]
    if kind == "threshold":
        return Threshold(spec["t"], over=over)
    if kind == "interval":
        return Interval(spec["lo"], spec["hi"], over=over)
    if kind == "weighted":
        return Weighted(spec["weights"], spec["t"], over=over)
    if kind == "andnot":
        return AndNot(Threshold(spec["t"], over=over), Col(names[spec["drop"]]))
    raise ValueError(f"unknown query kind {kind!r}")


def build_index(columns, cfg: dict, device):
    """A ``BitmapIndex`` over ``columns`` with its tile store built."""
    from repro_torch.query import BitmapIndex

    idx = BitmapIndex(columns, column_names(columns.shape[0]), r=int(cfg["universe"]),
                      tile_words=int(cfg["tile_words"]), device=device)
    idx.store  # noqa: B018 - the host classification, paid once in set-up
    return idx


def query_server(index, **settings):
    """A started ``QueryServer`` over ``index``."""
    from repro_torch.serve import QueryServer

    return QueryServer(index, **settings).start()


def streaming_index(index):
    """A ``StreamingIndex`` with ``index`` as its base."""
    from repro_torch.stream import StreamingIndex

    return StreamingIndex(index)


def route(index, query) -> str:
    """The algorithm the planner picks for ``query``."""
    return index.explain(query).algorithm


def enable_spans(sink: list) -> None:
    """Turn the program's spans and counters on; every finished root span
    is appended to ``sink``."""
    import repro_torch.obs as obs

    obs.trace.add_root_listener(sink.append)
    obs.enable()


def disable_spans() -> None:
    import repro_torch.obs as obs

    obs.disable()
