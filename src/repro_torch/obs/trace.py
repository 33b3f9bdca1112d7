"""Per-query trace spans.

A span tree covers one request end to end: plan (memo hit/miss,
candidates, predicted words/us), compile (circuit-cache hit/miss),
dispatch (engine, launches, tiles by case), decode (words gathered by
container kind).  Every span carries *predicted* cost attributes next
to *measured* wall time and words, so predicted-vs-realised drift is a
first-class queryable quantity rather than something reconstructed from
logs.

Spans parent through a contextvar, so instrumented layers never thread
a span argument through call signatures -- ``span("compile")`` inside a
running ``span("execute")`` nests automatically, including across the
serving front-end's batcher thread (each thread/context gets its own
stack).  When tracing is disabled, ``span()`` returns a shared no-op
singleton: one branch, zero allocation.
"""
from __future__ import annotations

import time
from contextvars import ContextVar

enabled = False  # toggled by repro_torch.obs.enable()/disable()

_CURRENT: ContextVar["Span | None"] = ContextVar("repro_obs_span", default=None)
_ROOT_LISTENERS: list = []


class Span:
    __slots__ = ("name", "attrs", "children", "t0", "wall_s", "_token")

    def __init__(self, name: str, attrs: dict | None = None) -> None:
        self.name = name
        self.attrs = dict(attrs) if attrs else {}
        self.children: list[Span] = []
        self.t0 = 0.0
        self.wall_s = 0.0
        self._token = None

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        parent = _CURRENT.get()
        if parent is not None:
            parent.children.append(self)
        self._token = _CURRENT.set(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.wall_s = time.perf_counter() - self.t0
        _CURRENT.reset(self._token)
        if _CURRENT.get() is None:
            for fn in _ROOT_LISTENERS:
                fn(self)

    def find(self, name: str) -> "Span | None":
        """Depth-first search for the first descendant span named *name*."""
        for c in self.children:
            if c.name == name:
                return c
            hit = c.find(name)
            if hit is not None:
                return hit
        return None

    def iter(self):
        yield self
        for c in self.children:
            yield from c.iter()

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "wall_us": self.wall_s * 1e6,
            "attrs": dict(self.attrs),
            "children": [c.to_dict() for c in self.children],
        }

    def format(self, indent: int = 0) -> str:
        """Human-readable span tree (quickstart/docs surface)."""
        pad = "  " * indent
        attrs = " ".join(f"{k}={v}" for k, v in self.attrs.items())
        lines = [f"{pad}{self.name} [{self.wall_s * 1e6:.0f}us] {attrs}".rstrip()]
        for c in self.children:
            lines.append(c.format(indent + 1))
        return "\n".join(lines)


class _NullSpan:
    """Disabled-mode span: every operation is a no-op on a singleton."""

    __slots__ = ()
    attrs: dict = {}
    children: list = []
    wall_s = 0.0
    name = ""

    def set(self, **attrs) -> "_NullSpan":
        return self

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass

    def find(self, name: str):
        return None

    def to_dict(self) -> dict:
        return {}


NULL_SPAN = _NullSpan()


def span(name: str, **attrs):
    """Open a span (context manager).  No-op singleton when disabled."""
    if not enabled:
        return NULL_SPAN
    return Span(name, attrs)


def current_span():
    """The innermost open span in this context (NULL_SPAN when none/off)."""
    if not enabled:
        return NULL_SPAN
    return _CURRENT.get() or NULL_SPAN


def add_root_listener(fn) -> None:
    """Call *fn(root_span)* whenever a root span completes."""
    if fn not in _ROOT_LISTENERS:
        _ROOT_LISTENERS.append(fn)


def merge_span_trees(name: str, roots: list) -> Span:
    """Fold per-shard span trees under one synthetic parent (dist path)."""
    out = Span(name)
    out.children = [r for r in roots if isinstance(r, Span)]
    out.wall_s = max((r.wall_s for r in out.children), default=0.0)
    return out
