"""Append-only write-ahead log of `StreamingIndex` mutation batches.

File layout: an 8-byte magic + u32 format version header, then records::

    u32 payload_len | u32 crc32(payload) | payload

    payload := u8 kind | u64 version | body
      kind 1 UPDATE      body: u64 m | i32 cols[m] | i64 pos[m] | u8 on[m]
      kind 2 APPEND      body: u64 n | u64 k | packbits(bool[n, k])
      kind 3 MATERIALIZE body: utf-8 JSON {"name":..., "query": <obj>}

Versions are monotone across the log's whole lifetime (they survive
checkpoint rotation), so "replay everything after snapshot version V" is
a single comparison per record.  Each record is guarded by its own
crc32 and length prefix: a crash mid-append leaves a short or corrupt
tail that :meth:`WriteAheadLog.scan` detects, and opening for append
truncates the file back to the last valid record -- replay never
surfaces a partial batch.

Queries are persisted via :func:`query_to_obj` / :func:`query_from_obj`,
a JSON codec over the frozen ``repro_torch.query.expr`` dataclasses (the
tree structure is the serialization; ``Query.key()`` is not invertible).
Records are the reference's byte for byte: a log written by either
package replays in the other.
"""
from __future__ import annotations

import json
import struct
import time as _time
import zlib
from pathlib import Path

import numpy as np

from repro_torch.obs import REGISTRY as _OBS_REGISTRY

# WAL durability accounting (no-ops until ``repro_torch.obs.enable()``): append
# latency is the write+flush(+fsync) critical path every mutation batch
# sits on before it applies.
_WAL_APPENDS = _OBS_REGISTRY.counter(
    "repro_wal_appends_total", "WAL records appended", ("fsync",),
)
_WAL_BYTES = _OBS_REGISTRY.counter(
    "repro_wal_bytes_total", "WAL bytes written (payload + framing)",
)
_WAL_APPEND_S = _OBS_REGISTRY.histogram(
    "repro_wal_append_seconds", "WAL append latency (write+flush+fsync)",
    ("fsync",),
)

__all__ = [
    "WriteAheadLog",
    "WalError",
    "UPDATE",
    "APPEND",
    "MATERIALIZE",
    "query_to_obj",
    "query_from_obj",
]

WAL_MAGIC = b"BMWAL001"
WAL_VERSION = 1
_HEADER = 12  # magic + u32 version

UPDATE, APPEND, MATERIALIZE = 1, 2, 3


class WalError(ValueError):
    """Raised on structural WAL corruption (not a truncated tail)."""


# -- query (de)serialization ------------------------------------------------

def query_to_obj(q):
    """JSON-serializable tree for one ``repro_torch.query.expr.Query``."""
    from repro_torch.query import expr as E

    def over(o):
        return None if o is None else [query_to_obj(m) for m in o]

    t = type(q)
    if t is E.Col:
        return {"op": "col", "name": q.name}
    if t is E.Threshold:
        return {"op": "threshold", "t": q.t, "over": over(q.over)}
    if t is E.Interval:
        return {"op": "interval", "lo": q.lo, "hi": q.hi, "over": over(q.over)}
    if t is E.Exactly:
        return {"op": "exactly", "k": q.k, "over": over(q.over)}
    if t is E.Parity:
        return {"op": "parity", "over": over(q.over)}
    if t is E.Majority:
        return {"op": "majority", "over": over(q.over)}
    if t is E.Sym:
        return {"op": "sym", "table": list(q.table), "over": over(q.over)}
    if t is E.Weighted:
        return {"op": "weighted", "weights": list(q.weights), "t": q.t,
                "over": over(q.over)}
    if t is E.And:
        return {"op": "and", "children": [query_to_obj(c) for c in q.children]}
    if t is E.Or:
        return {"op": "or", "children": [query_to_obj(c) for c in q.children]}
    if t is E.Not:
        return {"op": "not", "child": query_to_obj(q.child)}
    if t is E.AndNot:
        return {"op": "andnot", "keep": query_to_obj(q.keep),
                "drop": query_to_obj(q.drop)}
    raise TypeError(f"cannot serialize query node {t.__name__}")


def query_from_obj(obj):
    """Inverse of :func:`query_to_obj`."""
    from repro_torch.query import expr as E

    def over(o):
        return None if o is None else tuple(query_from_obj(m) for m in o)

    op = obj["op"]
    if op == "col":
        return E.Col(obj["name"])
    if op == "threshold":
        return E.Threshold(obj["t"], over=over(obj["over"]))
    if op == "interval":
        return E.Interval(obj["lo"], obj["hi"], over=over(obj["over"]))
    if op == "exactly":
        return E.Exactly(obj["k"], over=over(obj["over"]))
    if op == "parity":
        return E.Parity(over=over(obj["over"]))
    if op == "majority":
        return E.Majority(over=over(obj["over"]))
    if op == "sym":
        return E.Sym(tuple(obj["table"]), over=over(obj["over"]))
    if op == "weighted":
        return E.Weighted(tuple(obj["weights"]), obj["t"],
                          over=over(obj["over"]))
    if op == "and":
        return E.And(*[query_from_obj(c) for c in obj["children"]])
    if op == "or":
        return E.Or(*[query_from_obj(c) for c in obj["children"]])
    if op == "not":
        return E.Not(query_from_obj(obj["child"]))
    if op == "andnot":
        return E.AndNot(query_from_obj(obj["keep"]), query_from_obj(obj["drop"]))
    raise WalError(f"unknown query op {op!r}")


# -- the log ----------------------------------------------------------------

class WriteAheadLog:
    """One append-only log file (conventionally ``wal.bmwal``).

    Opening scans existing records, truncates any invalid tail (the
    crash case) and positions the writer after the last valid record;
    ``last_version`` resumes from there.  ``append_*`` methods flush to
    the OS on every record; pass ``fsync=True`` for full durability at
    the cost of one fsync per append.
    """

    def __init__(self, path, *, fsync: bool = False):
        self.path = Path(path)
        self.fsync = bool(fsync)
        if not self.path.exists() or self.path.stat().st_size < _HEADER:
            with open(self.path, "wb") as f:
                f.write(WAL_MAGIC)
                f.write(np.uint32(WAL_VERSION).tobytes())
        valid_end, last_version, n = self.scan()
        if self.path.stat().st_size > valid_end:
            with open(self.path, "r+b") as f:
                f.truncate(valid_end)
        self.last_version = last_version
        self.records = n
        self._f = open(self.path, "ab")

    # -- scanning / replay -------------------------------------------------
    def scan(self) -> tuple:
        """(valid_end_offset, last_version, n_records) -- read-only pass
        that stops at the first truncated or corrupt record."""
        size = self.path.stat().st_size
        with open(self.path, "rb") as f:
            head = f.read(_HEADER)
            if head[:8] != WAL_MAGIC:
                raise WalError(f"{self.path}: not a bmwal file")
            if int(np.frombuffer(head[8:12], "<u4")[0]) != WAL_VERSION:
                raise WalError(f"{self.path}: unsupported WAL version")
            end, version, n = _HEADER, 0, 0
            while True:
                hdr = f.read(8)
                if len(hdr) < 8:
                    break
                plen, crc = struct.unpack("<II", hdr)
                if end + 8 + plen > size:
                    break  # truncated tail
                payload = f.read(plen)
                if len(payload) < plen or (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
                    break  # corrupt tail
                v = struct.unpack("<Q", payload[1:9])[0]
                if v <= version:
                    break  # version went backwards: treat as tail damage
                version, n = v, n + 1
                end = f.tell()
        return end, version, n

    def replay(self, after_version: int = 0):
        """Yield decoded records with ``version > after_version`` as dicts.
        Stops cleanly at the first invalid record (crash tail)."""
        size = self.path.stat().st_size
        with open(self.path, "rb") as f:
            f.seek(_HEADER)
            while True:
                hdr = f.read(8)
                if len(hdr) < 8:
                    return
                plen, crc = struct.unpack("<II", hdr)
                if f.tell() + plen > size:
                    return
                payload = f.read(plen)
                if len(payload) < plen or (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
                    return
                rec = self._decode(payload)
                if rec["version"] > after_version:
                    yield rec

    @staticmethod
    def _decode(payload: bytes) -> dict:
        kind = payload[0]
        version = struct.unpack("<Q", payload[1:9])[0]
        body = payload[9:]
        if kind == UPDATE:
            (m,) = struct.unpack("<Q", body[:8])
            o = 8
            cols = np.frombuffer(body, "<i4", m, o)
            o += 4 * m
            pos = np.frombuffer(body, "<i8", m, o)
            o += 8 * m
            on = np.frombuffer(body, "<u1", m, o).astype(bool)
            return {"kind": UPDATE, "version": version,
                    "cols": cols.astype(np.int64), "pos": pos.copy(), "on": on}
        if kind == APPEND:
            n, k = struct.unpack("<QQ", body[:16])
            packed = np.frombuffer(body, np.uint8, -1, 16)
            bits = np.unpackbits(packed, count=n * k, bitorder="little")
            return {"kind": APPEND, "version": version,
                    "bits": bits.reshape(int(n), int(k)).astype(bool)}
        if kind == MATERIALIZE:
            obj = json.loads(body.decode())
            return {"kind": MATERIALIZE, "version": version,
                    "name": obj["name"], "query": query_from_obj(obj["query"])}
        raise WalError(f"unknown WAL record kind {kind}")

    # -- appends -----------------------------------------------------------
    def _append(self, kind: int, body: bytes) -> int:
        _OBS = _OBS_REGISTRY
        t0 = _time.perf_counter() if _OBS.enabled else 0.0
        self.last_version += 1
        payload = struct.pack("<BQ", kind, self.last_version) + body
        self._f.write(struct.pack(
            "<II", len(payload), zlib.crc32(payload) & 0xFFFFFFFF
        ))
        self._f.write(payload)
        self._f.flush()
        if self.fsync:
            import os

            os.fsync(self._f.fileno())
        self.records += 1
        if _OBS.enabled:
            _WAL_APPENDS.inc(1, fsync=self.fsync)
            _WAL_BYTES.inc(len(payload) + 8)
            _WAL_APPEND_S.observe(
                _time.perf_counter() - t0, fsync=self.fsync
            )
        return self.last_version

    def append_update(self, cols, pos, on) -> int:
        cols = np.ascontiguousarray(cols, "<i4")
        pos = np.ascontiguousarray(pos, "<i8")
        on = np.ascontiguousarray(np.asarray(on, bool), "<u1")
        if not (cols.size == pos.size == on.size):
            raise ValueError("cols/pos/on must align")
        body = struct.pack("<Q", cols.size) + cols.tobytes() + pos.tobytes() \
            + on.tobytes()
        return self._append(UPDATE, body)

    def append_rows(self, bits) -> int:
        bits = np.ascontiguousarray(np.asarray(bits, bool))
        n, k = bits.shape
        body = struct.pack("<QQ", n, k) + np.packbits(
            bits.reshape(-1), bitorder="little"
        ).tobytes()
        return self._append(APPEND, body)

    def append_materialize(self, name: str, query) -> int:
        body = json.dumps(
            {"name": name, "query": query_to_obj(query)},
            sort_keys=True, separators=(",", ":"),
        ).encode()
        return self._append(MATERIALIZE, body)

    # -- lifecycle ---------------------------------------------------------
    def rotate(self) -> None:
        """Drop every logged record (they are folded into a snapshot) but
        keep the version counter monotone."""
        self._f.close()
        with open(self.path, "wb") as f:
            f.write(WAL_MAGIC)
            f.write(np.uint32(WAL_VERSION).tobytes())
        self.records = 0
        self._f = open(self.path, "ab")

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
