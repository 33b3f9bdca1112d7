"""The `.bmsnap` on-disk snapshot framing: header, manifest, raw sections.

Layout (all integers little-endian)::

    [ 0..7 ]   magic  b"BMSNAP01"
    [ 8..11]   u32    format version (== 1)
    [12..19]   u64    manifest byte offset (a JSON footer)
    [20..23]   u32    manifest byte length
    [24..27]   u32    crc32 of the manifest bytes
    [28..63]   zeros  (reserved)
    [64.. ]    sections, each start aligned to 64 bytes
    [tail ]    manifest JSON (utf-8, sorted keys, canonical separators)

Every section is one raw little-endian C-order array; the manifest's
``sections`` table records ``name`` / ``dtype`` (numpy ``<u4``-style
codes) / ``shape`` / ``offset`` / ``nbytes`` / ``crc32`` per entry.
Writing the manifest as a footer keeps section offsets independent of
the (variable-length) metadata, so the writer is single-pass and
byte-deterministic -- the golden fixture ``tests/data/golden.bmsnap``
holds the format to that.  The bytes are the reference package's, bit for
bit: a snapshot written by either package loads in the other.

The reader never copies: :func:`map_sections` returns array views over
one ``np.memmap`` of the whole file.  Checksums are therefore verified
only on request (``verify=True``) -- an eager full-file CRC pass would
defeat the lazy-paging point of the mmap load.

This framing is the Roaring portable-serialization idea (PAPERS.md:
arxiv 1709.07821) applied to the tile store: flat versioned arrays that
load without decoding.
"""
from __future__ import annotations

import json
import zlib
from pathlib import Path

import numpy as np

__all__ = [
    "MAGIC",
    "VERSION",
    "FormatError",
    "write_snapshot",
    "read_manifest",
    "map_sections",
    "verify_snapshot",
    "schema_digest",
]

MAGIC = b"BMSNAP01"
VERSION = 1
_ALIGN = 64
_HEADER = 64


class FormatError(ValueError):
    """Raised when a snapshot file fails structural validation."""


def schema_digest(names, r: int, tile_words: int) -> str:
    """Stable digest of the index schema: column names + geometry.

    Two snapshots with equal digests hold the same universe shape and
    column identity -- the WAL-replay compatibility check.
    """
    import hashlib

    payload = json.dumps(
        [list(names) if names is not None else None, int(r), int(tile_words)],
        separators=(",", ":"),
    ).encode()
    return hashlib.sha256(payload).hexdigest()[:16]


def _le(arr: np.ndarray) -> np.ndarray:
    """C-contiguous little-endian view/copy of ``arr``."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype.byteorder == ">":
        arr = arr.astype(arr.dtype.newbyteorder("<"))
    return arr


def write_snapshot(path, sections, meta: dict) -> dict:
    """Write sections (an iterable of ``(name, ndarray)``) + metadata.

    ``meta`` lands in the manifest verbatim (it must be JSON-serializable
    and must not use the reserved keys ``format``/``version``/``sections``).
    Returns the manifest written.  The write goes to ``path + '.tmp'``
    first and is renamed into place, so a crashed save never leaves a
    half-written snapshot under the final name.
    """
    path = Path(path)
    entries = []
    offset = _HEADER
    arrays = []
    for name, arr in sections:
        arr = _le(arr)
        pad = (-offset) % _ALIGN
        offset += pad
        raw = arr.tobytes()
        entries.append({
            "name": name,
            "dtype": arr.dtype.str,
            "shape": list(arr.shape),
            "offset": offset,
            "nbytes": len(raw),
            "crc32": zlib.crc32(raw) & 0xFFFFFFFF,
        })
        arrays.append((pad, raw))
        offset += len(raw)
    manifest = {"format": "bmsnap", "version": VERSION, **meta,
                "sections": entries}
    mbytes = json.dumps(manifest, sort_keys=True,
                        separators=(",", ":")).encode()
    pad_tail = (-offset) % _ALIGN
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        f.write(MAGIC)
        f.write(np.uint32(VERSION).tobytes())
        f.write(np.uint64(offset + pad_tail).tobytes())
        f.write(np.uint32(len(mbytes)).tobytes())
        f.write(np.uint32(zlib.crc32(mbytes) & 0xFFFFFFFF).tobytes())
        f.write(b"\x00" * (_HEADER - f.tell()))
        for pad, raw in arrays:
            f.write(b"\x00" * pad)
            f.write(raw)
        f.write(b"\x00" * pad_tail)
        f.write(mbytes)
        f.flush()
    tmp.replace(path)
    return manifest


def read_manifest(path) -> dict:
    """Parse + validate the header and return the manifest dict."""
    with open(path, "rb") as f:
        head = f.read(_HEADER)
        if len(head) < _HEADER or head[:8] != MAGIC:
            raise FormatError(f"{path}: not a bmsnap file")
        version = int(np.frombuffer(head[8:12], "<u4")[0])
        if version != VERSION:
            raise FormatError(
                f"{path}: format version {version} unsupported (have {VERSION})"
            )
        moff = int(np.frombuffer(head[12:20], "<u8")[0])
        mlen = int(np.frombuffer(head[20:24], "<u4")[0])
        mcrc = int(np.frombuffer(head[24:28], "<u4")[0])
        f.seek(moff)
        mbytes = f.read(mlen)
    if len(mbytes) != mlen or (zlib.crc32(mbytes) & 0xFFFFFFFF) != mcrc:
        raise FormatError(f"{path}: manifest truncated or corrupt")
    manifest = json.loads(mbytes)
    if manifest.get("format") != "bmsnap" or manifest.get("version") != VERSION:
        raise FormatError(f"{path}: manifest/header version mismatch")
    return manifest


def map_sections(path, manifest: dict | None = None, *,
                 verify: bool = False) -> dict:
    """``{name: ndarray}`` views over one ``np.memmap`` of the file.

    Zero-copy: every returned array is a reshaped slice of the mapping
    (read-only).  With ``verify=True`` each section's crc32 is checked --
    which touches every byte, so leave it off for lazy loads.
    """
    if manifest is None:
        manifest = read_manifest(path)
    buf = np.memmap(path, dtype=np.uint8, mode="r")
    out = {}
    for s in manifest["sections"]:
        off, nb = s["offset"], s["nbytes"]
        if off + nb > buf.size:
            raise FormatError(f"{path}: section {s['name']!r} out of bounds")
        raw = buf[off:off + nb]
        if verify and (zlib.crc32(raw.tobytes()) & 0xFFFFFFFF) != s["crc32"]:
            raise FormatError(f"{path}: section {s['name']!r} checksum mismatch")
        out[s["name"]] = raw.view(s["dtype"]).reshape(s["shape"])
    return out


def verify_snapshot(path) -> dict:
    """Full structural + checksum validation; returns the manifest."""
    manifest = read_manifest(path)
    map_sections(path, manifest, verify=True)
    return manifest
