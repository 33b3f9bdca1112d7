"""Snapshot save/load for :class:`~repro_torch.storage.TileStore` indexes.

``save`` serializes the store's *pack surface* -- the same store-wide
per-kind arrays ``TileStore.packs`` assembles for query execution -- so
saving costs one lazy pack assembly plus a sequential write, and loading
costs nothing but an ``np.memmap``: ``load`` hands the mapped sections to
``TileStore.from_arrays``, whose per-column payloads are slices of the
mapped packs.  No word is copied (or even read off disk) until a query
actually gathers it; ``to_device=True`` eagerly uploads the dirty pack to
the store's device instead, for serving-path warm starts.

Legacy all-dense stores (``containers=False``) serialize under the very
same framing -- their sparse/run sections are just empty.  The bytes are
the reference's: a store saved by either package saves again, in either,
to the same file.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from repro_torch.storage import TileStore

from .format import map_sections, read_manifest, schema_digest, write_snapshot

__all__ = ["save", "load", "load_index", "read_manifest", "snapshot_info"]

#: manifest/section layout of one TileStore (order is the on-disk order)
_SECTIONS = (
    "classes", "kinds", "cardinalities",
    "dense_index", "sparse_index", "run_index",
    "dense_pack", "sparse_bounds", "sparse_pack", "run_bounds", "run_pack",
)


def save(obj, path, *, names=None, extra: dict | None = None) -> dict:
    """Write ``obj`` (a TileStore, or anything with ``.store``/``.names``
    like a BitmapIndex) to ``path``.  Returns the manifest."""
    store = obj
    if not isinstance(obj, TileStore):
        store = obj.store
        if names is None:
            names = tuple(obj.names)
    packs = store.packs
    arrays = {
        "classes": store.classes_word,
        "kinds": store.container_kinds,
        "cardinalities": np.asarray(store.cardinalities, np.int64),
        **packs,
    }
    meta = {
        "kind": "tilestore",
        "r": int(store.r),
        "n_words": int(store.n_words),
        "tile_words": int(store.tile_words),
        "n_tiles": int(store.n_tiles),
        "n_columns": int(store.n),
        "containers": bool(store.containers),
        "names": list(names) if names is not None else None,
        "schema_digest": schema_digest(names, store.r, store.tile_words),
    }
    if extra:
        for k in extra:
            if k in meta or k in ("format", "version", "sections"):
                raise ValueError(f"extra manifest key {k!r} is reserved")
        meta.update(extra)
    return write_snapshot(path, [(n, arrays[n]) for n in _SECTIONS], meta)


def load(path, *, device=None, to_device: bool = False, verify: bool = False,
         manifest: dict | None = None) -> TileStore:
    """Reconstruct the TileStore at ``path`` over ``np.memmap`` views.

    The returned store's pack arrays alias the file: host-resident reads
    page lazily through the OS.  ``device`` (default: the CUDA card) is
    where the store's dense view and device packs go on first use;
    ``to_device=True`` uploads the densified dirty pack there right away
    (for compressed stores this materializes the containers first -- they
    are small by construction).  ``verify=True`` checks every section
    crc32 before reconstruction.
    """
    if manifest is None:
        manifest = read_manifest(path)
    if manifest.get("kind") != "tilestore":
        raise ValueError(f"{path}: snapshot holds {manifest.get('kind')!r}, "
                         "not a tilestore")
    sections = map_sections(path, manifest, verify=verify)
    store = TileStore.from_arrays(
        sections,
        tile_words=manifest["tile_words"],
        n_words=manifest["n_words"],
        r=manifest["r"],
        containers=manifest["containers"],
        device=device,
    )
    if to_device:
        store.dirty  # noqa: B018 -- upload + cache the device dirty pack
    return store


def load_index(path, *, device=None, to_device: bool = False,
               verify: bool = False):
    """Reconstruct a :class:`~repro_torch.query.BitmapIndex` on ``device``
    (requires the snapshot to carry column names)."""
    from repro_torch.query import BitmapIndex

    manifest = read_manifest(path)
    names = manifest.get("names")
    if names is None:
        raise ValueError(f"{path}: snapshot has no column names; use load()")
    store = load(path, device=device, to_device=to_device, verify=verify,
                 manifest=manifest)
    return BitmapIndex(names=tuple(names), _store=store)


def snapshot_info(path) -> dict:
    """Manifest + file size, without mapping any section."""
    manifest = read_manifest(path)
    manifest["file_bytes"] = Path(path).stat().st_size
    return manifest
