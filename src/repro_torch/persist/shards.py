"""Per-shard snapshot files for `ShardedBitmapIndex`.

A sharded index persists as a directory::

    dir/
      sharded.json        # shard map: names, tile bounds, global geometry
      shard-0000.bmsnap   # one standalone snapshot per tile-range shard
      shard-0001.bmsnap
      ...

Each shard file is a complete, self-describing TileStore snapshot (it
carries its own ``shard`` metadata block), so a device can
:func:`load_shard` ONLY its own file -- the load path never gathers and
never touches another shard's bytes.  :func:`load_sharded` rebuilds the
full index from the shard map exactly the way
``ShardedTileStore.with_shards`` does after compaction: shard stores are
adopted as-is and bounds come straight from the map, no reclassification,
no concatenation.  The files and the map are the reference's bytes: a
directory written by either package loads in the other.
"""
from __future__ import annotations

import json
from pathlib import Path

from . import snapshot

__all__ = ["save_sharded", "load_sharded", "load_shard", "shard_path"]

_MAP = "sharded.json"


def shard_path(dirpath, k: int) -> Path:
    return Path(dirpath) / f"shard-{k:04d}.bmsnap"


def save_sharded(obj, dirpath, *, names=None, extra: dict | None = None) -> dict:
    """Write one ``.bmsnap`` per shard plus the ``sharded.json`` map.

    ``obj`` is a ``ShardedBitmapIndex`` or a ``ShardedTileStore``.
    Returns the shard-map metadata.
    """
    store = obj
    if hasattr(obj, "store"):
        store = obj.store
        if names is None:
            names = tuple(obj.names)
    d = Path(dirpath)
    d.mkdir(parents=True, exist_ok=True)
    n_shards = store.n_shards
    for k, shard in enumerate(store.shards):
        snapshot.save(
            shard, shard_path(d, k), names=names,
            extra={"shard": {
                "id": k,
                "n_shards": n_shards,
                "tile_bounds": list(store.tile_bounds[k]),
                "global_r": int(store.r),
                "global_n_words": int(store.n_words),
            }},
        )
    meta = {
        "kind": "sharded",
        "n_shards": n_shards,
        "names": list(names) if names is not None else None,
        "tile_bounds": [list(b) for b in store.tile_bounds],
        "n_words": int(store.n_words),
        "r": int(store.r),
        "tile_words": int(store.tile_words),
    }
    if extra:
        for key in extra:
            if key in meta:
                raise ValueError(f"extra shard-map key {key!r} is reserved")
        meta.update(extra)
    (d / _MAP).write_text(json.dumps(meta, indent=2, sort_keys=True))
    return meta


def read_shard_map(dirpath) -> dict:
    return json.loads((Path(dirpath) / _MAP).read_text())


def load_shard(dirpath, k: int, *, device=None, to_device: bool = False,
               verify: bool = False):
    """One shard's TileStore (memmap-backed) on ``device`` (default: the
    CUDA card) -- what a single device loads.  Returns ``(store, (t0,
    t1))`` with the shard's global tile bounds."""
    path = shard_path(dirpath, k)
    manifest = snapshot.read_manifest(path)
    store = snapshot.load(path, device=device, to_device=to_device,
                          verify=verify, manifest=manifest)
    return store, tuple(manifest["shard"]["tile_bounds"])


def load_sharded(dirpath, *, device=None, devices=None, to_device: bool = False,
                 verify: bool = False):
    """Rebuild the full ``ShardedBitmapIndex`` from a snapshot directory.

    Every shard store is an independent memmap view over its own file;
    nothing is gathered or reclassified -- the shard map supplies the
    bounds and global geometry directly (mirroring ``with_shards``).
    Shard ``k`` lives on ``devices[k]`` when ``devices`` is given (one per
    shard; the index then takes the shard-map path where it can), else on
    ``device`` (default: the CUDA card).
    """
    from repro_torch.dist.query import ShardedBitmapIndex, ShardedTileStore

    d = Path(dirpath)
    meta = read_shard_map(d)
    n_shards = meta["n_shards"]
    if devices is not None and len(devices) != n_shards:
        raise ValueError(f"{len(devices)} devices for {n_shards} shards")
    shards = tuple(
        snapshot.load(shard_path(d, k),
                      device=devices[k] if devices is not None else device,
                      to_device=to_device, verify=verify)
        for k in range(n_shards)
    )
    store = ShardedTileStore(
        shards, tuple(tuple(b) for b in meta["tile_bounds"]),
        n_words=meta["n_words"], r=meta["r"], devices=devices,
    )
    names = meta["names"]
    if names is None:
        return store
    return ShardedBitmapIndex(store, tuple(names))
