"""Tiled circuit execution: RBMRG clean/dirty skipping for ANY compiled query.

This generalises the paper's 3-case split to arbitrary compiled circuits
(``Interval`` / ``Exactly`` / ``And`` / ``Or`` compositions, multi-output
batched queries), using :meth:`Circuit.specialize`:

  1. group tiles by their *class signature* -- the tuple of per-column
     classes (all-zero / all-one / dirty) restricted to the circuit's
     support.  Tiles with the same signature need the same residual work;
  2. partially evaluate the circuit per signature.  Outputs that fold to
     constants are the case-1/case-2 tiles: written directly, zero bit
     work, zero device-memory traffic;
  3. signatures whose residuals fold to the same function are merged into
     one residual *group*, capping the signature explosion.

Case-3 execution then runs on one of two engines:

  * ``engine="scan"`` (default) -- at most two device dispatches per query
    (:mod:`repro_torch.kernels.tiled_scan`): the event stage for tiles
    whose residual inputs are all compressed, and ONE launch of the
    hand-written block kernel for everything else, which decodes the
    containers from the store's device packs into shared memory and runs
    each block's residual program.  The ``[k, n_tiles, tile_words]`` result
    is assembled on the device.

  * ``engine="merge"`` -- the host event-merge path: per-group gathers +
    one launch of the circuit kernel (``run_circuit_cached``) per residual
    group, host numpy ``evaluate_event_tiles`` for all-compressed tiles.
    This is the oracle the scan engine is held against.

The host plan builder is numpy, as in the reference, and its result is
cached per store.  Results equal the reference's bit for bit, and so does
every ``ExecInfo`` field.
"""
from __future__ import annotations

import os
from collections import OrderedDict

import numpy as np
import torch

from repro_torch.core.circuits import (
    CONST0,
    CONST1,
    _EXACT_CONST_MAX_INPUTS,
    _truth_table_masks,
    Circuit,
)
from repro_torch.core.planner import _MAX_EXACT_SIGNATURES as _MAX_SIGNATURES
from repro_torch.device import WORD_DTYPE, to_numpy_u32, to_words
from repro_torch.obs import trace as _trace

from .containers import (
    CONT_DENSE,
    CONT_RUN,
    CONT_SPARSE,
    CONTAINER_CROSSOVER,
    concat_ranges,
    evaluate_event_tiles,
    truth_table_bits,
)
from .tilestore import TILE_ONE, TILE_ZERO, TileStore, _signature_counts

__all__ = ["run_tiled_circuit"]

# residual-circuit memo: (circuit structural key, signature bytes) -> result
# of Circuit.specialize.  Signatures recur heavily (clean-dominated data has
# a handful), so this makes per-query specialisation O(#distinct signatures).
_SPECIALIZE_MEMO: OrderedDict[tuple, tuple] = OrderedDict()
_SPECIALIZE_MEMO_CAP = 4096

# per-store LRU of prepared scan plans (device plan arrays), keyed by
# (circuit, tile selection)
_SCAN_PLAN_CACHE_CAP = 64

# device event-merge cap on residual inputs: the stacked truth-table LUT
# strides at 2**m bytes per (group, output), so residuals wider than this
# take the block stage instead
_EV_MAX_INPUTS = 12


def _residual_key(res: Circuit):
    """Merge key for residual circuits: the exact truth table when the
    support is small (two residuals compute the same function iff their
    tables match), else the gate-order-independent Merkle key."""
    if res.n_inputs <= _EXACT_CONST_MAX_INPUTS:
        masks, zeros, ones = _truth_table_masks(res.n_inputs)
        return (res.n_inputs, tuple(res.evaluate(masks, zeros, ones)))
    return res.semantic_key()


def _specialize(circuit: Circuit, ckey: tuple, sig_bytes: bytes, assign: dict):
    """Memoised ``circuit.specialize`` + residual merge key (LRU-evicted).

    Returns (const_outputs, residual, kept_inputs, residual_key|None).
    """
    key = (ckey, sig_bytes)
    got = _SPECIALIZE_MEMO.get(key)
    if got is not None:
        _SPECIALIZE_MEMO.move_to_end(key)
        return got
    if len(_SPECIALIZE_MEMO) >= _SPECIALIZE_MEMO_CAP:
        _SPECIALIZE_MEMO.popitem(last=False)
    const, res, kept = circuit.specialize(assign)
    got = (const, res, kept, None if res is None else _residual_key(res))
    _SPECIALIZE_MEMO[key] = got
    return got


def _resolve_engine(store, engine: str | None) -> str:
    """Pick the case-3 execution engine for ``store``: the scan engine needs
    the store's pack surface (``device_packs``); ``REPRO_TILED_ENGINE``
    overrides, as in the reference."""
    if engine is None:
        engine = os.environ.get("REPRO_TILED_ENGINE") or None
    if engine is None:
        engine = (
            "scan"
            if (
                not getattr(store, "paged", False)
                and hasattr(store, "device_packs")
                and getattr(store, "container_kinds", None) is not None
            )
            else "merge"
        )
    if engine not in ("scan", "merge"):
        raise ValueError(f"unknown tiled engine {engine!r}")
    return engine


def _result(buf: torch.Tensor, k: int, nw: int, restricted: bool) -> torch.Tensor:
    """The caller's view of a ``[k, n_sel, tw]`` result buffer."""
    if restricted:
        return buf  # [k, n_sel, tw], caller patches per tile
    out = buf.reshape(k, -1)[:, :nw]
    return out[0] if k == 1 else out


def run_tiled_circuit(
    store: TileStore,
    circuit: Circuit,
    *,
    block_words: int | None = None,
    tiles=None,
    engine: str | None = None,
):
    """Evaluate ``circuit`` over the store's columns with tile skipping.

    Returns ``(out, info)``: ``out`` is int32[n_words] for a single-output
    circuit, int32[k, n_words] otherwise, on the store's device; ``info``
    reports the realised 3-case split and the words actually gathered.
    ``info["launches"]`` counts device dispatches -- at most two on the
    scan engine, one per residual group on the merge engine.

    ``tiles`` restricts evaluation (and its signature specialisation /
    launch merging) to a subset of tile indices; ``out`` is then
    int32[k, len(tiles), tile_words] (per selected tile, no tail clipping).

    ``engine`` selects the case-3 strategy (``"scan"`` / ``"merge"``,
    default auto -- see :func:`_resolve_engine`).  ``block_words`` is
    accepted for parity with the reference and passed to the circuit
    kernel's wrapper, which does not use it.
    """
    from repro_torch.kernels.threshold_ssum import circuit_structural_key
    from repro_torch.query.execinfo import make_exec_info

    if circuit.n_inputs != store.n:
        raise ValueError(f"circuit has {circuit.n_inputs} inputs, store {store.n} columns")
    k = len(circuit.outputs)
    tw, n_tiles, nw = store.tile_words, store.n_tiles, store.n_words
    support = circuit.support()
    ckey = circuit_structural_key(circuit)
    engine = _resolve_engine(store, engine)
    scan = engine == "scan"

    restricted = tiles is not None
    sel = None
    if restricted:
        sel = np.asarray(tiles, dtype=np.int64)
        if sel.ndim != 1 or (sel.size and not
                             ((0 <= sel) & (sel < n_tiles)).all()):
            raise ValueError(f"tiles must be 1-D indices in [0, {n_tiles})")
    n_sel = int(sel.size) if restricted else n_tiles

    if scan:
        # the scan plan is a pure function of (store, circuit, tiles); the
        # store is immutable, so repeat queries replay the cached plan
        pkey = (ckey, sel.tobytes() if restricted else None)
        cache = store.__dict__.setdefault("_scan_plan_cache", OrderedDict())
        hit = cache.get(pkey)
        if hit is not None:
            cache.move_to_end(pkey)
            plan, tmpl = hit
            return _execute_scan_plan(
                plan, {**tmpl, "words_by_kind": dict(tmpl["words_by_kind"])}
            )
    else:
        cache = pkey = None

    # per-tile constant fill values
    base_vals = np.zeros((k, n_sel), dtype=np.uint32)
    info = make_exec_info(
        "tiled_fused",
        n_tiles=n_tiles,
        selected_tiles=n_sel,
        n_outputs=k,
        engine=engine,
        total_words=int(store.n * nw),
    )

    def _finish_host(out):
        info["work_fraction"] = info["dirty_words_gathered"] / max(
            1, info["total_words"]
        )
        # roofline traffic term: gathered input words + written output words
        info["words_touched"] = info["dirty_words_gathered"] + k * nw
        return _result(to_words(out, store.device), k, nw, restricted), info

    if not support:
        # constant circuit: no data touched at all
        const, _res, _kept = circuit.specialize({})
        for j, cval in enumerate(const):
            base_vals[j] = 0xFFFFFFFF if cval else 0
        info["const_tiles"] = n_sel
        return _finish_host(np.repeat(base_vals[:, :, None], tw, axis=2))

    # word-level signature per tile over the support (RUN counts as dirty).
    # Under a tile restriction, "tile" arrays below index positions within
    # ``sel`` (the output buffer); ``sel`` maps them back to store tile ids.
    cls = store.classes_word[support]  # [s, n_tiles], ZERO/ONE/DIRTY
    if restricted:
        cls = cls[:, sel]
    sigs, inverse = _signature_counts(cls, return_inverse=True)
    info["signatures"] = int(sigs.shape[0])

    # most-populous signatures get exact specialisation; overflow tiles run
    # the dense support circuit (correct, just less skipping)
    counts = np.bincount(inverse, minlength=sigs.shape[0])
    order = np.argsort(-counts)
    exact = set(order[:_MAX_SIGNATURES].tolist())
    # the tiles of every signature in ascending order, from one stable sort
    # (the reference scans all tiles once per signature: O(sigs x tiles))
    by_sig = np.argsort(inverse, kind="stable")
    sig_end = np.cumsum(counts)

    # Pass 1: specialize per signature, record the constant-folded tiles,
    # and bucket the residual work by the residual's merge key.
    overflow_tiles: list = []
    merged: dict[tuple, list] = {}  # (residual key, live outputs) -> work
    for s_id in range(sigs.shape[0]):
        tiles = by_sig[sig_end[s_id] - counts[s_id]:sig_end[s_id]]
        if s_id not in exact:
            overflow_tiles.append(tiles)
            continue
        sig = sigs[s_id]
        assign = {i: CONST0 for i in range(store.n) if i not in support}
        for j, col in enumerate(support):
            if sig[j] == TILE_ZERO:
                assign[col] = CONST0
            elif sig[j] == TILE_ONE:
                assign[col] = CONST1
        const, res, kept, rkey = _specialize(circuit, ckey, sig.tobytes(), assign)
        for j, cval in enumerate(const):
            if cval is not None:
                base_vals[j, tiles] = 0xFFFFFFFF if cval else 0
        if res is None:
            info["const_tiles"] += int(tiles.size)
            continue
        info["case3_tiles"] += int(tiles.size)
        info["residual_signatures"] += 1
        live = tuple(j for j, cval in enumerate(const) if cval is None)
        merged.setdefault((rkey, live), [res, []])[1].append((tiles, kept))

    # the overflow residual folds only the non-support inputs; its tiles may
    # feed clean cells into kept wires (the decode stage / dense gather
    # fills those from class metadata).  On the scan engine it rides the
    # same single dispatch as every other group.
    if overflow_tiles:
        otiles = np.concatenate(overflow_tiles)
        assign = {i: CONST0 for i in range(store.n) if i not in support}
        const, res, kept, rkey = _specialize(circuit, ckey, b"dense", assign)
        for j, cval in enumerate(const):
            if cval is not None:
                base_vals[j, otiles] = 0xFFFFFFFF if cval else 0
        if res is None:
            info["const_tiles"] += int(otiles.size)
        else:
            info["case3_tiles"] += int(otiles.size)
            live = tuple(j for j, cval in enumerate(const) if cval is None)
            if scan:
                merged.setdefault((rkey, live), [res, []])[1].append(
                    (otiles, kept)
                )
            else:
                merged[("__overflow__", live)] = [
                    res, [(otiles, kept)], "overflow",
                ]

    if scan:
        return _run_scan_pass(
            store, merged, base_vals, info, sel, restricted,
            k, tw, nw, n_sel, cache, pkey,
        )
    return _run_merge_pass(
        store, merged, base_vals, info, sel, restricted,
        k, tw, n_sel, block_words, _finish_host,
    )


# ---------------------------------------------------------------------------
# scan engine: at most two dispatches via repro_torch.kernels.tiled_scan
# ---------------------------------------------------------------------------


def _execute_scan_plan(plan, info):
    """Dispatch a (possibly cached) scan plan: broadcast the constant base,
    run the staged dispatches (an ``events`` and a ``block`` span each),
    clip the padded tail."""
    from repro_torch.kernels import tiled_scan

    k, n_sel, tw, nw = plan["k"], plan["n_sel"], plan["tw"], plan["nw"]
    buf = plan["base"][:, :, None].expand(k, n_sel, tw).contiguous()
    if plan["event"] is not None:
        with _trace.span("events"):
            tiled_scan.event_runner(buf, plan["event"])
    if plan["block"] is not None:
        with _trace.span("block"):
            tiled_scan.block_runner(buf, plan["block"])
    return _result(buf, k, nw, plan["restricted"]), info


def cell_descriptors(store, wg: np.ndarray, tg: np.ndarray) -> np.ndarray:
    """Block-stage descriptors ``(kind, a, b)`` of the cells (column ``wg``,
    tile ``tg``), int64[..., 3]: dense cells name their row of the
    sentinel-extended dense pack, clean cells the zeros (``D``) or ones
    (``D + 1``) sentinel row, sparse and run cells their payload range
    ``[a, b)`` in the sparse / run pack (``kernels.tiled_scan.CELL_*``)."""
    from repro_torch.kernels import tiled_scan as ts

    packs = store.packs
    s_bounds, r_bounds = packs["sparse_bounds"], packs["run_bounds"]
    D = packs["dense_pack"].shape[0]
    kc = store.container_kinds[wg, tg]
    one = store.classes_word[wg, tg] == TILE_ONE
    sp, rn, dn = kc == CONT_SPARSE, kc == CONT_RUN, kc == CONT_DENSE
    si, ri = packs["sparse_index"][wg, tg], packs["run_index"][wg, tg]
    kind = np.select([dn, sp, rn, one], [ts.CELL_DENSE, ts.CELL_SPARSE, ts.CELL_RUN, ts.CELL_ONE],
                     ts.CELL_ZERO)
    a = np.select([dn, sp, rn, one],
                  [packs["dense_index"][wg, tg], s_bounds[si], r_bounds[ri], D + 1], D)
    b = np.select([sp, rn], [s_bounds[si + 1], r_bounds[ri + 1]], 0)
    return np.stack([kind, a, b], axis=-1)


def _run_scan_pass(store, merged, base_vals, info, sel, restricted,
                   k, tw, nw, n_sel, cache, pkey):
    from repro_torch.kernels import tiled_scan

    dev = store.device
    ck = store.container_kinds
    swc = store.storage_words_cell
    packs = store.packs
    s_index, s_bounds = packs["sparse_index"], packs["sparse_bounds"]
    r_index, r_bounds = packs["run_index"], packs["run_bounds"]
    D = int(store.device_packs()[0].shape[0]) - 2  # zeros sentinel row; ones = D + 1
    pow2 = tiled_scan.next_pow2

    # flatten merged groups; each group = one residual evaluator
    groups = []  # [res, live, tables|None, [(out_tiles, store_tiles, kcols)]]
    for (rkey, live), work in merged.items():
        res, entries = work[0], work[1]
        tables = (
            rkey[1]
            if isinstance(rkey, tuple) and res.n_inputs <= _EXACT_CONST_MAX_INPUTS
            else None
        )
        ents = [
            (t, sel[t] if restricted else t, np.asarray(kept, np.int64))
            for t, kept in entries
        ]
        groups.append([res, live, tables, ents])

    # ---- split each group's tiles: device event merge vs block decode ----
    stride = tw * 32 + 2
    n_ev = 0
    for g in groups:
        res, live, tables, ents = g
        m = res.n_inputs
        masks = []
        for _ot, stiles, kcols in ents:
            if tables is None or m > _EV_MAX_INPUTS or stiles.size == 0:
                masks.append(np.zeros(stiles.size, bool))
                continue
            kc = ck[kcols[:, None], stiles[None, :]]
            comp = (kc == CONT_SPARSE) | (kc == CONT_RUN)
            cw = swc[kcols[:, None], stiles[None, :]].sum(axis=0)
            masks.append(
                comp.all(axis=0) & (cw <= CONTAINER_CROSSOVER * m * tw)
            )
        g.append(masks)
        n_ev += sum(int(mk.sum()) for mk in masks)
    if n_ev and (pow2(n_ev) + 2) * stride >= 2**31:
        # the reference's int32 sort keys bound the event set (same split
        # kept here so the accounting matches): beyond it, block decode
        for g in groups:
            g[4] = [np.zeros_like(mk) for mk in g[4]]
        n_ev = 0

    plan = {
        "base": to_words(base_vals, dev), "event": None, "block": None,
        "k": k, "n_sel": n_sel, "tw": tw, "nw": nw, "restricted": restricted,
    }

    # ---- event stage: one dispatch for every all-compressed tile ---------
    if n_ev:
        s_pack = packs["sparse_pack"]
        r_pack = packs["run_pack"]
        pos_parts, row_parts, wire_parts = [], [], []
        gid_parts, out_parts = [], []
        ev_groups = []  # (m, tables, live)
        row0 = 0
        for res, live, tables, ents, masks in groups:
            m = res.n_inputs
            if not any(mk.any() for mk in masks):
                continue
            gidx = len(ev_groups)
            ev_groups.append((m, tables, live))
            for (otiles, stiles, kcols), mk in zip(ents, masks):
                if not mk.any():
                    continue
                et, ot = stiles[mk], otiles[mk]
                ne = int(et.size)
                rows = np.arange(row0, row0 + ne, dtype=np.int64)
                kc = ck[kcols[:, None], et[None, :]]  # [m, ne]
                wg = np.broadcast_to(kcols[:, None], kc.shape)
                tg = np.broadcast_to(et[None, :], kc.shape)
                rg = np.broadcast_to(rows[None, :], kc.shape)
                wireg = np.broadcast_to(
                    np.arange(m, dtype=np.int64)[:, None], kc.shape
                )
                for kind, idx_t, bnd, pack in (
                    (CONT_SPARSE, s_index, s_bounds, s_pack),
                    (CONT_RUN, r_index, r_bounds, r_pack),
                ):
                    cm = kc == kind
                    if not cm.any():
                        continue
                    s = idx_t[wg[cm], tg[cm]]
                    cnt = bnd[s + 1] - bnd[s]
                    take = concat_ranges(bnd[s], bnd[s + 1])
                    rowv = np.repeat(rg[cm], cnt)
                    wirev = np.repeat(wireg[cm], cnt)
                    if kind == CONT_SPARSE:
                        pp = pack[take].astype(np.int64)
                        pos_parts.append(np.concatenate([pp, pp + 1]))
                    else:
                        # [e, 2] intervals -> all starts, then all ends
                        pos_parts.append(
                            pack[take].astype(np.int64).T.reshape(-1)
                        )
                    row_parts.append(np.concatenate([rowv, rowv]))
                    wire_parts.append(np.concatenate([wirev, wirev]))
                sw_ev = swc[kcols[:, None], et[None, :]]
                ew = int(sw_ev.sum())
                info["compressed_words_gathered"] += ew
                info["dirty_words_gathered"] += ew
                for kind, name in ((CONT_SPARSE, "sparse"), (CONT_RUN, "run")):
                    info["words_by_kind"][name] += int(sw_ev[kc == kind].sum())
                info["event_tiles"] += ne
                gid_parts.append(np.full(ne, gidx, np.int64))
                out_parts.append((live, rows, ot))
                row0 += ne

        G = len(ev_groups)
        m_max_ev = max(m for m, _t, _l in ev_groups)
        mm = 1 << m_max_ev
        k_max_ev = max(len(l) for _m, _t, l in ev_groups)
        lut = np.zeros((G, k_max_ev, mm), np.uint8)
        for gi, (m, tables, _live) in enumerate(ev_groups):
            for j, tt in enumerate(tables):
                lut[gi, j, : 1 << m] = truth_table_bits(tt, m)
        n_rows = row0
        out_src, out_dst = [], []
        for live, rows, ot in out_parts:
            for j, oj in enumerate(live):
                out_src.append(j * n_rows + rows)
                out_dst.append(oj * n_sel + ot)

        # toggle merge order is pure store data: sort once here (host,
        # cached with the plan) so the device never sorts
        pos = np.concatenate(pos_parts)
        row = np.concatenate(row_parts)
        wire = np.concatenate(wire_parts)
        keys = row * stride + pos
        order = np.argsort(keys, kind="stable")
        plan["event"] = tiled_scan.EventStage(
            keys=torch.from_numpy(keys[order]).to(dev),
            mask=torch.from_numpy((1 << wire[order]).astype(np.int32)).to(dev),
            gid_row=torch.from_numpy(np.concatenate(gid_parts)).to(dev),
            lut=torch.from_numpy(lut.reshape(-1)).to(dev),
            out_src=torch.from_numpy(np.concatenate(out_src)).to(dev),
            out_dst=torch.from_numpy(np.concatenate(out_dst).astype(np.int64)).to(dev),
            k_max=k_max_ev, mm=mm, n_wires=m_max_ev, tw=tw,
            counted_toggles=tiled_scan.next_pow2(keys.size),  # the reference pads to pow2
        )
        info["launches"] += 1

    # ---- block stage: one dispatch for everything that needs dense work --
    bgroups = []  # (res, live, wg, tg, out_tiles)
    for res, live, _tables, ents, masks in groups:
        m = res.n_inputs
        wgs, tgs, ots = [], [], []
        for (otiles, stiles, kcols), mk in zip(ents, masks):
            dm = ~mk
            if not dm.any():
                continue
            dt = stiles[dm]
            wgs.append(np.broadcast_to(kcols[:, None], (m, dt.size)))
            tgs.append(np.broadcast_to(dt[None, :], (m, dt.size)))
            ots.append(otiles[dm])
        if ots:
            bgroups.append((
                res, live,
                np.concatenate(wgs, axis=1),
                np.concatenate(tgs, axis=1),
                np.concatenate(ots),
            ))

    if bgroups:
        circuits = tuple(b[0] for b in bgroups)
        m_max = max(c.n_inputs for c in circuits)
        k_max = max(len(b[1]) for b in bgroups)
        table = tiled_scan.program_table(circuits, k_max)
        B = tiled_scan.pick_tile_block(
            tw, table, max(b[4].size for b in bgroups)
        )
        gids_p, cells_p, dst_p = [], [], []
        for gidx, (res, live, wg, tg, ot) in enumerate(bgroups):
            m = res.n_inputs
            ng = int(ot.size)
            nb_g = -(-ng // B)
            kc = ck[wg, tg]  # [m, ng]
            cells = np.zeros((m_max, nb_g * B, 3), np.int64)
            cells[:, :, 1] = D  # padding cells: zeros
            cells[:m, :ng] = cell_descriptors(store, wg, tg)
            cells_p.append(cells.reshape(m_max, nb_g, B, 3).transpose(1, 0, 2, 3))
            tpos = np.arange(ng)
            dst_g = np.full((nb_g, k_max, B), -1, np.int64)
            for j, oj in enumerate(live):
                dst_g[tpos // B, j, tpos % B] = oj * n_sel + ot
            dst_p.append(dst_g)
            gids_p.append(np.full(nb_g, gidx, np.int32))
            sw_cells = swc[wg, tg]
            info["dirty_words_gathered"] += int(sw_cells.sum())
            for kind_c, name in (
                (CONT_DENSE, "dense"), (CONT_SPARSE, "sparse"),
                (CONT_RUN, "run"),
            ):
                kw = int(sw_cells[kc == kind_c].sum())
                info["words_by_kind"][name] += kw
                if kind_c != CONT_DENSE:
                    info["compressed_words_gathered"] += kw
            info["densified_tiles"] += ng
            info["decode_words"] += m * ng * tw

        plan["block"] = tiled_scan.make_block_stage(
            table, np.concatenate(gids_p), np.concatenate(cells_p),
            np.concatenate(dst_p), store.device_packs(), B, tw,
            counted_decode_words=tiled_scan.reference_decode_words(
                tw, m_max, k_max, [b[4].size for b in bgroups]
            ),
        )
        info["launches"] += 1

    info["work_fraction"] = info["dirty_words_gathered"] / max(
        1, info["total_words"]
    )
    info["words_touched"] = info["dirty_words_gathered"] + k * nw
    cache[pkey] = (plan, {**info, "words_by_kind": dict(info["words_by_kind"])})
    while len(cache) > _SCAN_PLAN_CACHE_CAP:
        cache.popitem(last=False)
    return _execute_scan_plan(plan, info)


# ---------------------------------------------------------------------------
# merge engine: host event merge + one circuit-kernel launch per group
# ---------------------------------------------------------------------------


def _dense_cells(store, kcols: np.ndarray, dt: np.ndarray) -> torch.Tensor:
    """Dense words of cells (kcols x dt) read from the store's dense view on
    its device, words past ``n_words`` zero: int32[m, nd * tw]."""
    tw, nw = store.tile_words, store.n_words
    dev = store.device
    widx = torch.from_numpy(dt[:, None] * tw + np.arange(tw)[None, :]).to(dev).view(-1)
    inb = widx < nw
    rows = store.densify()[torch.from_numpy(kcols).to(dev)]
    cells = rows[:, widx.clamp(max=nw - 1)]
    return torch.where(inb[None, :], cells, 0)


def _run_merge_pass(store, merged, base_vals, info, sel, restricted,
                    k, tw, n_sel, block_words, _finish_host):
    from repro_torch.kernels.threshold_ssum import run_circuit_cached

    out = np.repeat(base_vals[:, :, None], tw, axis=2)

    # Per merged group, split its case-3 tiles by representation.  Tiles
    # whose residual inputs are ALL compressed containers -- and whose
    # compressed payload undercuts the dense gather by the crossover -- are
    # evaluated container-natively on the host against the residual's exact
    # truth table; the rest densify per tile into one gather + one kernel
    # launch per group.
    container_native = getattr(store, "container_kinds", None) is not None
    ck = store.container_kinds if container_native else None
    swc = store.storage_words_cell if container_native else None
    # with no compressed tile anywhere the device gather of the densified
    # dirty pack is byte-identical and keeps the working set on the device;
    # paged stores (persist.tiers) must never trigger that whole-pack
    # upload: their point is touching only the gathered tiles
    all_dense = not getattr(store, "paged", False) and (
        not container_native or not (ck > CONT_DENSE).any()
    )
    for (rkey, live), work in merged.items():
        res, entries = work[0], work[1]
        overflow = len(work) > 2
        m = res.n_inputs
        tables = (
            rkey[1]
            if not overflow
            and container_native
            and m <= _EXACT_CONST_MAX_INPUTS
            else None
        )
        ev_rows, ev_pos, ev_wires = [], [], []
        ev_out_tiles: list = []
        dense_out_tiles: list = []
        dense_gathers: list = []  # device int32[m, nd * tw] or host index rows
        n_ev = 0
        for tiles, kept in entries:
            stiles = sel[tiles] if restricted else tiles
            kcols = np.asarray(kept, np.int64)
            if tables is not None:
                kinds_cell = ck[kcols[:, None], stiles[None, :]]
                comp = (kinds_cell == CONT_SPARSE) | (kinds_cell == CONT_RUN)
                cwords = swc[kcols[:, None], stiles[None, :]].sum(axis=0)
                ev_mask = comp.all(axis=0) & (
                    cwords <= CONTAINER_CROSSOVER * m * tw
                )
            else:
                ev_mask = np.zeros(tiles.size, bool)
            if ev_mask.any():
                et = stiles[ev_mask]
                ne = int(et.size)
                cell, pos = store.gather_events(
                    np.repeat(kcols, ne), np.tile(et, m)
                )
                ev_rows.append(n_ev + cell % ne)
                ev_pos.append(pos)
                ev_wires.append(cell // ne)
                ev_out_tiles.append(tiles[ev_mask])
                n_ev += ne
                sw_ev = swc[kcols[:, None], et[None, :]]
                ew = int(sw_ev.sum())
                info["compressed_words_gathered"] += ew
                info["dirty_words_gathered"] += ew
                kc_ev = kinds_cell[:, ev_mask]
                for kind, name in ((CONT_SPARSE, "sparse"), (CONT_RUN, "run")):
                    info["words_by_kind"][name] += int(
                        sw_ev[kc_ev == kind].sum()
                    )
            dmask = ~ev_mask
            if dmask.any():
                dt = stiles[dmask]
                nd = int(dt.size)
                # residual input order follows each signature's kept-column
                # order, so tiles from different signatures feed the same
                # kernel wires
                if overflow:
                    # dense fallback: full support rows for these tiles
                    dense_gathers.append(_dense_cells(store, kcols, dt))
                    # every overflow cell reads dense-expanded words
                    info["words_by_kind"]["dense"] += m * nd * tw
                elif all_dense:
                    # device path: rows of the densified dirty pack
                    dense_gathers.append(store.dirty_index[kept][:, dt])
                    info["words_by_kind"]["dense"] += m * nd * tw
                else:
                    cells = store.gather_cells(
                        np.repeat(kcols, nd), np.tile(dt, m)
                    )
                    if swc is not None:
                        sw_dt = swc[kcols[:, None], dt[None, :]]
                        kc_dt = ck[kcols[:, None], dt[None, :]]
                        for kind, name in (
                            (CONT_DENSE, "dense"),
                            (CONT_SPARSE, "sparse"),
                            (CONT_RUN, "run"),
                        ):
                            kw = int(sw_dt[kc_dt == kind].sum())
                            info["words_by_kind"][name] += kw
                            if kind != CONT_DENSE:
                                info["compressed_words_gathered"] += kw
                    else:
                        info["words_by_kind"]["dense"] += m * nd * tw
                    dense_gathers.append(
                        to_words(cells.reshape(m, nd * tw), store.device)
                    )
                dense_out_tiles.append(tiles[dmask])
        if n_ev:
            got = evaluate_event_tiles(
                np.concatenate(ev_rows),
                np.concatenate(ev_pos),
                np.concatenate(ev_wires),
                n_ev,
                tw,
                tables,
                m,
            )
            etiles = np.concatenate(ev_out_tiles)
            out[np.asarray(live)[:, None], etiles[None, :]] = got
            info["event_tiles"] += n_ev
        if dense_gathers:
            tiles = np.concatenate(dense_out_tiles)
            if all_dense and not overflow:
                rows = np.concatenate(dense_gathers, axis=1)  # [m, nd]
                idx = torch.from_numpy(rows.reshape(-1)).to(store.device)
                gathered = store.dirty[idx].reshape(m, -1)
            else:
                gathered = torch.cat(dense_gathers, dim=1)
            info["dirty_words_gathered"] += int(gathered.numel())
            info["densified_tiles"] += int(tiles.size)
            info["launches"] += 1
            got = run_circuit_cached(gathered, res, block_words=block_words)
            got = to_numpy_u32(got.to(WORD_DTYPE))
            if got.ndim == 1:
                got = got[None]
            out[np.asarray(live)[:, None], tiles[None, :]] = got.reshape(
                len(live), tiles.size, tw
            )

    return _finish_host(out)
