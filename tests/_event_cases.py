"""Synthetic event-stage plans for the event kernel and its plain version.

Each case builds the host arrays ``storage/tiled.py`` builds (toggle keys
sorted by ``(row, pos)``, one wire each, a group per row, stacked LUTs, the
(output, row) -> buffer-row map) from a numpy generator, and hands them to
``tiled_scan.make_event_stage`` on the device asked for.  It imports no JAX,
so the same cases run on the card (kernel against plain version) and on the
CPU (plain version against the reference).
"""
import zlib

import numpy as np
import torch

from repro_torch.kernels import tiled_scan as TK


def build_case(rng, rows, tw, groups, device, *, k=None):
    """An event stage and its constant base.

    ``rows``: per event row, ``(group, [(wire, pos), ...])``;
    ``groups``: per group ``(m, k_g)``, its wires and outputs.  Output j of a
    row's group goes to a drawn live output of the ``k`` buffer outputs and a
    drawn tile of ``n_sel = len(rows) + 2``.  Returns ``(stage, base)`` with
    ``base`` uint32[k, n_sel] of tile constants (0 or all ones)."""
    n_rows = len(rows)
    m_max = max(m for m, _k in groups)
    k_max = max(kg for _m, kg in groups)
    k = k_max + 1 if k is None else k
    mm = 1 << m_max
    n_sel = n_rows + 2
    stride = tw * 32 + 2
    lut = np.zeros((len(groups), k_max, mm), np.uint8)
    for g, (m, kg) in enumerate(groups):
        lut[g, :kg, : 1 << m] = rng.integers(0, 2, (kg, 1 << m))
    live = [np.sort(rng.choice(k, kg, replace=False)) for _m, kg in groups]
    tiles = rng.permutation(n_sel)[:n_rows]
    keys, wires, gid_row, out_src, out_dst = [], [], [], [], []
    for r, (g, toggles) in enumerate(rows):
        m, kg = groups[g]
        gid_row.append(g)
        for w, p in toggles:
            assert 0 <= w < m and 0 <= p <= tw * 32
            keys.append(r * stride + p)
            wires.append(w)
        for j in range(kg):
            out_src.append(j * n_rows + r)
            out_dst.append(int(live[g][j]) * n_sel + int(tiles[r]))
    keys = np.asarray(keys, np.int64)
    wires = np.asarray(wires, np.int64)
    order = np.argsort(keys, kind="stable")
    st = TK.make_event_stage(
        keys[order], wires[order], np.asarray(gid_row, np.int64), lut,
        np.asarray(out_src, np.int64), np.asarray(out_dst, np.int64),
        k_max=k_max, mm=mm, n_wires=m_max, tw=tw,
        counted_toggles=TK.next_pow2(keys.size), device=device,
    )
    base = np.where(rng.random((k, n_sel)) < 0.3, 0xFFFFFFFF, 0).astype(np.uint32)
    return st, base


def random_rows(rng, n_rows, tw, groups, per_wire):
    """Rows of drawn groups, each wire of a row toggled at ``per_wire``
    drawn positions of ``[0, tw * 32]`` (repeats included: they cancel)."""
    rows = []
    for _ in range(n_rows):
        g = int(rng.integers(0, len(groups)))
        m = groups[g][0]
        toggles = [(w, int(p)) for w in range(m)
                   for p in rng.integers(0, tw * 32 + 1, int(rng.integers(0, per_wire + 1)))]
        rows.append((g, toggles))
    return rows


def _edges(rng, device):
    tw = 8
    span = tw * 32
    rows = [
        (0, [(0, 3), (1, 3)]),                   # equal positions, two wires
        (0, []),                                 # a row with no toggles
        (0, [(0, 5), (0, 5), (1, 9), (0, 40)]),  # one wire twice: they cancel
        (0, [(1, 31), (0, 32), (1, 63), (0, 64), (1, span - 1), (0, span)]),  # word edges
        (0, [(0, span), (1, span), (0, 0)]),     # the dropped column and bit 0
        (0, [(0, 7), (1, 7), (0, 7), (1, 7)]),   # a run that cancels whole
    ]
    return build_case(rng, rows, tw, [(2, 2)], device)


def _many_toggles(rng, device):
    # one tile with eight full sparse columns (every position, and the one
    # after it), beside short rows: far more toggles than a block's threads
    tw = 64
    full = [(w, p) for w in range(8) for q in range(tw * 32) for p in (q, q + 1)]
    rows = [(0, full)] + random_rows(rng, 5, tw, [(8, 1)], 3)
    return build_case(rng, rows, tw, [(8, 1)], device)


def _wires(m):
    def case(rng, device):
        groups = [(m, 1)]
        return build_case(rng, random_rows(rng, 40, 8, groups, 6), 8, groups, device)
    return case


def _groups(rng, device):
    # G > 1 groups of different widths and outputs, k_max > 1
    groups = [(2, 1), (5, 3), (8, 2)]
    return build_case(rng, random_rows(rng, 60, 8, groups, 5), 8, groups, device)


def _wide_lut(rng, device):
    # twelve wires and two outputs: the LUT rows exceed what a block stages
    groups = [(12, 2), (3, 1)]
    return build_case(rng, random_rows(rng, 30, 4, groups, 3), 4, groups, device)


def _wide_tiles(rng, device):
    # 1,536-word tiles with nine outputs: a row's outputs span two blocks
    groups = [(3, 9)]
    return build_case(rng, random_rows(rng, 6, 1536, groups, 200), 1536, groups, device)


CASES = {
    "edges": _edges,
    "many_toggles": _many_toggles,
    **{f"wires_{m}": _wires(m) for m in range(1, 9)},
    "groups": _groups,
    "wide_lut": _wide_lut,
    "wide_tiles": _wide_tiles,
}


def event_case(name, device, seed=0):
    """``(stage, base)`` of case ``name`` on ``device``."""
    return CASES[name](np.random.default_rng([seed, zlib.crc32(name.encode())]), device)


def base_buffer(base, tw, device):
    """The stage's output buffer int32[k, n_sel, tw], seeded with ``base``."""
    words = torch.from_numpy(base.view(np.int32)).to(device)
    return words[:, :, None].expand(*base.shape, tw).contiguous()
