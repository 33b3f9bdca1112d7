"""Clustered sets (Kaser & Lemire, arXiv:1402.4073, 5.3, after Anh & Moffat's
ClusterData): ``card`` distinct rows of ``[0, universe)`` placed by
recursive halving, block by block.  The middle element of a range's budget goes to a value
drawn uniformly among those that leave room for the rest on both sides, and
each half recurses into its side; a range exactly as long as its budget is
filled.  Dense stretches and long gaps follow.

The universe is cut into blocks of ``block_rows`` rows, the size of the
paper's own universe at this density, and each block of each column is a
set of the paper's size drawn independently (the budget spread evenly over
the blocks).  One recursion over the whole scaled universe would make a
column's few top-level cuts decide most of its shape, so columns, and with
them the cost of a query, would differ far more from seed to seed.

:func:`cluster_data` is the recursive algorithm (the yardstick the tests
hold the rewrite to); :func:`generate` is the same recursion one level at a
time over every open range of every column, on the device.

The port's ``data/paper_datasets.py::clustered_set`` splits a range's budget
in proportion to the two sides (a hypergeometric draw), which is how a
uniform subset falls: its sets are uniform, not clustered.  It is not used.
"""
from __future__ import annotations

import numpy as np
import torch

from bench.common import derive_seed, pack_positions


def cluster_data(rng: np.random.Generator, card: int, r: int) -> np.ndarray:
    """Anh & Moffat's ClusterData, recursive: sorted distinct rows of [0, r)."""
    out: list[int] = []

    def fill(lo: int, hi: int, n: int) -> None:  # inclusive [lo, hi], n rows
        if n <= 0:
            return
        if hi - lo + 1 == n:
            out.extend(range(lo, hi + 1))
            return
        m = n // 2
        v = lo + m + int(rng.integers(0, hi - lo - n + 2))
        fill(lo, v - 1, m)
        out.append(v)
        fill(v + 1, hi, n - m - 1)

    fill(0, r - 1, min(card, r))
    return np.asarray(out, dtype=np.int64)


def blocks(n: int, r: int, card: int, block_rows: int, device):
    """The starting ranges: (column, first row, last row, budget) of every
    block of every column, the budget split as evenly as the rows allow."""
    i64 = dict(dtype=torch.int64, device=device)
    nb = (r + block_rows - 1) // block_rows
    first = torch.arange(nb, **i64) * block_rows
    last = torch.clamp(first + block_rows, max=r) - 1
    size = last - first + 1
    # budget proportional to each block's rows (the last may be shorter),
    # the remainder one row each to the first blocks
    base = size * card // r
    extra = card - int(base.sum())
    budget = base + (torch.arange(nb, **i64) < extra).to(torch.int64)
    budget = torch.minimum(budget, size)
    return (torch.arange(n, **i64).repeat_interleave(nb), first.repeat(n), last.repeat(n),
            budget.repeat(n))


def generate(cfg: dict, seed: int, device) -> torch.Tensor:
    """int32 [columns, universe / 32] packed words on ``device``."""
    n, r, card = int(cfg["columns"]), int(cfg["universe"]), min(int(cfg["card"]), int(cfg["universe"]))
    n_words = (r + 31) // 32
    g = torch.Generator(device=device)
    g.manual_seed(derive_seed(seed, "data"))
    i64 = dict(dtype=torch.int64, device=device)
    col, lo, hi, cnt = blocks(n, r, card, int(cfg.get("block_rows", r)), device)
    pts_col, pts = [], []
    while col.numel():
        keep = cnt > 0
        col, lo, hi, cnt = col[keep], lo[keep], hi[keep], cnt[keep]
        full = (hi - lo + 1) == cnt
        if bool(full.any()):
            fl, fh, fc = lo[full], hi[full], col[full]
            lens = fh - fl + 1
            starts = torch.repeat_interleave(fl, lens)
            offs = torch.arange(int(lens.sum()), **i64) - torch.repeat_interleave(
                torch.cumsum(lens, 0) - lens, lens)
            pts.append(starts + offs)
            pts_col.append(torch.repeat_interleave(fc, lens))
            keep = ~full
            col, lo, hi, cnt = col[keep], lo[keep], hi[keep], cnt[keep]
        if not col.numel():
            break
        m = cnt // 2
        choices = hi - lo - cnt + 2
        u = torch.rand(col.numel(), generator=g, dtype=torch.float64, device=device)
        v = lo + m + torch.minimum((u * choices).floor().to(torch.int64), choices - 1)
        pts.append(v)
        pts_col.append(col)
        col = torch.cat([col, col])
        lo, hi = torch.cat([lo, v + 1]), torch.cat([v - 1, hi])
        cnt = torch.cat([m, cnt - m - 1])
    if not pts:
        return torch.zeros(n, n_words, dtype=torch.int32, device=device)
    return pack_positions(torch.cat(pts_col), torch.cat(pts), n, n_words)
