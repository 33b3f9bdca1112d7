"""Sorted-integer-list T-occurrence baselines (paper 4.3 and the 'w' family).

These are the state-of-the-art competitors the paper benchmarks against
(ScanCount, MergeOpt, MergeSkip, DivideSkip of Li et al. / Sarawagi &
Kirpal) plus the paper's own 'w'-style algorithms (WSORT, HASHCNT, W2CTI).

Heap-based skipping is serial, data-dependent pointer chasing with no
word-parallel form, so these run on the host in NumPy, as in the
reference (``repro.core.listalgos``, of which this is a copy that imports
nothing of it).  ``query.executors`` runs ``dsk`` as the DivideSkip backend
over the position lists of the rows.
"""
from __future__ import annotations

import heapq
from collections import Counter

import numpy as np

__all__ = ["wheap", "wsort", "hashcnt", "w2cti", "mgopt", "wmgsk", "dsk", "scancount_np"]


def scancount_np(lists: list[np.ndarray], t: int, r: int) -> np.ndarray:
    counts = np.zeros(r, dtype=np.int32)
    for l in lists:
        counts[l] += 1
    return np.nonzero(counts >= t)[0]


def wsort(lists: list[np.ndarray], t: int, r: int) -> np.ndarray:
    """Concatenate, sort, emit values repeated >= T times (paper 4.2.1)."""
    if not lists:
        return np.empty(0, dtype=np.int64)
    allv = np.sort(np.concatenate(lists))
    vals, cnt = np.unique(allv, return_counts=True)
    return vals[cnt >= t]


def hashcnt(lists: list[np.ndarray], t: int, r: int) -> np.ndarray:
    c: Counter = Counter()
    for l in lists:
        c.update(l.tolist())
    return np.array(sorted(v for v, k in c.items() if k >= t), dtype=np.int64)


def wheap(lists: list[np.ndarray], t: int, r: int) -> np.ndarray:
    """N-way heap merge counting duplicates (Sarawagi & Kirpal)."""
    heap = [(int(l[0]), i, 0) for i, l in enumerate(lists) if len(l)]
    heapq.heapify(heap)
    out = []
    cur, cnt = None, 0
    while heap:
        v, i, j = heapq.heappop(heap)
        if v == cur:
            cnt += 1
        else:
            if cur is not None and cnt >= t:
                out.append(cur)
            cur, cnt = v, 1
        if j + 1 < len(lists[i]):
            heapq.heappush(heap, (int(lists[i][j + 1]), i, j + 1))
    if cur is not None and cnt >= t:
        out.append(cur)
    return np.array(out, dtype=np.int64)


def w2cti(lists: list[np.ndarray], t: int, r: int) -> np.ndarray:
    """Mergeable value+counter arrays with pruning during the merge (4.2.2)."""
    order = sorted(range(len(lists)), key=lambda i: len(lists[i]))
    n = len(lists)
    acc_v = lists[order[0]].astype(np.int64)
    acc_c = np.ones_like(acc_v)
    for step, idx in enumerate(order[1:], start=1):
        remaining = n - step - 1  # inputs left after this merge
        nv = lists[idx].astype(np.int64)
        merged_v = np.union1d(acc_v, nv)
        c = np.zeros_like(merged_v)
        c[np.searchsorted(merged_v, acc_v)] += acc_c
        c[np.searchsorted(merged_v, nv)] += 1
        # prune during merge: drop items that cannot reach T
        keep = c + remaining >= t
        acc_v, acc_c = merged_v[keep], c[keep]
    return acc_v[acc_c >= t]


def _find_geq(lst: np.ndarray, pos: int, val: int) -> int:
    """Doubling (galloping) search for the first index with lst[i] >= val."""
    n = len(lst)
    if pos >= n or lst[pos] >= val:
        return pos
    step = 1
    lo = pos
    while pos + step < n and lst[pos + step] < val:
        lo = pos + step
        step *= 2
    return int(np.searchsorted(lst[lo : min(n, pos + step) + 1], val) + lo)


def mgopt(lists: list[np.ndarray], t: int, r: int) -> np.ndarray:
    """MergeOpt (Sarawagi & Kirpal): set aside the T-1 largest lists."""
    return _divide(lists, t, n_long=t - 1)


def dsk(lists: list[np.ndarray], t: int, r: int, mu: float = 0.05) -> np.ndarray:
    """DivideSkip (Li et al.): L largest set aside, L = T/(mu log2 M + 1)."""
    if t <= 1:
        return wheap(lists, t, r)
    m = max(max((len(l) for l in lists), default=2), 2)
    n_long = int(t / (mu * np.log2(m) + 1))
    n_long = min(max(n_long, 0), t - 1)
    return _divide(lists, t, n_long=n_long)


def _divide(lists: list[np.ndarray], t: int, n_long: int) -> np.ndarray:
    order = sorted(range(len(lists)), key=lambda i: -len(lists[i]))
    long_ids = order[:n_long]
    short_ids = order[n_long:]
    longs = [lists[i] for i in long_ids]
    shorts = [lists[i] for i in short_ids]
    need = t - n_long  # occurrences that must come from the short lists
    # heap-merge the short lists, keep items occurring >= max(1, need - ...)
    cand = wheap(shorts, max(1, need), 10**18) if shorts else np.empty(0, np.int64)
    # recount candidate occurrences in short lists (wheap returned >=max(1,need))
    out = []
    pos = [0] * len(longs)
    for v in cand:
        cnt = 0
        for s in shorts:
            j = np.searchsorted(s, v)
            if j < len(s) and s[j] == v:
                cnt += 1
        for li, l in enumerate(longs):
            pos[li] = _find_geq(l, pos[li], int(v))
            if pos[li] < len(l) and l[pos[li]] == v:
                cnt += 1
        if cnt >= t:
            out.append(int(v))
    return np.array(out, dtype=np.int64)


def wmgsk(lists: list[np.ndarray], t: int, r: int) -> np.ndarray:
    """MergeSkip (Li et al.): pop T-1 extra items and gallop past them."""
    heap = [(int(l[0]), i, 0) for i, l in enumerate(lists) if len(l)]
    heapq.heapify(heap)
    out = []
    while heap:
        v = heap[0][0]
        same = []
        while heap and heap[0][0] == v:
            same.append(heapq.heappop(heap))
        if len(same) >= t:
            out.append(v)
            for _, i, j in same:
                if j + 1 < len(lists[i]):
                    heapq.heappush(heap, (int(lists[i][j + 1]), i, j + 1))
        else:
            # pop T-1-|same| additional smallest items; all skip to the new top
            extra = []
            while heap and len(same) + len(extra) < t - 1:
                extra.append(heapq.heappop(heap))
            nxt = heap[0][0] if heap else None
            for _, i, j in same + extra:
                if nxt is None:
                    continue
                jj = _find_geq(lists[i], j, nxt)
                if jj < len(lists[i]):
                    heapq.heappush(heap, (int(lists[i][jj]), i, jj))
    return np.array(out, dtype=np.int64)
