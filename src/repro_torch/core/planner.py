"""Algorithm selection -- the paper's 5.10 decision rules as a cost-model planner.

Given a query (or bare (N, T)) and data statistics, choose the backend a
query engine should run and attach an estimated cost.  Statistics come in
two strengths:

  * scalar ``density`` / ``clean_fraction`` kwargs -- the legacy
    index-wide-mean interface, driving the paper's rule thresholds exactly
    as published (kept for direct callers and old tests);
  * a ``stats`` object (``repro_torch.storage.MemberStats``, duck-typed) -- real
    per-column tile statistics of the *member subset* of the query,
    computed once at ``TileStore`` build time.  With it the planner runs a
    words-touched cost model: every candidate backend gets an estimate of
    the uint32 words it moves through the memory system, and the
    tile-skipping backend (``tiled_fused``) is chosen when the words it
    gathers (only dirty tiles) undercut the dense sweep.

Every plan names a *runnable executor*: bare-threshold names resolve
through ``repro_torch.query.executors.run_threshold_backend`` and circuit names
through ``BitmapIndex``'s compiled cache.  The recommendations encode the
paper's conclusions:

  * T == 1 / T == N        -> wide OR / wide AND (paper 2.3)
  * many clean tiles       -> tiled_fused (stats-aware; the RBMRG
                              generalisation) or rbmrg_block (scalar rule)
  * very small T           -> LOOPED
  * T close to N, sparse   -> pruning algorithms (host-side DSK)
  * otherwise              -> SSUM ('if one does not know much about the
                               data ... the adder circuits are safe bets'),
                               as the fused CUDA kernel on the card, as
                               the plain gate program on the CPU

Composite expressions and non-threshold symmetric leaves compile to one
shared circuit ('circuit' / 'fused' / 'tiled_fused'), because the whole
tree costs a single adder pass there -- leaf-at-a-time execution cannot win.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.calibration import get_calibration

__all__ = [
    "Plan",
    "plan_threshold",
    "plan_query",
    "estimate_words_touched",
    "CIRCUIT_BACKENDS",
]

# Backends executed by compiling the (whole) expression into one circuit.
CIRCUIT_BACKENDS = ("circuit", "fused", "tiled_fused")

# tiled execution wins when its gathered words undercut the dense sweep by
# at least this factor (covers the host-side gather/scatter bookkeeping)
_TILED_ADVANTAGE = 0.5

# words-equivalent fixed cost of one device dispatch (trace/launch
# overhead).  The tiled executor collapses per-residual-group launches into
# at most two dispatches per query (one event merge + one block scan), so
# this prices dispatches, not groups -- the per-group cost that remains (a
# branch on the group id, block padding to the group boundary) is priced
# separately by _GROUP_OVERHEAD_WORDS.  The _TILED_ADVANTAGE gate plus the
# group/decode terms keep the planner off tiled in dirty-dominated regimes.
# The constants are kept equal to the reference planner's so that both
# packages choose the same plan for the same statistics.
_LAUNCH_OVERHEAD_WORDS = 256.0

# words-equivalent cost of one residual group riding the single scan:
# its group-id branch and the padding of its tile count to whole blocks.
_GROUP_OVERHEAD_WORDS = 64.0

# the in-kernel decode prologue stages every compressed cell as dense
# words on chip before the residual evaluates, so a compressed gather's
# effective cost is its payload *plus* a slice of the staging work; the
# model inflates the compression ratio by this factor (capped at the
# dense-equivalent -- decode never costs more than having stored dense).
_DECODE_WORDS_FACTOR = 2.0

# the tiled executor specializes at most this many signatures exactly;
# overflow tiles fall back to a dense gather of the full member support,
# and the estimate must price that.  This is the CANONICAL constant --
# storage/tiled imports it, so the cost model and the executor cannot
# diverge on the exact-vs-overflow split.
_MAX_EXACT_SIGNATURES = 64


@dataclasses.dataclass
class Plan:
    algorithm: str
    rationale: str
    cost: float | None = None  # estimated words touched (None: no estimate)
    candidates: tuple = ()  # ((backend, estimated words touched), ...)
    #: calibrated microsecond estimates (``core.calibration``); None / empty
    #: when no calibration is installed or a backend has no constant
    cost_us: float | None = None
    candidates_us: tuple = ()  # ((backend, estimated µs), ...) sorted by µs
    #: "hit" / "miss" when the plan came through the per-store plan memo
    #: (``BitmapIndex.explain``); None for direct planner calls
    memo: str | None = None


def _attach_us(p: Plan) -> Plan:
    """Price the plan and its candidate list in calibrated microseconds
    when a calibration is installed; a no-op otherwise."""
    calib = get_calibration()
    if calib is None:
        return p
    cands = [
        (b, calib.cost_us(b, w))
        for b, w in p.candidates
        if calib.cost_us(b, w) is not None
    ]
    p.candidates_us = tuple(sorted(cands, key=lambda kv: kv[1]))
    p.cost_us = calib.cost_us(p.algorithm, p.cost)
    return p


def estimate_words_touched(
    backend: str,
    n: int,
    t: int | None = None,
    *,
    n_words: int = 1,
    stats=None,
    density: float | None = None,
) -> float | None:
    """Estimated 32-bit words moved through device memory for one execution.

    The unit is words read+written per query; ``n_words = 1`` gives a
    per-output-word figure.  ``stats`` (a ``MemberStats``-shaped object)
    enables the data-dependent estimates; without it those return None.
    The model is deliberately coarse -- it ranks backends, it does not
    predict wall time.
    """
    nw = float(n_words)
    t_known = t is not None  # None: not a bare threshold (composite circuit)
    t = int(t) if t is not None else max(1, n // 2)
    dense = n * nw
    if backend in ("wide_or", "wide_and"):
        return dense + nw
    if backend == "looped":
        # T counter bitmaps updated per input: ~2NT reads+writes
        return 2.0 * n * min(t, n) * nw
    if backend in ("ssum", "treeadd", "srtckt", "csvckt", "circuit"):
        # ~5N gates, every intermediate round-trips through device memory
        return dense + 2 * 5 * dense
    if backend in ("scancount", "scancount_streaming"):
        # 32 counter lanes per word, read+write per chunk pass
        return dense + 64 * nw
    if backend == "fused":
        return dense + nw
    if backend == "tiled_fused":
        if stats is None:
            return None
        n_tiles = max(1, int(nw) // max(1, stats.tile_words))
        # container compression ratio of the member subset: the executor
        # gathers sparse/run tiles as their compressed payloads (or
        # evaluates them event-natively), so the words it moves scale with
        # the stored container sizes, not the dense dirty pack.  1.0 when
        # every container is dense / containers are off -- estimates are
        # monotone in container size and never exceed the dense-pack model.
        compressed = getattr(stats, "compressed_words", 0) or stats.dirty_words
        ratio = compressed / stats.dirty_words if stats.dirty_words else 1.0
        sigs = getattr(stats, "signatures", ())
        if sigs:
            # Per-signature model: a signature launches a residual kernel only
            # when the circuit cannot fold it constant; for a bare threshold
            # that is exactly 0 < T - #ones <= #dirty (RBMRG case 3).  Without
            # a known T, any signature with dirty members may launch.  Launch
            # groups are counted after the executor's structural merge: bare
            # thresholds with equal (T - #ones, #dirty) share one kernel.
            gathered = 0
            groups = set()
            # mirror the executor: only the most populous signatures get
            # exact specialization; overflow tiles skip constant folding
            # and run the dense support residual as one extra group
            exact = sorted(sigs, key=lambda s: -s[0])[:_MAX_EXACT_SIGNATURES]
            overflow_tiles = sum(cnt for cnt, _, _ in sigs) - sum(
                cnt for cnt, _, _ in exact
            )
            for cnt, ones, dirty in exact:
                if t_known:
                    tt = t - ones
                    if tt <= 0 or tt > dirty:
                        continue  # case 1/2: folds constant, no gather
                    groups.add((tt, dirty))
                else:
                    if dirty == 0:
                        continue
                    groups.add(dirty)
                gathered += cnt * dirty * stats.tile_words
            n_groups = len(groups)
            if overflow_tiles:
                # overflow rides the same block scan as every other group;
                # the decode prologue sentinel-fills its clean cells, so
                # only the overflow tiles' dirty cells are gathered
                gathered += (
                    sum(cnt * dirty for cnt, _ones, dirty in sigs)
                    - sum(cnt * dirty for cnt, _ones, dirty in exact)
                ) * stats.tile_words
                n_groups += 1
            # compressed tiles gather less, but the decode prologue stages
            # them back to dense words on chip -- price payload + staging,
            # never more than the dense-equivalent gather
            eff_ratio = min(1.0, ratio * _DECODE_WORDS_FACTOR)
            gathered = gathered * eff_ratio
            # the scan engine dispatches at most twice per query (event
            # merge + block scan), regardless of group count
            launches = min(2, n_groups) if n_groups else 0
            return (
                float(gathered) + nw + n_tiles
                + _LAUNCH_OVERHEAD_WORDS * launches
                + _GROUP_OVERHEAD_WORDS * n_groups
            )
        # no signature stats: gathered (compressed) words + one output pass
        # + per-tile bookkeeping (the legacy coarse estimate)
        return float(compressed) + nw + n_tiles
    if backend == "rbmrg_block":
        if stats is None:
            return None
        return float(stats.dirty_words) + nw + 2 * (nw / max(1, stats.tile_words))
    if backend == "dsk":
        if density is None:
            return None
        # host position lists: ~32 positions per dense word at this density
        return 32.0 * density * dense
    return None


def _candidates(n, t, *, n_words, stats, density):
    names = ("tiled_fused", "fused", "ssum", "looped", "scancount_streaming")
    out = []
    for name in names:
        est = estimate_words_touched(
            name, n, t, n_words=n_words, stats=stats, density=density
        )
        if est is not None:
            out.append((name, est))
    return tuple(sorted(out, key=lambda kv: kv[1]))


def plan_threshold(
    n: int,
    t: int,
    *,
    density: float | None = None,
    clean_fraction: float | None = None,
    on_device: bool = True,
    fused_available: bool = True,
    stats=None,
    n_words: int = 1,
) -> Plan:
    """Pick the executor for theta(T, .) over N bitmaps."""
    if stats is not None:
        n_words = stats.n_words
        if density is None:
            density = stats.density
    cands = _candidates(n, t, n_words=n_words, stats=stats, density=density)

    def plan(alg, why):
        cost = estimate_words_touched(
            alg, n, t, n_words=n_words, stats=stats, density=density
        )
        return _attach_us(Plan(alg, why, cost=cost, candidates=cands))

    if t <= 1:
        return plan("wide_or", "T<=1 is a wide OR (paper 2.3)")
    if t >= n:
        return plan("wide_and", "T=N is a wide AND (paper 2.3)")
    if stats is not None:
        tiled = estimate_words_touched("tiled_fused", n, t, n_words=n_words, stats=stats)
        # compare against the dense memory FLOOR (N reads + 1 write), not the
        # gate-by-gate estimate: skipping must pay off even vs a perfect sweep
        dense = estimate_words_touched("fused", n, t, n_words=n_words)
        if tiled is not None and tiled < _TILED_ADVANTAGE * dense:
            return plan(
                "tiled_fused",
                f"member columns are {stats.clean_fraction:.0%} clean tiles: "
                f"gather ~{int(tiled)} words vs ~{int(dense)} dense "
                "(paper 4.1 skipping, tile-classified store)",
            )
    elif clean_fraction is not None and clean_fraction > 0.5:
        return plan(
            "rbmrg_block",
            f"{clean_fraction:.0%} of tiles are clean runs; run-aware merge "
            "does O(RUNCOUNT log N) work (paper 4.1, 5.10)",
        )
    if n >= 2048:
        return plan(
            "scancount_streaming",
            "N huge: per-(N,T) circuit tabulation is infeasible; streaming "
            "counters keep an O(chunk x r) working set (paper section 6)",
        )
    if not on_device and density is not None and density < 1e-3 and t >= 0.9 * n:
        return plan(
            "dsk",
            "sparse data with T~N: pruning algorithms win on the host (paper 5.8.3)",
        )
    if stats is not None and cands:
        # cost-model path: the plan honors its own candidate ranking (the
        # fused backend is runnable everywhere: the CUDA kernel on the
        # card, the plain gate program on the CPU).
        # tiled_fused stays behind the _TILED_ADVANTAGE gate above -- its
        # estimate omits host gather/scatter bookkeeping, so it must win
        # by a margin, not by a hair.
        eligible = [kv for kv in cands if kv[0] != "tiled_fused"]
        if eligible:
            calib = get_calibration()
            ranked = (
                [(b, calib.cost_us(b, w)) for b, w in eligible]
                if calib is not None
                and all(calib.cost_us(b, w) is not None for b, w in eligible)
                else None
            )
            if ranked is not None:
                # calibrated path: rank by measured µs, not raw words --
                # the per-backend exchange rate is exactly what the words
                # model cannot know (host lists vs fused kernel vs plain ops)
                best, cost_us = min(ranked, key=lambda kv: kv[1])
                return plan(
                    best,
                    f"min-cost candidate: ~{int(cost_us)}us calibrated "
                    f"({calib.device} words->us constants over member tile "
                    "statistics)",
                )
            best, cost = min(eligible, key=lambda kv: kv[1])
            return plan(
                best,
                f"min-cost candidate: ~{int(cost)} words touched "
                "(cost model over member tile statistics)",
            )
    if t <= 3:
        return plan("looped", "T very small: LOOPED is O(NT) ops and wins (paper 5.10)")
    if fused_available:
        return plan("fused", "default: sideways-sum adder, fused kernel (paper 5.10 + ours)")
    return plan("ssum", "default: sideways-sum adder circuit, gate by gate (paper 5.10)")


def _bare_threshold_members(query):
    """If ``query`` is a Threshold over plain columns (or all columns),
    return its member count resolver; else None."""
    from repro_torch.query.expr import Col, Threshold

    if type(query) is not Threshold:
        return None
    if query.over is not None and not all(type(m) is Col for m in query.over):
        return None
    return (lambda n: n) if query.over is None else (lambda n: len(query.over))


def plan_query(
    query,
    n: int,
    *,
    density: float | None = None,
    clean_fraction: float | None = None,
    on_device: bool = True,
    fused_available: bool = True,
    stats=None,
    n_words: int = 1,
) -> Plan:
    """Pick the executor for a query expression over an N-column index."""
    from repro_torch.query.expr import Col, Weighted, as_query

    q = as_query(query)
    if type(q) is Col:
        return _attach_us(Plan(
            "column", "bare column reference: fetch, no compute",
            cost=float(stats.n_words if stats is not None else n_words),
        ))
    members = _bare_threshold_members(q)
    if members is not None:
        return plan_threshold(
            members(n),
            q.t,
            density=density,
            clean_fraction=clean_fraction,
            on_device=on_device,
            fused_available=fused_available,
            stats=stats,
            n_words=n_words,
        )
    backend = "fused" if fused_available else "circuit"
    if stats is not None:
        n_words = stats.n_words
        tiled = estimate_words_touched("tiled_fused", n, None, n_words=n_words, stats=stats)
        dense = estimate_words_touched("fused", n, None, n_words=n_words)
        if tiled is not None and tiled < _TILED_ADVANTAGE * dense:
            return _attach_us(Plan(
                "tiled_fused",
                f"member columns are {stats.clean_fraction:.0%} clean tiles; the "
                "whole compiled circuit gets RBMRG case-skipping per tile "
                "(storage engine generalisation of paper 4.1)",
                cost=tiled,
                candidates=_candidates(n, None, n_words=n_words, stats=stats,
                                       density=density),
            ))
    cost = estimate_words_touched(backend, n, None, n_words=n_words)
    if type(q) is Weighted:
        return _attach_us(Plan(
            backend,
            "weighted threshold: binary weight decomposition circuit "
            "(O(log max_w) adders instead of replication; beyond-paper)",
            cost=cost,
        ))
    return _attach_us(Plan(
        backend,
        "symmetric/composite expression: one compiled circuit, sub-queries "
        "share the sideways-sum adder via CSE (paper 4.4 + query layer)",
        cost=cost,
    ))
