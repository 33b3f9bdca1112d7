"""``repro_torch.obs`` against the reference's ``repro.obs``.

The cases of ``tests/test_obs.py`` that need no server and no sharding,
run on the port's index (``device="cpu"``), plus parity: the span trees of
the port's and the reference's index for the same queries are equal in
names and in every attribute that is not a time (once the port's own
spans -- ``program``, ``launch``, ``events``, ``block`` -- are folded out),
and so are the kernel counter deltas of a tiled query and the exported
metric families.  The port's spans are also profiler ranges, checked here
under a CPU ``torch.profiler`` session.
"""
from __future__ import annotations

import json

import numpy as np
import pytest

import repro.obs as robs
import repro_torch.obs as obs
from _torch_port import PORT_ONLY_FAMILIES, PORT_ONLY_SPANS, TILE_BITS, reference_view, u32
from repro import query as RQ
from repro_torch import query as TQ
from repro_torch.convert import index_from_reference_arrays
from repro_torch.core.bitmaps import unpack
from repro_torch.core.threshold import ALGORITHMS
from repro_torch.obs import trace
from repro_torch.obs.registry import BUCKET_EDGES, HistogramState, MetricsRegistry, lint_prometheus
from repro_torch.obs.slowlog import SlowQueryLog

N = 10
R = 8 * TILE_BITS + 700  # 8 full tiles + a partial one
NAMES = [f"s{i}" for i in range(N)]


def _bits(seed=0, density=0.3):
    rng = np.random.default_rng(seed)
    bits = rng.random((N, R)) < density
    bits[: N // 3, : R // 2] = False  # clean territory for the tiled path
    return bits


def _t_for(alg: str) -> int:
    return {"wide_or": 1, "wide_and": N, "sopckt": 2}.get(alg, 4)


@pytest.fixture(scope="module")
def data():
    bits = _bits()
    return bits, bits.sum(0)


@pytest.fixture(scope="module")
def pair(data):
    bits, _ = data
    ref = RQ.BitmapIndex.from_dense(bits, names=NAMES)
    tor = index_from_reference_arrays(np.asarray(ref.columns), ref.names, ref.r, device="cpu")
    return ref, tor


@pytest.fixture(scope="module")
def idx(pair):
    return pair[1]


@pytest.fixture(autouse=True)
def _obs_clean():
    for o in (obs, robs):
        o.disable()
        o.reset()
    yield
    for o in (obs, robs):
        o.disable()
        o.reset()


def _untimed(sp) -> tuple:
    """A span tree without its times: (name, attrs, children)."""
    return (sp.name, dict(sp.attrs), [_untimed(c) for c in sp.children])


def _python_values(tree) -> bool:
    name, attrs, children = tree
    ok = all(not hasattr(v, "dtype") for v in attrs.values())
    return ok and all(_python_values(c) for c in children)


# -- the reference's cases, on the port's index --------------------------------

def test_span_words_match_exec_info_every_backend(idx, data):
    _, counts = data
    for alg in ALGORITHMS:
        t = _t_for(alg)
        obs.enable()
        got = unpack(idx.execute(TQ.Threshold(t), backend=alg), idx.r).numpy()
        obs.disable()
        np.testing.assert_array_equal(got, counts >= t, err_msg=alg)
        root = obs.last_trace()
        assert root is not None and root.name == "execute", alg
        assert root.attrs["measured_words"] == idx.last_info["words_touched"], alg
        disp = root.find("dispatch")
        assert disp is not None and disp.attrs["backend"] == alg
        assert disp.attrs["measured_words"] == idx.last_info["words_touched"]
        obs.reset()


def test_planner_routed_trace_has_plan_and_predicted_words(idx):
    obs.enable()
    idx.execute(TQ.Interval(2, 8))
    obs.disable()
    root = obs.last_trace()
    plan_sp = root.find("plan")
    assert plan_sp is not None
    assert plan_sp.attrs["algorithm"] == root.attrs["backend"]
    assert plan_sp.attrs["predicted_words"] == root.attrs["predicted_words"]
    assert root.attrs["measured_words"] == idx.last_info["words_touched"]
    text = root.format()
    assert "execute" in text and "plan" in text and "dispatch" in text


def test_compile_span_on_miss_hit_annotates_parent(idx):
    TQ.clear_compiled_cache()
    obs.enable()
    idx.execute(TQ.Interval(3, 7), backend="circuit")
    first = obs.last_trace()
    idx.execute(TQ.Interval(3, 7), backend="circuit")
    second = obs.last_trace()
    obs.disable()
    comp = first.find("compile")
    assert comp is not None and comp.attrs["cache"] == "miss"
    assert second.find("compile") is None
    assert second.find("dispatch").attrs.get("compile_cache") == "hit"
    TQ.clear_compiled_cache()


def test_decode_span_only_on_tiled_path(idx):
    obs.enable()
    idx.execute(TQ.Threshold(4), backend="tiled_fused")
    tiled_root = obs.last_trace()
    idx.execute(TQ.Threshold(4), backend="fused")
    dense_root = obs.last_trace()
    obs.disable()
    dec = tiled_root.find("decode")
    assert dec is not None and isinstance(dec.attrs["words_by_kind"], dict)
    assert dense_root.find("decode") is None
    assert dense_root.find("dispatch").attrs["words_by_kind"].get("dense", 0) > 0


def test_histogram_merge_exact_and_associative():
    rng = np.random.default_rng(7)
    parts = []
    for _ in range(3):
        st = HistogramState()
        for v in 10.0 ** rng.uniform(-7.5, 9.5, 200):
            st.observe(float(v))
        parts.append(st)
    a, b, c = parts
    left = a.merge(b).merge(c)
    right = a.merge(b.merge(c))
    assert left.counts == right.counts and left.count == right.count == 600
    assert left.sum == pytest.approx(right.sum)
    for q in (0.5, 0.95, 0.99):
        assert np.isfinite(left.quantile(q))
    # the same fixed edges as the reference, so merges across packages are exact
    assert BUCKET_EDGES == robs.BUCKET_EDGES


def test_disabled_mode_mutates_nothing(idx):
    obs.enable()
    idx.execute(TQ.Interval(2, 8))
    idx.execute(TQ.Threshold(4), backend="tiled_fused")
    obs.disable()
    obs.reset()
    before = json.dumps(obs.REGISTRY.snapshot(), sort_keys=True, default=str)
    for _ in range(5):
        idx.execute(TQ.Interval(2, 8))
        idx.execute(TQ.Threshold(4), backend="tiled_fused")
        idx.execute_many([TQ.Threshold(3), TQ.Interval(2, 5)], backend="tiled_fused")
    after = json.dumps(obs.REGISTRY.snapshot(), sort_keys=True, default=str)
    assert before == after
    assert obs.last_trace() is None
    assert obs.drift_samples() == 0
    assert trace.span("anything") is trace.NULL_SPAN
    assert trace.current_span() is trace.NULL_SPAN


def test_drift_samples_accumulate_over_100_queries(idx):
    obs.enable()
    for i in range(100):
        idx.execute(TQ.Threshold(2 + (i % 5)))
    n = obs.drift_samples()
    obs.disable()
    assert n >= 100
    d = obs.dump()["drift"]
    assert d["samples"] == n and np.isfinite(d["ratio_p50"])


def test_slow_query_log_threshold_and_ring(idx):
    obs.enable(slow_query_threshold_s=0.0)
    idx.execute(TQ.Interval(2, 8))
    entry = obs.SLOW_QUERIES.entries()[-1]
    assert entry["span"]["name"] == "execute" and "algorithm" in entry["plan"]
    obs.SLOW_QUERIES.set_threshold(999.0)
    obs.SLOW_QUERIES.clear()
    idx.execute(TQ.Interval(2, 8))
    assert obs.SLOW_QUERIES.entries() == []
    obs.disable()
    log = SlowQueryLog(threshold_s=0.0, capacity=4)
    for i in range(6):
        sp = trace.Span(f"q{i}")
        sp.wall_s = 1.0
        log.maybe_record(sp)
    assert len(log.entries()) == 4 and log.dropped == 2


def test_prometheus_export_lints_clean_and_jsonl_parses(idx):
    obs.enable()
    for i in range(10):
        idx.execute(TQ.Threshold(2 + (i % 4)))
    idx.execute_many([TQ.Interval(2, 6), TQ.Threshold(3)], backend="tiled_fused")
    prom = obs.export_prometheus()
    obs.disable()
    assert lint_prometheus(prom) == []
    assert robs.lint_prometheus(prom) == []  # the reference's scrape check too
    for name in ("repro_query_wall_seconds", "repro_kernel_launches_total",
                 "repro_calibration_drift_ratio"):
        assert name in prom
    for line in obs.export_jsonl().strip().splitlines():
        assert {"name", "type", "samples"} <= set(json.loads(line))
    snap = obs.dump()
    assert snap["drift"]["samples"] >= 10 and snap["last_trace"] is not None


def test_registry_isolated_instances_and_reset():
    reg = MetricsRegistry(enabled=True)
    c = reg.counter("x_total", "", ("k",))
    bound = c.bind(k="a")
    bound.inc(2)
    c.inc(1, k="b")
    assert c.value(k="a") == 2 and c.value(k="b") == 1
    h = reg.histogram("h_seconds")
    h.observe(0.25)
    assert h.state().count == 1
    reg.reset()
    assert c.value(k="a") == 0 and h.state().count == 0
    bound.inc(3)
    assert c.value(k="a") == 3
    reg.enabled = False
    bound.inc(5)
    c.inc(5, k="b")
    h.observe(1.0)
    assert c.value(k="a") == 3 and c.value(k="b") == 0 and h.state().count == 0
    with pytest.raises(TypeError):
        reg.gauge("x_total")
    reg.enabled = True
    with pytest.raises(ValueError):
        c.inc(1, j="a")


# -- parity with the reference ---------------------------------------------------

def _same_families():
    """Every family the reference registers exists in the port with the same
    type, help and labels (the port's may add none the reference lacks but
    ``PORT_ONLY_FAMILIES``, which the reference must not have)."""
    want = {k: (v["type"], v["help"], v["labels"]) for k, v in robs.REGISTRY.snapshot().items()}
    got = {k: (v["type"], v["help"], v["labels"])
           for k, v in obs.REGISTRY.snapshot().items() if k not in PORT_ONLY_FAMILIES}
    return ({k: want[k] for k in got if k in want} == got and set(got) <= set(want)
            and not PORT_ONLY_FAMILIES & set(want))


def test_metric_families_carry_the_reference_names():
    import repro.kernels.tiled_scan  # noqa: F401  (registers the reference's counters)
    import repro_torch.kernels.tiled_scan  # noqa: F401

    assert _same_families()
    for name in ("repro_kernel_launches_total", "repro_kernel_decode_words_total",
                 "repro_kernel_event_toggles_total", "repro_calibration_drift_ratio",
                 "repro_query_wall_seconds", "repro_query_words_touched"):
        assert name in obs.REGISTRY.snapshot()
    assert PORT_ONLY_FAMILIES <= set(obs.REGISTRY.snapshot())


K1 = {"program", "launch"}  # the circuit kernel's lookup and launch
QUERIES = {  # name: (query, backend, the port-only spans its tree holds)
    "planned_interval": (lambda Q: Q.Interval(2, 8), None, K1),
    "planned_threshold": (lambda Q: Q.Threshold(4), None, K1),
    "tiled_threshold": (lambda Q: Q.Threshold(4), "tiled_fused", {"block"}),
    "tiled_interval": (lambda Q: Q.Interval(3, 7), "tiled_fused", {"block"}),
    "fused_interval": (lambda Q: Q.Interval(2, 8), "fused", K1),
    "circuit_composite": (lambda Q: Q.And(Q.Interval(2, 8), Q.Not(Q.Col("s3"))), "circuit", K1),
    "looped": (lambda Q: Q.Threshold(3), "looped", set()),
    "csvckt": (lambda Q: Q.Threshold(5), "csvckt", set()),
    "rbmrg_block": (lambda Q: Q.Threshold(4), "rbmrg_block", set()),
    "dsk": (lambda Q: Q.Threshold(9), "dsk", set()),
    "wide_or": (lambda Q: Q.Threshold(1), None, set()),
    "column": (lambda Q: Q.Col("s2"), None, set()),
}


@pytest.mark.parametrize("name", list(QUERIES))
def test_span_trees_equal_reference(pair, name):
    """Equal trees once the port-only spans are folded out; those are
    present exactly where the port runs K1 or the tiled stages."""
    ref, tor = pair
    make, backend, port_spans = QUERIES[name]
    for cold in (True, False):  # compile miss, then the cached circuit
        if cold:
            RQ.clear_compiled_cache()
            TQ.clear_compiled_cache()
        robs.enable()
        obs.enable()
        want = ref.execute(make(RQ), backend=backend)
        got = tor.execute(make(TQ), backend=backend)
        robs.disable()
        obs.disable()
        assert np.array_equal(u32(got), np.asarray(want))
        folded = set()
        want_tree = _untimed(robs.last_trace())
        got_tree = reference_view(obs.last_trace(), folded)
        assert got_tree == want_tree, (name, cold)
        assert folded == port_spans, (name, cold)
        assert _python_values(_untimed(obs.last_trace()))
        assert robs.drift_samples() == obs.drift_samples()


MANY_PORT_SPANS = {None: K1, "tiled_fused": {"block"}, "fused": K1, "circuit": K1, "looped": set()}


@pytest.mark.parametrize("backend", list(MANY_PORT_SPANS))
def test_execute_many_span_trees_and_drift_equal_reference(pair, backend):
    ref, tor = pair
    RQ.clear_compiled_cache()
    TQ.clear_compiled_cache()
    ts = (2, 3, 7)
    robs.enable()
    obs.enable()
    want = ref.execute_many([RQ.Threshold(t) for t in ts] + [RQ.Interval(2, 6)]
                            if backend != "looped" else [RQ.Threshold(t) for t in ts],
                            backend=backend)
    got = tor.execute_many([TQ.Threshold(t) for t in ts] + [TQ.Interval(2, 6)]
                           if backend != "looped" else [TQ.Threshold(t) for t in ts],
                           backend=backend)
    robs.disable()
    obs.disable()
    for g, w in zip(got, want):
        assert np.array_equal(u32(g), np.asarray(w))
    folded = set()
    assert reference_view(obs.last_trace(), folded) == _untimed(robs.last_trace())
    assert folded == MANY_PORT_SPANS[backend]
    assert obs.drift_samples() == robs.drift_samples()
    for fam in ("repro_query_words_touched", "repro_calibration_drift_ratio"):
        want_counts = {k: v["counts"] for k, v in robs.REGISTRY.snapshot()[fam]["samples"].items()}
        got_counts = {k: v["counts"] for k, v in obs.REGISTRY.snapshot()[fam]["samples"].items()}
        assert got_counts == want_counts, fam


def _kernel_counters(o) -> dict:
    snap = o.REGISTRY.snapshot()
    return {k: dict(snap[k]["samples"]) for k in (
        "repro_kernel_launches_total", "repro_kernel_decode_words_total",
        "repro_kernel_event_toggles_total")}


@pytest.mark.parametrize("tile_words", (8, 64))
def test_tiled_counter_deltas_equal_reference(tile_words):
    """The kernel counters of tiled queries -- block and event stages, one and
    several residual groups, batched outputs -- advance by the reference's
    amounts, though the port's block plan pads nothing."""
    from _torch_port import container_mix_bits

    import repro.kernels.tiled_scan  # noqa: F401
    import repro_torch.kernels.tiled_scan  # noqa: F401

    bits = container_mix_bits(7, seed=3)
    ref = RQ.BitmapIndex.from_dense(bits, tile_words=tile_words)
    tor = TQ.BitmapIndex.from_dense(bits, tile_words=tile_words, device="cpu")
    calls = [
        ("one", lambda Q, i: i.execute(Q.Threshold(3), backend="tiled_fused")),
        ("interval", lambda Q, i: i.execute(Q.Interval(2, 5), backend="tiled_fused")),
        ("subset", lambda Q, i: i.execute(Q.Threshold(2, over=("c1", "c4", "c6")),
                                          backend="tiled_fused")),
        ("many", lambda Q, i: i.execute_many([Q.Threshold(2), Q.Parity(), Q.Interval(3, 6)],
                                             backend="tiled_fused")),
    ]
    robs.enable()
    obs.enable()
    for name, call in calls:
        call(RQ, ref)
        call(TQ, tor)
        assert _kernel_counters(obs) == _kernel_counters(robs), name
        assert tor.last_info == ref.last_info, name
    robs.disable()
    obs.disable()
    got = _kernel_counters(obs)
    assert got["repro_kernel_launches_total"].get("block", 0) > 0
    assert got["repro_kernel_launches_total"].get("event", 0) > 0


# -- the port's own spans: where the work happens, on the profiler's clock -----

def _names(sp) -> tuple:
    return (sp.name, [_names(c) for c in sp.children])


def _stage_bits():
    """Mostly clean columns with three sparse tiles (the event stage) and
    one dense tile (the block kernel) in each, so the planner goes tiled."""
    rng = np.random.default_rng(1)
    n, n_tiles = 8, 32
    bits = np.zeros((n, n_tiles * TILE_BITS), bool)
    for i in range(n):
        for tj in (3, 7, 11):
            bits[i, rng.integers(tj * TILE_BITS, (tj + 1) * TILE_BITS, 10)] = True
        bits[i, 20 * TILE_BITS:21 * TILE_BITS] = rng.random(TILE_BITS) < 0.4
    return bits


@pytest.fixture(scope="module")
def staged():
    return TQ.BitmapIndex.from_dense(_stage_bits(), device="cpu")


def _traced(index, q, runs=2):
    """The span tree of the last of ``runs`` planner-routed runs of ``q``."""
    obs.enable()
    for _ in range(runs):
        index.execute(q)
    obs.disable()
    return obs.last_trace()


def test_dense_route_span_tree(idx):
    from repro_torch.kernels import threshold_ssum

    threshold_ssum._CIRCUIT_RUNNERS.clear()
    cold = _traced(idx, TQ.Threshold(5), runs=1)
    warm = _traced(idx, TQ.Threshold(5))
    assert idx.last_info["engine"] == "dense"
    assert _names(warm) == ("execute", [("plan", []), ("dispatch", [("program", []),
                                                                    ("launch", [])])])
    assert cold.find("program").attrs == {"cache": "miss"}
    assert warm.find("program").attrs == {"cache": "hit"}
    assert warm.find("launch").attrs == {"kernel": "circuit_eval"}


def test_tiled_scan_route_span_tree(staged):
    root = _traced(staged, TQ.Threshold(2))
    info = staged.last_info
    assert info["backend"] == "tiled_fused" and info["engine"] == "scan"
    assert info["event_tiles"] > 0 and info["case3_tiles"] > 0
    assert _names(root) == ("execute", [("plan", []), ("dispatch", [("events", []), ("block", []),
                                                                    ("decode", [])])])
    assert root.find("events").attrs == {} and root.find("block").attrs == {}


def test_every_span_of_a_request_carries_the_root_rid(idx, staged):
    obs.enable()
    roots = []
    for index, q in ((idx, TQ.Threshold(4)), (staged, TQ.Threshold(2)), (idx, TQ.Interval(2, 8))):
        index.execute(q)
        roots.append(obs.last_trace())
    idx.execute_many([TQ.Threshold(3), TQ.Interval(2, 5)])
    roots.append(obs.last_trace())
    obs.disable()
    rids = [r.rid for r in roots]
    assert len(set(rids)) == len(rids) and all(r > 0 for r in rids)
    for root in roots:
        assert root.parent is None
        for sp in root.iter():
            assert sp.rid == root.rid
            assert "rid" not in sp.attrs and "parent" not in sp.attrs
            end = sp.t0 + sp.wall_s
            for c in sp.children:  # t0 is the start: children lie inside, in order
                assert c.parent is sp
                assert sp.t0 <= c.t0 and c.t0 + c.wall_s <= end
            starts = [c.t0 for c in sp.children]
            assert starts == sorted(starts)
    assert {sp.name for r in roots for sp in r.iter()} >= PORT_ONLY_SPANS


def _profiled(calls):
    """The span trees of ``calls`` (each one request) and the CPU profiler's
    events over them."""
    import torch

    roots = []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for call in calls:
            call()
            roots.append(obs.last_trace())
    return roots, prof.events()


def _range_forest(events) -> list:
    """The ``repro.*`` ranges as (name, children) trees, each under the
    nearest enclosing ``repro.*`` range, in start order."""
    def owner(e):
        p = e.cpu_parent
        while p is not None and not p.name.startswith("repro."):
            p = p.cpu_parent
        return p

    ranges = sorted((e for e in events if e.name.startswith("repro.")),
                    key=lambda e: e.time_range.start)
    kids: dict = {}
    for e in ranges:
        p = owner(e)
        kids.setdefault(None if p is None else id(p), []).append(e)

    def tree(e):
        return (e.name, [tree(c) for c in kids.get(id(e), [])])

    return [tree(e) for e in kids.get(None, [])]


def test_spans_are_profiler_ranges_nested_as_the_spans(idx, staged):
    def ranged(sp):
        return ("repro." + sp.name, [ranged(c) for c in sp.children])

    obs.enable()
    roots, events = _profiled([lambda: idx.execute(TQ.Threshold(4)),
                               lambda: staged.execute(TQ.Threshold(2)),
                               lambda: idx.execute_many([TQ.Threshold(3), TQ.Interval(2, 5)])])
    obs.disable()
    assert _range_forest(events) == [ranged(r) for r in roots]
    names = {e.name for e in events}
    assert {"repro." + n for n in PORT_ONLY_SPANS} <= names


def test_tracing_off_makes_no_span_and_opens_no_range(idx, staged, monkeypatch):
    made = []

    class Counted(trace.Span):
        __slots__ = ()

        def __init__(self, *args, **kw):
            made.append(args[0])
            super().__init__(*args, **kw)

    monkeypatch.setattr(trace, "Span", Counted)
    calls = [lambda: idx.execute(TQ.Threshold(4)), lambda: staged.execute(TQ.Threshold(2)),
             lambda: idx.execute_many([TQ.Threshold(3), TQ.Interval(2, 5)])]
    roots, events = _profiled(calls)
    assert made == [] and roots == [None] * 3
    assert not [e.name for e in events if e.name.startswith("repro.")]
    obs.enable()  # the same calls traced: the counting and the search do see spans
    _, events = _profiled(calls)
    obs.disable()
    assert "launch" in made and "events" in made
    assert "repro.launch" in {e.name for e in events}
