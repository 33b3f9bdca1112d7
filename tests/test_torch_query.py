"""The slice as a whole: ``BitmapIndex.execute`` / ``execute_many`` of the port
(``device="cpu"``) against the reference, bit for bit, with equal plans and
equal ``last_info``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import clean_fraction_bits, u32
from repro import query as RQ
from repro_torch import query as TQ
from repro_torch.convert import index_from_reference_arrays, words_to_numpy

N, R = 12, 10_000
NAMES = [f"store{i}" for i in range(N)]
PORTED = ("fused", "circuit", "scancount", "scancount_streaming", "ssum", "treeadd", "srtckt")


@pytest.fixture(scope="module")
def pair():
    """The quickstart's index (12 stores x 10,000 products at 15 %), built in
    the reference and carried across as numpy arrays."""
    rng = np.random.default_rng(0)
    on_sale = rng.random((N, R)) < 0.15
    ref = RQ.BitmapIndex.from_dense(jnp.asarray(on_sale), names=NAMES)
    tor = index_from_reference_arrays(np.asarray(ref.columns), ref.names, ref.r, device="cpu")
    return on_sale, ref, tor


def _cases(Q):
    s = NAMES
    return {
        "abstract_2_to_10": Q.Interval(2, 10),
        "threshold_2": Q.Threshold(2),
        "threshold_1": Q.Threshold(1),
        "threshold_n": Q.Threshold(N),
        "threshold_0": Q.Threshold(0),
        "threshold_over_n": Q.Threshold(N + 1),
        "exactly_1": Q.Exactly(1),
        "parity": Q.Parity(),
        "majority": Q.Majority(),
        "weighted": Q.Weighted(tuple(1 + (i * 5) % 7 for i in range(N)), 9),
        "sym": Q.Sym(tuple(w % 3 == 1 for w in range(N + 1))),
        "and_not_col": Q.And(Q.Interval(2, 10), Q.Not(Q.Col(s[0]))),
        "ops": Q.Interval(2, 10) & ~Q.Threshold(11),
        "minus": Q.Threshold(2) - Q.Col(s[3]),
        "or_tree": (Q.Threshold(2, over=s[:4]) & ~Q.Col(s[4])) | Q.Parity(over=s[5:8]),
        "subset_threshold": Q.Threshold(2, over=(s[7], s[1], s[10], s[4])),
        "votes": Q.Threshold(2, over=(Q.Col(s[0]), Q.Col(s[1]), Q.Interval(4, 10))),
        "col": Q.Col(s[6]),
        "weighted_over": Q.Weighted((3, 2, 1), 4, over=(s[0], s[2], Q.Threshold(3))),
        "interval_over": Q.Interval(1, 1, over=s[2:9]),
    }


CASES = list(_cases(TQ))


@pytest.mark.parametrize("name", CASES)
def test_execute_planner_driven_equals_reference(pair, name):
    _bits, ref, tor = pair
    rq, tq = _cases(RQ)[name], _cases(TQ)[name]
    rp, tp = ref.explain(rq), tor.explain(tq)
    assert (tp.algorithm, tp.cost, tp.candidates) == (rp.algorithm, rp.cost, rp.candidates)
    want = np.asarray(ref.execute(rq))
    got = tor.execute(tq)
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    assert np.array_equal(words_to_numpy(got), want)
    assert tor.last_info == ref.last_info
    assert tor.count(tq) == ref.count(rq)


def test_abstract_query_against_position_counts(pair):
    bits, _ref, tor = pair
    counts = bits.sum(0)
    from repro_torch.core.bitmaps import unpack

    mid = unpack(tor.execute(TQ.Interval(2, 10)), tor.r).numpy()
    assert np.array_equal(mid, (counts >= 2) & (counts <= 10))


@pytest.mark.parametrize("backend", PORTED + ("wide_or", "wide_and"))
def test_backend_overrides_equal_reference(pair, backend):
    _bits, ref, tor = pair
    t = {"wide_or": 1, "wide_and": N}.get(backend, 4)
    queries = [(RQ.Threshold(t), TQ.Threshold(t)),
               (RQ.Threshold(min(t, 3), over=NAMES[2:6]) if backend != "wide_and" else RQ.Threshold(4, over=NAMES[2:6]),
                TQ.Threshold(min(t, 3), over=NAMES[2:6]) if backend != "wide_and" else TQ.Threshold(4, over=NAMES[2:6]))]
    for rq, tq in queries:
        want = np.asarray(ref.execute(rq, backend=backend))
        assert np.array_equal(u32(tor.execute(tq, backend=backend)), want), backend
        assert tor.last_info == ref.last_info
    if backend in ("fused", "circuit"):
        rq, tq = _cases(RQ)["or_tree"], _cases(TQ)["or_tree"]
        assert np.array_equal(u32(tor.execute(tq, backend=backend)),
                              np.asarray(ref.execute(rq, backend=backend)))
        assert tor.last_info == ref.last_info
    else:
        with pytest.raises(ValueError, match="only executes bare Threshold"):
            tor.execute(_cases(TQ)["or_tree"], backend=backend)


def test_sopckt_override_on_a_tiny_subset(pair):
    _bits, ref, tor = pair
    rq, tq = RQ.Threshold(2, over=NAMES[:5]), TQ.Threshold(2, over=NAMES[:5])
    assert np.array_equal(u32(tor.execute(tq, backend="sopckt")),
                          np.asarray(ref.execute(rq, backend="sopckt")))


@pytest.mark.parametrize("backend", [None, "fused", "circuit", "ssum"])
def test_execute_many_equals_reference(pair, backend):
    _bits, ref, tor = pair
    pick = ["threshold_2", "parity", "exactly_1", "or_tree", "col", "threshold_1", "weighted"]
    if backend == "ssum":
        pick = ["threshold_2", "subset_threshold", "threshold_n"]
    rqs = [_cases(RQ)[k] for k in pick]
    tqs = [_cases(TQ)[k] for k in pick]
    want = [np.asarray(x) for x in ref.execute_many(rqs, backend=backend)]
    got = tor.execute_many(tqs, backend=backend)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.array_equal(u32(g), w)
    assert np.array_equal(words_to_numpy(got), np.stack(want))


def test_free_function_and_constructors_equal_reference(pair):
    bits, ref, _tor = pair
    cols = np.asarray(ref.columns)
    want = np.asarray(RQ.execute(jnp.asarray(cols), RQ.Interval(2, 10), r=R))
    assert np.array_equal(u32(TQ.execute(cols, TQ.Interval(2, 10), r=R, device="cpu")), want)
    a = TQ.BitmapIndex.from_dense(bits, names=NAMES, device="cpu")
    b = TQ.BitmapIndex.from_columns({n: cols[i] for i, n in enumerate(NAMES)}, r=R, device="cpu")
    for idx in (a, b):
        assert idx.names == tuple(NAMES) and len(idx) == N and "store3" in idx
        assert np.array_equal(u32(idx.execute(TQ.Interval(2, 10))), want)
        assert np.array_equal(u32(idx.column("store5")), cols[5])
        assert np.array_equal(u32(idx.execute(idx["store1"] & ~idx["store2"])),
                              np.asarray(ref.execute(ref["store1"] & ~ref["store2"])))
    with pytest.raises(KeyError):
        a.column("nope")
    with pytest.raises(ValueError):
        TQ.BitmapIndex(cols, names=NAMES[:-1], device="cpu")
    with pytest.raises(ValueError):
        TQ.BitmapIndex(cols, r=R * 40, device="cpu")


def test_add_and_replace_column_return_new_indexes(pair):
    _bits, ref, tor = pair
    hot_r, hot_t = ref.execute(RQ.Threshold(2)), tor.execute(TQ.Threshold(2))
    ref2, tor2 = ref.add_column("hot", hot_r), tor.add_column("hot", hot_t)
    assert tor2 is not tor and tor2.n == N + 1 and "hot" not in tor
    rq, tq = RQ.And(RQ.Col("hot"), RQ.Col("store0")), TQ.And(TQ.Col("hot"), TQ.Col("store0"))
    assert np.array_equal(u32(tor2.execute(tq)), np.asarray(ref2.execute(rq)))
    assert tor2.explain(TQ.Interval(2, 10)).cost == ref2.explain(RQ.Interval(2, 10)).cost
    rare_r, rare_t = ref2.execute(RQ.Interval(6, 12)), tor2.execute(TQ.Interval(6, 12))
    ref3, tor3 = ref2.replace_column("store1", rare_r), tor2.replace_column("store1", rare_t)
    assert np.array_equal(u32(tor3.execute(TQ.Threshold(2))), np.asarray(ref3.execute(RQ.Threshold(2))))
    slot = tor3.names.index("store1")
    assert tor3.store.container_census(slots=[slot]) == ref3.store.container_census(slots=[slot])
    # the stale indexes keep working against their own schema
    assert np.array_equal(u32(tor.execute(TQ.Threshold(2))), u32(hot_t))
    assert np.array_equal(u32(tor2.execute(TQ.Col("store1"))), np.asarray(ref2.execute(RQ.Col("store1"))))
    with pytest.raises(ValueError):
        tor.add_column("store0", hot_t)
    with pytest.raises(KeyError):
        tor.replace_column("nope", hot_t)


def test_compiled_and_plan_caches(pair):
    _bits, _ref, tor = pair
    TQ.clear_compiled_cache()
    assert TQ.compiled_cache_info() == {"size": 0, "hits": 0, "misses": 0}
    tor.execute(TQ.Interval(2, 10))
    tor.execute(TQ.Interval(2, 10))
    info = TQ.compiled_cache_info()
    assert info["misses"] == 1 and info["hits"] == 1
    memo = TQ.plan_memo_info()
    assert memo["hits"] >= 1 and memo["entries"] >= 1
    c1 = TQ.circuit_for((TQ.Interval(2, 10),), N, tuple(NAMES))
    assert c1 is TQ.circuit_for((TQ.Interval(2, 10),), N, tuple(NAMES))


def test_clean_heavy_index_plans_and_answers_through_tiled_fused():
    """A clean-heavy index plans ``tiled_fused`` as the reference does, and
    (since the route is ported) answers through it: results, plans and
    ``last_info`` equal the reference's, batched queries included."""
    bits = clean_fraction_bits(8, 0.95, seed=5)
    ref = RQ.BitmapIndex.from_dense(jnp.asarray(bits))
    tor = index_from_reference_arrays(np.asarray(ref.columns), ref.names, ref.r, device="cpu")
    for rq, tq in ((RQ.Threshold(3), TQ.Threshold(3)), (RQ.Interval(2, 5), TQ.Interval(2, 5))):
        rp, tp = ref.explain(rq), tor.explain(tq)
        assert tp.algorithm == rp.algorithm == "tiled_fused"
        assert (tp.cost, tp.candidates) == (rp.cost, rp.candidates)
        assert np.array_equal(u32(tor.execute(tq)), np.asarray(ref.execute(rq)))
        assert tor.last_info == ref.last_info and tor.last_info["backend"] == "tiled_fused"
        # the dense route still answers when asked for by name
        assert np.array_equal(u32(tor.execute(tq, backend="fused")), np.asarray(ref.execute(rq)))
    want = ref.execute_many([RQ.Threshold(3), RQ.Interval(2, 5)])
    got = tor.execute_many([TQ.Threshold(3), TQ.Interval(2, 5)])
    assert np.array_equal(words_to_numpy(got), np.stack([np.asarray(w) for w in want]))
    assert tor.last_info == ref.last_info


def test_unknown_backend_raises(pair):
    _bits, _ref, tor = pair
    with pytest.raises(ValueError, match="unknown"):
        tor.execute(TQ.Threshold(3), backend="no_such_backend")
    with pytest.raises(ValueError, match="unknown"):
        TQ.run_threshold_backend(tor.columns, 3, "no_such_backend")


def test_device_none_without_a_card_raises(pair):
    _bits, ref, _tor = pair
    if torch.cuda.is_available():  # decided here, not while the module is imported
        pytest.skip("a CUDA device is present")
    cols = np.asarray(ref.columns)
    with pytest.raises(RuntimeError, match="CUDA"):
        TQ.BitmapIndex(cols, names=NAMES, r=R)
    with pytest.raises(RuntimeError, match="CUDA"):
        TQ.BitmapIndex.from_dense(np.zeros((2, 64), bool))
    with pytest.raises(RuntimeError, match="CUDA"):
        TQ.execute(cols, TQ.Threshold(2), r=R)
    with pytest.raises(RuntimeError, match="CUDA"):
        index_from_reference_arrays(cols, NAMES, R)
