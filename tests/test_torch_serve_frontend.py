"""The port's query front-end (``repro_torch.serve``) against the reference.

Each case of ``tests/test_serve_frontend.py`` drives a reference
``QueryServer`` and a port one (``device="cpu"``) over the same
numpy-seeded bits with the same submissions, and holds every served result
equal word for word (``np.array_equal`` on ``uint32``) and the ``info()``
counters and batch-size histograms of the same ``pump()`` sequence equal.
The tolerance is none.  The threaded case bounds every wait, so a deadlock
fails fast; the last cases check that threads loading a kernel for the
first time share one build and one library.
"""
from __future__ import annotations

import threading
import time
import types

import jax.numpy as jnp
import numpy as np
import pytest

from _torch_port import u32
from repro import query as RQ
from repro import serve as RS
from repro import stream as RSt
from repro_torch import query as TQ
from repro_torch import serve as TS
from repro_torch import stream as TSt
from repro_torch.core.threshold import ALGORITHMS

EVENTS = ("requests", "served", "cache_hits", "dedup_hits", "shed", "executed",
          "batches", "invalidations", "errors")
WAIT_S = 30.0  # every wait of the threaded case ends within this


def _bits(n=8, r=512, seed=0, density=0.3):
    rng = np.random.default_rng(seed)
    return rng.random((n, r)) < density


def _names(n):
    return [f"s{i}" for i in range(n)]


@pytest.fixture(autouse=True)
def _fresh_caches():
    RQ.clear_compiled_cache()
    TQ.clear_compiled_cache()
    yield
    RQ.clear_compiled_cache()
    TQ.clear_compiled_cache()


class Pair:
    """One reference and one port server over the same bits; each call
    takes ``make(M)``, built once from ``repro.query`` and once from
    ``repro_torch.query``, and returns the two answers."""

    def __init__(self, bits, *, streaming=False, **kw):
        names = _names(bits.shape[0])
        if streaming:
            self.ref = RSt.StreamingIndex.from_dense(jnp.asarray(bits), names=names)
            self.tor = TSt.StreamingIndex.from_dense(bits, names=names, device="cpu")
        else:
            self.ref = RQ.BitmapIndex.from_dense(jnp.asarray(bits), names=names)
            self.tor = TQ.BitmapIndex.from_dense(bits, names=names, device="cpu")
        self.rs = RS.QueryServer(self.ref, **kw)
        self.ts = TS.QueryServer(self.tor, **kw)

    def submit(self, make, **kw):
        return self.rs.submit(make(RQ), **kw), self.ts.submit(make(TQ), **kw)

    def pump(self) -> int:
        got = self.rs.pump()
        assert self.ts.pump() == got
        return got

    def drain(self) -> None:
        while self.pump():
            pass

    def serve_many(self, makes, **kw) -> list:
        """Served words, held equal across the packages."""
        a = self.rs.serve_many([m(RQ) for m in makes], **kw)
        b = self.ts.serve_many([m(TQ) for m in makes], **kw)
        out = []
        for x, y in zip(a, b):
            assert np.array_equal(u32(y), u32(x))
            out.append(u32(y))
        return out

    def execute(self, make, **kw) -> np.ndarray:
        """Direct execution on both indexes (streaming: the overlay index),
        held equal; the served results' oracle."""
        ridx = self.ref.index() if hasattr(self.ref, "index") else self.ref
        tidx = self.tor.index() if hasattr(self.tor, "index") else self.tor
        want, got = u32(ridx.execute(make(RQ), **kw)), u32(tidx.execute(make(TQ), **kw))
        assert np.array_equal(got, want)
        return got

    def info(self) -> dict:
        """The port's ``info()``, after holding its counters, occupancy,
        histograms and plan-memo counters equal to the reference's."""
        a, b = self.rs.info(), self.ts.info()
        for key in EVENTS + ("pending", "cache_entries", "batch_size_hist", "plan_memo"):
            assert b[key] == a[key], (key, b[key], a[key])
        for key in ("latency", "queue_wait"):
            assert b[key]["count"] == a[key]["count"], key
        assert (b["calibration"] is None) == (a["calibration"] is None)
        return b


def same_words(ref_future, tor_future, want=None) -> np.ndarray:
    got = u32(tor_future.result(0))
    assert np.array_equal(got, u32(ref_future.result(0)))
    if want is not None:
        assert np.array_equal(got, want)
    return got


# -- oracle: served == executed, across the cache tier and every backend ---

def test_served_bit_identical_to_execute():
    p = Pair(_bits(), window=0)
    pool = [
        lambda M: M.Interval(2, 6),
        lambda M: M.Threshold(3, over=("s0", "s1", "s2", "s4")),
        lambda M: M.And(M.Threshold(2, over=("s1", "s3", "s5")), M.Not(M.Col("s7"))),
        lambda M: M.AndNot(M.Interval(1, 2, over=("s2", "s6")), M.Col("s0")),
    ]
    futs = [p.submit(make) for make in pool]
    p.drain()
    for make, (rf, tf) in zip(pool, futs):
        same_words(rf, tf, p.execute(make))
    p.info()


@pytest.mark.parametrize("alg", ALGORITHMS)
def test_cached_result_bit_identical_per_backend(alg):
    """First serve executes; the resubmit is a cache hit -- both must equal
    direct execution on the same backend, in both packages."""
    p = Pair(_bits(n=6, r=256, seed=3), window=0)
    t = {"wide_or": 1, "wide_and": 6}.get(alg, 3)  # degenerate-only backends

    def make(M):
        return M.Threshold(t, over=tuple(_names(6)))

    ref = p.execute(make, backend=alg)
    cold = p.submit(make, backend=alg)
    assert p.pump() == 1
    same_words(*cold, ref)
    warm = p.submit(make, backend=alg)
    assert warm[1].done(), "second submit should complete from the result cache"
    same_words(*warm, ref)
    info = p.info()
    assert info["cache_hits"] == 1 and info["executed"] == 1


def test_semantic_cache_key_ignores_member_order():
    p = Pair(_bits(), window=0)
    a = p.submit(lambda M: M.Threshold(2, over=("s1", "s3", "s5")))
    p.pump()
    b = p.submit(lambda M: M.Threshold(2, over=("s5", "s1", "s3")))
    assert b[1].done() and p.info()["cache_hits"] == 1
    assert np.array_equal(same_words(*a), same_words(*b))


def test_failed_bucket_fails_its_futures():
    """A bucket whose execution raises fails every waiter with that error
    (``errors`` counted), and the server keeps serving."""
    p = Pair(_bits(), window=0)
    bad = p.submit(lambda M: M.Interval(2, 4), backend="looped")
    p.pump()
    for fut in bad:
        with pytest.raises(ValueError, match="only executes bare Threshold"):
            fut.result(0)
    good = p.submit(lambda M: M.Threshold(2))
    p.pump()
    same_words(*good, p.execute(lambda M: M.Threshold(2)))
    assert p.info()["errors"] == 1


# -- streaming invalidation: exact, and no stale reads ---------------------

def test_invalidation_touches_exactly_mutated_columns():
    p = Pair(_bits(), streaming=True, window=0)
    q_a = lambda M: M.Threshold(1, over=("s0", "s1"))  # noqa: E731
    q_b = lambda M: M.Threshold(1, over=("s6", "s7"))  # noqa: E731
    p.serve_many([q_a, q_b])
    assert p.info()["cache_entries"] == 2

    for s in (p.ref, p.tor):
        s.set_bits("s0", [5])  # touches q_a's support only
    info = p.info()
    assert info["invalidations"] == 1 and info["cache_entries"] == 1

    hit = p.submit(q_b)  # untouched support: still a hit
    assert hit[1].done() and p.info()["cache_hits"] == 1
    same_words(*hit, p.execute(q_b))


def test_no_stale_reads_after_update():
    """Mutate, resubmit: the served bits are the NEW bits."""
    p = Pair(_bits(n=4, r=256, seed=7, density=0.0), streaming=True, window=0)
    q = lambda M: M.Threshold(1, over=("s0", "s1"))  # noqa: E731
    before = p.serve_many([q])[0]
    assert not before.any()

    for s in (p.ref, p.tor):
        s.set_bits("s0", [0, 33, 77])
    after = p.serve_many([q])[0]
    assert np.array_equal(after, p.execute(q))
    assert after.any(), "served result must observe the mutation"
    p.info()


def test_view_columns_cascade_invalidation():
    p = Pair(_bits(), streaming=True, window=0)
    p.ref.materialize("hot", RQ.Threshold(2, over=("s0", "s1", "s2")))
    p.tor.materialize("hot", TQ.Threshold(2, over=("s0", "s1", "s2")))
    hot = lambda M: M.Col("hot")  # noqa: E731
    served = p.serve_many([hot])[0]
    assert p.info()["cache_entries"] == 1
    assert np.array_equal(served, p.execute(hot))

    for s in (p.ref, p.tor):
        s.set_bits("s1", [3])  # an INPUT of the view, not the view itself
    assert p.info()["cache_entries"] == 0, "view entry must cascade out"
    fresh = p.serve_many([hot])[0]
    assert np.array_equal(fresh, p.execute(hot))


# -- dedup: one execution, many waiters ------------------------------------

def test_dedup_fans_out_single_execution():
    p = Pair(_bits(), window=0)
    q = lambda M: M.Interval(2, 5)  # noqa: E731
    futs = [p.submit(q) for _ in range(5)]
    # member order must not defeat dedup either
    futs.append(p.submit(lambda M: M.Interval(2, 5, over=tuple(reversed(_names(8))))))
    p.pump()
    info = p.info()
    assert info["executed"] == 1 and info["batches"] == 1
    assert info["dedup_hits"] == 5 and info["served"] == 6
    want = p.execute(q)
    for f in futs:
        same_words(*f, want)


@pytest.mark.parametrize("cache_entries", [4096, 0])
def test_waiter_mutating_its_result_leaves_others_intact(cache_entries):
    """Each request resolves to a tensor of its own: one waiter's in-place
    op reaches neither another waiter nor a later cache hit (the
    reference's results are immutable arrays)."""
    p = Pair(_bits(), window=0, cache_entries=cache_entries)
    q = lambda M: M.Interval(2, 5)  # noqa: E731
    futs = [p.submit(q) for _ in range(3)]
    p.pump()
    want = p.execute(q)
    assert want.any()
    futs[0][1].result(0).zero_()
    futs[1][1].result(0).bitwise_not_()
    assert not u32(futs[0][1].result(0)).any()
    same_words(*futs[2], want)
    later = p.submit(q)
    p.drain()
    same_words(*later, want)
    info = p.info()
    assert info["executed"] == (1 if cache_entries else 2)
    assert info["cache_hits"] == (1 if cache_entries else 0)


# -- admission control ------------------------------------------------------

def test_overload_sheds_with_explicit_signal():
    p = Pair(_bits(), window=0, max_pending=2, cache_entries=0)
    p.submit(lambda M: M.Threshold(1, over=("s0",)))
    p.submit(lambda M: M.Threshold(1, over=("s1",)))
    with pytest.raises(RS.Overloaded):
        p.rs.submit(RQ.Threshold(1, over=("s2",)))
    with pytest.raises(TS.Overloaded):
        p.ts.submit(TQ.Threshold(1, over=("s2",)))
    # duplicates of an admitted query are always accepted
    p.submit(lambda M: M.Threshold(1, over=("s0",)))
    info = p.info()
    assert info["shed"] == 1 and info["dedup_hits"] == 1
    p.drain()
    p.info()


# -- micro-batching ----------------------------------------------------------

def test_same_shape_queries_share_one_batch():
    p = Pair(_bits(), window=0)
    qs = [lambda M: M.Threshold(2, over=("s0", "s1", "s2")),
          lambda M: M.Threshold(3, over=("s3", "s5", "s7")),
          lambda M: M.Threshold(1, over=("s4", "s6", "s0"))]
    assert len({TS.shape_bucket(q(TQ)) for q in qs}) == 1
    outs = p.serve_many(qs)
    info = p.info()
    assert info["batches"] == 1 and info["batch_size_hist"] == {3: 1}
    for q, out in zip(qs, outs):
        assert np.array_equal(out, p.execute(q))


def _shapes(M):
    a = M.Threshold(2, over=("s0", "s1", "s2"))
    b = M.Threshold(5, over=("s3", "s4", "s5"))
    c = M.Threshold(2, over=("s0", "s1"))
    return [a, b, c, M.And(a, M.Not(M.Col("s0"))), M.And(b, M.Not(M.Col("s7"))),
            M.Interval(1, 3), M.Weighted((1, 2), 2, over=("s0", "s1")),
            M.AndNot(M.Parity(over=("s0", "s1")), M.Or(M.Col("s1"), M.Col("s2")))]


def test_shape_bucket_drops_names_keeps_arity():
    got = [TS.shape_bucket(q) for q in _shapes(TQ)]
    assert got == [RS.shape_bucket(q) for q in _shapes(RQ)]
    assert got[0] == got[1] and got[0] != got[2] and got[3] == got[4]


# -- batcher thread ----------------------------------------------------------

def test_threaded_mode_serves_concurrent_clients():
    bits = _bits(n=8, r=512, seed=11)
    p = Pair(bits, window=0.001)
    pool = [lambda M: M.Interval(2, 6), lambda M: M.Threshold(2, over=("s0", "s3", "s6")),
            lambda M: M.And(M.Col("s1"), M.Not(M.Col("s2")))]
    refs = [p.execute(make) for make in pool]
    before = set(threading.enumerate())
    for server, M in ((p.rs, RQ), (p.ts, TQ)):
        results: list = [None] * 4
        server.start()
        try:
            def client(ci, server=server, M=M, results=results):
                futs = [server.submit(pool[(ci + j) % len(pool)](M)) for j in range(9)]
                results[ci] = [u32(f.result(WAIT_S)) for f in futs]

            threads = [threading.Thread(target=client, args=(ci,)) for ci in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(WAIT_S)
            assert not any(t.is_alive() for t in threads), "a client thread hung"
        finally:
            batcher = server._thread
            stopper = threading.Thread(target=server.stop)
            stopper.start()
            stopper.join(WAIT_S)
            assert not stopper.is_alive(), "stop() hung"
            assert batcher is None or not batcher.is_alive()
        for ci, got in enumerate(results):
            for j, arr in enumerate(got):
                assert np.array_equal(arr, refs[(ci + j) % len(pool)])
        info = server.info()
        assert info["served"] == 36 and info["pending"] == 0
    assert set(threading.enumerate()) <= before, "a thread outlived the test"


# -- plan memo ---------------------------------------------------------------

def test_plan_memo_hit_miss_and_clear():
    bits = _bits()
    idx = TQ.BitmapIndex.from_dense(bits, names=_names(8), device="cpu")
    ridx = RQ.BitmapIndex.from_dense(jnp.asarray(bits), names=_names(8))
    base = TQ.plan_memo_info()
    q = TQ.Threshold(3, over=("s0", "s2", "s4", "s6"))
    p0 = idx.explain(q)
    p1 = idx.explain(TQ.Threshold(3, over=("s6", "s4", "s2", "s0")))  # semantic twin
    r0 = ridx.explain(RQ.Threshold(3, over=("s0", "s2", "s4", "s6")))
    assert (p0.memo, p1.memo) == ("miss", "hit")
    assert p1.algorithm == p0.algorithm == r0.algorithm
    info = TQ.plan_memo_info()
    assert info["misses"] >= base["misses"] + 1 and info["hits"] >= base["hits"] + 1
    TQ.clear_compiled_cache()
    cleared = TQ.plan_memo_info()
    assert cleared["entries"] == 0 and cleared["hits"] == 0 and cleared["misses"] == 0
    assert idx.explain(q).memo == "miss"


def test_server_info_reports_plan_memo_counters():
    p = Pair(_bits(), window=0)
    p.serve_many([lambda M: M.Interval(2, 4)])
    assert set(p.info()["plan_memo"]) >= {"hits", "misses", "entries"}


# -- kernel libraries: one build, one library, whatever the threads --------

class _Fn:
    """A stand-in for a ``ctypes`` function: takes ``argtypes``/``restype``."""

    def __init__(self, fn):
        self.fn = fn

    def __call__(self, *args):
        return self.fn(*args)


class _FakeLib:
    """A stand-in for a loaded kernel library: the self-checks that
    ``_lib()`` runs at load get the host's answers, everything else 0."""

    def __init__(self):
        from repro_torch.core.bytecode import PROG_CHUNK
        from repro_torch.kernels.tiled_scan import block_shared_bytes

        self._answers = {
            "circuit_eval_program_bytes": lambda: PROG_CHUNK * 16,
            "tiled_block_shared_bytes": lambda m, b, tw, regs, rows: block_shared_bytes(
                b, tw, regs, m, rows),
        }

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        fn = _Fn(self._answers.get(name, lambda *a: 0))
        setattr(self, name, fn)
        return fn


@pytest.fixture
def fake_builds(monkeypatch):
    """``build_libraries`` and ``ctypes.CDLL`` of ``kernels._build`` mocked
    (no ``nvcc`` here), every loaded library forgotten; yields the lists of
    builds and loads."""
    import sys

    from repro_torch.kernels import _build
    from repro_torch.kernels import threshold_ssum as K
    from repro_torch.kernels import tiled_scan as TK

    builds, loads = [], []

    def build(names):
        builds.extend(names)
        time.sleep(0.05)  # a build takes a while: the other threads pile up

    def cdll(path):
        loads.append(path)
        return _FakeLib()

    monkeypatch.setattr(_build, "build_libraries", build)
    monkeypatch.setattr(_build, "ctypes", types.SimpleNamespace(CDLL=cdll))
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(K, "_LIB", None)
    monkeypatch.setattr(TK, "_LIB", None)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        yield builds, loads
    finally:
        sys.setswitchinterval(interval)


def _race(calls, n_threads=8) -> list:
    """Run every callable of ``calls`` from ``n_threads`` threads released
    together; returns each thread's results, in ``calls`` order."""
    barrier = threading.Barrier(n_threads)
    got: list = [None] * n_threads

    def run(i):
        barrier.wait(WAIT_S)
        got[i] = [c() for c in calls]

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(WAIT_S)
    assert not any(t.is_alive() for t in threads), "a loading thread hung"
    return got


@pytest.mark.parametrize("entry", ["load_library", "wrapper_lib"])
def test_concurrent_first_loads_share_one_library(fake_builds, entry):
    """Threads that load a kernel for the first time together run one build
    and one load a library, and all get the same library object."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import threshold_ssum as K
    from repro_torch.kernels import tiled_scan as TK

    builds, loads = fake_builds
    if entry == "load_library":
        calls = [lambda: _build.load_library("circuit_eval"),
                 lambda: _build.load_library("tiled_block")]
    else:
        calls = [K._lib, TK._lib]
    got = _race(calls)
    assert sorted(builds) == ["circuit_eval", "tiled_block"]
    assert len(loads) == 2
    for j, name in enumerate(("circuit_eval", "tiled_block")):
        assert all(row[j] is _build._LIBS[name] for row in got)
    if entry == "wrapper_lib":
        assert K._LIB is _build._LIBS["circuit_eval"] and TK._LIB is _build._LIBS["tiled_block"]
