"""Differential fuzzing of the port's persistence path against the reference.

Hypothesis drives random column mixes (dense, sparse, runny, all-zero,
all-one, mixed, partial final tile) and random mutation batches through
both packages -- the port on ``device="cpu"`` -- and holds the words equal
(``np.array_equal``, no tolerance):

  * save -> load -> every ``ALGORITHMS`` backend, container-enabled and
    legacy all-dense, with the two packages' files byte-identical;
  * ``StreamingIndex`` checkpoint/recover with random batches and a
    checkpoint at a random point (pre- and post-compaction);
  * the WAL truncated at a random byte offset recovers exactly the
    surviving prefix of batches.

These are the unsharded properties of ``tests/test_persist_fuzz.py``.
"""
import numpy as np
import pytest

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from _torch_port import u32  # noqa: E402
from repro import persist as RPer  # noqa: E402
from repro import query as RQ  # noqa: E402
from repro_torch import persist as TPer  # noqa: E402
from repro_torch import query as TQ  # noqa: E402
from repro_torch.core.bitmaps import unpack  # noqa: E402
from repro_torch.core.threshold import ALGORITHMS  # noqa: E402
from repro_torch.stream import CompactionPolicy, StreamingIndex  # noqa: E402

SETTINGS = dict(max_examples=6, deadline=None)
TW = 8
SPAN = TW * 32

COLUMN_KINDS = ("dense", "sparse", "runny", "all_zero", "all_one", "mixed")


def _column(rng, kind, r):
    bits = np.zeros(r, bool)
    if kind == "all_one":
        bits[:] = True
    elif kind == "dense":
        bits[:] = rng.random(r) < 0.5
    elif kind == "sparse":
        k = int(rng.integers(1, max(2, r // 64)))
        bits[rng.choice(r, min(k, r), replace=False)] = True
    elif kind == "runny":
        for _ in range(int(rng.integers(1, 5))):
            a = int(rng.integers(0, r))
            b = int(rng.integers(a + 1, r + 1))
            bits[a:b] = True
    elif kind == "mixed":
        for t0 in range(0, r, SPAN):
            bits[t0 : t0 + SPAN] = _column(
                rng, COLUMN_KINDS[int(rng.integers(0, 4))], min(SPAN, r - t0)
            )
    return bits


@st.composite
def column_mix(draw, max_n=6, max_tiles=4):
    n = draw(st.integers(2, max_n))
    n_tiles = draw(st.integers(1, max_tiles))
    tail = draw(st.sampled_from([0, 1, 37, SPAN // 2]))
    seed = draw(st.integers(0, 2**31 - 1))
    kinds = draw(st.lists(st.sampled_from(COLUMN_KINDS), min_size=n, max_size=n))
    rng = np.random.default_rng(seed)
    return np.stack([_column(rng, k, n_tiles * SPAN + tail) for k in kinds])


@st.composite
def mutation_batches(draw, n, r, max_batches=4):
    batches = []
    for _ in range(draw(st.integers(1, max_batches))):
        seed = draw(st.integers(0, 2**31 - 1))
        k = draw(st.integers(1, 16))
        rng = np.random.default_rng(seed)
        cols = rng.integers(0, n, k)
        pos = rng.integers(0, r, k)
        on = rng.random(k) < 0.5
        last = {int(c) * r + int(p): i for i, (c, p) in enumerate(zip(cols, pos))}
        sel = np.asarray(sorted(last.values()))
        batches.append((cols[sel], pos[sel], on[sel]))
    return batches


def _apply(stream, names, batch):
    cols, pos, on = batch
    sets = {names[c]: pos[on & (cols == c)] for c in np.unique(cols[on])}
    clears = {names[c]: pos[~on & (cols == c)] for c in np.unique(cols[~on])}
    stream.update(sets=sets or None, clears=clears or None)


def _stream(bits, names, d=None):
    idx = TQ.BitmapIndex.from_dense(bits, names, tile_words=TW, device="cpu")
    return StreamingIndex(idx, policy=CompactionPolicy(auto=False), durable_dir=d)


@given(column_mix(), st.booleans(), st.data())
@settings(**SETTINGS)
def test_loaded_store_every_algorithm(tmp_path_factory, bits, containers, data):
    n, r = bits.shape
    t = data.draw(st.integers(1, n))
    d = tmp_path_factory.mktemp("fuzz")
    names = [f"c{i}" for i in range(n)]
    tor = TQ.BitmapIndex.from_dense(bits, names, tile_words=TW, containers=containers,
                                    device="cpu")
    ref = RQ.BitmapIndex.from_dense(bits, names, tile_words=TW, containers=containers)
    TPer.save(tor, d / "t.bmsnap")
    RPer.save(ref, d / "r.bmsnap")
    assert (d / "t.bmsnap").read_bytes() == (d / "r.bmsnap").read_bytes()
    loaded = TPer.load_index(d / "r.bmsnap", device="cpu", verify=True)
    expect = bits.sum(0) >= t
    for alg in ALGORITHMS:
        if (alg == "wide_or" and t != 1) or (alg == "wide_and" and t != n):
            continue
        got = loaded.execute(TQ.Threshold(t), backend=alg)
        np.testing.assert_array_equal(
            unpack(got, r).numpy(), expect, err_msg=f"containers={containers} alg={alg} t={t}")
        assert np.array_equal(u32(got), u32(ref.execute(RQ.Threshold(t), backend=alg)))


@given(column_mix(max_n=4, max_tiles=3), st.data())
@settings(**SETTINGS)
def test_stream_recover_differential(tmp_path_factory, bits, data):
    n, r = bits.shape
    names = [f"c{i}" for i in range(n)]
    batches = data.draw(mutation_batches(n, r))
    ckpt_after = data.draw(st.integers(0, len(batches)))
    compact_before_ckpt = data.draw(st.booleans())
    d = tmp_path_factory.mktemp("fuzz") / "durable"
    s = _stream(bits, names, d)
    live = _stream(bits, names)
    hi = max(1, n - 1)
    for x in (s, live):
        x.materialize("mid", TQ.Interval(1, hi))
    for i, b in enumerate(batches):
        _apply(s, names, b)
        _apply(live, names, b)
        if i + 1 == ckpt_after:
            if compact_before_ckpt:
                s.compact()
            s.checkpoint()
    rec = StreamingIndex.recover(d, device="cpu")
    assert rec.wal_version == s.wal_version
    for q in (TQ.Threshold(max(1, n // 2)), TQ.Col("mid")):
        assert np.array_equal(u32(rec.execute(q)), u32(live.execute(q))), (q, ckpt_after)
    assert rec.count("mid") == live.count("mid")
    counts = np.asarray(bits, np.int64)
    for c, p, o in (x for b in batches for x in zip(*b)):
        counts[c, p] = o
    want = (counts.sum(0) >= 1) & (counts.sum(0) <= hi)
    np.testing.assert_array_equal(unpack(rec.execute(TQ.Col("mid")), r).numpy(), want)


@given(column_mix(max_n=3, max_tiles=2), st.data())
@settings(**SETTINGS)
def test_wal_random_truncation_recovers_prefix(tmp_path_factory, bits, data):
    n, r = bits.shape
    names = [f"c{i}" for i in range(n)]
    batches = data.draw(mutation_batches(n, r, max_batches=3))
    d = tmp_path_factory.mktemp("fuzz") / "durable"
    s = _stream(bits, names, d)
    for b in batches:
        _apply(s, names, b)
    wal_path = d / "wal.bmwal"
    raw = wal_path.read_bytes()
    cut = data.draw(st.integers(12, len(raw)))
    wal_path.write_bytes(raw[:cut])
    with TPer.WriteAheadLog(wal_path) as wal:
        surviving = wal.records
    with RPer.WriteAheadLog(wal_path) as wal:
        assert wal.records == surviving
    wal_path.write_bytes(raw[:cut])
    rec = StreamingIndex.recover(d, device="cpu")
    live = _stream(bits, names)
    for b in batches[:surviving]:
        _apply(live, names, b)
    q = TQ.Threshold(max(1, n // 2))
    assert np.array_equal(u32(rec.execute(q)), u32(live.execute(q))), (cut, surviving)
