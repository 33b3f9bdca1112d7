"""The port's copy of the sorted-list baselines (``core.listalgos``) against
the reference's, on the cases of ``tests/test_listalgos.py``: the same
numpy-seeded position lists into both, ``np.array_equal`` on the results."""
import numpy as np
import pytest

from repro.core import listalgos as RLA
from repro_torch.core import listalgos as TLA

NAMES = ("scancount_np", "wsort", "hashcnt", "wheap", "w2cti", "mgopt", "wmgsk", "dsk")


def _lists(n, r, card, seed=0):
    rng = np.random.default_rng(seed)
    return [np.sort(rng.choice(r, size=rng.integers(1, card), replace=False)) for _ in range(n)]


def _same(name, lists, t, r):
    want = np.asarray(getattr(RLA, name)(lists, t, r))
    got = np.asarray(getattr(TLA, name)(lists, t, r))
    assert got.dtype == want.dtype and np.array_equal(got, want), (name, t)


def test_the_port_exports_the_eight_functions():
    assert sorted(TLA.__all__) == sorted(RLA.__all__) == sorted(NAMES)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("n,r,card", [(5, 500, 200), (12, 2000, 400), (8, 300, 290)])
def test_equal_reference(name, n, r, card):
    lists = _lists(n, r, card, seed=n)
    for t in sorted({1, 2, 3, n // 2, n - 1, n, n + 1}):
        _same(name, lists, t, r)


@pytest.mark.parametrize("name", ("mgopt", "dsk", "wmgsk"))
def test_skewed_lists(name):
    """Pruning algorithms with very skewed list sizes (their favoured case)."""
    rng = np.random.default_rng(11)
    r = 5000
    lists = [np.sort(rng.choice(r, size=s, replace=False)) for s in (4000, 3500, 20, 15, 10)]
    for t in (4, 5):
        _same(name, lists, t, r)
        assert np.array_equal(getattr(TLA, name)(lists, t, r), TLA.scancount_np(lists, t, r))


@pytest.mark.parametrize("name", ("wheap", "wsort", "hashcnt", "w2cti", "mgopt", "dsk"))
def test_differential_fuzz(name):
    """Random families with empty lists, a single list, t = 1, N and above."""
    rng = np.random.default_rng(sum(map(ord, name)))
    for _trial in range(25):
        r = int(rng.integers(1, 400))
        n = int(rng.integers(1, 10))
        lists = [np.sort(rng.choice(r, size=int(rng.integers(0, max(r // 2, 1) + 1)),
                                    replace=False)) for _ in range(n)]
        for t in sorted({1, n, n + 1, n + 3, int(rng.integers(1, n + 2))}):
            _same(name, lists, t, r)


def test_dsk_mu_and_the_find_geq_gallop():
    rng = np.random.default_rng(5)
    lists = [np.sort(rng.choice(3000, size=s, replace=False)) for s in (2500, 900, 60, 40, 30, 8)]
    for mu in (0.01, 0.05, 0.5):
        for t in (2, 3, 5):
            want = RLA.dsk(lists, t, 3000, mu=mu)
            assert np.array_equal(TLA.dsk(lists, t, 3000, mu=mu), want)
    big = lists[0]
    for pos, val in ((0, 0), (3, int(big[100])), (10, 10**6), (len(big), 5)):
        assert TLA._find_geq(big, pos, val) == RLA._find_geq(big, pos, val)
