"""Every threshold backend of the port against the reference, and the
free-function shims (``core.threshold``, ``core.symmetric``,
``kernels.ops``).

The same numpy-seeded bits go into both packages (the port on
``device="cpu"``); results are bitmaps, so the comparison is
``np.array_equal`` on ``uint32`` words, with no tolerance.
"""
import importlib
import math
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import u32
from repro import query as RQ
from repro.core.bitmaps import pack as r_pack
from repro.core.deprecation import reset_legacy_shim_warning as r_reset_warning
from repro.core.threshold import _scancount as r_scancount
from repro.core.threshold import threshold as r_threshold
from repro.core.threshold import weighted_threshold as r_weighted_threshold
from repro.kernels import ops as r_ops
from repro.query.executors import run_threshold_backend as r_backend
from repro_torch import query as TQ
from repro_torch.convert import index_from_reference_arrays
from repro_torch.core import deprecation as t_deprecation
from repro_torch.core import symmetric as t_sym
from repro_torch.core.threshold import ALGORITHMS
from repro_torch.core.threshold import threshold as t_threshold
from repro_torch.core.threshold import weighted_threshold as t_weighted_threshold
from repro_torch.device import to_words
from repro_torch.kernels import ops as t_ops
from repro_torch.query.executors import THRESHOLD_BACKENDS
from repro_torch.query.executors import run_threshold_backend as t_backend

# the reference's ``repro.core`` re-exports functions over its module names
r_sym = importlib.import_module("repro.core.symmetric")

# (n, r, density): the grids of tests/test_threshold.py and
# tests/test_oracle_properties.py; most r end inside a word
GRID = sorted({
    (2, 40, 0.5), (5, 100, 0.3), (8, 64, 0.1), (16, 257, 0.7), (33, 1000, 0.05),
    (2, 31, 0.5), (3, 64, 0.9), (5, 100, 0.05), (9, 257, 0.3), (17, 130, 0.5),
    (33, 96, 0.7),
})
NEW_BACKENDS = ("looped", "csvckt", "rbmrg_block", "dsk")
# sum-of-products circuits grow as C(n, t): capped like the reference's tests
SOPCKT_MAX_TERMS = 300

_WORDS: dict = {}


def grid_words(n, r, density):
    """uint32[n, words] packed by the reference, and its scancount result for
    every T from 0 to n + 1 (eager, unjitted)."""
    key = (n, r, density)
    if key not in _WORDS:
        rng = np.random.default_rng(n * 7919 + r)
        bits = rng.random((n, r)) < density
        words = np.asarray(r_pack(jnp.asarray(bits)))
        oracle = {}
        for t in range(0, n + 2):
            oracle[t] = np.asarray(r_backend(jnp.asarray(words), t, "scancount")) \
                if t <= 0 or t > n else np.asarray(r_scancount(jnp.asarray(words), t))
        _WORDS[key] = (words, oracle)
    return _WORDS[key]


def test_algorithms_and_backends_name_the_same_set():
    assert set(ALGORITHMS) == set(THRESHOLD_BACKENDS)
    assert len(ALGORITHMS) == 14


@pytest.mark.parametrize("alg", ALGORITHMS)
@pytest.mark.parametrize("n,r,density", GRID)
def test_every_backend_equals_reference_for_every_t(n, r, density, alg):
    words, oracle = grid_words(n, r, density)
    tw = to_words(words, "cpu")
    for t in range(0, n + 2):
        if alg == "sopckt" and 0 < t <= n and math.comb(n, t) > SOPCKT_MAX_TERMS:
            continue
        if (alg == "wide_or" and 0 < t <= n and t != 1) or (
            alg == "wide_and" and 0 < t <= n and t != n
        ):
            with pytest.raises(ValueError, match=alg):
                r_backend(jnp.asarray(words), t, alg)
            with pytest.raises(ValueError, match=alg):
                t_backend(tw, t, alg)
            continue
        got = t_backend(tw, t, alg)
        assert got.dtype == torch.int32 and got.shape == (words.shape[1],)
        assert np.array_equal(u32(got), oracle[t]), f"{alg} n={n} t={t}"


@pytest.mark.parametrize("alg", NEW_BACKENDS)
@pytest.mark.parametrize("n,r,density", GRID)
def test_new_backends_equal_the_same_reference_backend(n, r, density, alg):
    """The four backends this slice ports, each against the reference's own
    implementation of the same name."""
    words, _oracle = grid_words(n, r, density)
    for t in sorted({2, (n + 1) // 2}):
        want = np.asarray(r_backend(jnp.asarray(words), t, alg))
        got = u32(t_backend(to_words(words, "cpu"), t, alg))
        assert np.array_equal(got, want), f"{alg} n={n} t={t}"


def test_looped_and_csvckt_bit_31_and_long_counters():
    """Words with bit 31 set (negative int32) and a count past the counter's
    second digit: the arithmetic shift never enters LOOPED / CSVCKT."""
    words = np.full((40, 3), 0x80000001, dtype=np.uint32)
    words[::3, 1] = 0xFFFFFFFF
    for alg in ("looped", "csvckt"):
        for t in (1, 13, 14, 39, 40):
            want = np.asarray(r_backend(jnp.asarray(words), t, alg))
            got = u32(t_backend(to_words(words, "cpu"), t, alg))
            assert np.array_equal(got, want), (alg, t)


@pytest.mark.parametrize("alg", ("ssum", "looped", "csvckt", "fused", "rbmrg_block", "dsk"))
def test_threshold_shim_equals_reference(alg):
    words, _ = grid_words(16, 257, 0.7)
    for t in (0, 1, 5, 16, 17):
        want = np.asarray(r_threshold(jnp.asarray(words), t, alg))
        got = u32(t_threshold(to_words(words, "cpu"), t, alg))
        assert np.array_equal(got, want), (alg, t)
    # a host array goes to the named device
    assert np.array_equal(u32(t_threshold(words, 5, alg, device="cpu")),
                          np.asarray(r_threshold(jnp.asarray(words), 5, alg)))


@pytest.mark.parametrize("weights", ([2, 1, 3], [0, 4, 1], [1, 1, 1]))
def test_weighted_threshold_shim_equals_reference(weights):
    rng = np.random.default_rng(sum(weights))
    bits = rng.random((3, 50)) < 0.5
    words = np.asarray(r_pack(jnp.asarray(bits)))
    for t in (1, 2, 3, 5, sum(weights), sum(weights) + 1):
        for alg in ("ssum", "looped"):
            want = np.asarray(r_weighted_threshold(jnp.asarray(words), weights, t, alg))
            got = u32(t_weighted_threshold(to_words(words, "cpu"), weights, t, alg))
            assert np.array_equal(got, want), (weights, t, alg)


def test_shims_validate_like_the_reference():
    words = to_words(np.zeros((4, 2), np.uint32), "cpu")
    with pytest.raises(TypeError):
        t_threshold(words, torch.tensor(2))
    with pytest.raises(ValueError, match="non-negative"):
        t_weighted_threshold(words, [1, -1, 1, 1], 2)
    with pytest.raises(ValueError, match="all weights zero"):
        t_weighted_threshold(words, [0, 0, 0, 0], 2)
    with pytest.raises(ValueError, match="unknown"):
        t_backend(words, 2, "no_such_backend")


def test_legacy_free_functions_equal_reference_and_warn_once():
    rng = np.random.default_rng(21)
    bits = rng.random((7, 300)) < 0.3
    words = np.asarray(r_pack(jnp.asarray(bits)))
    tw = to_words(words, "cpu")
    r = 300
    pairs = [
        (lambda: r_sym.symmetric(jnp.asarray(words), [w % 2 == 0 for w in range(8)], r=r),
         lambda: t_sym.symmetric(tw, [w % 2 == 0 for w in range(8)], r=r, device="cpu")),
        (lambda: r_sym.exactly(jnp.asarray(words), 2, r=r),
         lambda: t_sym.exactly(tw, 2, r=r, device="cpu")),
        (lambda: r_sym.interval(jnp.asarray(words), 2, 4, r=r),
         lambda: t_sym.interval(tw, 2, 4, r=r, device="cpu")),
        (lambda: r_sym.parity(jnp.asarray(words), r=r),
         lambda: t_sym.parity(tw, r=r, device="cpu")),
        (lambda: r_sym.majority(jnp.asarray(words), r=r),
         lambda: t_sym.majority(tw, r=r, device="cpu")),
        (lambda: r_ops.fused_threshold(jnp.asarray(words), 3),
         lambda: t_ops.fused_threshold(tw, 3, device="cpu")),
        (lambda: r_ops.fused_symmetric(jnp.asarray(words), [w == 3 for w in range(8)]),
         lambda: t_ops.fused_symmetric(tw, [w == 3 for w in range(8)], device="cpu")),
        (lambda: r_ops.fused_interval(jnp.asarray(words), 1, 5),
         lambda: t_ops.fused_interval(tw, 1, 5, device="cpu")),
        (lambda: r_ops.fused_weighted_threshold(jnp.asarray(words), [1, 2, 3, 1, 2, 3, 1], 6),
         lambda: t_ops.fused_weighted_threshold(tw, [1, 2, 3, 1, 2, 3, 1], 6, device="cpu")),
    ]
    r_reset_warning()
    t_deprecation.reset_legacy_shim_warning()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for ref_fn, port_fn in pairs:
            assert np.array_equal(u32(port_fn()), np.asarray(ref_fn()))
    ours = [w for w in caught if issubclass(w.category, DeprecationWarning)
            and "repro_torch.query" in str(w.message)]
    assert len(ours) == 1


def test_shim_routes_clean_heavy_data_through_the_tiled_path():
    """``fused_threshold`` on a transient index whose statistics favour
    skipping runs ``tiled_fused``, as the reference's does."""
    from _torch_port import clean_fraction_bits

    bits = clean_fraction_bits(8, 0.95, seed=5)
    words = np.asarray(r_pack(jnp.asarray(bits)))
    idx = TQ.BitmapIndex(words, device="cpu")
    assert idx.explain(TQ.Threshold(3)).algorithm == "tiled_fused"
    got = t_ops.fused_threshold(to_words(words, "cpu"), 3, device="cpu")
    assert np.array_equal(u32(got), np.asarray(r_ops.fused_threshold(jnp.asarray(words), 3)))


@pytest.fixture(scope="module")
def quickstart_pair():
    rng = np.random.default_rng(0)
    on_sale = rng.random((12, 10_000)) < 0.15
    names = [f"store{i}" for i in range(12)]
    ref = RQ.BitmapIndex.from_dense(jnp.asarray(on_sale), names=names)
    tor = index_from_reference_arrays(np.asarray(ref.columns), ref.names, ref.r, device="cpu")
    return ref, tor


@pytest.mark.parametrize("backend", NEW_BACKENDS)
def test_index_execute_new_backends_with_equal_last_info(quickstart_pair, backend):
    ref, tor = quickstart_pair
    for t in (0, 1, 2, 3, 6, 11, 12, 13):
        want = np.asarray(ref.execute(RQ.Threshold(t), backend=backend))
        got = u32(tor.execute(TQ.Threshold(t), backend=backend))
        assert np.array_equal(got, want), (backend, t)
        assert tor.last_info == ref.last_info, (backend, t)
    over = ("store7", "store1", "store10", "store4")
    want = np.asarray(ref.execute(RQ.Threshold(2, over=over), backend=backend))
    got = u32(tor.execute(TQ.Threshold(2, over=over), backend=backend))
    assert np.array_equal(got, want)
    assert tor.last_info == ref.last_info
    engine = "host" if backend == "dsk" else "dense"
    assert tor.last_info["engine"] == engine and tor.last_info["backend"] == backend
    with pytest.raises(ValueError, match="only executes bare Threshold"):
        tor.execute(TQ.Interval(2, 5), backend=backend)


@pytest.mark.parametrize("backend", NEW_BACKENDS)
def test_index_execute_many_new_backends(quickstart_pair, backend):
    """An explicit non-circuit override is honoured per query, as in the
    reference."""
    ref, tor = quickstart_pair
    ts = (2, 5, 9)
    want = ref.execute_many([RQ.Threshold(t) for t in ts], backend=backend)
    got = tor.execute_many([TQ.Threshold(t) for t in ts], backend=backend)
    for g, w in zip(got, want):
        assert np.array_equal(u32(g), np.asarray(w))
    assert tor.last_info == ref.last_info
