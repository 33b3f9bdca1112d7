"""The circuit kernel's module: the sweep of tests/test_kernel.py through the
reference's Pallas kernel (interpret mode, as its own tests run it on the
CPU), the port's ``run_circuit`` on ``device="cpu"`` (the kernel's plain
version, running the very program the CUDA kernel interprets) and the
counter oracles of both packages.

The interpret-mode sweep is thinned to keep this file's run time small: the
reference kernel runs one threshold per (n, n_words) cell instead of four;
the port and the oracles run all four.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import t_words, u32, words
from repro.core import circuits as RC
from repro.kernels import ref as RR
from repro.kernels.threshold_ssum import run_circuit_pallas, threshold_pallas
from repro_torch.core import circuits as TC
from repro_torch.core.weighted import build_weighted_threshold_circuit
from repro_torch.kernels import ref as TR
from repro_torch.kernels import threshold_ssum as K


@pytest.mark.parametrize("n", [2, 3, 5, 16, 64, 130])
@pytest.mark.parametrize("nw", [1, 7, 100, 1030])
def test_threshold_kernel_shape_sweep(n, nw):
    arr = words(n, nw, seed=n * 1000 + nw)
    t_arr = t_words(arr)
    before = K.launch_counts["circuit_eval"]
    for t in sorted({1, 2, n // 2, n}):
        got = u32(K.threshold_fused(arr, t, device="cpu"))
        assert np.array_equal(got, np.asarray(RR.threshold_ref(jnp.asarray(arr), t))), (n, nw, t)
        assert np.array_equal(got, u32(TR.threshold_ref(t_arr, t)))
    t = max(1, n // 2)
    pallas = run_circuit_pallas(jnp.asarray(arr), RC.build_threshold_circuit(n, t, "ssum"),
                                block_words=256, interpret=True)
    assert np.array_equal(np.asarray(pallas), u32(K.threshold_fused(arr, t, device="cpu")))
    assert K.launch_counts["circuit_eval"] == before  # the CPU never counts a launch


@pytest.mark.parametrize("n", [4, 9, 31])
def test_symmetric_kernel(n):
    rng = np.random.default_rng(4 + n)
    arr = words(n, 300, seed=n)
    truth = tuple(bool(x) for x in rng.integers(0, 2, n + 1))
    got = u32(K.threshold_fused(arr, truth=truth, device="cpu"))
    assert np.array_equal(got, np.asarray(RR.symmetric_ref(jnp.asarray(arr), truth)))
    assert np.array_equal(got, u32(TR.symmetric_ref(t_words(arr), truth)))
    pallas = threshold_pallas(jnp.asarray(arr), truth=truth, block_words=256, interpret=True)
    assert np.array_equal(got, np.asarray(pallas))


def test_interval_kernel():
    arr = words(12, 129, seed=5)
    truth = tuple(3 <= w <= 7 for w in range(13))
    got = u32(K.run_circuit(arr, TC.build_interval_circuit(12, 3, 7), device="cpu"))
    assert np.array_equal(got, np.asarray(RR.symmetric_ref(jnp.asarray(arr), truth)))
    pallas = run_circuit_pallas(jnp.asarray(arr), RC.build_interval_circuit(12, 3, 7), interpret=True)
    assert np.array_equal(got, np.asarray(pallas))


def test_treeadd_kernel_variant():
    arr = words(21, 500, seed=6)
    got = u32(K.threshold_fused(arr, 9, kind="treeadd", device="cpu"))
    assert np.array_equal(got, np.asarray(RR.threshold_ref(jnp.asarray(arr), 9)))
    pallas = threshold_pallas(jnp.asarray(arr), 9, kind="treeadd", interpret=True)
    assert np.array_equal(got, np.asarray(pallas))


@pytest.mark.parametrize("weights,t", [((3, 1, 4, 1, 5, 9, 2, 6), 12), ((1,) * 7, 4), ((100, 1, 1, 50), 51)])
def test_weighted_kernel(weights, t):
    n = len(weights)
    arr = words(n, 77, seed=n + t)
    got = u32(K.threshold_fused(arr, t, weights=weights, device="cpu"))
    pallas = threshold_pallas(jnp.asarray(arr), t, weights=weights, interpret=True)
    assert np.array_equal(got, np.asarray(pallas))
    bits = np.unpackbits(arr.view(np.uint8), axis=1, bitorder="little").astype(np.int64)
    want = np.packbits((np.asarray(weights)[:, None] * bits).sum(0) >= t, bitorder="little").view(np.uint32)
    assert np.array_equal(got, want)
    assert np.array_equal(got, u32(K.run_circuit(arr, build_weighted_threshold_circuit(list(weights), t),
                                                 device="cpu")))


@pytest.mark.parametrize("t", [0, -3, 8, 100])
def test_vacuous_thresholds_short_cut(t):
    arr = words(7, 19, seed=1)
    got = u32(K.threshold_fused(arr, t, device="cpu"))
    want = np.asarray(threshold_pallas(jnp.asarray(arr), t, interpret=True))
    assert np.array_equal(got, want)
    assert (got == (0xFFFFFFFF if t <= 0 else 0)).all()


def test_multi_output_run_matches_pallas():
    n = 16
    arr = words(n, 333, seed=2)
    tc = TC.Circuit(n, [], [])
    rc = RC.Circuit(n, [], [])
    for c, mod in ((tc, TC), (rc, RC)):
        bits = mod.sideways_sum_bits(c, list(range(n)))
        c.outputs = [mod.ge_const(c, bits, t) for t in range(1, 9)]
    got = K.run_circuit(arr, tc.optimized(), device="cpu")
    assert tuple(got.shape) == (8, 333) and got.dtype == torch.int32
    pallas = run_circuit_pallas(jnp.asarray(arr), rc.optimized(), interpret=True)
    assert np.array_equal(u32(got), np.asarray(pallas))


def test_strided_rows_and_row_subsets_need_no_copy():
    big = t_words(words(32, 200, seed=3))
    circ = TC.build_threshold_circuit(16, 5, "ssum")
    want = u32(TR.threshold_ref(big[::2], 5))
    assert np.array_equal(u32(K.run_circuit_cached(big[::2], circ)), want)
    assert np.array_equal(u32(K.run_circuit_cached(big, circ, rows=tuple(range(0, 32, 2)))), want)
    sl = big[:16, 3:150]
    assert np.array_equal(u32(K.run_circuit_cached(sl, circ)), u32(TR.threshold_ref(sl, 5)))


def test_program_cache_is_structural_and_bounded():
    K.clear_circuit_runners()
    a = TC.build_threshold_circuit(8, 3, "ssum")
    b = TC.build_threshold_circuit(8, 3, "ssum")
    assert K._program_for(a, None) is K._program_for(b, None)
    assert K._program_for(a, (7, 6, 5, 4, 3, 2, 1, 0)) is not K._program_for(a, None)
    assert len(K._CIRCUIT_RUNNERS) == 2 and K._CIRCUIT_RUNNERS_CAP == 1024
    K.clear_circuit_runners()
    assert not K._CIRCUIT_RUNNERS


# an H100's opt-in shared memory a block (232,448 bytes, compute capability
# 9.0) less the kernel's staged program chunk
H100_LIMIT = 232448 - 4096


def test_launch_shape_choice():
    # the most columns a thread while 128 threads fit, then the most threads
    assert K.pick_launch_shape(0, H100_LIMIT) == (256, 4)
    assert K.pick_launch_shape(49, H100_LIMIT) == (256, 4)  # the 64-column queries: 200,704 bytes
    assert K.pick_launch_shape(55, H100_LIMIT) == (256, 4)  # 225,280 bytes
    assert K.pick_launch_shape(56, H100_LIMIT) == (128, 4)  # 229,376 bytes do not fit
    assert K.pick_launch_shape(75, H100_LIMIT) == (128, 4)  # the 64-column Weighted
    assert K.pick_launch_shape(150, H100_LIMIT) == (128, 2)
    assert K.pick_launch_shape(300, H100_LIMIT) == (128, 1)
    assert K.pick_launch_shape(1000, H100_LIMIT) == (32, 1)
    with pytest.raises(ValueError, match="n_registers=5000"):
        K.pick_launch_shape(5000, H100_LIMIT)


@pytest.mark.parametrize("n_registers", [0, 1, 16, 25, 48, 49, 50, 74, 75, 150, 300, 1000, 1784])
def test_launch_shape_fits_and_follows_the_preference(n_registers):
    """The picked shape's register file fits, and no shape earlier in the
    preference order (more columns a thread, then more threads) does."""
    def fits(threads, vec):
        return n_registers * vec * threads * 4 <= H100_LIMIT

    shape = K.pick_launch_shape(n_registers, H100_LIMIT)
    order = [(t, v) for v, floor in K.SHAPE_PREFERENCE for t in K.THREAD_CHOICES if t >= floor]
    assert shape in order and fits(*shape)
    assert not any(fits(*earlier) for earlier in order[: order.index(shape)])


def test_wrapper_refuses_what_the_kernel_does_not_take():
    circ = TC.build_threshold_circuit(4, 2, "ssum")
    good = t_words(words(4, 10))
    p = K._program_for(circ, None)
    with pytest.raises(ValueError, match="CUDA tensor"):
        K._circuit_eval_cuda(good, p)  # a CPU tensor never reaches the kernel
    with pytest.raises(ValueError):
        K.run_circuit_cached(good[:3], circ)
    with pytest.raises(TypeError):
        K.run_circuit(torch.zeros((4, 10), dtype=torch.int64), circ, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            K.run_circuit(words(4, 10), circ)  # device=None means the card
        with pytest.raises(RuntimeError):
            K.threshold_fused(words(4, 10), 2)
