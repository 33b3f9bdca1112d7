"""core.bitmaps of the port against the reference: same words, bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import t_words, u32, words
from repro.core import bitmaps as RB
from repro_torch.core import bitmaps as TB
from repro_torch.device import resolve_device, to_numpy_u32, to_words


@pytest.mark.parametrize("r", [1, 31, 32, 33, 95, 1000, 2048 + 17])
def test_pack_unpack_match_reference(r):
    rng = np.random.default_rng(r)
    bits = rng.random((3, r)) < 0.5
    bits[:, -1] = True  # the last valid bit, often bit 31 of nothing
    ref = np.asarray(RB.pack(jnp.asarray(bits)))
    got = TB.pack(bits, "cpu")
    assert got.dtype == torch.int32
    assert np.array_equal(u32(got), ref)
    back = TB.unpack(got, r)
    assert back.dtype == torch.bool and np.array_equal(back.numpy(), bits)
    assert np.array_equal(TB.unpack(got).numpy(), np.asarray(RB.unpack(jnp.asarray(ref))))


def test_words_with_top_bit_set_survive_the_boundary():
    arr = np.array([[0x80000000, 0xFFFFFFFF, 0x7FFFFFFF, 0, 1, 0xDEADBEEF]], np.uint32)
    t = to_words(arr, "cpu")
    assert t.dtype == torch.int32 and t[0, 0].item() == -(2**31) and t[0, 1].item() == -1
    assert np.array_equal(to_numpy_u32(t), arr)
    # logical, not arithmetic, shifts in unpack
    assert np.array_equal(TB.unpack(t).numpy(), np.asarray(RB.unpack(jnp.asarray(arr))))
    # a copy: the tensor never aliases the caller's array
    arr[0, 0] = 5
    assert t[0, 0].item() == -(2**31)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_popcount_and_cardinality_match_reference(seed):
    arr = words(4, 257, seed)
    arr[0, :4] = [0xFFFFFFFF, 0x80000000, 0, 0x80000001]
    t = t_words(arr)
    assert np.array_equal(TB.popcount(t).numpy(), np.asarray(RB.popcount(jnp.asarray(arr))))
    assert np.array_equal(TB.cardinality(t).numpy(), np.asarray(RB.cardinality(jnp.asarray(arr))))
    assert np.allclose(TB.density(t, 257 * 32).numpy(), np.asarray(RB.density(jnp.asarray(arr), 257 * 32)))


@pytest.mark.parametrize("r,nw", [(1, 1), (31, 1), (32, 1), (33, 2), (64, 3), (1000, 32)])
def test_tail_masks_match_reference(r, nw):
    assert TB.tail_mask(r) == RB.tail_mask(r)
    assert TB.n_words_for(r) == RB.n_words_for(r)
    ref = RB.packed_tail_mask(r, nw)
    got = TB.packed_tail_mask(r, nw, "cpu")
    if ref is None:
        assert got is None
    else:
        assert np.array_equal(u32(got), np.asarray(ref))


@pytest.mark.parametrize("r", [40, 64, 95])
def test_bitwise_ops_match_reference(r):
    nw = RB.n_words_for(r)
    a, b = words(2, nw, r)
    ta, tb = t_words(a), t_words(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    for name in ("bitmap_and", "bitmap_or", "bitmap_xor", "bitmap_andnot"):
        assert np.array_equal(u32(getattr(TB, name)(ta, tb)), np.asarray(getattr(RB, name)(ja, jb))), name
    assert np.array_equal(u32(TB.bitmap_not(ta)), np.asarray(RB.bitmap_not(ja)))
    assert np.array_equal(u32(TB.bitmap_not(ta, r)), np.asarray(RB.bitmap_not(ja, r)))


def test_positions_roundtrip_matches_reference():
    rng = np.random.default_rng(5)
    r = 3000
    pos = np.unique(rng.integers(0, r, 200))
    pos = np.union1d(pos, [31, 63, r - 1])
    ref = np.asarray(RB.from_positions(pos, r))
    got = TB.from_positions(pos, r, "cpu")
    assert np.array_equal(u32(got), ref)
    assert np.array_equal(TB.to_positions_np(got), RB.to_positions_np(jnp.asarray(ref)))
    assert np.array_equal(TB.to_positions_np(got), pos)


def test_device_rule():
    assert resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device(None)
        with pytest.raises(RuntimeError):
            resolve_device("cuda")
        with pytest.raises(RuntimeError):
            TB.pack(np.zeros((1, 8), bool))  # device=None means the card
    with pytest.raises(TypeError):
        to_words(torch.zeros(3, dtype=torch.int64), "cpu")
