"""The port's attention masks (``repro_torch.serve.masks``) and the paper's
synthetic datasets (``repro_torch.data``) against the reference.

The same numpy-seeded positions, documents and votes go to the reference's
``repro.serve.masks`` and to the port's (``device="cpu"``, where the
``fused`` head vote is K1's plain version); packed masks are held equal
word for word (``np.array_equal`` on ``uint32``), skip lists and their info
equal, and the generated datasets equal array for array.  The tolerance is
none.  These are the cases of ``tests/test_masks.py`` and the two
``paper_datasets`` cases of ``tests/test_data_planner.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.data.paper_datasets as RD
import repro.serve.masks as RM
import repro_torch.data as TD
import repro_torch.serve.masks as TM
from _torch_port import u32
from repro.core.bitmaps import pack as r_pack
from repro_torch.core.bitmaps import cardinality, pack, unpack
from repro_torch.core.blockrle import runcount


def test_composed_mask_matches_dense_logic_and_reference():
    rng = np.random.default_rng(0)
    n_kv = 300
    kv_pos = rng.permutation(n_kv).astype(np.int32)
    kv_pos[5] = -1  # empty slot
    doc = rng.integers(0, 3, n_kv).astype(np.int32)
    q_pos, window, q_doc = 200, 64, 1
    parts = (
        TM.causal_mask_bitmap(q_pos, kv_pos, device="cpu"),
        TM.window_mask_bitmap(q_pos, kv_pos, window, device="cpu"),
        TM.document_mask_bitmap(doc, q_doc, device="cpu"),
    )
    rparts = (
        RM.causal_mask_bitmap(q_pos, kv_pos),
        RM.window_mask_bitmap(q_pos, kv_pos, window),
        RM.document_mask_bitmap(doc, q_doc),
    )
    for a, b in zip(parts, rparts):
        assert np.array_equal(u32(a), u32(b))
    m = TM.compose_masks_all(*parts)
    assert np.array_equal(u32(m), u32(RM.compose_masks_all(*rparts)))
    expect = (kv_pos >= 0) & (kv_pos <= q_pos) & (q_pos - kv_pos < window) & (doc == q_doc)
    np.testing.assert_array_equal(unpack(m, n_kv).numpy(), expect)
    # a tensor is used where it lies
    kv_t = torch.as_tensor(kv_pos)
    assert np.array_equal(u32(TM.causal_mask_bitmap(q_pos, kv_t)), u32(parts[0]))


@pytest.mark.parametrize("t", [1, 3, 8])
def test_head_vote_threshold(t):
    rng = np.random.default_rng(1)
    n_pages = 256 + 7
    votes_bool = rng.random((8, n_pages)) < 0.2
    votes = pack(votes_bool, "cpu")
    kept = TM.head_vote_mask(votes, t)
    want = RM.head_vote_mask(r_pack(jnp.asarray(votes_bool)), t)
    assert np.array_equal(u32(kept), u32(want))
    np.testing.assert_array_equal(unpack(kept, n_pages).numpy(), votes_bool.sum(0) >= t)
    # numpy uint32 words go to the device named
    assert np.array_equal(u32(TM.head_vote_mask(u32(votes), t, device="cpu")), u32(kept))


def test_kv_tile_skiplist_skips_dead_tiles():
    n_kv = 32 * 64 * 8  # 8 tiles of 2048 positions
    live = np.zeros(n_kv, bool)
    live[:2048] = True  # tile 0 fully live
    live[3 * 2048 + 17] = True  # tile 3 one bit
    mask = pack(live, "cpu")
    keep, info = TM.kv_tile_skiplist(mask, n_kv, tile_positions=2048)
    rkeep, rinfo = RM.kv_tile_skiplist(r_pack(jnp.asarray(live)), n_kv, tile_positions=2048)
    assert keep.tolist() == rkeep.tolist() == [0, 3]
    assert info == rinfo
    assert info["skipped_tiles"] == 6
    assert 0.74 < info["skip_fraction"] <= 0.76


def test_device_none_is_the_card():
    if torch.cuda.is_available():  # decided inside the test, not at import
        pytest.skip("a CUDA device is present: this checks the no-card refusal")
    with pytest.raises(RuntimeError, match="CUDA"):
        TM.causal_mask_bitmap(3, np.arange(8))
    with pytest.raises(RuntimeError, match="CUDA"):
        TD.synthetic_dataset("uniform", "dense", n_bitmaps=2, card=10)


@pytest.mark.parametrize("kind", ["uniform", "clustered"])
@pytest.mark.parametrize("density", ["dense", "moderate"])
def test_synthetic_dataset_equal_reference(kind, density):
    packed, r, lists = TD.synthetic_dataset(kind, density, n_bitmaps=4, card=300, seed=1111,
                                            device="cpu")
    rpacked, rr, rlists = RD.synthetic_dataset(kind, density, n_bitmaps=4, card=300, seed=1111)
    assert r == rr and packed.dtype == np.uint32
    assert np.array_equal(packed, np.asarray(rpacked, np.uint32))
    assert all(np.array_equal(a, b) for a, b in zip(lists, rlists))


def test_synthetic_dataset_paper_5_3():
    """``tests/test_data_planner.py:44`` on the port."""
    packed, r, lists = TD.synthetic_dataset("uniform", "dense", n_bitmaps=8, card=500,
                                            seed=1111, device="cpu")
    assert r == 1500
    assert all(len(l) == 500 for l in lists)
    assert cardinality(torch.from_numpy(packed.view(np.int32))).tolist() == [500] * 8
    packed_c, r_c, lists_c = TD.synthetic_dataset("clustered", "dense", n_bitmaps=4, card=500,
                                                  device="cpu")
    assert runcount(torch.from_numpy(packed_c.view(np.int32))) < \
        runcount(torch.from_numpy(packed[:4].view(np.int32)))


@pytest.mark.parametrize("rid", [None, "first", 999_999])
def test_similarity_query_selects_containing_bitmaps(rid):
    """``tests/test_data_planner.py:56`` on the port, beside the reference."""
    rng = np.random.default_rng(0)
    lists = [np.sort(rng.choice(1000, 100, replace=False)) for _ in range(20)]
    rid = int(lists[3][0]) if rid == "first" else rid
    for n in (5, 40):
        sel, got_rid = TD.similarity_query(lists, n=n, rid=rid)
        assert (sel, got_rid) == RD.similarity_query(lists, n=n, rid=rid)
        assert len(sel) == n
        if rid is not None and rid < 1000:
            assert all(got_rid in set(lists[i].tolist()) for i in set(sel))
