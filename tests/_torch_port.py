"""Shared helpers of the tests/test_torch_*.py parity tests.

Every test feeds the same numpy-seeded bits to the JAX reference (``repro``)
and to the PyTorch port (``repro_torch``, on ``device="cpu"``) and compares
packed ``uint32`` words with ``np.array_equal``: results are bitmaps, so the
tolerance is none.
"""
import numpy as np
import torch

from repro_torch.device import to_numpy_u32, to_words

TILE_BITS = 64 * 32


def words(n, nw, seed=0):
    """uint32[n, nw] random words (top bits set about half the time)."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, (n, nw), dtype=np.uint32)


def t_words(arr) -> torch.Tensor:
    return to_words(arr, "cpu")


def u32(x) -> np.ndarray:
    """A port result (tensor) or a reference result (jax array) as numpy uint32."""
    if isinstance(x, torch.Tensor):
        return to_numpy_u32(x)
    return np.asarray(x, dtype=np.uint32)


def clean_fraction_bits(n, clean_fraction, seed, n_tiles=5, tail_bits=700):
    """Columns with ~clean_fraction all-zero/all-one tiles + a partial tile."""
    rng = np.random.default_rng(seed)
    r = n_tiles * TILE_BITS + tail_bits
    bits = np.zeros((n, r), bool)
    for i in range(n):
        for tj in range(n_tiles + 1):
            lo, hi = tj * TILE_BITS, min((tj + 1) * TILE_BITS, r)
            u = rng.random()
            if u < clean_fraction / 2:
                pass
            elif u < clean_fraction:
                bits[i, lo:hi] = True
            else:
                bits[i, lo:hi] = rng.random(hi - lo) < 0.35
    return bits


def container_mix_bits(n, seed, n_tiles=6, tail_bits=333):
    """Columns whose dirty tiles are a mix of sparse (a few bits), runny (a
    few long runs) and dense (35% random) content, plus clean tiles."""
    rng = np.random.default_rng(seed)
    r = n_tiles * TILE_BITS + tail_bits
    bits = np.zeros((n, r), bool)
    for i in range(n):
        for tj in range(n_tiles + 1):
            lo, hi = tj * TILE_BITS, min((tj + 1) * TILE_BITS, r)
            kind = rng.integers(0, 5)
            if kind == 0:
                continue
            if kind == 1:
                bits[i, lo:hi] = True
            elif kind == 2:  # sparse
                pos = rng.integers(lo, hi, size=rng.integers(1, 20))
                bits[i, pos] = True
            elif kind == 3:  # a few runs
                for _ in range(rng.integers(1, 4)):
                    a = rng.integers(lo, hi)
                    bits[i, a:min(hi, a + rng.integers(1, 400))] = True
            else:
                bits[i, lo:hi] = rng.random(hi - lo) < 0.35
    return bits


def stream_pair(bits, *, tile_words=64, policy=None, durable=(None, None), n_shards=None):
    """The same bits as a reference ``StreamingIndex`` and a port one (on
    ``device="cpu"``), columns ``c0..c{n-1}``; ``policy`` holds
    ``CompactionPolicy`` keywords (default ``auto=False``), ``durable`` the
    two ``durable_dir`` arguments; ``n_shards`` row-shards both bases."""
    import jax.numpy as jnp

    from repro import query as RQ
    from repro import stream as RSt
    from repro_torch import query as TQ
    from repro_torch import stream as TSt

    names = [f"c{i}" for i in range(bits.shape[0])]
    kw = {"auto": False} if policy is None else dict(policy)
    rbase = RQ.BitmapIndex.from_dense(jnp.asarray(bits), names, tile_words=tile_words)
    tbase = TQ.BitmapIndex.from_dense(bits, names, tile_words=tile_words, device="cpu")
    if n_shards is not None:
        rbase, tbase = rbase.shard(n_shards=n_shards), tbase.shard(n_shards=n_shards)
    ref = RSt.StreamingIndex(rbase, policy=RSt.CompactionPolicy(**kw), durable_dir=durable[0])
    tor = TSt.StreamingIndex(tbase, policy=TSt.CompactionPolicy(**kw), durable_dir=durable[1])
    return ref, tor


def gathered(res):
    """A result as a single packed row: a sharded one is gathered."""
    return res.gather() if hasattr(res, "shards") else res


def same_plan(rp, tp):
    """A plan, or per-shard plans (``ShardedPlan``), equal to the reference's."""
    if hasattr(rp, "plans"):
        assert len(tp.plans) == len(rp.plans)
        for a, b in zip(tp.plans, rp.plans):
            same_plan(b, a)
        return
    assert (tp.algorithm, tp.cost, tp.candidates) == (rp.algorithm, rp.cost, rp.candidates)


def same_answer(ref, tor, make_query, **kw):
    """Execute ``make_query(module)`` -- built once from the reference's
    ``repro.query`` and once from ``repro_torch.query`` -- on a reference
    and a port index (or streaming index, sharded or not) and hold the
    words, the plan and ``last_info`` equal.  Returns the words."""
    from repro import query as RQ
    from repro_torch import query as TQ

    rq, tq = make_query(RQ), make_query(TQ)
    want = u32(gathered(ref.execute(rq, **kw)))
    got = u32(gathered(tor.execute(tq, **kw)))
    assert np.array_equal(got, want), (rq, kw)
    ridx = ref.index() if hasattr(ref, "index") else ref
    tidx = tor.index() if hasattr(tor, "index") else tor
    assert tidx.last_info == ridx.last_info, (rq, kw)
    if "backend" not in kw:
        same_plan(ref.explain(rq), tor.explain(tq))
    return got
