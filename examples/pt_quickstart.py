"""Quickstart: composable queries over a bitmap index (the PyTorch port).

    PYTHONPATH=src python examples/pt_quickstart.py [--device cpu]

The port's counterpart of ``examples/quickstart.py``, on the CUDA card
unless ``--device`` names another device.  The paper's motivating example:
stores x products, one bitmap per store of the products it has on sale.
The headline query from the abstract -- "on sale in 2 to 10 stores" -- is
one expression; because every result is again a bitmap, queries compose
and feed back in as virtual columns.
"""
import argparse

import numpy as np

from repro_torch.core.bitmaps import unpack
from repro_torch.device import resolve_device, to_numpy_u32
from repro_torch.query import And, BitmapIndex, Col, Interval, Not, Parity, Threshold

N_STORES, N_PRODUCTS = 12, 10_000


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the CUDA card)")
    dev = resolve_device(ap.parse_args(argv).device)
    rng = np.random.default_rng(0)

    # each store's "on sale" set as one index column; building the index
    # tile-classifies every column (the storage engine's build-time work)
    on_sale = rng.random((N_STORES, N_PRODUCTS)) < 0.15
    idx = BitmapIndex.from_dense(
        on_sale, names=[f"store{i}" for i in range(N_STORES)], device=dev
    )
    stats = idx.stats()  # free: computed once when the TileStore was built
    print(f"{idx.n} stores x {idx.r} products, "
          f"cardinalities: {stats.cardinalities[:6]}...")
    print(f"tile stats: {stats.clean_fraction:.0%} clean tiles, "
          f"{stats.dirty_words} dirty words stored")

    # per-container tile census for the abstract's 2..10-stores query: dirty
    # tiles live as dense words, sparse position lists or run intervals --
    # whichever is cheapest (compressed_words <= the dense dirty pack)
    census = idx.store.container_census()
    print(f"container census               : {census['dense']} dense / "
          f"{census['sparse']} sparse / {census['run']} run tiles, "
          f"{census['storage_words']} words stored "
          f"(dense pack would be {census['dense_equiv_words']})")

    # the abstract's query: on sale in 2 to 10 stores -- with the chosen plan
    # and its estimated cost (words touched) from the tile-stats cost model
    plan = idx.explain(Interval(2, 10))
    print(f"plan for Interval(2, 10)      : {plan.algorithm} "
          f"(~{plan.cost:.0f} words touched; {plan.rationale})")
    mid = idx.execute(Interval(2, 10))
    print(f"on sale in 2..10 stores       : {idx.count(Interval(2, 10)):6d} products")

    # no string algorithm= argument anywhere: the planner picks the backend
    plan = idx.explain(Threshold(2))
    print(f"planner for Threshold(2)      : {plan.algorithm} ({plan.rationale})")

    # queries compose: in 2..10 stores AND NOT in store 0, one compiled circuit
    q = And(Interval(2, 10), Not(Col("store0")))
    print(f"...and not in store 0         : {idx.count(q):6d}")

    # operators build the same trees: & | ~ -
    q2 = Interval(2, 10) & ~Threshold(11)
    print(f"in 2..10 but never 11+        : {idx.count(q2):6d}")

    # independent queries batch into ONE multi-output circuit: one launch
    hot, odd, rare = idx.execute_many([Threshold(2), Parity(), Interval(1, 1)])
    print(f"threshold/parity/exactly-once : "
          f"{int(unpack(hot, idx.r).sum())} / {int(unpack(odd, idx.r).sum())} / "
          f"{int(unpack(rare, idx.r).sum())}")

    # results are bitmaps: feed one back in as a virtual column and keep
    # querying (add_column returns a NEW index; the old one stays valid) --
    # the result column is itself compressed into the cheapest container
    idx = idx.add_column("hot", hot)
    promo = idx.execute(And(Col("hot"), Col("store0")))
    print(f"hot AND in store 0            : {int(unpack(promo, idx.r).sum()):6d}")
    rare = idx.execute(Interval(6, 12))  # a handful of products match
    idx = idx.add_column("rare", rare)
    c = idx.store.container_census(slots=[idx.names.index("rare")])
    print(f"'rare' stored as              : {c['sparse']} sparse / {c['run']} run "
          f"/ {c['dense']} dense tiles ({c['storage_words']} words)")

    # sub-queries can even vote inside a threshold: 2 of these 3 criteria
    panel = Threshold(2, over=(Col("store0"), Col("store1"), Interval(4, 10)))
    print(f"2 of [s0, s1, broadly on sale]: {idx.count(panel):6d}")

    # shard the row space (host-sequenced here; pass devices= for the
    # shard-map path): still ONE compiled circuit, but a per-shard plan from
    # each shard's own tile statistics -- clean shards skip tiles, dense
    # shards sweep
    sidx = idx.shard(n_shards=4)
    print(f"sharded plan (4 row shards)   : {sidx.plan(Interval(2, 10)).backends}")
    sres = sidx.execute(Interval(2, 10))  # per-shard bitmaps, gather only to print
    assert np.array_equal(
        to_numpy_u32(sres.gather()), to_numpy_u32(idx.execute(Interval(2, 10)))
    )
    print("sharded == unsharded - OK")

    # verify against per-position counts
    counts = on_sale.sum(0)
    assert (unpack(mid, idx.r).cpu().numpy() == ((counts >= 2) & (counts <= 10))).all()
    assert (unpack(hot, idx.r).cpu().numpy() == (counts >= 2)).all()
    assert (unpack(promo, idx.r).cpu().numpy() == ((counts >= 2) & on_sale[0])).all()
    print("verified against position counts - OK")

    # -- streaming updates: no rebuilds -------------------------------------
    # the index so far is frozen at build time; production sees sustained
    # writes.  StreamingIndex absorbs them as tile deltas and keeps
    # registered query results fresh incrementally (repro_torch.stream)
    from repro_torch.stream import StreamingIndex

    stream = StreamingIndex(
        BitmapIndex.from_dense(
            on_sale, names=[f"store{i}" for i in range(N_STORES)], device=dev
        )
    )
    stream.materialize("mid", Interval(2, 10))  # the abstract's query, maintained
    before = stream.count("mid")

    # pick a product on sale in exactly 1 store; ONE store putting it on sale
    # moves it into the "2 to 10 stores" band -- the materialized result
    # flips without a rebuild, by re-running the circuit over ONE tile
    product = int(np.nonzero(counts == 1)[0][0])
    store = next(f"store{i}" for i in range(N_STORES) if not on_sale[i, product])
    stream.set_bits(store, [product])
    after = stream.count("mid")  # incrementally-maintained count: O(1) read
    info = stream.view_info("mid")
    print(f"product {product} goes on sale in {store}: "
          f"'in 2..10 stores' {before} -> {after} "
          f"({info['tiles_refreshed']} tile refreshed, "
          f"{info['words_touched']} words touched, 0 rebuilds)")
    assert after == before + 1
    assert stream.delta_stats()["compactions"] == 0  # pure delta, base untouched

    # -- persistence: save the index, kill the process state, re-serve ------
    # the durable StreamingIndex logs every mutation batch to a WAL ahead of
    # applying it; checkpoint() folds the log into a .bmsnap snapshot.  A new
    # process recovers the snapshot as np.memmap views (zero copy -- words
    # page in only as queries touch them) and replays the WAL tail, views
    # included (repro_torch.persist)
    import shutil
    import tempfile

    workdir = tempfile.mkdtemp(prefix="quickstart_persist_")
    stream.attach_durable(workdir)      # snapshot now, WAL from here on
    stream.set_bits("store1", [product])  # logged AND applied
    live_mid, live_total = stream.count("mid"), stream.count(Threshold(1))

    del stream, idx, sidx               # "kill" the in-memory state

    from repro_torch.stream import StreamingIndex as _SI  # fresh import, fresh process

    revived = _SI.recover(workdir, device=dev)  # memmap load + WAL replay
    print(f"recovered from {workdir}: 'in 2..10 stores' = {revived.count('mid')}"
          f" (view re-registered, WAL tail replayed)")
    assert revived.count("mid") == live_mid
    assert revived.count(Threshold(1)) == live_total
    revived.set_bits("store2", [product])  # the recovered index keeps serving
    print("recovered index keeps absorbing writes - OK")

    # -- serving: many clients, one coalescing front-end ---------------------
    # the abstract's query under load: concurrent clients submit to a
    # QueryServer, which collapses identical in-flight requests to ONE
    # execution, rides shape-bucketed micro-batches through execute_many
    # (its batcher thread runs on the index's device), and caches results
    # keyed on per-column versions -- a write invalidates exactly the
    # entries reading a touched column (repro_torch.serve)
    import threading

    from repro_torch.serve import QueryServer

    with QueryServer(revived, window=0.001) as server:
        requests = [Interval(2, 10), Interval(2, 10) & ~Col("store0"), Threshold(11)]

        def client():
            for f in [server.submit(q) for q in requests * 3]:
                f.result(30)

        clients = [threading.Thread(target=client) for _ in range(8)]
        for t in clients:
            t.start()
        for t in clients:
            t.join()
        served = server.info()
        print(f"served 8 clients x {len(requests) * 3} requests: "
              f"{served['executed']} executions "
              f"({served['cache_hits']} cache hits, {served['dedup_hits']} deduped, "
              f"{served['batches']} micro-batches)")
        assert served["served"] == 8 * len(requests) * 3
        assert served["executed"] <= len(requests) * 2  # dedup + cache did the rest

        baseline = to_numpy_u32(server.submit(Interval(2, 10)).result(30))
        revived.set_bits("store3", [product])  # invalidates only readers of store3
        fresh = to_numpy_u32(server.submit(Interval(2, 10)).result(30))
        print(f"write to store3 invalidated {server.info()['invalidations']} "
              f"cache entries; resubmit observes the new bits "
              f"({'changed' if not np.array_equal(baseline, fresh) else 'same count band'})")
    shutil.rmtree(workdir)


if __name__ == "__main__":
    main()
