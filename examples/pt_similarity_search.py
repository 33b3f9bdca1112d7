"""Similarity queries over a q-gram index (the paper's 5 experiment shape),
in the PyTorch port.

    PYTHONPATH=src python examples/pt_similarity_search.py [--device cpu]

The port's counterpart of ``examples/similarity_search.py``, on the CUDA
card unless ``--device`` names another device.  Builds a bigram bitmap
index over a synthetic corpus with ``repro_torch.search.build_qgram_index``,
then answers approximate-match queries through the planner path: the
Sarawagi-Kirpal bound over a record's DISTINCT bigrams says every record
within edit distance k shares >= T = n_grams - k*q of the query's grams.
Candidates come out as a bitmap; edit-distance verification runs only on
candidates (the paper's screening pattern), and ``topk`` relaxes T stepwise
for nearest-neighbour queries.

Crucially, T can be <= 0 (short strings, generous k) -- then the filter
is VACUOUS and every record is a candidate.  Clamping ``T = max(1, ...)``
would silently drop true matches that share zero grams with the query;
the vacuous demo at the bottom keeps that case checked.
"""
import argparse
import time

import numpy as np

from repro_torch.core import listalgos as LA
from repro_torch.device import resolve_device
from repro_torch.search import build_qgram_index, edit_distance

Q = 2  # bigrams, as Ferro et al.
ALPHA = "abcdefghijklmnopqrstuvwxyz"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the CUDA card)")
    dev = resolve_device(ap.parse_args(argv).device)
    rng = np.random.default_rng(0)

    def rand_name():
        n = rng.integers(6, 14)
        return "".join(ALPHA[i] for i in rng.integers(0, 26, n))

    # corpus with planted near-duplicates
    corpus = [rand_name() for _ in range(4000)]
    target = corpus[123]
    corpus.append(target[:-1] + "x")          # distance 1
    corpus.append("q" + target[1:])           # distance 1
    corpus.append("qz")                       # shares ZERO bigrams with "zq"
    R = len(corpus)

    idx = build_qgram_index(corpus, q=Q, device=dev)
    print(f"corpus: {R} records, {len(idx.index.names)} tokenizer columns")

    k = 1  # edit-distance budget
    cand = idx.candidates(target, k)
    print(
        f"query {target!r}: {cand.n_grams} distinct bigrams, threshold T={cand.t}"
    )

    idx.candidates(target, k)  # warm the compiled-circuit cache
    t0 = time.perf_counter()
    cand = idx.candidates(target, k)  # a host bitmap: the device's work is done
    t_bitmap = time.perf_counter() - t0
    print(f"bitmap threshold  : {len(cand)} candidates in {t_bitmap * 1e3:.1f} ms")

    # the same T-occurrence query over the paper's integer-list competitor
    lists = idx.posting_lists(target)
    t0 = time.perf_counter()
    cands_list = LA.dsk(lists, cand.t, R)
    t_dsk = time.perf_counter() - t0
    print(f"DivideSkip (host) : {len(cands_list)} candidates in {t_dsk * 1e3:.1f} ms")
    assert np.array_equal(cand.ids, cands_list)

    matches = idx.search(target, k)
    print(f"verified matches within distance {k}: {sorted(matches.ids.tolist())}")
    assert {123, R - 3, R - 2} <= set(matches.ids.tolist())
    print("planted near-duplicates found - OK")

    # nearest neighbours by adaptive threshold relaxation: starts at the
    # exact T for k_edits=0 and relaxes stepwise, verifying only each step's
    # new band
    top = idx.topk(target, 3)
    print(
        f"top-3 neighbours: ids {top.ids.tolist()} at distances "
        f"{top.distances.tolist()} ({top.relaxations} relaxation steps, "
        f"{top.verified} verifications)"
    )
    assert top.ids.tolist()[0] == 123 and top.distances.tolist() == [0, 1, 1]

    # the vacuous-threshold case a clamp would get wrong: a 2-char query with
    # k=3 has T = n_grams - k*q <= 0, so NO record can be excluded -- the
    # planted "qz" (distance 2) shares zero bigrams with "zq" and a clamped
    # filter would silently drop it
    short = "zq"
    vac = idx.candidates(short, k=3)
    print(
        f"query {short!r} with k=3: T={vac.t} (vacuous={vac.vacuous}) -> "
        f"{len(vac)} candidates"
    )
    assert vac.vacuous and len(vac) == R, "non-positive T must candidate ALL rows"
    hits = idx.search(short, k=3)
    assert R - 1 in hits.ids.tolist(), "zero-shared-gram match must be found"
    assert all(edit_distance(short, corpus[i]) <= 3 for i in hits.ids.tolist())
    print(f"verified {len(hits.ids)} matches within distance 3 - vacuous case OK")


if __name__ == "__main__":
    main()
