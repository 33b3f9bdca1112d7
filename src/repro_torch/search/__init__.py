"""`repro_torch.search`: similarity search and windowed analytics workloads.

The port of the reference's ``repro.search``, with the reference's exports.
Every index lives on ``device`` (default: the CUDA card); tokenizing,
candidate verification and the list views stay on the host, as in the
reference.  Sharded similarity indexes wait for ``ROADMAP.md`` Queue 1
item 10.

The paper's threshold queries ARE T-occurrence queries -- the engine of
approximate string/set similarity search -- and its symmetric-function
counts are the natural windowed-analytics primitive.  This package turns
both into first-class scenarios on the query/stream stack:

* :func:`build_qgram_index` / :class:`SimilarityIndex` -- q-gram (+
  length, + minhash-band) tokenizer columns over a string corpus, exact
  Sarawagi-Kirpal candidate generation (vacuous ``T <= 0`` handled
  correctly: the all-rows bitmap, never a clamp), verified
  :meth:`~SimilarityIndex.search` and adaptive
  :meth:`~SimilarityIndex.topk` with stepwise threshold relaxation;
* :class:`WindowedStream` -- sliding-window / time-decayed counts as
  materialized streaming views over an append-heavy event row space,
  with a :class:`WindowRetentionPolicy` retiring expired rows.

Quickstart::

    from repro_torch.search import build_qgram_index

    idx = build_qgram_index(["chateau margaux 1982", ...], q=2)  # on the card
    idx.search("chateau margeaux 1982", k=1)   # all matches within k
    idx.topk("margo", k=5)                     # 5 nearest, adaptive T
"""
from .similarity import (
    Candidates,
    Matches,
    SimilarityIndex,
    TopK,
    build_qgram_index,
    edit_distance,
)
from .tokenize import (
    MinHashParams,
    band_buckets,
    minhash_signature,
    qgrams,
    sk_threshold,
    token_hashes,
)
from .window import WindowedStream, WindowRetentionPolicy

__all__ = [
    "Candidates",
    "Matches",
    "MinHashParams",
    "SimilarityIndex",
    "TopK",
    "WindowRetentionPolicy",
    "WindowedStream",
    "band_buckets",
    "build_qgram_index",
    "edit_distance",
    "minhash_signature",
    "qgrams",
    "sk_threshold",
    "token_hashes",
]
