"""Tokenizer column families: q-grams and minhash bands.

The port's own copy of the reference's ``repro.search.tokenize`` (host
numpy and ``hashlib``; it imports nothing of the reference): its grams,
hashes, signatures and buckets equal the reference's byte for byte.

A similarity index is "just" a bitmap index whose columns are tokens: one
bitmap per q-gram (records containing that gram) and/or one bitmap per
(minhash band, bucket) pair (records whose band signature hashes there).
Everything downstream -- candidate generation, adaptive top-k, windowed
counts -- is then threshold/symmetric queries over those columns, which is
exactly how the paper frames T-occurrence queries (section 1: approximate
string/set similarity search as the home application).

The q-gram side follows Ferro et al. / Sarawagi & Kirpal: strings are
sentinel-padded with ``#``/``$`` so a string of length L yields L + q - 1
gram *positions*.  Columns are set-valued (a bitmap either contains the
record or not), so the threshold bound must be stated over DISTINCT grams
-- see :func:`sk_threshold` for the exact form and its vacuous case.

Minhash is the standard banding scheme over 64-bit token hashes: ``H``
hash functions grouped into ``bands`` bands of ``H // bands`` rows; two
sets with Jaccard similarity ``s`` share any given band with probability
``s ** rows_per_band``.  Hashing is content-stable (blake2b, fixed seeds),
never Python ``hash`` -- signatures must not depend on PYTHONHASHSEED.
"""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np

__all__ = [
    "qgrams",
    "sk_threshold",
    "MinHashParams",
    "token_hashes",
    "minhash_signature",
    "band_buckets",
]

#: sentinel characters padding string ends (Ferro et al. section 5)
PAD_START = "#"
PAD_END = "$"

# Mersenne prime 2^61 - 1: the classic universal-hash modulus -- products
# of 61-bit values fit python ints exactly and numpy uint64 after reduction
_MERSENNE = (1 << 61) - 1


def qgrams(s: str, q: int = 2) -> frozenset:
    """The DISTINCT q-grams of ``s`` with sentinel padding.

    Padding guarantees ``len(s) + q - 1`` gram *positions*; the returned
    set collapses repeats (a bitmap column is set-valued), so its size can
    be smaller -- thresholds over these columns must use the set size, not
    the positional count (:func:`sk_threshold`).
    """
    if q < 1:
        raise ValueError(f"q must be >= 1, got {q}")
    padded = PAD_START * (q - 1) + s + PAD_END * (q - 1)
    return frozenset(padded[i : i + q] for i in range(len(padded) - q + 1))


def sk_threshold(n_grams: int, q: int, k: int) -> int:
    """The Sarawagi-Kirpal q-gram count bound for edit distance ``k``.

    A record within edit distance ``k`` of the query shares at least

        ``T = n_grams - k * q``

    of the query's ``n_grams`` distinct q-grams: one edit rewrites at most
    ``q`` gram positions, so it can remove at most ``q`` distinct grams
    from the intersection.  (For gram *multisets* the same bound reads
    ``|s| + q - 1 - k*q``; bitmap columns are sets, so the set form is the
    one that is actually exact here.)

    **The bound can be non-positive** -- short strings, large edit budgets
    -- and then the filter is VACUOUS: sharing zero grams is consistent
    with being within distance ``k``, so every record is a candidate.
    Callers must treat ``T <= 0`` as "no filter" (all rows).  Clamping to
    ``max(1, T)`` instead silently drops every true match that shares no
    gram with the query -- the false-negative bug this module exists to
    bury.  This function deliberately returns the raw, possibly
    non-positive value.
    """
    return int(n_grams) - int(k) * int(q)


# ---------------------------------------------------------------------------
# Minhash banding
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MinHashParams:
    """Shape of the minhash-band column family.

    ``n_hashes`` minwise hash functions split into ``bands`` bands of
    ``n_hashes // bands`` rows each; every band hashes to one of
    ``buckets`` buckets, giving ``bands * buckets`` columns.
    """

    n_hashes: int = 16
    bands: int = 4
    buckets: int = 32
    seed: int = 0

    def __post_init__(self):
        if self.n_hashes % self.bands:
            raise ValueError(
                f"n_hashes ({self.n_hashes}) must divide into bands ({self.bands})"
            )

    @property
    def rows_per_band(self) -> int:
        return self.n_hashes // self.bands


def token_hashes(tokens) -> np.ndarray:
    """Stable uint64 content hashes of a token iterable (sorted, distinct)."""
    out = {
        int.from_bytes(
            hashlib.blake2b(str(t).encode("utf-8"), digest_size=8).digest(), "little"
        )
        for t in tokens
    }
    return np.fromiter(out, dtype=np.uint64, count=len(out))


def _hash_coeffs(n_hashes: int, seed: int) -> tuple:
    rng = np.random.default_rng(seed)
    a = rng.integers(1, _MERSENNE, size=n_hashes, dtype=np.int64)
    b = rng.integers(0, _MERSENNE, size=n_hashes, dtype=np.int64)
    return a, b


def minhash_signature(tokens, params: MinHashParams) -> np.ndarray:
    """uint64[n_hashes] minwise signature of a token set.

    ``h_i(x) = (a_i * x + b_i) mod (2^61 - 1)`` over the token content
    hashes; an empty token set gets the all-max sentinel signature (it can
    never collide with a non-empty one).
    """
    xs = token_hashes(tokens)
    if xs.size == 0:
        return np.full(params.n_hashes, np.iinfo(np.uint64).max, dtype=np.uint64)
    a, b = _hash_coeffs(params.n_hashes, params.seed)
    # exact 61-bit universal hash via python ints (object dtype keeps the
    # products exact; shapes are tiny -- |tokens| x n_hashes)
    xo = xs.astype(object)[:, None]
    hv = (a.astype(object)[None, :] * xo + b.astype(object)[None, :]) % _MERSENNE
    return np.min(hv, axis=0).astype(np.uint64)


def band_buckets(signature: np.ndarray, params: MinHashParams) -> tuple:
    """Per-band bucket ids of a signature: ``tuple[int]`` of length
    ``params.bands``, each in ``[0, params.buckets)``."""
    sig = np.asarray(signature, dtype=np.uint64)
    if sig.shape != (params.n_hashes,):
        raise ValueError(f"signature shape {sig.shape} != ({params.n_hashes},)")
    rows = params.rows_per_band
    out = []
    for band in range(params.bands):
        chunk = sig[band * rows : (band + 1) * rows]
        digest = hashlib.blake2b(chunk.tobytes(), digest_size=8).digest()
        out.append(int.from_bytes(digest, "little") % params.buckets)
    return tuple(out)
