"""Typed ExecInfo: ONE executor-accounting schema shared by every backend.

Before this module each backend reported a different ad-hoc dict (or
``None``), and the sharded path merged by hand-picked keys -- a new
counter added to the tiled executor was silently dropped at 8 shards.
Now:

* every backend returns an ExecInfo built by :func:`make_exec_info`,
  which fills defaults for every schema key and REJECTS unknown keys
  (adding a counter forces a schema entry, and the schema entry defines
  how it merges);
* :func:`merge_exec_infos` folds per-shard infos by schema -- summable
  counters add, nested word-kind dicts add key-wise, labels collect,
  ratios are recomputed from the merged numerators/denominators.  No
  key present in a shard info can be dropped by the merge.

The schema is the paper's words-touched accounting (Table 4's case
split, generalised to containers) plus dispatch costs: ``launches``
prices kernel dispatch, ``words_touched`` is the roofline traffic term
(gathered input words + written output words) that the planner's
``Plan.cost`` predicts and an observability layer compares against.
"""
from __future__ import annotations

__all__ = ["EXEC_INFO_SCHEMA", "make_exec_info", "merge_exec_infos"]

# merge kinds: how each key folds across shards
_SUM = "sum"            # integer counter: adds
_MAX = "max"            # per-query shape (same on every shard): max
_LABEL = "label"        # string tag: scalar if unanimous, sorted list else
_DICT_SUM = "dict_sum"  # {category: counter}: key-wise addition
_RATIO = "ratio"        # recomputed from merged fields (numerator, denominator)

EXEC_INFO_SCHEMA: dict[str, tuple] = {
    "backend": (_LABEL, ""),
    "engine": (_LABEL, ""),
    "n_tiles": (_SUM, 0),
    "selected_tiles": (_SUM, 0),
    "n_outputs": (_MAX, 1),
    "signatures": (_SUM, 0),
    "residual_signatures": (_SUM, 0),
    "const_tiles": (_SUM, 0),
    "case3_tiles": (_SUM, 0),
    "event_tiles": (_SUM, 0),
    "densified_tiles": (_SUM, 0),
    "dirty_words_gathered": (_SUM, 0),
    "compressed_words_gathered": (_SUM, 0),
    "decode_words": (_SUM, 0),
    "total_words": (_SUM, 0),
    "words_touched": (_SUM, 0),
    "launches": (_SUM, 0),
    "words_by_kind": (_DICT_SUM, {"dense": 0, "sparse": 0, "run": 0}),
    "work_fraction": (_RATIO, ("dirty_words_gathered", "total_words")),
}


def _default(kind: str, dflt):
    if kind == _DICT_SUM:
        return dict(dflt)
    if kind == _RATIO:
        return 0.0
    return dflt


def make_exec_info(backend: str, **fields) -> dict:
    """A full ExecInfo dict: every schema key present, defaults filled.

    Unknown keys raise -- the schema is the single registration point, so
    a counter can never exist without a defined merge rule.
    """
    unknown = set(fields) - set(EXEC_INFO_SCHEMA)
    if unknown:
        raise KeyError(
            f"unknown ExecInfo keys {sorted(unknown)}; add them to "
            "EXEC_INFO_SCHEMA with a merge rule first"
        )
    info = {
        key: _default(kind, dflt)
        for key, (kind, dflt) in EXEC_INFO_SCHEMA.items()
    }
    info["backend"] = backend
    for key, val in fields.items():
        kind = EXEC_INFO_SCHEMA[key][0]
        if kind == _DICT_SUM:
            info[key].update(val)
        else:
            info[key] = val
    return info


def merge_exec_infos(infos) -> dict:
    """Fold shard-local ExecInfos into one, by schema -- never by key list.

    Associative and commutative for every numeric field (plain integer
    addition / max), so shard order and grouping cannot change the
    result.  Keys outside the schema present in any input raise rather
    than silently vanish.
    """
    infos = [i for i in infos if i is not None]
    if not infos:
        return make_exec_info("")
    for i in infos:
        unknown = set(i) - set(EXEC_INFO_SCHEMA)
        if unknown:
            raise KeyError(
                f"ExecInfo with unregistered keys {sorted(unknown)}; "
                "the schema must know how to merge every key"
            )
    out = {}
    for key, (kind, dflt) in EXEC_INFO_SCHEMA.items():
        vals = [i[key] for i in infos if key in i]
        if kind == _SUM:
            out[key] = sum(vals) if vals else dflt
        elif kind == _MAX:
            out[key] = max(vals) if vals else dflt
        elif kind == _LABEL:
            uniq = sorted({v for v in vals if v})
            out[key] = uniq[0] if len(uniq) == 1 else uniq
        elif kind == _DICT_SUM:
            acc = dict(dflt)
            for v in vals:
                for k2, n in v.items():
                    acc[k2] = acc.get(k2, 0) + n
            out[key] = acc
    for key, (kind, dflt) in EXEC_INFO_SCHEMA.items():
        if kind == _RATIO:
            num, den = dflt
            out[key] = out[num] / max(1, out[den])
    return out
