"""The traffic generator: every seed gets the same sizes and kinds."""
import collections
import itertools
import json

import numpy as np
import pytest

import _bench
from bench import templates

TRAFFIC = {name: json.loads((_bench.ROOT / "bench" / "traffic" / f"{name}.json").read_text())
           for name in ("recurring16", "adhoc8", "live20")}
SEEDS = [0, 1, 2**31 + 11, 2**62 + 3, -5]


def _cost(spec):
    """Everything about a spec but which columns it reads."""
    return (spec["kind"], len(templates.columns_read(spec)), spec.get("t"), spec.get("lo"),
            spec.get("hi"), tuple(sorted(spec.get("weights", ()))))


@pytest.mark.parametrize("name", sorted(TRAFFIC))
def test_recurring_cost_composition_is_the_same_for_every_seed(name):
    t = TRAFFIC[name]
    comps = {tuple(sorted(map(_cost, templates.recurring(t, 64, s)))) for s in SEEDS}
    assert len(comps) == 1
    (comp,) = comps
    assert sorted(c[:2] for c in comp) == sorted((k, n) for n in t["columns_read"]
                                                 for k in t["kinds"])
    assert len(comp) == 16


@pytest.mark.parametrize("seed", SEEDS)
def test_order_holds_every_template_once_a_block(seed):
    seq = list(itertools.islice(templates.order(16, seed), 16 * 20))
    for b in range(20):
        assert sorted(seq[16 * b:16 * (b + 1)]) == list(range(16))


@pytest.mark.parametrize("seed", SEEDS)
def test_adhoc_blocks_hold_every_pair_once_and_never_repeat(seed):
    t = TRAFFIC["adhoc8"]
    specs = list(itertools.islice(templates.adhoc(t, 64, seed, "client0"), 16 * 10))
    for b in range(10):
        block = collections.Counter(map(_cost, specs[16 * b:16 * (b + 1)]))
        assert block == collections.Counter(map(_cost, specs[:16]))
        assert sorted(c[:2] for c in block) == sorted(
            (k, n) for n in t["columns_read"] for k in t["kinds"])
    keys = {json.dumps(s, sort_keys=True) for s in specs}
    assert len(keys) == len(specs)


@pytest.mark.parametrize("name", sorted(TRAFFIC))
def test_spec_parameters_lie_in_the_issue_ranges(name):
    """t in [2, n - 1] (andnot: [2, n - 2]), lo in [2, n / 4], hi in (lo, n / 2],
    weights 1 to 4 with t half their total."""
    t = TRAFFIC[name]
    rng = np.random.default_rng(0)
    for n in t["columns_read"]:
        for kind in t["kinds"]:
            s = templates.draw_spec(rng, kind, n, 64, t["params"])
            cols = templates.columns_read(s)
            assert len(cols) == len(set(cols)) == n
            if kind == "threshold":
                assert 2 <= s["t"] <= n - 1
            elif kind == "interval":
                assert 2 <= s["lo"] <= n // 4 and s["lo"] < s["hi"] <= n // 2
            elif kind == "weighted":
                assert all(1 <= w <= 4 for w in s["weights"]) and s["t"] == sum(s["weights"]) // 2
                assert sorted(s["weights"]) == sorted([1, 2, 3, 4] * (n // 4))
            else:
                assert 2 <= s["t"] <= n - 2 and s["drop"] not in s["members"]


def test_update_batches():
    t = TRAFFIC["live20"]
    r = 1 << 20
    batches = templates.updates(t, r, 64, 9, 400)
    assert all(c1 == c2 and np.array_equal(a1, a2) and np.array_equal(b1, b2)
               for (c1, a1, b1), (c2, a2, b2) in zip(batches, templates.updates(t, r, 64, 9, 400)))
    pos = np.concatenate([np.concatenate([s, c]) for _, s, c in batches])
    assert all(len(s) == len(c) == 32 for _, s, c in batches)
    assert pos.min() >= 0 and pos.max() < r
    recent = (pos >= r - r // 16).mean()
    assert 0.78 < recent < 0.86  # 80 % drawn recent, plus the uniform draws that land there


def _ladder(n):
    """Section 5.4's SMALL-COMPETITIONS thresholds for N = n: T' = 3, then
    3 T' / 2 while T' <= N/2 + 1, and each mirror N + 2 - T'."""
    ts, tp = set(), 3
    while tp <= n // 2 + 1:
        ts |= {tp, n + 2 - tp}
        tp = 3 * tp // 2
    return {t for t in ts if 2 <= t <= n - 1}


@pytest.mark.parametrize("name", sorted(TRAFFIC))
def test_thresholds_are_a_rung_of_the_papers_ladder_and_its_mirror(name):
    p = TRAFFIC[name]["params"]
    for n in TRAFFIC[name]["columns_read"]:
        a, b = p["threshold"]["t"][str(n)], p["andnot"]["t"][str(n)]
        assert {a, b} <= _ladder(n) and a + b == n + 2
    for kind in ("threshold", "andnot"):
        ts = [(t, int(n)) for n, t in p[kind]["t"].items()]
        assert any(t <= n // 2 for t, n in ts) and any(t > n // 2 for t, n in ts)
    assert "5.4" in TRAFFIC[name]["grid"]
