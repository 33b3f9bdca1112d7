"""The port's continuous-batching decode engine (``repro_torch.serve.engine``)
and its command line (``repro_torch.launch.serve``) against the reference's.

Both engines serve the same weights (the reference's ``init_params``,
loaded into the port with ``lm_params_from_reference``) on the same
requests, on the CPU in float32.  Emitted tokens, ``step_count``, free and
draining slots after every step, and ``_slot_version`` (one bump a submit
or step) are held EQUAL: tokens are argmaxes of logits that agree to about
1e-5, far from a tie on these inputs.  Batched output is also held equal
to the port's own unbatched greedy decode (prefill + ``decode_step`` with
one position).  These are the cases of ``tests/test_serve.py`` and the
sharded-slots case of ``tests/test_sharded.py`` (``devices=["cpu"] * 8``
in place of the 8-device mesh).  Reference engines are built once per
configuration (a module-scoped cache): each jit-compiles its decode step.
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import repro.serve as RS
import repro_torch.obs as TO
import repro_torch.serve as TS
from _torch_lm import np_tree
from repro.configs import get_config as r_config
from repro.models import init_params as r_init
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_reference
from repro_torch.models import decode_step, forward
from repro_torch.query import And, Col, Not

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
ARCH = "qwen3-1.7b"
_MODELS: dict = {}


def models(arch, seed=0):
    """(reference cfg, reference params, port cfg, port model), cached."""
    if (arch, seed) not in _MODELS:
        rcfg, tcfg = r_config(arch, reduced=True), get_config(arch, reduced=True)
        if rcfg.moe:  # no capacity drops, as tests/test_serve.py
            rcfg = dataclasses.replace(rcfg, capacity_factor=float(rcfg.n_experts))
            tcfg = dataclasses.replace(tcfg, capacity_factor=float(tcfg.n_experts))
        rp = r_init(rcfg, jax.random.PRNGKey(seed))
        tp = lm_params_from_reference(np_tree(rp), tcfg, device="cpu")
        _MODELS[arch, seed] = (rcfg, rp, tcfg, tp)
    return _MODELS[arch, seed]


def engines(arch=ARCH, slots=4, max_seq=64, seed=0, **port_kw):
    rcfg, rp, tcfg, tp = models(arch, seed)
    return (RS.ServeEngine(rcfg, rp, batch_slots=slots, max_seq=max_seq),
            TS.ServeEngine(tcfg, tp, batch_slots=slots, max_seq=max_seq, device="cpu", **port_kw))


def reqs(mod, prompts, max_new):
    return [mod.Request(rid=i, prompt=list(p), max_new=max_new) for i, p in enumerate(prompts)]


def greedy_unbatched(arch, prompt, max_new, max_seq=64, seed=0):
    """The port's unbatched greedy decode: prefill, then decode_step at one
    (scalar) position."""
    _, _, cfg, tp = models(arch, seed)
    toks = torch.tensor(prompt, dtype=torch.long)[None, :]
    _, caches, _ = forward(tp, cfg, {"tokens": toks}, mode="prefill", max_seq=max_seq)
    out, cur, pos = [], toks[:, -1:], len(prompt)
    for _ in range(max_new):
        logits, caches = decode_step(tp, cfg, caches, cur, pos)
        cur = logits.argmax(-1)
        out.append(int(cur[0, 0]))
        pos += 1
    return out


def slot_oracle(eng):
    """Free and draining slots from the request table (a Python set oracle)."""
    free = [i for i, r in enumerate(eng.requests) if r is None]
    near = [i for i, r in enumerate(eng.requests)
            if r is not None and eng.pos[i] >= eng.max_seq - eng._near_margin]
    return free, near


PROMPTS = [[1, 2, 3], [9, 8, 7, 6], [5]]
_DRAINED: dict = {}


def drained_reference(arch=ARCH, prompts=PROMPTS, max_new=4, slots=4):
    key = (arch, tuple(map(tuple, prompts)), max_new, slots)
    if key not in _DRAINED:
        rcfg, rp, _, _ = models(arch)
        eng = RS.ServeEngine(rcfg, rp, batch_slots=slots, max_seq=64)
        done = eng.run_until_drained(reqs(RS, prompts, max_new))
        _DRAINED[key] = ({r.rid: r.out for r in done}, [r.rid for r in done], eng.step_count)
    return _DRAINED[key]


def test_batched_matches_reference_and_unbatched():
    want, order, steps = drained_reference()
    _, tp_eng = engines()
    done = tp_eng.run_until_drained(reqs(TS, PROMPTS, 4))
    assert {r.rid: r.out for r in done} == want
    assert [r.rid for r in done] == order
    assert tp_eng.step_count == steps
    for i, p in enumerate(PROMPTS):
        assert want[i] == greedy_unbatched(ARCH, p, 4)


def test_lockstep_slot_queries_and_versions():
    """5 requests through 2 slots with a short cap: admissions, completions
    and positions crossing the near-limit margin.  After every submit and
    step both engines agree on emitted tokens, free and draining slots and
    a composed selection, each equals the request-table oracle, and
    ``_slot_version`` moved by exactly one."""
    ref, tor = engines(slots=2, max_seq=16)
    pending_r = reqs(RS, [[i + 1, 2, 3] for i in range(5)], 10)
    pending_t = reqs(TS, [[i + 1, 2, 3] for i in range(5)], 10)
    steps = 0
    busy = And(Col("occupied"), Not(Col("near_limit")))
    from repro.query import And as RAnd, Col as RCol, Not as RNot

    rbusy = RAnd(RCol("occupied"), RNot(RCol("near_limit")))
    while pending_t or any(r is not None for r in tor.requests):
        assert ref.free_slots() == tor.free_slots()
        while pending_t and tor.free_slots():
            v = tor._slot_version
            assert tor.submit(pending_t.pop(0)) and ref.submit(pending_r.pop(0))
            assert tor._slot_version == v + 1
        v = tor._slot_version
        assert tor.step() == ref.step()
        steps += 1
        assert tor._slot_version == v + 1 == ref._slot_version
        free, near = slot_oracle(tor)
        assert tor.free_slots() == ref.free_slots() == free
        assert tor.draining_slots() == ref.draining_slots() == near
        assert tor.select_slots(busy) == ref.select_slots(rbusy)
        assert steps < 100
    assert tor.step_count == ref.step_count == steps
    assert tor.slot_index(near_limit_margin=16).count(Col("near_limit")) == \
        ref.slot_index(near_limit_margin=16).count(RCol("near_limit"))


def test_continuous_batching_reuses_slots():
    want, order, steps = drained_reference(prompts=[[i + 1, 2] for i in range(5)], max_new=3,
                                           slots=2)
    _, _, tcfg, tp = models(ARCH)
    eng = TS.ServeEngine(tcfg, tp, batch_slots=2, max_seq=64, device="cpu")
    done = eng.run_until_drained(reqs(TS, [[i + 1, 2] for i in range(5)], 3))
    assert {r.rid: r.out for r in done} == want and [r.rid for r in done] == order
    assert eng.step_count == steps and 9 <= steps <= 20


def test_step_coalesces_slot_updates_into_one_version():
    _, _, tcfg, tp = models(ARCH)
    tor = TS.ServeEngine(tcfg, tp, batch_slots=4, max_seq=64, device="cpu")
    for i in range(3):
        assert tor.submit(TS.Request(rid=i, prompt=[i + 1, 2], max_new=1))
    assert tor.free_slots() == [3]
    v0 = tor._slot_version
    tor.step()  # all three requests complete in this one step
    assert tor._slot_version == v0 + 1
    assert tor.free_slots() == [0, 1, 2, 3]
    from repro_torch.stream import StreamingIndex

    assert isinstance(tor._slot_stream, StreamingIndex)


def test_submit_replaces_the_whole_cache_row():
    """A request admitted into a slot a longer one used leaves nothing of
    it: every position past the new prompt is -1 again."""
    _, _, tcfg, tp = models(ARCH)
    tor = TS.ServeEngine(tcfg, tp, batch_slots=1, max_seq=32, device="cpu")
    tor.run_until_drained([TS.Request(rid=0, prompt=list(range(1, 11)), max_new=6)])
    assert tor.submit(TS.Request(rid=1, prompt=[4, 5], max_new=2))
    cpos = tor.cache[0][2][0].tolist()
    assert cpos[:2] == [0, 1] and all(p == -1 for p in cpos[2:])


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "mixtral-8x22b", "rwkv6-3b"])
def test_engine_across_mixer_families(arch):
    """Ring-KV (local) with RG-LRU, MoE, and RWKV state through the engine:
    the reference engine's tokens, and the port's unbatched greedy decode."""
    prompts = [[1, 2, 3], [7, 5]]
    rcfg, rp, tcfg, tp = models(arch, seed=3)
    ref = RS.ServeEngine(rcfg, rp, batch_slots=2, max_seq=64)
    want = {r.rid: r.out for r in ref.run_until_drained(reqs(RS, prompts, 3))}
    tor = TS.ServeEngine(tcfg, tp, batch_slots=2, max_seq=64, device="cpu")
    got = {r.rid: r.out for r in tor.run_until_drained(reqs(TS, prompts, 3))}
    assert got == want
    assert tor.step_count == ref.step_count
    for i, p in enumerate(prompts):
        assert got[i] == greedy_unbatched(arch, p, 3, seed=3)


def test_sharded_slots_on_eight_devices():
    """256 slots, the slot index row-sharded over ``devices=["cpu"] * 8``
    (``tests/test_sharded.py::test_serve_engine_sharded_slots_subprocess``
    on an 8-device mesh); the engine's tokens equal the reference's."""
    from repro_torch.dist import ShardedBitmapIndex

    _, _, tcfg, tp = models(ARCH)
    eng = TS.ServeEngine(tcfg, tp, batch_slots=256, max_seq=32, devices=["cpu"] * 8,
                         device="cpu")
    sidx = eng.slot_index()
    assert isinstance(sidx, ShardedBitmapIndex) and sidx.n_shards == 8
    assert eng.free_slots() == list(range(256))
    assert eng.submit(TS.Request(rid=0, prompt=[1, 2], max_new=2))
    assert eng.free_slots() == list(range(1, 256))
    assert eng.draining_slots() == []
    while any(r is not None for r in eng.requests):
        eng.step()
    assert eng.free_slots() == list(range(256))
    want, order, _ = drained_reference()
    done = eng.run_until_drained(reqs(TS, PROMPTS, 4))
    assert {r.rid: r.out for r in done} == want and [r.rid for r in done] == order


def test_snapshot_and_warm_start(tmp_path):
    """The slot index checkpoints through ``repro_torch.persist``; a new
    engine (and the reference's, reading the same bytes) warm-starts from it;
    a mismatched slot universe or an empty directory is refused."""
    rcfg, rp, tcfg, tp = models(ARCH)
    eng = TS.ServeEngine(tcfg, tp, batch_slots=4, max_seq=16, device="cpu")
    for i in range(2):
        assert eng.submit(TS.Request(rid=i, prompt=[1, 2, 3], max_new=9))
    for _ in range(5):  # slot positions 3 -> 8 >= 16 - 8: near the limit
        eng.step()
    free, near = eng.free_slots(), eng.draining_slots()
    assert free == [2, 3] and near == [0, 1]
    d = tmp_path / "slots"
    meta = eng.snapshot_slot_index(d)
    assert (d / "index.json").exists() and meta

    warm = TS.ServeEngine(tcfg, tp, batch_slots=4, max_seq=16, device="cpu")
    assert warm.warm_start_slot_index(d)
    assert warm.free_slots() == free and warm.draining_slots() == near
    assert warm._occ_now == {0, 1} and warm._near_now == {0, 1}
    ref = RS.ServeEngine(rcfg, rp, batch_slots=4, max_seq=16)
    assert ref.warm_start_slot_index(d)
    assert ref.free_slots() == free and ref.draining_slots() == near

    wider = TS.ServeEngine(tcfg, tp, batch_slots=8, max_seq=16, device="cpu")
    assert not wider.warm_start_slot_index(d)
    assert not wider.warm_start_slot_index(tmp_path / "empty")


def test_encoder_only_rejected():
    _, _, _, tp = models(ARCH)
    with pytest.raises(ValueError, match="encoder-only"):
        TS.ServeEngine(get_config("hubert-xlarge", reduced=True), tp, batch_slots=1,
                       max_seq=16, device="cpu")
    _, rp, _, _ = models(ARCH)
    with pytest.raises(AssertionError):
        RS.ServeEngine(r_config("hubert-xlarge", reduced=True), rp, batch_slots=1, max_seq=16)


def test_model_on_another_device_is_refused():
    _, _, tcfg, tp = models(ARCH)
    with pytest.raises(ValueError, match="lies on"):
        TS.ServeEngine(tcfg, tp, batch_slots=1, max_seq=16, device="meta")


def test_default_device_without_a_card_raises():
    if torch.cuda.is_available():  # decided inside the test, not at import
        pytest.skip("a CUDA device is present: this checks the no-card refusal")
    _, _, tcfg, tp = models(ARCH)
    with pytest.raises(RuntimeError, match="CUDA"):
        TS.ServeEngine(tcfg, tp, batch_slots=2, max_seq=16)


def test_engine_counters_match_the_reference():
    """The ``repro_engine_*`` families exist in both registries, with the
    same help and labels, and count the same run alike."""
    import repro.obs as RO

    names = ("repro_engine_admissions_total", "repro_engine_decode_steps_total",
             "repro_engine_tokens_emitted_total", "repro_engine_occupied_slots")
    rsnap, tsnap = RO.REGISTRY.snapshot(), TO.REGISTRY.snapshot()
    for name in names:
        assert (tsnap[name]["type"], tsnap[name]["help"], tsnap[name]["labels"]) == \
            (rsnap[name]["type"], rsnap[name]["help"], rsnap[name]["labels"])
    ref, tor = engines(slots=2)
    RO.enable()
    TO.enable()
    try:
        before = (RO.REGISTRY.snapshot(), TO.REGISTRY.snapshot())
        ref.run_until_drained(reqs(RS, PROMPTS, 2))
        tor.run_until_drained(reqs(TS, PROMPTS, 2))
        after = (RO.REGISTRY.snapshot(), TO.REGISTRY.snapshot())
    finally:
        RO.disable()
        TO.disable()

    def delta(pkg, name):
        a, b = after[pkg][name]["samples"], before[pkg][name]["samples"]
        return {k: v - b.get(k, 0) for k, v in a.items()}

    for name in names[:3]:
        assert delta(1, name) == delta(0, name), name
        assert any(delta(1, name).values()), name


def test_launch_serve_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "qwen3-1.7b", "--reduced",
         "--device", "cpu"],
        env=env, capture_output=True, text=True, cwd=ROOT, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith("served 16 requests / 128 tokens in ")
    assert "engine steps)" in lines[0] and len(lines) == 5
    assert all(line.startswith("  rid=") and "out=[" in line for line in lines[1:])
    assert "jax" not in out.stderr
