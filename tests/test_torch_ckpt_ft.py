"""Checkpoints and fault tolerance of the port (``repro_torch.ckpt``,
``repro_torch.ft``) against the reference's.

Checkpoints cross between the packages in both directions: the same key
set and equal arrays (compared as arrays: ``np.savez`` stamps times into
the zip, so the bytes differ).  The monitors are held against the
reference's on the same sequences.  Everything runs on the CPU; the
crash-and-resume replay is exact there (the same float32 ops in the same
order), so it is held to the reference's 1e-6.
"""
from __future__ import annotations

import os
import signal
import threading

import jax
import numpy as np
import pytest
import torch

from _torch_lm import np_tree, perturb
from repro.ckpt import CheckpointManager as RCheckpointManager
from repro.configs import get_config as r_config
from repro.ft import Heartbeat as RHeartbeat
from repro.ft import StragglerMonitor as RStragglerMonitor
from repro.train import init_train_state as r_init_train_state
from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.convert import train_state_from_reference, train_state_to_reference
from repro_torch.data import DataConfig, lm_batch
from repro_torch.ft import Heartbeat, PreemptionHandler, StragglerMonitor
from repro_torch.train import OptConfig, TrainConfig, init_train_state, make_train_step

ARCH = "qwen3-1.7b"


def _npz(directory, step):
    with np.load(os.path.join(directory, f"step_{step:08d}", "arrays.npz")) as z:
        return {k: z[k] for k in z.files}


def _ref_state(arch, seed=0):
    """A reference train state with non-zero moments and step, as numpy."""
    rcfg = r_config(arch, reduced=True)
    st = np_tree(r_init_train_state(rcfg, jax.random.PRNGKey(seed)))
    st["opt"]["m"] = perturb(st["opt"]["m"], seed + 1, 0.01)
    st["opt"]["v"] = jax.tree.map(np.abs, perturb(st["opt"]["v"], seed + 2, 0.01))
    st["opt"]["step"] = np.asarray(17, np.int32)
    return st


def _leaves_equal(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb) and jax.tree.structure(a) == jax.tree.structure(b)
    for x, y in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "recurrentgemma-2b", "mixtral-8x22b"])
def test_checkpoints_cross_between_packages(arch, tmp_path):
    """The same state saved by each package: same keys, equal arrays; each
    package restores the other's checkpoint (recurrentgemma: ``lambda``,
    two layer groups; mixtral: expert stacks)."""
    rcfg, tcfg = r_config(arch, reduced=True), get_config(arch, reduced=True)
    ref = _ref_state(arch)
    port = train_state_from_reference(ref, tcfg, device="cpu")
    rdir, tdir = str(tmp_path / "ref"), str(tmp_path / "port")
    RCheckpointManager(rdir, async_save=False).save(5, jax.tree.map(jax.numpy.asarray, ref))
    CheckpointManager(tdir, async_save=False).save(5, port)
    rz, tz = _npz(rdir, 5), _npz(tdir, 5)
    assert rz.keys() == tz.keys()
    assert "params//embed" in tz and "opt//m//embed" in tz and "opt//step" in tz
    assert any(k.startswith("params//groups//0//b0//") for k in tz)
    if arch == "recurrentgemma-2b":
        assert any(k.endswith("//rec//lambda") for k in tz)
    for k in rz:
        assert rz[k].dtype == tz[k].dtype and np.array_equal(rz[k], tz[k]), k
    assert CheckpointManager(tdir).manifest(5)["paths"] == RCheckpointManager(rdir).manifest(5)["paths"]

    # the reference restores the port's checkpoint, the port the reference's
    template = r_init_train_state(rcfg, jax.random.PRNGKey(9))
    _leaves_equal(np_tree(RCheckpointManager(tdir).restore(5, template)), ref)
    meta = init_train_state(tcfg, 0, device="meta")
    back = CheckpointManager(rdir).restore(5, meta, device="cpu")
    _leaves_equal(train_state_to_reference(back, tcfg), ref)
    assert all(p.requires_grad for p in back["params"].parameters())
    assert back["opt"]["step"].dtype == torch.int32 and int(back["opt"]["step"]) == 17


def test_save_restore_roundtrip(tmp_path):
    cfg = get_config(ARCH, reduced=True)
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    state = init_train_state(cfg, 0, device="cpu")
    mgr.save(7, state, extra={"note": "x"})
    assert mgr.all_steps() == [7]
    restored = mgr.restore(7, state, device="cpu")
    assert restored["params"] is not state["params"]
    for (n, a), (m, b) in zip(state["params"].named_parameters(),
                              restored["params"].named_parameters()):
        assert n == m and torch.equal(a, b)
    for part in ("m", "v"):
        assert all(torch.equal(state["opt"][part][k], v) for k, v in restored["opt"][part].items())
    assert torch.equal(restored["opt"]["step"], state["opt"]["step"])
    assert mgr.manifest(7)["extra"]["note"] == "x"
    assert set(mgr.manifest(7)) == {"step", "time", "paths", "extra"}


def test_plain_state_roundtrip(tmp_path):
    """A state that is not a train state: nested dicts, lists and tuples."""
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    state = {"a": torch.arange(4), "b": [torch.ones(2, 3), (torch.tensor(2.5),)],
             "c": np.arange(3, dtype=np.int16)}
    mgr.save(1, state)
    assert sorted(_npz(str(tmp_path), 1)) == ["a", "b//0", "b//1//0", "c"]
    back = mgr.restore(1, state, device="cpu")
    assert torch.equal(back["a"], state["a"]) and torch.equal(back["b"][0], state["b"][0])
    assert isinstance(back["b"][1], tuple) and float(back["b"][1][0]) == 2.5
    assert back["c"].dtype == torch.int16


def test_atomic_publish_no_tmp_visible(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, {"a": torch.arange(4)})
    entries = os.listdir(tmp_path)
    assert "step_00000001" in entries
    assert not any(e.endswith(".tmp") for e in entries)
    os.makedirs(tmp_path / "step_00000009.tmp")  # a torn write is never a step
    assert mgr.all_steps() == [1] and mgr.latest_step() == 1


def test_retention_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"a": torch.arange(3)})
    assert mgr.all_steps() == [3, 4]


def test_async_save_copies_in_the_callers_thread(tmp_path):
    """``save`` returns with the host copy taken: writes to the state after
    it returns do not reach the checkpoint; ``wait`` joins the writer."""
    cfg = get_config(ARCH, reduced=True)
    state = init_train_state(cfg, 1, device="cpu")
    want = state["params"].embed.detach().clone()
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(3, state)
    writer = mgr._thread
    assert isinstance(writer, threading.Thread)
    with torch.no_grad():
        state["params"].embed.add_(1.0)
    mgr.wait()
    assert not writer.is_alive() and mgr.latest_step() == 3
    assert np.array_equal(_npz(str(tmp_path), 3)["params//embed"], want.numpy())


def test_crash_resume_replays_identically(tmp_path):
    """Train 6 steps straight vs 3 + 'crash' + resume 3: identical params."""
    cfg = get_config(ARCH, reduced=True)
    tc = TrainConfig(opt=OptConfig(peak_lr=1e-3, warmup_steps=2, total_steps=10))
    dc = DataConfig(vocab=cfg.vocab, batch=4, seq=32)
    step = make_train_step(cfg, tc)

    s = init_train_state(cfg, 4, device="cpu")
    for i in range(6):
        s, _ = step(s, lm_batch(dc, i, device="cpu"))
    straight = s

    mgr = CheckpointManager(str(tmp_path), async_save=False)
    s = init_train_state(cfg, 4, device="cpu")
    for i in range(3):
        s, _ = step(s, lm_batch(dc, i, device="cpu"))
    mgr.save(3, s)
    del s  # crash
    s2 = mgr.restore(3, init_train_state(cfg, 4, device="meta"), device="cpu")
    for i in range(3, 6):
        s2, _ = step(s2, lm_batch(dc, i, device="cpu"))
    d = max(float((a - b).detach().abs().max()) for a, b in
            zip(straight["params"].parameters(), s2["params"].parameters()))
    assert d < 1e-6
    assert int(s2["opt"]["step"]) == 6


@pytest.mark.parametrize("seq", [
    [0.1] * 8 + [0.5, 0.1, 0.1],
    [0.2, 0.21, 0.19, 0.2, 0.9, 0.2, 0.2, 0.8, 0.75, 0.2, 3.0, 0.2],
    list(np.random.default_rng(0).lognormal(-2.0, 0.6, 64)),
])
def test_straggler_monitor_matches_reference(seq):
    for kw in (dict(), dict(threshold=2.0, warmup=3), dict(threshold=1.5, alpha=0.3, warmup=1)):
        port, ref = StragglerMonitor(**kw), RStragglerMonitor(**kw)
        for i, t in enumerate(seq):
            got, want = port.record(i, t), ref.record(i, t)
            assert (got is None) == (want is None)
            if got is not None:
                assert (got.step, got.step_time, got.ewma, got.ratio) == \
                    (want.step, want.step_time, want.ewma, want.ratio)
            assert port.ewma == ref.ewma and port.count == ref.count
        assert len(port.events) == len(ref.events)


def test_straggler_monitor_flags_outliers():
    mon = StragglerMonitor(threshold=2.0, warmup=3)
    assert all(mon.record(i, 0.1) is None for i in range(8))
    ev = mon.record(8, 0.5)
    assert ev is not None and ev.ratio > 2.0
    assert mon.ewma < 0.12  # the outlier does not drag the EWMA up
    assert mon.record(9, 0.1) is None


def test_heartbeat_matches_reference():
    port, ref = Heartbeat(hosts=5, timeout=10.0), RHeartbeat(hosts=5, timeout=10.0)
    rng = np.random.default_rng(1)
    now = 1000.0
    for h in range(5):
        port.beat(h, now)
        ref.beat(h, now)
    for _ in range(40):
        now += float(rng.uniform(0, 4))
        h = int(rng.integers(0, 5))
        if h != 4:  # host 4 goes silent
            port.beat(h, now)
            ref.beat(h, now)
        assert port.dead_hosts(now) == ref.dead_hosts(now)
        assert port.surviving_shards(now) == ref.surviving_shards(now)
    assert 4 in port.dead_hosts(now)


def test_preemption_handler_on_sigterm():
    saved = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    called = []
    try:
        h = PreemptionHandler(on_preempt=lambda: called.append(1))
        assert not h.should_stop
        h.install()
        os.kill(os.getpid(), signal.SIGTERM)
        assert h.should_stop and called == [1]
    finally:
        for s, handler in saved.items():
            signal.signal(s, handler)
