"""``python -m repro_torch.launch.train`` on the CPU: a run, a resume from
its newest checkpoint, a preemption, the reference's flags and printed
lines, and its checkpoints read by the reference.

Both packages draw their own random weights (``jax.random`` and a
``torch.Generator`` differ), so printed numbers differ; the lines are
compared with every number masked.
"""
from __future__ import annotations

import os
import re
import signal

import jax
import numpy as np
import pytest

import repro.launch.train as RL
import repro_torch.launch.train as TL
from repro.ckpt import CheckpointManager as RCheckpointManager
from repro.configs import get_config as r_config
from repro.train import init_train_state as r_init_train_state
from repro_torch.ckpt import CheckpointManager

ARGS = ["--arch", "qwen3-1.7b", "--reduced", "--batch", "4", "--seq", "16"]


def _run(main, argv, capsys, device=True):
    extra = ["--device", "cpu"] if device else []
    main(ARGS + argv + extra)
    return capsys.readouterr().out.splitlines()


def _shape(lines, directory):
    """Lines with the directory and every number masked."""
    return [re.sub(r"-?\d+(\.\d+)?(e[-+]\d+)?", "#", line.replace(directory, "DIR"))
            for line in lines]


@pytest.fixture
def handlers():
    """The driver installs SIGTERM / SIGINT handlers: put the old ones back."""
    saved = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    yield
    for s, h in saved.items():
        signal.signal(s, h)


def test_run_then_resume(tmp_path, capsys, handlers):
    d = str(tmp_path / "ck")
    first = _run(TL.main, ["--steps", "12", "--ckpt-dir", d, "--ckpt-every", "5"], capsys)
    assert first[0].startswith("step     0 loss ") and first[-1] == "[done]"
    assert [ln.split()[1] for ln in first if ln.startswith("step")] == ["0", "10", "11"]
    mgr = CheckpointManager(d)
    assert mgr.all_steps() == [5, 10, 12]  # every 5 steps, and the last
    second = _run(TL.main, ["--steps", "15", "--ckpt-dir", d, "--ckpt-every", "5"], capsys)
    assert second[0] == f"[resume] restored step 12 from {d}"
    assert second[1].startswith("step    14 loss ") and second[-1] == "[done]"
    assert mgr.all_steps() == [10, 12, 15]  # keep 3
    loss = [float(ln.split()[3]) for ln in first + second if ln.startswith("step")]
    assert all(np.isfinite(loss))

    # the reference reads the port's checkpoint into its own train state
    rcfg = r_config("qwen3-1.7b", reduced=True)
    st = RCheckpointManager(d).restore(15, r_init_train_state(rcfg, jax.random.PRNGKey(0)))
    assert int(st["opt"]["step"]) == 15
    assert all(np.isfinite(np.asarray(x)).all() for x in jax.tree.leaves(st))


def test_printed_lines_match_reference(tmp_path, capsys, handlers):
    argv = ["--steps", "3", "--ckpt-every", "2"]
    want = _run(RL.main, argv + ["--ckpt-dir", str(tmp_path / "r")], capsys, device=False)
    want += _run(RL.main, ["--steps", "4", "--ckpt-every", "2", "--ckpt-dir",
                           str(tmp_path / "r")], capsys, device=False)
    got = _run(TL.main, argv + ["--ckpt-dir", str(tmp_path / "t")], capsys)
    got += _run(TL.main, ["--steps", "4", "--ckpt-every", "2", "--ckpt-dir",
                          str(tmp_path / "t")], capsys)
    assert _shape(got, str(tmp_path / "t")) == _shape(want, str(tmp_path / "r"))
    assert sorted(os.listdir(tmp_path / "t")) == sorted(os.listdir(tmp_path / "r"))


def test_sigterm_checkpoints_and_stops(tmp_path, capsys, monkeypatch, handlers):
    real = TL.lm_batch

    def batch_then_signal(cfg, step, device=None):
        if step == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return real(cfg, step, device)

    monkeypatch.setattr(TL, "lm_batch", batch_then_signal)
    d = str(tmp_path / "ck")
    out = _run(TL.main, ["--steps", "20", "--ckpt-dir", d, "--ckpt-every", "50"], capsys)
    assert "[preempt] signal received; checkpointing at step 3" in out
    assert out[-1] == "[done]"
    assert CheckpointManager(d).all_steps() == [3]


def test_production_mesh_is_refused(capsys):
    # make_production_mesh's error: the (16, 16) mesh needs 256 ranks, not 1
    with pytest.raises(ValueError, match="needs 256 ranks; the process group has 1"):
        TL.main(ARGS + ["--production-mesh", "--device", "cpu"])
