"""``python -m repro_torch.launch.train`` on its mesh path, in process on
the CPU: ``make_host_mesh()`` is the 1 x 1 mesh over a one-rank gloo group
``main`` starts and destroys, the state and batches are DTensors on it.

* Started from the reference's initial state, ``main([--arch qwen3-1.7b
  --reduced --steps 3 --device cpu])`` prints the same loss lines (4
  decimals) as the reference's ``main`` with the same arguments (which
  runs on its own 1 x 1 host mesh).
* A run checkpoints, a second resumes through ``restore(..., shardings=)``
  and reaches the loss of a straight run.
* ``--production-mesh`` and ``make_production_mesh`` raise on a one-rank
  world, naming the sizes; ``make_host_mesh()`` raises without a card.
"""
from __future__ import annotations

import signal

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

import repro.launch.train as RL
import repro_torch.launch.train as TL
from _torch_lm import np_tree
from repro.configs import get_config as r_config
from repro.train import init_train_state as r_init_train_state
from repro_torch.convert import train_state_from_reference
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh

ARGS = ["--arch", "qwen3-1.7b", "--reduced"]


@pytest.fixture
def clean():
    """Signal handlers put back, and no process group left behind."""
    saved = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    assert not dist.is_initialized()
    yield
    for s, h in saved.items():
        signal.signal(s, h)
    if dist.is_initialized():
        dist.destroy_process_group()
        pytest.fail("launch.train left its process group behind")


@pytest.fixture
def from_reference_init(monkeypatch):
    """The port's ``main`` starts from the reference's ``init_train_state``
    (the two packages draw different random weights); records the state
    each train step is given."""
    rcfg = r_config("qwen3-1.7b", reduced=True)
    state0 = np_tree(r_init_train_state(rcfg, jax.random.PRNGKey(0)))
    real_init, real_make = TL.init_train_state, TL.make_train_step
    seen = []

    def init(cfg, seed=0, dtype=torch.float32, device=None):
        if device == "meta":
            return real_init(cfg, seed, dtype, device)
        return train_state_from_reference(state0, cfg, device, dtype)

    def make(cfg, tc):
        step = real_make(cfg, tc)

        def recorded(state, batch):
            seen.append((state, batch))
            return step(state, batch)

        return recorded

    monkeypatch.setattr(TL, "init_train_state", init)
    monkeypatch.setattr(TL, "make_train_step", make)
    return seen


def _losses(lines):
    return {int(ln.split()[1]): ln.split()[3] for ln in lines if ln.startswith("step")}


def test_loss_lines_match_reference(capsys, clean, from_reference_init):
    argv = ARGS + ["--steps", "3"]
    RL.main(argv)
    want = capsys.readouterr().out.splitlines()
    TL.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert _losses(got) == _losses(want) and sorted(_losses(got)) == [0, 2]
    assert got[-1] == want[-1] == "[done]"


def test_the_step_runs_on_the_1x1_mesh(capsys, clean, from_reference_init):
    TL.main(ARGS + ["--steps", "2", "--batch", "4", "--seq", "16", "--device", "cpu"])
    assert len(from_reference_init) == 2
    state, batch = from_reference_init[0]
    params = list(state["params"].parameters())
    assert all(isinstance(p, DTensor) for p in params)
    mesh = params[0].device_mesh
    assert mesh.mesh_dim_names == ("data", "model") and tuple(mesh.shape) == (1, 1)
    assert all(isinstance(t, DTensor) for t in list(state["opt"]["m"].values()) + [
        state["opt"]["step"], batch["tokens"], batch["labels"]])
    assert not dist.is_initialized()  # main destroyed the group it started


def test_resume_through_restore_shardings(tmp_path, capsys, clean):
    d = str(tmp_path / "ck")
    argv = ARGS + ["--batch", "4", "--seq", "16", "--device", "cpu"]
    TL.main(argv + ["--steps", "6"])
    straight = _losses(capsys.readouterr().out.splitlines())
    TL.main(argv + ["--steps", "4", "--ckpt-dir", d, "--ckpt-every", "2"])
    capsys.readouterr()
    TL.main(argv + ["--steps", "6", "--ckpt-dir", d, "--ckpt-every", "2"])
    resumed = capsys.readouterr().out.splitlines()
    assert resumed[0] == f"[resume] restored step 4 from {d}"
    assert _losses(resumed) == {5: straight[5]}


@pytest.mark.parametrize("multi_pod,n", [(False, 256), (True, 512)])
def test_production_mesh_raises_on_one_rank(multi_pod, n, clean):
    with pytest.raises(ValueError, match=f"needs {n} ranks; the process group has 1"):
        make_production_mesh(multi_pod=multi_pod, device="cpu")
    assert not dist.is_initialized()


def test_production_mesh_flag_raises(capsys, clean):
    with pytest.raises(ValueError, match="needs 256 ranks"):
        TL.main(ARGS + ["--production-mesh", "--device", "cpu"])


def test_host_mesh_needs_a_card_by_default(monkeypatch, clean):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_host_mesh()
    assert not dist.is_initialized()


def test_host_mesh_refuses_a_shape_the_world_lacks(clean):
    with pytest.raises(ValueError, match=r"\(2, 1\).*needs 2 ranks"):
        make_host_mesh(data=2, device="cpu")
    assert not dist.is_initialized()
