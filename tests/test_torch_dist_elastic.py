"""Elastic restore on 8 gloo ranks (the reference's
``tests/test_dist.py::test_elastic_checkpoint_reshard``): qwen3-1.7b
reduced's initial train state placed on an 8 x 1 mesh, saved (every rank
gathers, rank 0 writes), restored onto a 2 x 4 mesh of the same ranks
through ``CheckpointManager.restore(..., shardings=)``.  Every leaf's
``full_tensor()`` equals the saved state, and the ``.npz`` equals the one
an unsharded save of the same state writes, key for key and bit for bit.

Then ``launch.train.main`` on the 8 ranks (its host mesh
is 8 x 1, each rank a slice of the batch) prints the loss lines of a
one-rank run, and its checkpoint resumes in one process on the 1 x 1 mesh.
"""
from __future__ import annotations

import json
import os

import signal

import numpy as np
import pytest
import torch.distributed as dist

import _torch_dist as TD
import repro_torch.launch.train as TL

LAUNCH = ["--arch", "qwen3-1.7b", "--reduced", "--batch", "8", "--seq", "32", "--device", "cpu"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist_elastic")
    TD.spawn(TD.elastic_worker, 8, d)
    with open(d / "elastic.json") as f:
        return d, json.load(f)


def test_restored_leaves_equal_saved_state(run):
    _, report = run
    assert report["equal"] and all(report["equal"].values()), \
        [k for k, v in report["equal"].items() if not v]
    assert report["requires_grad"]


def test_restore_places_on_the_new_mesh(run):
    _, report = run
    # 2 x 4: wq [64, 64] is split over data (its rows) and model (its columns)
    assert report["placements_b"]["blocks.0.attn.wq"] == ["S(0)", "S(1)"]


def test_sharded_npz_equals_unsharded_save(run):
    d, _ = run
    step = "step_00000001"
    with np.load(os.path.join(d, "sharded", step, "arrays.npz")) as a, \
            np.load(os.path.join(d, "plain", step, "arrays.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        assert "params//groups//0//b0//attn//wq" in a.files
        for k in a.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    with open(os.path.join(d, "sharded", step, "manifest.json")) as f:
        paths = json.load(f)["paths"]
    assert paths == sorted(a.files)


def _losses(text):
    return {int(ln.split()[1]): float(ln.split()[3]) for ln in text.splitlines()
            if ln.startswith("step")}


def test_launch_train_on_8_ranks_then_resume_on_one(tmp_path, capsys):
    d = str(tmp_path / "ck")
    TD.spawn(TD.launch_worker, 8, tmp_path, LAUNCH + ["--steps", "4", "--ckpt-dir", d,
                                                      "--ckpt-every", "2"])
    outs = [(tmp_path / f"launch_{r}.txt").read_text() for r in range(8)]
    assert all(_losses(o) == _losses(outs[0]) for o in outs[1:])  # every rank alike
    assert all(o.splitlines()[-1] == "[done]" for o in outs)
    saved = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        TL.main(LAUNCH + ["--steps", "4"])
        one_rank = capsys.readouterr().out
        TL.main(LAUNCH + ["--steps", "6", "--ckpt-dir", d, "--ckpt-every", "2"])
        resumed = capsys.readouterr().out
        TL.main(LAUNCH + ["--steps", "6"])
        straight = capsys.readouterr().out
    finally:
        for s, h in saved.items():
            signal.signal(s, h)
    assert not dist.is_initialized()
    eight, one = _losses(outs[0]), _losses(one_rank)
    assert sorted(eight) == sorted(one) == [0, 3]
    for step in eight:
        assert abs(eight[step] - one[step]) <= 1e-4, (step, eight, one)
    assert resumed.splitlines()[0] == f"[resume] restored step 4 from {d}"
    assert abs(_losses(resumed)[5] - _losses(straight)[5]) <= 1e-4
