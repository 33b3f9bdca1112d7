"""``repro_torch.dist.pipeline.pipeline_forward``: GPipe over a ``pod``
axis of 8 gloo ranks (S = 8 stages, M = 4 microbatches, ``tanh(x @ w)``,
the reference's ``tests/test_dist.py::test_pipeline_parallel_matches_sequential``
recipe) against the reference's ``pipeline_forward`` on a one-device mesh
(its sequential path: the reference's own GPipe path fails under jax
0.9.0, see ``ROADMAP.md``), within 1e-5; the port's own sequential
fallback against it too.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist as TD
from repro.dist.pipeline import pipeline_forward as r_pipeline_forward
from repro_torch.dist.pipeline import pipeline_forward
from repro_torch.launch.mesh import AbstractMesh


@pytest.fixture(scope="module")
def gpipe(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist_pipeline")
    TD.spawn(TD.pipeline_worker, 8, d)
    return np.load(d / "pipeline.npy")


def _reference():
    w, x = TD.pipeline_inputs()
    mesh = jax.make_mesh((1,), ("pod",))
    out = r_pipeline_forward(lambda p, mb: jnp.tanh(mb @ p["w"]), jnp.asarray(x),
                             {"w": jnp.asarray(w)}, mesh, axis_name="pod")
    return np.asarray(out)


def test_gpipe_matches_reference(gpipe):
    np.testing.assert_allclose(gpipe[0], _reference(), atol=1e-5, rtol=0)


def test_gpipe_every_rank_returns_the_outputs(gpipe):
    assert gpipe.shape == (8, 4, 2, 16)
    for r in range(1, 8):
        np.testing.assert_array_equal(gpipe[r], gpipe[0])


def test_gpipe_matches_stage_by_stage_loop(gpipe):
    w, x = TD.pipeline_inputs()
    ref = x
    for s in range(8):
        ref = np.tanh(ref @ w[s])
    np.testing.assert_allclose(gpipe[0], ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("pods", [1, 4])
def test_sequential_fallback_matches_reference(pods):
    """An axis of another size than the stage count runs the stages in turn."""
    w, x = TD.pipeline_inputs()
    out = pipeline_forward(TD.stage_fn, torch.from_numpy(x), {"w": torch.from_numpy(w)},
                           AbstractMesh((pods,), ("pod",)), axis_name="pod")
    np.testing.assert_allclose(out.numpy(), _reference(), atol=1e-5, rtol=0)
