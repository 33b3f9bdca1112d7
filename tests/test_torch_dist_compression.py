"""``repro_torch.dist.compression`` against ``repro.dist.compression``.

* The int8 ring all-reduce on 8 gloo ranks (rank r holds row r of an
  ``(8, 257)`` normal draw from seed 0, the reference's
  ``tests/test_dist.py::test_int8_ring_allreduce`` input): within 0.05 of
  the exact sum relative to its largest value, every rank's result
  bitwise equal, and within 1e-6 relative of the reference's ring run on
  8 XLA host devices in a subprocess (as ``tests/test_dist.py`` runs it):
  under ``jit`` XLA divides the scale by 127 as a multiply by the float32
  reciprocal, the port divides (a last-bit difference in some scales).
* ``quantize_int8`` / ``dequantize_int8`` bit for bit, ties rounded half to
  even; ``collective_bytes_saved`` equal to the reference's dict.
* ``ErrorFeedback``: the reference's 50-step recipe passes (``< 0.05``) and
  its per-step errors track the reference's within 1e-6.
"""
from __future__ import annotations

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist as TD
from repro.dist.compression import ErrorFeedback as RErrorFeedback
from repro.dist.compression import collective_bytes_saved as r_bytes_saved
from repro.dist.compression import dequantize_int8 as r_dequantize
from repro.dist.compression import quantize_int8 as r_quantize
from repro_torch.dist.compression import (
    ErrorFeedback,
    collective_bytes_saved,
    dequantize_int8,
    quantize_int8,
)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ENV = {**os.environ, "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
       "PYTHONPATH": SRC}

REF_RING = """
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.dist.compression import _ring_allreduce_int8
from repro.launch.mesh import make_host_mesh

mesh = make_host_mesh(data=8, model=1)
xs = jnp.asarray(np.random.default_rng(0).normal(size=(8, 257)).astype(np.float32))
f = jax.jit(jax.shard_map(lambda x: _ring_allreduce_int8(x, "data", 8), mesh=mesh,
            in_specs=P("data", None), out_specs=P("data", None), check_vma=False))
np.save(sys.argv[1], np.asarray(f(xs)))
"""


@pytest.fixture(scope="module")
def ring(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist_ring")
    ref_out = str(d / "ref_ring.npy")
    proc = subprocess.Popen([sys.executable, "-c", REF_RING, ref_out], env=ENV,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        TD.spawn(TD.ring_worker, 8, d)
        _, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-3000:]
    return {"port": np.load(d / "ring.npy")[:, 0], "ref": np.load(ref_out)}


def test_int8_ring_error_is_small(ring):
    xs = TD.ring_inputs()
    expect = xs.sum(0)
    rel = np.abs(ring["port"] - expect[None]).max() / np.abs(expect).max()
    assert rel < 0.05, rel


def test_int8_ring_every_rank_bitwise_equal(ring):
    out = ring["port"]
    assert out.shape == (8, 257)
    for r in range(1, 8):
        assert np.array_equal(out[r].view(np.uint32), out[0].view(np.uint32)), r


def test_int8_ring_matches_reference(ring):
    """Within 1e-6 relative, element by element: where they differ it is
    by the last bit of a chunk's scale (see the next test)."""
    np.testing.assert_allclose(ring["port"], ring["ref"], rtol=1e-6, atol=0)


def test_reference_scale_rounds_by_reciprocal_under_jit():
    """Why the ring is not bitwise the reference's: under ``jax.jit`` XLA
    turns ``absmax / 127.0`` into ``absmax * float32(1 / 127)``, which
    differs in the last bit for some inputs; the port divides, as the
    reference's source (and ``jnp`` run eagerly) does."""
    rng = np.random.default_rng(0)
    differ = 0
    for _ in range(200):
        x = (rng.normal(size=(33,)) * rng.uniform(0.1, 10)).astype(np.float32)
        absmax = np.abs(x).max()
        _, port = quantize_int8(torch.from_numpy(x))
        _, eager = r_quantize(jnp.asarray(x))
        _, jitted = jax.jit(r_quantize)(jnp.asarray(x))
        assert np.float32(port) == np.float32(eager) == absmax / np.float32(127.0)
        assert np.float32(jitted) == absmax * np.float32(1.0 / 127.0)
        differ += np.float32(jitted) != np.float32(port)
    assert 0 < differ < 20, differ


def test_quantize_int8_matches_reference_bitwise():
    rng = np.random.default_rng(1)
    # 127 makes the scale exactly 1: the .5 entries are ties (half to even)
    ties = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5, 0.0], np.float32)
    for x in (rng.normal(size=(1000,)).astype(np.float32) * 3, ties,
              np.zeros((7,), np.float32), rng.normal(size=(4, 33)).astype(np.float32)):
        q, s = quantize_int8(torch.from_numpy(x))
        rq, rs = r_quantize(jnp.asarray(x))
        assert q.dtype == torch.int8
        assert np.array_equal(q.numpy(), np.asarray(rq))
        assert np.float32(s).view(np.uint32) == np.float32(rs).view(np.uint32)
        d = dequantize_int8(q, s).numpy()
        assert np.array_equal(d.view(np.uint32), np.asarray(r_dequantize(rq, rs)).view(np.uint32))
    q, _ = quantize_int8(torch.from_numpy(ties))
    assert q.tolist() == [127, 0, 2, 2, 0, -2, 4, 0]


@pytest.mark.parametrize("n_elems,n_devices", [(1_000_000, 8), (257, 8), (10, 3), (4096, 512)])
def test_collective_bytes_saved_matches_reference(n_elems, n_devices):
    got = collective_bytes_saved(n_elems, n_devices)
    assert got == r_bytes_saved(n_elems, n_devices)
    assert got["fp32_psum_bytes"] / got["int8_ring_bytes"] == 4.0


def test_error_feedback_recipe_tracks_reference():
    rng = np.random.default_rng(0)
    true = rng.normal(size=(64,)).astype(np.float32)
    noise = [0.01 * rng.normal(size=(64,)).astype(np.float32) for _ in range(50)]

    def lossy_ref(t):
        return {k: r_dequantize(*r_quantize(v)) for k, v in t.items()}

    def lossy(t):
        return {k: dequantize_int8(*quantize_int8(v)) for k, v in t.items()}

    ref, port = RErrorFeedback(), ErrorFeedback()
    ref_err, port_err = [], []
    for n in noise:
        g = true + n
        red = ref.apply({"w": jnp.asarray(g)}, lossy_ref)
        ref_err.append(float(jnp.abs(red["w"] - g).mean()))
        red = port.apply({"w": torch.from_numpy(g)}, lossy)
        port_err.append(float((red["w"] - torch.from_numpy(g)).abs().mean()))
    assert np.mean(port_err[-10:]) < 0.05, port_err[-5:]
    np.testing.assert_allclose(port_err, ref_err, atol=1e-6, rtol=0)
    assert set(port.residual) == {"w"}
