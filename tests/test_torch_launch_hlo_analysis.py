"""``repro_torch.launch.hlo_analysis``: the reference's HLO reader, copied,
and the port's own accounting of an eager step (``OpAccounting``).

* ``analyze_hlo`` on the HLO text jax emits for the five programs of
  ``tests/test_hlo_analysis.py`` (the scan of 7, the nested scans, the
  fused chain, the scan of 16, the ``psum`` in a loop on 8 host devices):
  the port's dict equals the reference's, key for key; so does
  ``launch.dryrun.collective_bytes``.
* ``OpAccounting`` on the same programs written in torch: the 7 and
  5 x 3 + 5 + 1 products counted exactly (eager torch unrolls every loop,
  so nothing is multiplied); the traffic proxy counts every eager op (XLA
  fuses the chain's intermediates away: the port's proxy is the sum of the
  four ops' outputs, twice, above the reference's); five ``psum`` on a
  fake 8-rank group give five all-reduces of 4 KiB.  Beside them: the
  per-device count of a DTensor product (the local shapes, not the global
  op; DTensor's shape propagation not counted), the collectives of
  redistributes and of ``ring_shift``, and the bytes alive at the peak.
"""
from __future__ import annotations

import contextlib
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.launch import hlo_analysis as ref
from repro_torch.launch import dryrun as port_dryrun
from repro_torch.launch import hlo_analysis as port
from repro_torch.launch.hlo_analysis import OpAccounting

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

PSUM_HLO = """
import sys
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.launch.mesh import make_host_mesh
mesh = make_host_mesh(data=8, model=1)

def f(x):
    def body(c, _):
        return jax.lax.psum(c, "data") * 0.125, None
    out, _ = jax.lax.scan(body, x, None, length=5)
    return out

try:  # jax >= 0.5
    _shard_map, _kw = jax.shard_map, {"check_vma": False}
except AttributeError:
    from jax.experimental.shard_map import shard_map as _shard_map
    _kw = {"check_rep": False}
g = jax.jit(_shard_map(f, mesh=mesh, in_specs=P(None), out_specs=P(None), **_kw))
sys.stdout.write(g.lower(jnp.ones((1024,))).compile().as_text())
"""


def _scan7(x):
    def body(c, _):
        return jnp.tanh(c @ c), None
    out, _ = jax.lax.scan(body, x, None, length=7)
    return out


def _nested(x):
    def outer(c, _):
        def inner(ci, _):
            return ci @ ci, None
        ci, _ = jax.lax.scan(inner, c, None, length=3)
        return jnp.tanh(ci @ ci), None
    out, _ = jax.lax.scan(outer, x, None, length=5)
    return out @ x


def _chain(x):
    return jnp.tanh(x * 2.0 + 1.0).sum()


def _scan16(x):
    def body(c, _):
        return c @ c, None
    out, _ = jax.lax.scan(body, x, None, length=16)
    return out


PROGRAMS = {
    "scan7": (_scan7, 64),
    "nested": (_nested, 32),
    "chain": (_chain, 256),
    "scan16": (_scan16, 48),
}


@pytest.fixture(scope="module")
def hlo_texts():
    texts = {name: jax.jit(f).lower(jnp.ones((n, n))).compile().as_text()
             for name, (f, n) in PROGRAMS.items()}
    env = {**os.environ, "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
           "PYTHONPATH": SRC}
    res = subprocess.run([sys.executable, "-c", PSUM_HLO], env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    texts["psum"] = res.stdout
    return texts


@pytest.mark.parametrize("name", [*PROGRAMS, "psum"])
def test_analyze_hlo_equals_reference(hlo_texts, name):
    got, want = port.analyze_hlo(hlo_texts[name]), ref.analyze_hlo(hlo_texts[name])
    assert got == want
    assert list(got) == ["dot_flops", "collective_bytes", "collective_total",
                         "collective_counts", "hbm_traffic_proxy", "n_computations"]


# the reference's HLO-text scan of collectives, in a process of its own
# (importing repro.launch.dryrun sets XLA_FLAGS for 512 host devices)
REF_COLLECTIVES = """
import json, sys
from repro.launch.dryrun import collective_bytes
texts = json.load(open(sys.argv[1]))
json.dump({k: collective_bytes(v) for k, v in texts.items()}, sys.stdout)
"""


@pytest.fixture(scope="module")
def ref_collectives(hlo_texts, tmp_path_factory):
    import json

    path = tmp_path_factory.mktemp("hlo") / "texts.json"
    path.write_text(json.dumps(hlo_texts))
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu"}
    res = subprocess.run([sys.executable, "-c", REF_COLLECTIVES, str(path)], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    return json.loads(res.stdout)


@pytest.mark.parametrize("name", [*PROGRAMS, "psum"])
def test_collective_bytes_equals_reference(hlo_texts, ref_collectives, name):
    """``launch.dryrun.collective_bytes`` (the copied HLO-text scan)."""
    assert port_dryrun.collective_bytes(hlo_texts[name]) == ref_collectives[name]


def test_reference_psum_counts(hlo_texts):
    """The fifth program's expectation, as the reference's test states it."""
    r = port.analyze_hlo(hlo_texts["psum"])
    assert r["collective_counts"]["all-reduce"] == 5
    assert r["collective_bytes"]["all-reduce"] == 5 * 1024 * 4


# ---------------------------------------------------------------------------
# OpAccounting on torch programs
# ---------------------------------------------------------------------------


def test_scan_of_7_products_counted():
    x = torch.ones(64, 64)
    with OpAccounting() as acc:
        c = x
        for _ in range(7):
            c = torch.tanh(c @ c)
    assert acc.result()["dot_flops"] == 7 * 2 * 64**3
    assert acc.dots == {("aten::mm", 64 * 64, 64): 7}


def test_nested_loops_products_counted():
    x = torch.ones(32, 32)
    with OpAccounting() as acc:
        c = x
        for _ in range(5):
            ci = c
            for _ in range(3):
                ci = ci @ ci
            c = torch.tanh(ci @ ci)
        c @ x
    assert acc.result()["dot_flops"] == (5 * 3 + 5 + 1) * 2 * 32**3


def test_scan_of_16_products_counted():
    """XLA's ``cost_analysis`` counts a loop body once; eager torch runs
    all 16 products, and each is counted."""
    x = torch.ones(48, 48)
    with OpAccounting() as acc:
        c = x
        for _ in range(16):
            c = c @ c
    assert acc.result()["dot_flops"] == 16 * 2 * 48**3


def test_traffic_counts_every_eager_op(hlo_texts):
    """``tanh(x * 2 + 1).sum()``: eager torch writes each intermediate
    (mul, add, tanh: 256 x 256 float32 each, and the sum's scalar), XLA
    fuses them; the port's proxy is twice the four outputs, above the
    reference's fused count."""
    x = torch.ones(256, 256)
    with OpAccounting() as acc:
        torch.tanh(x * 2.0 + 1.0).sum()
    r = acc.result()
    assert r["hbm_traffic_proxy"] == 2 * (3 * 256 * 256 * 4 + 4)
    assert r["n_computations"] == 4
    assert r["hbm_traffic_proxy"] > ref.analyze_hlo(hlo_texts["chain"])["hbm_traffic_proxy"]


def test_views_are_not_traffic():
    x = torch.ones(64, 64)
    with OpAccounting() as acc:
        x.t()
        x.view(-1)
        x[:10]
    assert acc.result()["hbm_traffic_proxy"] == 0 and acc.n_ops == 3


def test_peak_bytes_follow_storages():
    """Storages made in the mode count from their op to their last
    tensor's end; a view or an op writing in place makes none."""
    x = torch.ones(1024, 256)  # 1 MiB, made outside: not counted
    with OpAccounting() as acc:
        a = x * 2.0  # 1 MiB alive
        b = a.view(256, 1024)  # a view: nothing new
        b.add_(1.0)  # in place: nothing new
        c = a + 1.0  # 2 MiB alive
        del a, b
        d = c * 3.0  # a dies with b: 2 MiB alive
        del c, d
        assert acc.live_bytes == 0
    assert acc.peak_bytes == 2 * 1024 * 256 * 4


@contextlib.contextmanager
def fake_group(world: int):
    import torch.testing._internal.distributed.fake_pg  # noqa: F401 -- registers "fake"

    dist.init_process_group("fake", store=dist.HashStore(), rank=0, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_psum_in_a_loop_on_fake_group():
    from repro_torch.dist.context import ShardingRules, psum, use_rules
    from repro_torch.launch.mesh import make_host_mesh

    with fake_group(8):
        mesh = make_host_mesh(data=8, model=1, device="cpu")
        with use_rules(ShardingRules(mesh)), OpAccounting() as acc:
            z = torch.ones(1024)
            for _ in range(5):
                z = psum(z, "data") * 0.125
    r = acc.result()
    assert r["collective_counts"]["all-reduce"] == 5
    assert r["collective_bytes"]["all-reduce"] == 5 * 1024 * 4
    assert r["collective_total"] == 5 * 1024 * 4


def test_dtensor_product_counts_the_local_shapes():
    """[256, 4096] @ [4096, 4096] over a 16 x 16 mesh: each device's share,
    8.59e9 / 256 FLOPs (``FlopCounterMode`` counts the global op), on a
    cold sharding cache too (DTensor's shape propagation runs the global op
    on fake tensors: not counted)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch.mesh import make_production_mesh

    with fake_group(256):
        mesh = make_production_mesh(device="cpu")  # its rank tables are real tensors
        with FakeTensorMode(allow_non_fake_inputs=True):
            a = distribute_tensor(torch.empty(256, 4096), mesh, [Shard(0), Replicate()],
                                  src_data_rank=None)
            w = distribute_tensor(torch.empty(4096, 4096), mesh, [Replicate(), Shard(1)],
                                  src_data_rank=None)
            for _ in range(2):  # the cold cache, then the warm one
                with OpAccounting() as acc:
                    a @ w
                assert acc.result()["dot_flops"] == 2 * 256 * 4096 * 4096 / 256
                assert acc.dots == {("aten::mm", 16 * 256, 4096): 1}
            with FlopCounterMode(display=False) as fc:
                a @ w
    assert fc.get_total_flops() == 2 * 256 * 4096 * 4096


def test_redistributes_and_ring_shift_on_fake_group():
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor

    from repro_torch.dist.context import ring_shift

    with fake_group(8):
        mesh = init_device_mesh("cpu", (8,), mesh_dim_names=("x",))
        t = distribute_tensor(torch.ones(64, 32), mesh, [Shard(0)], src_data_rank=None)
        p = DTensor.from_local(torch.ones(64, 32), mesh, [Partial()], run_check=False)
        with OpAccounting() as acc:
            t.redistribute(mesh, [Replicate()])  # all-gather: [64, 32] out
            p.redistribute(mesh, [Shard(0)])  # reduce-scatter: [8, 32] out
            p.redistribute(mesh, [Replicate()])  # all-reduce: [64, 32]
            ring_shift([torch.ones(256), torch.ones(3, 4)])  # two receives
    r = acc.result()
    assert r["collective_counts"] == {"all-reduce": 1, "all-gather": 1, "reduce-scatter": 1,
                                      "all-to-all": 0, "collective-permute": 2}
    assert r["collective_bytes"] == {"all-reduce": 8192, "all-gather": 8192,
                                     "reduce-scatter": 1024, "all-to-all": 0,
                                     "collective-permute": (256 + 12) * 4}
    assert not dist.is_initialized()
