"""The event kernel (``csrc/tiled_events.cu``) on the card against its plain
version ``tiled_scan.event_plain``, bit for bit.

Every test is marked ``cuda`` and takes the ``card`` fixture, which skips
where ``torch.cuda.is_available()`` is False (decided inside the fixture,
never while the module is imported).  The file imports no JAX, so it runs on
a machine with the card::

    python -m pytest -q -m cuda tests/test_torch_tiled_events_cuda.py

The plain version is held to the reference on the same synthetic cases and
fixtures on the CPU (``tests/test_torch_tiled.py``), so the kernel equals
both.
"""
import numpy as np
import pytest
import torch

from _event_cases import CASES, base_buffer, event_case
from _torch_port import container_mix_bits
from repro_torch.core import circuits as TC
from repro_torch.core.bitmaps import pack
from repro_torch.device import to_numpy_u32
from repro_torch.kernels import tiled_scan as TK
from repro_torch.storage import TileStore, run_tiled_circuit

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the event kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", sorted(CASES))
def test_event_kernel_equals_the_plain_version(card, case, seed):
    st, base = event_case(case, card, seed)
    want = base_buffer(base, st.tw, card)
    TK.event_plain(want, st)
    got = base_buffer(base, st.tw, card)
    before = TK.launch_counts["tiled_events"]
    TK.event_runner(got, st)
    torch.cuda.synchronize()
    assert TK.launch_counts["tiled_events"] == before + 1
    assert torch.equal(got, want)


def _runs_bits(seed, n=6, r=40 * 2048 + 77):
    """Columns of long runs with a few stray bits: run and sparse containers."""
    rng = np.random.default_rng(seed)
    bits = np.zeros((n, r), bool)
    for i in range(n):
        edges = np.cumsum(rng.geometric(1 / 900, 2 * r // 900 + 8))
        edges = edges[edges < r]
        toggles = np.zeros(r + 1, np.int8)
        np.add.at(toggles, edges, 1)
        bits[i] = np.cumsum(toggles[:r]) % 2 == 1
        bits[i, rng.integers(0, r, 40)] = True
    return bits


FIXTURES = {
    "sparse": lambda: np.random.default_rng(23).random((6, 16 * 2048)) < 20 / 2048,
    "containers": lambda: container_mix_bits(6, seed=11),
    "runs": lambda: _runs_bits(5),
}


def _circuit(kind, n):
    if kind == "threshold":
        return TC.build_threshold_circuit(n, 2, "ssum")
    if kind == "interval":
        return TC.build_interval_circuit(n, 2, 4)
    c = TC.Circuit(n, [], [])  # three outputs: two thresholds and a parity
    w = TC.sideways_sum_bits(c, list(range(n)))
    c.outputs = [TC.ge_const(c, w, 1), TC.ge_const(c, w, 3), w[0]]
    return c.optimized()


@pytest.mark.parametrize("kind", ["threshold", "interval", "multi"])
@pytest.mark.parametrize("fixture,tw", [("sparse", 8), ("sparse", 64), ("containers", 64),
                                        ("runs", 8), ("runs", 64)])
def test_scan_engine_on_the_card_equals_the_cpu(card, fixture, tw, kind):
    """The scan engine on a card store (the event kernel and K2) against the
    same store on the CPU (both plain versions): words and ExecInfo."""
    bits = FIXTURES[fixture]()
    packed = to_numpy_u32(pack(bits, "cpu"))
    r = bits.shape[1]
    circ = _circuit(kind, bits.shape[0])
    want, want_info = run_tiled_circuit(
        TileStore.from_packed(packed, tile_words=tw, r=r, device="cpu"), circ, engine="scan")
    store = TileStore.from_packed(packed, tile_words=tw, r=r, device=card)
    before = TK.launch_counts["tiled_events"]
    got, info = run_tiled_circuit(store, circ, engine="scan")
    torch.cuda.synchronize()
    assert info == want_info and info["event_tiles"] > 0
    assert TK.launch_counts["tiled_events"] == before + 1
    assert torch.equal(got.cpu(), want)


def test_shared_memory_mirror_equals_the_library(card):
    lib = TK._events_lib()  # loading also holds the two counts to each other
    for tw in (1, 8, 64, 1536, 2047):
        for kb in (1, 3, 16):
            for mm in (2, 256, 4096):
                assert lib.tiled_events_shared_bytes(tw, kb, mm) == TK.event_shared_bytes(tw, kb, mm)
