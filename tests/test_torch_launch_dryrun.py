"""``repro_torch.launch.dryrun`` against the reference's dry run.

Reduced ``qwen3-1.7b`` and ``granite-moe-1b-a400m`` on a (data=4, model=2)
mesh, for a ``train``, a ``prefill`` and a ``decode`` cell.  The reference
runs ``run_cell`` in a subprocess on 8 XLA host devices, with
``get_config``, ``shape_cells`` and ``make_production_mesh`` patched on its
module object (no file of it is edited); the port runs the same cells on a
fake process group of 8 ranks, patched the same way.

* ``memory_analysis.argument_size_in_bytes`` and ``alias_size_in_bytes``
  are equal.
* ``loop_aware.dot_flops`` is equal dot for dot: the products of each
  side, tallied by their FLOPs (2 x output elements x contraction size) --
  the reference's from its HLO with loop multipliers, the port's from
  ``OpAccounting`` -- are equal except for the dots named in
  ``_excluded``, whose FLOPs are subtracted.  A product's FLOPs, not its
  shape, are what both sides share: GSPMD and DTensor may split its work
  differently between the output and the contraction (a partial sum).
  The one cell with any is granite-moe's train step: the MoE combine
  ``einsum("tkd,tk->td")`` of ``moe_dispatch_local``, which the port runs
  twice a layer (the forward and the remat recompute) where XLA's module
  keeps it once, and that einsum's gradient with respect to the gathered
  rows, a product over K = 1 that XLA writes as a multiply.
* Collective counts are recorded (printed), not held equal: GSPMD and
  DTensor choose different collectives.  On the CPU's fake group DTensor
  emulates all-to-all with all-gather, so the port counts no all-to-all
  here (on the card it would).
* The records keep the reference's keys; a SKIP is the reference's SKIP;
  ``input_specs`` equals the reference's for every arch and shape.
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
from collections import Counter

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import ARCHS, get_config, shape_cells
from repro_torch.launch import dryrun as D
from repro_torch.launch.hlo_analysis import OpAccounting

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ARCHS_TESTED = ("qwen3-1.7b", "granite-moe-1b-a400m")
SHAPES = {"train_4k": dict(seq_len=64, global_batch=8, kind="train"),
          "prefill_32k": dict(seq_len=64, global_batch=8, kind="prefill"),
          "decode_32k": dict(seq_len=2048, global_batch=8, kind="decode")}
CELLS = [(a, s) for a in ARCHS_TESTED for s in SHAPES]

REF = """
import json, os, re, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
assert len(jax.devices()) == 8  # initialised before dryrun's import sets 512
from collections import defaultdict
import repro.launch.dryrun as D
import repro.launch.hlo_analysis as H
from repro.configs import ARCHS, get_config, shape_cells
from repro.launch.mesh import make_host_mesh

out_dir, shapes, cells = sys.argv[1], json.loads(sys.argv[2]), json.loads(sys.argv[3])
specs = {f"{a}/{s}": {k: [list(v.shape), str(v.dtype)] for k, v in D.input_specs(a, s).items()}
         for a in ARCHS for s in shape_cells()}

def dot_tally(text):
    m = H.HloModule(text)
    mult = defaultdict(float)
    mult[m.entry] = 1.0
    edges = m._edges()
    for _ in range(64):
        new = defaultdict(float)
        new[m.entry] = 1.0
        for a, b, f in edges:
            new[b] += mult.get(a, 0.0) * f
        if dict(new) == dict(mult):
            break
        mult = new
    tally = defaultdict(float)
    for comp, n in mult.items():
        if n <= 0 or comp not in m.comps:
            continue
        table = m.shapes(comp)
        for line in m.comps[comp]:
            om = H._OP_RE.match(line)
            if not om or om.group(3) != "dot":
                continue
            shapes_out, _ = H._shape_info(om.group(2))
            lhs = re.search(r"dot\\(([^)]*)\\)", line).group(1).split(",")[0].strip().lstrip("%")
            dims = [int(x) for x in H._shape_info(table.get(lhs, ""))[0][0][1].split(",") if x]
            k = 1
            for c in re.search(r"lhs_contracting_dims=\\{([0-9,]*)\\}", line).group(1).split(","):
                if c:
                    k *= dims[int(c)]
            tally[f"{sum(e for _, _, e in shapes_out)},{k}"] += n
    return dict(tally)

tallies = {}
analyze = H.analyze_hlo
def analyze_and_tally(text):
    tallies["last"] = dot_tally(text)
    return analyze(text)
H.analyze_hlo = analyze_and_tally
D.get_config = lambda a: get_config(a, reduced=True)
D.shape_cells = lambda: shapes
D.make_production_mesh = lambda multi_pod=False: make_host_mesh(data=4, model=2)
recs = {}
for arch, shape in cells:
    tallies.pop("last", None)
    rec = D.run_cell(arch, shape, "single", out_dir, force=True)
    rec["dots"] = tallies.get("last")
    recs[f"{arch}/{shape}"] = rec
json.dump({"records": recs, "specs": specs}, open(os.path.join(out_dir, "ref.json"), "w"))
"""


def _excluded(arch: str, shape: str) -> dict:
    """``{FLOPs of one dot: (port count - reference count, what)}``."""
    if (arch, shape) != ("granite-moe-1b-a400m", "train_4k"):
        return {}
    cfg = get_config(arch, reduced=True)
    cell = SHAPES[shape]
    # experts replicated (64 ff columns over model=2): a rank routes its
    # batch rows' (over data=4) tokens of its sequence half (over model=2)
    tokens = cell["global_batch"] // 4 * (cell["seq_len"] // 2)
    d, k = cfg.d_model, cfg.top_k
    combine = 2 * (tokens * d) * k  # [T, d] out, K = top_k
    grad_rows = 2 * (tokens * k * d) * 1  # [T, k, d] out, K = 1
    assert combine == grad_rows
    return {combine: (2 * cfg.n_layers,
                      "a layer's MoE combine einsum('tkd,tk->td') of moe_dispatch_local, "
                      "which the port runs twice (forward, remat recompute) and XLA's module "
                      "once, and its gradient with respect to the gathered rows, a product "
                      "over K = 1 that XLA writes as a multiply")}


@contextlib.contextmanager
def _patched(monkeypatch):
    from repro_torch.launch.mesh import make_host_mesh

    monkeypatch.setattr(D, "MESH_RANKS", {"single": 8, "multi": 8})
    monkeypatch.setattr(D, "get_config", lambda a: get_config(a, reduced=True))
    monkeypatch.setattr(D, "shape_cells", lambda: SHAPES)
    monkeypatch.setattr(D, "make_production_mesh",
                        lambda multi_pod=False, device=None: make_host_mesh(4, 2, device=device))
    yield


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("dryrun")
    ref_dir = d / "ref"
    ref_dir.mkdir()
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu"}
    proc = subprocess.Popen([sys.executable, "-c", REF, str(ref_dir), json.dumps(SHAPES),
                             json.dumps(CELLS)], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        mp = pytest.MonkeyPatch()
        seen = []

        class Capturing(OpAccounting):
            def __init__(self):
                super().__init__()
                seen.append(self)

        try:
            with _patched(mp):
                mp.setattr(D, "OpAccounting", Capturing)
                port = {}
                for arch, shape in CELLS:
                    seen.clear()
                    rec = D.run_cell(arch, shape, "single", str(d / "port"), force=True,
                                     device="cpu")
                    tally = Counter()
                    for (_, out, k), n in seen[-1].dots.items():
                        tally[2 * out * k] += n
                    port[(arch, shape)] = (rec, dict(tally))
        finally:
            mp.undo()
        _, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-3000:]
    with open(ref_dir / "ref.json") as f:
        ref = json.load(f)
    return {"port": port, "ref": ref, "dir": d}


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_is_ok_in_both(runs, arch, shape):
    rec, _ = runs["port"][(arch, shape)]
    ref = runs["ref"]["records"][f"{arch}/{shape}"]
    assert ref["status"] == "OK", ref.get("error")
    assert rec["status"] == "OK", rec.get("traceback")
    assert rec["n_devices"] == ref["n_devices"] == 8
    assert rec["mesh_shape"] == ref["mesh_shape"] == {"data": 4, "model": 2}


@pytest.mark.parametrize("arch,shape", CELLS)
def test_argument_and_alias_bytes_equal(runs, arch, shape):
    got = runs["port"][(arch, shape)][0]["memory_analysis"]
    want = runs["ref"]["records"][f"{arch}/{shape}"]["memory_analysis"]
    assert got["argument_size_in_bytes"] == want["argument_size_in_bytes"]
    assert got["alias_size_in_bytes"] == want["alias_size_in_bytes"]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_dot_flops_equal_dot_for_dot(runs, arch, shape):
    rec, port = runs["port"][(arch, shape)]
    ref_rec = runs["ref"]["records"][f"{arch}/{shape}"]
    ref = Counter()
    for key, n in ref_rec["dots"].items():
        out, k = (int(float(x)) for x in key.split(","))
        ref[2 * out * k] += n
    diff = {key: port.get(key, 0) - ref.get(key, 0) for key in set(port) | set(ref)}
    diff = {key: n for key, n in diff.items() if n}
    excluded = _excluded(arch, shape)
    assert diff == {key: n for key, (n, _) in excluded.items()}
    cut = sum(flops * n for flops, (n, _) in excluded.items())
    assert rec["loop_aware"]["dot_flops"] - cut == ref_rec["loop_aware"]["dot_flops"]
    assert rec["cost_analysis"]["flops"] == rec["loop_aware"]["dot_flops"]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_collectives_recorded(runs, arch, shape):
    """Counts are recorded beside the reference's, not held equal."""
    rec, _ = runs["port"][(arch, shape)]
    ref = runs["ref"]["records"][f"{arch}/{shape}"]
    print(f"{arch} {shape}: port {rec['collectives']['counts']} "
          f"reference {ref['collectives']['counts']}")
    assert rec["collectives"]["counts"].keys() == ref["collectives"]["counts"].keys()
    assert rec["collectives"]["total_bytes"] == sum(rec["collectives"]["bytes"].values()) > 0
    assert rec["collectives"]["counts"]["all-to-all"] == 0  # the CPU group: all-gather
    assert rec["loop_aware"]["collective_counts"] == rec["collectives"]["counts"]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_record_keeps_reference_keys(runs, arch, shape):
    rec, _ = runs["port"][(arch, shape)]
    ref = runs["ref"]["records"][f"{arch}/{shape}"]
    assert set(rec) == set(ref) - {"dots"}
    assert rec["memory_analysis"].keys() == ref["memory_analysis"].keys()
    assert rec["loop_aware"].keys() == ref["loop_aware"].keys()
    assert {"flops", "bytes accessed"} <= set(ref["cost_analysis"])
    assert set(rec["cost_analysis"]) == {"flops", "bytes accessed"}
    assert rec["compile_s"] is None and rec["memory_analysis"]["generated_code_size_in_bytes"] == 0
    assert rec["memory_analysis"]["temp_size_in_bytes"] > 0
    with open(runs["dir"] / "port" / f"{arch}__{shape}__single.json") as f:
        assert json.load(f) == rec


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", list(shape_cells()))
def test_input_specs_match_reference(runs, arch, shape):
    got = {k: [list(v.shape), str(v.dtype).removeprefix("torch.")]
           for k, v in D.input_specs(arch, shape).items()}
    assert all(v.device.type == "meta" for v in D.input_specs(arch, shape).values())
    assert got == runs["ref"]["specs"][f"{arch}/{shape}"]


def test_no_process_group_is_left(runs):
    assert not dist.is_initialized()


def test_skip_record_is_the_reference_rule(tmp_path):
    rec = D.run_cell("hubert-xlarge", "decode_32k", "single", str(tmp_path), device="cpu")
    assert rec == {"arch": "hubert-xlarge", "shape": "decode_32k", "mesh": "single",
                   "status": "SKIP", "reason": "encoder-only arch has no decode step"}
    assert not dist.is_initialized()


def test_cached_record_is_returned(monkeypatch, tmp_path, capsys):
    with _patched(monkeypatch):
        first = D.run_cell("qwen3-1.7b", "decode_32k", "single", str(tmp_path), device="cpu")
        again = D.run_cell("qwen3-1.7b", "decode_32k", "single", str(tmp_path), device="cpu")
    assert again == first and "[skip-cached] qwen3-1.7b__decode_32k__single" in capsys.readouterr().out


def test_failing_cell_is_recorded_and_its_group_destroyed(monkeypatch, tmp_path):
    def broken(*args, **kwargs):
        raise RuntimeError("no placement")

    with _patched(monkeypatch):
        monkeypatch.setattr(D, "build_cell", broken)
        rec = D.run_cell("qwen3-1.7b", "train_4k", "single", str(tmp_path), device="cpu")
    assert rec["status"] == "FAIL" and rec["error"] == "RuntimeError: no placement"
    assert "no placement" in rec["traceback"]
    assert not dist.is_initialized()


def test_group_of_another_size_is_refused(monkeypatch, tmp_path):
    import torch.testing._internal.distributed.fake_pg  # noqa: F401 -- registers "fake"

    dist.init_process_group("fake", store=dist.HashStore(), rank=0, world_size=4)
    try:
        with _patched(monkeypatch), pytest.raises(ValueError, match="needs 8 ranks"):
            D.run_cell("qwen3-1.7b", "train_4k", "single", str(tmp_path), device="cpu")
        assert dist.is_initialized()  # not the dry run's to destroy
    finally:
        dist.destroy_process_group()


def test_device_none_needs_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with _patched(monkeypatch), pytest.raises(RuntimeError, match="CUDA"):
        D.run_cell("qwen3-1.7b", "train_4k", "single", str(tmp_path))
    assert not dist.is_initialized()


def test_cli_runs_a_cell(monkeypatch, tmp_path, capsys):
    with _patched(monkeypatch), pytest.raises(SystemExit) as done:
        D.main(["--arch", "granite-moe-1b-a400m", "--shape", "prefill_32k", "--mesh", "single",
                "--out", str(tmp_path), "--device", "cpu"])
    assert done.value.code == 0
    out = capsys.readouterr().out
    assert "[ok] granite-moe-1b-a400m__prefill_32k__single" in out and "failures: 0" in out
    with open(tmp_path / "granite-moe-1b-a400m__prefill_32k__single.json") as f:
        assert json.load(f)["status"] == "OK"
