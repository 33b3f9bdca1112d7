"""What a run loads: no JAX, no JAX package, nothing of the repository's
other benchmark scripts; the reference loads nothing of the program."""
import json
import re
import subprocess
import sys

import _bench

PROBE = r"""
import json, sys
sys.path[:0] = [{root!r}, {src!r}]
from bench import common, run, control
from bench import reference, roofline, templates, tracing, program
for sub in ("datagen", "loops", "metrics"):
    for path in sorted((common.BENCH_DIR / sub).glob("*.py")):
        common.load_module(path, path.stem)
import repro_torch.query, repro_torch.serve, repro_torch.stream, repro_torch.obs
tops = sorted({{m.split(".", 1)[0] for m in sys.modules}})
print(json.dumps(tops))
"""


def test_the_harness_and_the_program_load_no_jax():
    code = PROBE.format(root=str(_bench.ROOT), src=str(_bench.ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=_bench.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in tops and "bench" in tops
    assert not tops & {"jax", "jaxlib", "flax", "repro"}


def test_the_reference_and_generators_load_nothing_of_the_program():
    code = (f"import sys; sys.path[:0] = [{str(_bench.ROOT)!r}]\n"
            "from bench import reference, roofline, templates, common\n"
            "from bench.datagen import clustered, uniform\n"
            "print(sorted({m.split('.', 1)[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=_bench.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "repro_torch" not in out.stdout and "'repro'" not in out.stdout


def test_no_file_of_the_harness_reads_the_other_benchmark_scripts():
    pattern = re.compile(r"\bbenchmarks\b|chip_smoke|\btools[/.]|import jax|from jax|"
                         r"import repro\b|from repro\b|from repro import|import repro\.")
    for path in (_bench.ROOT / "bench").rglob("*.py"):
        if path.parent.name == "tests":
            continue
        text = path.read_text()
        hits = [m.group(0) for m in pattern.finditer(text)]
        assert not hits, f"{path}: {hits}"
