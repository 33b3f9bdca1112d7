"""The port imports torch and numpy only: never jax, never the reference."""
import os
import re
import subprocess
import sys

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SRC = os.path.join(ROOT, "src")


def test_port_imports_neither_jax_nor_reference():
    code = (
        "import sys; "
        "import repro_torch, repro_torch.query, repro_torch.kernels.threshold_ssum, "
        "repro_torch.convert, repro_torch.storage, repro_torch.core.threshold, "
        "repro_torch.kernels.tiled_scan, repro_torch.storage.tiled, repro_torch.obs, "
        "repro_torch.persist, repro_torch.core.listalgos, repro_torch.storage.tiles, "
        "repro_torch.core.symmetric, repro_torch.core.blockrle, repro_torch.kernels.ops, "
        "repro_torch.stream, repro_torch.stream.delta, repro_torch.stream.overlay, "
        "repro_torch.stream.index, repro_torch.persist.format, repro_torch.persist.snapshot, "
        "repro_torch.persist.wal, repro_torch.persist.tiers, repro_torch.serve, "
        "repro_torch.serve.frontend, repro_torch.search, repro_torch.search.tokenize, "
        "repro_torch.search.similarity, repro_torch.search.window, repro_torch.dist, "
        "repro_torch.dist.query, repro_torch.persist.shards, repro_torch.serve.masks, "
        "repro_torch.data, repro_torch.data.paper_datasets, repro_torch.configs, "
        "repro_torch.configs.registry, repro_torch.models, repro_torch.models.layers, "
        "repro_torch.models.rglru, repro_torch.models.rwkv6, repro_torch.models.model, "
        "repro_torch.serve.engine, repro_torch.launch, repro_torch.launch.serve, "
        "repro_torch.train, repro_torch.train.optimizer, repro_torch.train.step, "
        "repro_torch.data.pipeline, repro_torch.ckpt, repro_torch.ckpt.manager, "
        "repro_torch.ft, repro_torch.ft.monitor, repro_torch.launch.train, "
        "repro_torch.dist.context, repro_torch.dist.compression, repro_torch.dist.pipeline, "
        "repro_torch.launch.mesh, repro_torch.launch.sharding, repro_torch.launch.dryrun, "
        "repro_torch.launch.hlo_analysis; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'repro' or m.startswith('repro.')]; "
        "print('BAD', bad); sys.exit(1 if bad else 0)"
    )
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True)
    assert out.returncode == 0, out.stdout + out.stderr


def test_sources_name_neither_jax_nor_reference():
    pat = re.compile(r"^\s*(import\s+jax|from\s+jax|import\s+repro\b(?!_)|from\s+repro\b(?!_)"
                     r"|import\s+repro\.|from\s+repro\.)", re.M)
    files = [os.path.join(ROOT, "chip_smoke.py"), os.path.join(ROOT, "tools", "k1_ab.py")]
    for base, _dirs, names in os.walk(os.path.join(SRC, "repro_torch")):
        files += [os.path.join(base, n) for n in names if n.endswith(".py")]
    assert len(files) > 15
    for new in ("serve/frontend.py", "search/tokenize.py", "search/similarity.py",
                "search/window.py", "dist/__init__.py", "dist/query.py", "persist/shards.py",
                "serve/masks.py", "data/__init__.py", "data/paper_datasets.py",
                "configs/base.py", "configs/registry.py", "models/layers.py", "models/rglru.py",
                "models/rwkv6.py", "models/model.py", "serve/engine.py", "launch/serve.py",
                "train/__init__.py", "train/optimizer.py", "train/step.py", "data/pipeline.py",
                "ckpt/__init__.py", "ckpt/manager.py", "ft/__init__.py", "ft/monitor.py",
                "launch/train.py", "dist/context.py", "dist/compression.py",
                "dist/pipeline.py", "launch/mesh.py", "launch/sharding.py",
                "launch/dryrun.py", "launch/hlo_analysis.py"):
        assert os.path.join(SRC, "repro_torch", *new.split("/")) in files
    for path in files:
        with open(path) as f:
            hit = pat.search(f.read())
        assert hit is None, f"{path}: {hit.group(0)!r}"


def test_importing_the_port_builds_nothing():
    """No kernel build (and no triton / nvcc lookup) happens at import time."""
    code = (
        "import sys, subprocess; "
        "subprocess.run = None; subprocess.Popen = None; "
        "import repro_torch.kernels.threshold_ssum, repro_torch.kernels._build, "
        "repro_torch.kernels.tiled_scan, repro_torch.storage.tiled; "
        "print('ok')"
    )
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True)
    assert out.returncode == 0 and "ok" in out.stdout, out.stdout + out.stderr


def test_chip_smoke_refuses_to_run_without_a_card():
    """Without CUDA chip_smoke.py exits non-zero and reports nothing as ok."""
    import torch

    if torch.cuda.is_available():  # decided inside the test, not at import
        import pytest

        pytest.skip("a CUDA device is present: this checks the no-card refusal")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                         capture_output=True, text=True, cwd=ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
