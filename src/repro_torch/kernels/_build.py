"""Build the CUDA sources under ``csrc/`` with ``nvcc`` and load them.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled for
``sm_90a`` into a shared library that ``ctypes`` loads; pointers and the
stream cross as integers, and no source includes PyTorch's headers.
``nvcc`` links its CUDA runtime statically, beside the one PyTorch loaded:
both attach to the device's one primary context, and device pointers and
stream handles belong to that context, so they are valid in either.

The library goes into ``build/repro_torch_kernels/`` at the root of the
checkout, named after a hash of its source, at first use.  Nothing is built when the module is imported.
A build or load failure raises: there is no other path on a CUDA device.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["load_library", "build_dir", "nvcc_path", "build_seconds"]

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_LIBS: dict[str, ctypes.CDLL] = {}
#: seconds each library's build took in this process (0.0: found already built)
build_seconds: dict[str, float] = {}


def build_dir() -> Path:
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"


def nvcc_path() -> str:
    for cand in (
        os.environ.get("NVCC"),
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, $NVCC, $CUDA_HOME/bin): the CUDA kernels of "
        "repro_torch are compiled from source at first use"
    )


def load_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if its library is not built yet, load it."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out_dir = build_dir()
    os.makedirs(out_dir, exist_ok=True)
    so = out_dir / f"lib{name}-{digest}.so"
    if not so.exists():
        t0 = time.perf_counter()
        tmp = out_dir / f"lib{name}-{digest}.{os.getpid()}.tmp.so"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {src} (exit {proc.returncode}):\n"
                f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, so)  # atomic: a concurrent build never loads half a file
        build_seconds[name] = time.perf_counter() - t0
    else:
        build_seconds.setdefault(name, 0.0)
    lib = ctypes.CDLL(str(so))
    _LIBS[name] = lib
    return lib
