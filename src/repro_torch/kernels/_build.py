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

__all__ = ["load_library", "build_libraries", "build_dir", "nvcc_path", "build_seconds"]

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


def _library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return build_dir() / f"lib{name}-{digest}.so"


def build_libraries(names) -> None:
    """Compile every ``csrc/<name>.cu`` of ``names`` that is not built yet,
    one ``nvcc`` per source, all started together; raises if any fails."""
    os.makedirs(build_dir(), exist_ok=True)
    started = []
    for name in names:
        so = _library_path(name)
        if so.exists():
            build_seconds.setdefault(name, 0.0)
            continue
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        started.append((name, so, tmp, cmd, proc, time.perf_counter()))
    failed = []
    for name, so, tmp, cmd, proc, t0 in started:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name} (exit {proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{out}\n{err}")
            continue
        os.replace(tmp, so)  # atomic: a concurrent build never loads half a file
        build_seconds[name] = time.perf_counter() - t0
    if failed:
        raise RuntimeError("\n".join(failed))


def load_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if its library is not built yet, load it."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    build_libraries([name])
    lib = ctypes.CDLL(str(_library_path(name)))
    _LIBS[name] = lib
    return lib
