"""Roofline analysis from the port's dry-run records.

Per (arch x shape x mesh) cell of ``python -m repro_torch.launch.dryrun``:
    compute term    = dot_FLOPs_per_rank / PEAK_FLOPS
    memory term     = hbm_traffic_proxy_per_rank / HBM_BW
    collective term = collective_bytes_per_rank / LINK_BW

The peaks are one NVIDIA H100 SXM's published rates (NVIDIA's data sheet,
dense, at its 700 W power limit): 989 TFLOP/s in bf16 (the dry run's
parameters are bf16), 3.35 TB/s of HBM, and NVLink's 450 GB/s each way
between the cards of one 8-card host.  A mesh of 256 or 512 ranks spans
many hosts, whose network is slower than NVLink, so the collective term is
a lower bound.  A card set below 700 W (``nvidia-smi``'s ``power.limit``)
runs slower than these peaks.

The dry run places one rank's program, so every count in a record is
already per rank; dividing by one card's peaks is the global form FLOPs /
(ranks x peak).  MODEL_FLOPS uses the 6ND / 2ND convention on active
params.  ``hbm_traffic_proxy`` is what ``OpAccounting``
(``repro_torch/launch/hlo_analysis.py``) counts: every op that is not a
view writes its outputs once and a consumer reads them once (2x the
output bytes of every op, parameters' first reads not counted), with no
fusion -- an eager program's traffic, not a compiled one's.

The port's counterpart of ``benchmarks/roofline.py``: it reads
``artifacts/pt_dryrun`` (the port's dry-run default) and writes
``artifacts/pt_roofline.md``.

    PYTHONPATH=src:. python benchmarks/pt_roofline.py [dry-run dir]
"""
from __future__ import annotations

import glob
import json
import os

#: the card the peaks are of, and the power limit they assume
CARD = "NVIDIA H100 SXM, 700 W"
PEAK_FLOPS = 989e12  # dense bf16 on the tensor cores
HBM_BW = 3.35e12
LINK_BW = 450e9  # NVLink, each way, within one 8-card host

DRYRUN_DIR = "artifacts/pt_dryrun"
MARKDOWN_PATH = "artifacts/pt_roofline.md"

_PCACHE: dict[str, int] = {}


def model_flops(arch: str, shape: str, n_devices: int) -> float:
    from repro_torch.configs import get_config, shape_cells

    cfg = get_config(arch)
    if arch not in _PCACHE:
        _PCACHE[arch] = cfg.active_param_count()
    n_active = _PCACHE[arch]
    cell = shape_cells()[shape]
    b, s, kind = cell["global_batch"], cell["seq_len"], cell["kind"]
    if kind == "train":
        tokens, mult = b * s, 6
    elif kind == "prefill":
        tokens, mult = b * s, 2
    else:  # decode: one new token per sequence
        tokens, mult = b, 2
    return mult * n_active * tokens / n_devices


def analyze(artifact: dict) -> dict | None:
    if artifact.get("status") != "OK":
        return None
    la = artifact.get("loop_aware")
    if la:  # OpAccounting's counts (every record the port writes has them)
        flops = la["dot_flops"]
        byts = la["hbm_traffic_proxy"]
        coll = la["collective_total"]
    else:  # a record with cost_analysis only
        flops = artifact["cost_analysis"].get("flops", 0.0)
        byts = artifact["cost_analysis"].get("bytes accessed", 0.0)
        coll = artifact["collectives"]["total_bytes"]
    terms = {
        "compute_s": flops / PEAK_FLOPS,
        "memory_s": byts / HBM_BW,
        "collective_s": coll / LINK_BW,
    }
    dominant = max(terms, key=terms.get)
    step_s = max(terms.values())
    mf = model_flops(artifact["arch"], artifact["shape"], artifact["n_devices"])
    return {
        "arch": artifact["arch"],
        "shape": artifact["shape"],
        "mesh": artifact["mesh"],
        **{k: round(v * 1e3, 3) for k, v in terms.items()},  # ms
        "dominant": dominant.replace("_s", ""),
        "model_flops_per_dev": mf,
        "useful_flops_ratio": round(mf / flops, 3) if flops else 0.0,
        "roofline_fraction": round((mf / PEAK_FLOPS) / step_s, 3) if step_s else 0.0,
        "hlo_flops": flops,
        "hlo_bytes": byts,
        "coll_bytes": coll,
    }


def run(art_dir: str = DRYRUN_DIR):
    out = []
    rows = []
    for f in sorted(glob.glob(os.path.join(art_dir, "*.json"))):
        with open(f) as fh:
            rec = analyze(json.load(fh))
        if rec:
            rows.append(rec)
    for r in rows:
        tag = f"roofline_{r['arch']}_{r['shape']}_{r['mesh']}"
        out.append(
            (
                tag,
                max(r["compute_s"], r["memory_s"], r["collective_s"]) * 1e3,
                f"dom={r['dominant']} frac={r['roofline_fraction']} "
                f"useful={r['useful_flops_ratio']}",
            )
        )
    return out, rows


def write_markdown(rows, path=MARKDOWN_PATH):
    hdr = (
        f"Peaks of one {CARD}: {PEAK_FLOPS / 1e12:.0f} TFLOP/s bf16, "
        f"{HBM_BW / 1e12:.2f} TB/s HBM, {LINK_BW / 1e9:.0f} GB/s NVLink each way.\n\n"
        "| arch | shape | mesh | compute ms | memory ms | collective ms | dominant "
        "| MODEL/HLO flops | roofline frac |\n|---|---|---|---|---|---|---|---|---|\n"
    )
    lines = [
        f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r['compute_s']} | {r['memory_s']} "
        f"| {r['collective_s']} | {r['dominant']} | {r['useful_flops_ratio']} "
        f"| {r['roofline_fraction']} |"
        for r in rows
    ]
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(hdr + "\n".join(lines) + "\n")
    return path


if __name__ == "__main__":
    import sys

    res, rows = run(*sys.argv[1:2])
    for name, val, extra in res:
        print(f"{name},{val:.3f},{extra}")
    print("wrote", write_markdown(rows))
