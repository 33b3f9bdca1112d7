"""The port's paper-benchmark CLI: one section per paper table/figure.

The counterpart of ``benchmarks/run.py`` for ``repro_torch``, on the CUDA
card unless ``--device`` names another device.  Prints ``name,value,derived``
CSV lines, row names as the reference's.  Sections, in the reference's
order:
  table5   -- row scan vs bitmap index (paper Table 5)
  table7   -- circuit gate counts vs Tables 6/7/8 (paper-faithfulness check)
  fig3     -- scaling with N and T (paper Figs 3/4)
  table10  -- workload ranking across algorithm families (paper 5.9)
  heatmap  -- SMALL-COMPETITIONS win/terrible rates (paper 5.8, App. C)
  kernel   -- the circuit kernel's bytes model and launch shape + torch-op
              wall-times
  weighted -- weighted thresholds: replication vs binary decomposition
  query    -- unified query API: composed-circuit vs leafwise, batching,
              compiled-circuit cache (repro_torch.query)
  stream   -- streaming update engine: delta apply + view refresh vs full
              rebuild, compaction amortization (repro_torch.stream; smoke
              sizes)
  persist  -- on-disk format: snapshot size vs density, cold-load-to-
              first-query vs rebuild, WAL replay throughput
              (repro_torch.persist; scratch snapshots in a temp dir,
              removed on exit)
  serve    -- multi-client serving front-end: coalesced QPS vs sequential
              across client counts, cache/dedup/shed rates, batch-size
              histogram, plan-memo + calibration counters
              (repro_torch.serve; smoke sizes and contracts)
  obs      -- observability overhead: metrics+tracing ON vs OFF per-query
              cost, disabled-site cost, drift sample counts, Prometheus
              scrape lint (repro_torch.obs; smoke sizes and contracts)
  search   -- similarity search + windowed analytics: bitmap candidate
              generation raced vs MergeOpt / DivideSkip / WHEAP at the same
              T, adaptive top-k, window refresh words-touched vs the
              touched-tiles bound (repro_torch.search; smoke sizes and
              contract)
  roofline -- three-term roofline per dry-run cell against one H100's
              peaks (reads artifacts/pt_dryrun from ``python -m
              repro_torch.launch.dryrun``; runs nothing on a device)

Artifacts go to ``artifacts/pt_bench/`` (``artifacts/pt_roofline.md`` for
the roofline table).  A section that raises is reported with its
traceback, the others still run, and the CLI exits 1.

    PYTHONPATH=src:. python benchmarks/pt_run.py [section ...] [--device cpu]
"""
from __future__ import annotations

import argparse
import importlib
import traceback

#: ported sections, in the reference's order, and the module of each
SECTIONS = {
    "table5": "pt_table5_rowscan",
    "table7": "pt_table7_gates",
    "fig3": "pt_fig3_scaling",
    "table10": "pt_table10_workload",
    "heatmap": "pt_heatmap_competitions",
    "kernel": "pt_kernel_bench",
    "weighted": "pt_weighted_bench",
    "query": "pt_query_bench",
    "stream": "pt_stream_bench",
    "persist": "pt_persist_bench",
    "serve": "pt_serve_bench",
    "obs": "pt_obs_bench",
    "search": "pt_search_bench",
    "roofline": "pt_roofline",
}
#: the sections the reference's CLI runs at their ``--smoke`` shapes
SMOKE_SECTIONS = ("stream", "persist", "serve", "obs", "search")


def run_section(section: str, device=None) -> list:
    """The rows of one section; raises ``ValueError`` for an unknown one."""
    if section not in SECTIONS:
        raise ValueError(f"unknown section {section}")
    mod = importlib.import_module(f"benchmarks.{SECTIONS[section]}")
    if section == "roofline":
        rows, table = mod.run()
        if table:
            print(f"# roofline table -> {mod.write_markdown(table)}")
        return rows
    if section in SMOKE_SECTIONS:
        return mod.run(smoke=True, device=device)
    return mod.run(device=device)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("sections", nargs="*", default=list(SECTIONS))
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the CUDA card)")
    args = ap.parse_args(argv)
    failures = 0
    for section in args.sections:
        print(f"# --- {section} ---")
        try:
            rows = run_section(section, args.device)
            for name, val, extra in rows:
                print(f"{name},{val if isinstance(val, int) else round(float(val), 3)},{extra}")
        except Exception:  # noqa: BLE001  (a section's failure is reported, the rest run)
            failures += 1
            traceback.print_exc()
    if failures:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
