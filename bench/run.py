"""Run one cell of ``BENCHMARK.json`` and print its result as one JSON line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up makes the configuration's data on the card from the seed, builds the
program's index and warms the cell's own queries; the window then drives
the traffic's loop for ``--seconds``.  After the window the peak memory is
read, the program's state is freed, and the plain reference checks a
sample of the window's results drawn from the seed.  With ``--trace 1`` the
per-layer metrics are read instead of the end-to-end ones.

Exits 3 without a result when there is no CUDA card (or fewer than the cell
asks for), 4 when JAX or the JAX package was loaded.
"""
from __future__ import annotations

import os
import time


def _process_start() -> float:
    """The process's start on the ``perf_counter`` clock (Linux: from
    ``/proc``, so the interpreter's own start-up counts as set-up)."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


T_PROCESS = _process_start()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
from pathlib import Path  # noqa: E402

_ROOT = Path(__file__).resolve().parent.parent


def _environment(root: Path) -> None:
    """Caches inside the checkout at fixed paths; no JAX through libraries."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(root / "build" / "triton_cache"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(root / "build" / "torch_extensions"))
    os.environ["USE_FLAX"] = "0"
    for p in (str(root / "src"), str(root)):
        if p not in sys.path:
            sys.path.insert(0, p)


_environment(_ROOT)

import torch  # noqa: E402

from bench import common, program, reference  # noqa: E402
from bench.tracing import TraceWindow  # noqa: E402


class NoDevice(RuntimeError):
    pass


class Layout:
    """Where the parts of a cell are found: BENCHMARK.json at ``root``, and
    each part under the first of ``dirs`` that holds it."""

    def __init__(self, root: Path, dirs=None):
        self.root = Path(root)
        self.spec = common.load_json(self.root / "BENCHMARK.json")
        self.dirs = [Path(d) for d in (dirs or [self.root / "bench"])]
        if common.BENCH_DIR not in self.dirs:
            self.dirs.append(common.BENCH_DIR)

    def find(self, rel: str) -> Path:
        for d in self.dirs:
            if (d / rel).exists():
                return d / rel
        raise FileNotFoundError(f"{rel} under none of {[str(d) for d in self.dirs]}")

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return common.load_json(self.root / c["file"])
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def metrics(self, key: str, cell: str) -> list:
        return [m for m in self.spec[key] if cell in m.get("workloads", [cell])]


class Run:
    """One run of one cell: what the loop fills in, and what is read after."""

    def __init__(self, layout: Layout, workload: str, seed: int, seconds: float,
                 trace: bool, device, overrides: dict | None = None):
        self.layout = layout
        self.cell = layout.cell(workload)
        self.cfg = dict(layout.config(self.cell["config"]), **(overrides or {}))
        self.traffic = common.load_json(layout.find(f"traffic/{self.cell['traffic']}.json"))
        self.seed, self.seconds, self.trace = int(seed), float(seconds), bool(trace)
        self.device = torch.device(device)
        self.n_cols, self.r = int(self.cfg["columns"]), int(self.cfg["universe"])
        self.n_words = (self.r + 31) // 32
        self.columns = None
        self.lock = threading.Lock()
        self.tracer = TraceWindow(self.trace, self.device)
        # filled by the loop
        self.latencies: list = []   # seconds, every request started in the window
        self.completed = 0          # requests done by the window's close
        self.attempted = 0
        self.failed = 0
        self.errors: list = []
        self.samples: list = []     # (spec, result, version or None)
        self.traced: list = []      # specs of the requests done in the traced stretch
        self.update_latencies: list = []
        self.updates: list = []     # update batches in the order applied
        self.applied = 0
        self.layer: dict = {}       # readings the per-layer metrics take
        self.notes: dict = {}       # printed on standard error
        self.t_open = self.t_close = None
        self.datagen = None
        self.program = program      # the factories a loop builds the system under test with
        self._ref_columns = None

    def ref_columns(self):
        """The reference's own copy of the data, made again from the seed
        once the program's state is gone."""
        if self._ref_columns is None:
            self._ref_columns = self.datagen.generate(self.cfg, self.seed, self.device)
        return self._ref_columns

    def open_window(self) -> float:
        self.t_open = time.perf_counter()
        self.t_close = self.t_open + self.seconds
        lead = min(1.0, 0.1 * self.seconds)
        span = min(float(self.traffic.get("trace_seconds", 3.0)), self.seconds - lead)
        self.tracer.schedule(self.t_open + lead, span)
        return self.t_close

    def record(self, t0: float, t1: float, spec: dict) -> None:
        """One request started at ``t0`` in the window, done at ``t1``."""
        with self.lock:
            self.latencies.append(t1 - t0)
            if t1 <= self.t_close:
                self.completed += 1
            if self.tracer.state == "on" and t0 >= self.tracer.host[0]:
                self.traced.append(spec)

    def fail(self, exc: BaseException) -> None:
        with self.lock:
            self.failed += 1
            if len(self.errors) < 5:
                self.errors.append(f"{type(exc).__name__}: {exc}")


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def check(run: Run) -> dict:
    """Hold the sampled results to the plain reference, on data made again
    from the seed with the run's updates applied by the reference itself."""
    cols = run.ref_columns()
    mismatched = 0
    wrong = 0
    applied = 0
    for spec, got, version in sorted(run.samples, key=lambda s: s[2] or 0):
        while version is not None and applied < version:
            col, sets, clears = run.updates[applied]
            reference.apply_update(cols, col, sets, clears)
            applied += 1
        want = reference.evaluate(cols, spec, run.r)
        m = reference.mismatched_words(got, want)
        mismatched += m
        wrong += m > 0
    sync(run.device)
    return {
        "mismatched_words": {"value": mismatched, "limit": 0},
        "wrong_answers": {"value": wrong, "limit": 0},
        "failed_requests": {"value": run.failed, "limit": 0},
        "checked_answers": {"value": len(run.samples), "limit": 1},
    }


def passed(checks: dict) -> bool:
    c = checks
    return (c["mismatched_words"]["value"] <= c["mismatched_words"]["limit"]
            and c["wrong_answers"]["value"] <= c["wrong_answers"]["limit"]
            and c["failed_requests"]["value"] <= c["failed_requests"]["limit"]
            and c["checked_answers"]["value"] >= c["checked_answers"]["limit"])


def end_to_end(run: Run, setup_s: float) -> dict:
    """The cell's end-to-end metrics: the built-in ones below, or, for a
    name they do not cover, the reader ``metrics/<name>.py``."""
    built = {"setup_s": (setup_s, "s")}
    if run.latencies:
        built["queries_per_s"] = (run.completed / run.seconds, "queries/s")
        built["query_p50_ms"] = (1e3 * common.quantile(run.latencies, 0.50), "ms")
        built["query_p95_ms"] = (1e3 * common.quantile(run.latencies, 0.95), "ms")
    if run.update_latencies:
        built["update_p95_ms"] = (1e3 * common.quantile(run.update_latencies, 0.95), "ms")
    out = {}
    for m in run.layout.metrics("end_to_end", run.cell["name"]):
        if m["name"] in built:
            value = built[m["name"]][0]
        else:
            reader = common.load_module(run.layout.find(f"metrics/{m['name']}.py"), m["name"])
            value = reader.read(run, None)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def per_layer(run: Run, prof: dict | None) -> dict:
    out = {}
    for m in run.layout.metrics("per_layer", run.cell["name"]):
        reader = common.load_module(run.layout.find(f"metrics/{m['name']}.py"), m["name"])
        value = reader.read(run, prof)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def device_info(run: Run, peak: int, prof: dict | None) -> dict:
    if run.device.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(run.device),
                "count": int(run.cell.get("chips", 1)), "memory_peak_bytes": int(peak)}
        try:
            q = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                               capture_output=True, text=True, timeout=20)
            info["power_limit"] = q.stdout.strip().splitlines()[0] if q.returncode == 0 else None
        except (OSError, subprocess.SubprocessError, IndexError):
            info["power_limit"] = None
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    if prof is not None:
        info["busy_s"] = prof["busy_s"]
        info["window_s"] = prof["window_s"]
    return info


def run_cell(layout: Layout, workload: str, seed: int, seconds: float, trace: bool,
             device=None, overrides: dict | None = None, t_start: float | None = None,
             stand_in=None) -> dict:
    """One run; returns the result line's object (``correct`` and all).
    ``stand_in`` (a module with ``bench/program.py``'s factories) is built
    in the program's place under the same loop: the control uses it."""
    t_start = T_PROCESS if t_start is None else t_start
    if device is None:
        if not torch.cuda.is_available():
            raise NoDevice("torch.cuda.is_available() is false")
        device = torch.device("cuda", 0)
    run = Run(layout, workload, seed, seconds, trace, device, overrides)
    if run.device.type == "cuda" and torch.cuda.device_count() < int(run.cell.get("chips", 1)):
        raise NoDevice(f"{torch.cuda.device_count()} CUDA devices, the cell asks for "
                       f"{run.cell['chips']}")
    run.datagen = common.load_module(layout.find(f"datagen/{run.cfg['generator']}.py"),
                                     run.cfg["generator"])
    loop = common.load_module(layout.find(f"loops/{run.traffic['loop']}.py"), run.traffic["loop"])
    if stand_in is not None:
        run.program = stand_in
    if run.device.type == "cuda":
        torch.cuda.set_device(run.device)
        torch.cuda.reset_peak_memory_stats(run.device)
    run.columns = run.datagen.generate(run.cfg, run.seed, run.device)
    loop.setup(run)
    run.tracer.prime()
    sync(run.device)
    setup_s = time.perf_counter() - t_start
    loop.window(run)
    run.tracer.finish()
    sync(run.device)
    peak = torch.cuda.max_memory_allocated(run.device) if run.device.type == "cuda" else 0
    prof = run.tracer.read()
    loop.teardown(run)
    run.columns = None
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    metrics = per_layer(run, prof) if trace else end_to_end(run, setup_s)
    checks = check(run)
    result = {
        "correct": passed(checks),
        "attempted": run.attempted,
        "failed": run.failed,
        "metrics": metrics,
        "device": device_info(run, peak, prof),
    }
    if prof is not None and prof["busy_s"] > 0:
        result["breakdown"] = {"device_ops": prof["device_ops"], "idle_gaps": prof["idle_gaps"]}
    result["checks"] = checks
    run.notes.update(setup_s=setup_s, requests=len(run.latencies), errors=run.errors,
                     updates_applied=run.applied)
    if run.latencies:
        run.notes["query_p50_ms"] = 1e3 * common.quantile(run.latencies, 0.50)
    if prof is not None:
        run.notes["trace"] = {k: prof[k] for k in ("window_s", "busy_s", "device_intervals",
                                                   "host_window_s")}
    result["_notes"] = run.notes
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        result = run_cell(Layout(_ROOT), args.workload, args.seed, args.seconds,
                          bool(args.trace))
    except NoDevice as e:
        print(f"bench: no result: {e}", file=sys.stderr)
        return 3
    found = common.forbidden_loaded()
    if found:
        print(f"bench: no result: forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return 4
    notes = result.pop("_notes")
    print(json.dumps({"notes": notes}, default=str), file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
