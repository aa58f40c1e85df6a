"""Runs one cell of BENCHMARK.json once and builds its result line.

Everything a cell needs is found by name:

* the configuration: the file that BENCHMARK.json's `configs` entry names;
* the traffic mix: `traffic/<traffic>.json`, whose "driver" key names the
  generator that reads it, `drivers/<driver>.py` (a `run(ctx)` function);
* each per-layer metric: `metrics/<name>.py`, a `read(ctx)` function that
  returns a number or None (nothing to read: the metric is left out);
* the limits of the correctness check: `limits/<workload>.json`.

A later change adds a cell, a mix, a configuration or a metric by adding
files and entries; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "bridgelang_tpu")


def load_module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def find_cell(bench: Dict, workload: str) -> Dict:
    for cell in bench["workloads"]:
        if cell["name"] == workload:
            return cell
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json; have {[c['name'] for c in bench['workloads']]}")


def applies(metric: Dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(root: Path, bench: Dict, workload: str) -> Dict[str, Any]:
    """The cell, its configuration, traffic mix, driver and limits."""
    cell = find_cell(bench, workload)
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    bench_dir = HERE
    traffic = json.loads((bench_dir / "traffic" / f"{cell['traffic']}.json").read_text())
    return {
        "cell": cell,
        "config": json.loads((root / config["file"]).read_text()),
        "traffic": traffic,
        "driver": load_module(bench_dir / "drivers" / f"{traffic['driver']}.py", f"bench_driver_{traffic['driver']}"),
        "limits": json.loads((bench_dir / "limits" / f"{workload}.json").read_text()),
    }


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one the benchmark must not reach."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def nvidia_smi() -> Dict[str, str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return {"nvidia_smi": f"unavailable: {e}"}
    line = out.stdout.strip().splitlines()[0] if out.stdout.strip() else out.stderr.strip()
    parts = [p.strip() for p in line.split(",")]
    return {"nvidia_smi_name": parts[0], "power_limit": parts[1] if len(parts) > 1 else ""}


def run_cell(root: Path, workload: str, seed: int, seconds: float, trace: bool, t0: float, device: str = "cuda",
             overrides: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Run the cell once -> the result line's dict (with "checks" last).
    `overrides` (tests and the control) replace parts of the loaded cell:
    "config", "traffic", "limits", or "hooks" the driver applies."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    loaded = load_cell(root, bench, workload)
    loaded.update(overrides or {})
    ctx = dict(loaded, root=root, workload=workload, seed=int(seed), seconds=float(seconds), trace=bool(trace),
               t0=t0, device=device)
    out = loaded["driver"].run(ctx)

    metrics: Dict[str, Dict[str, Any]] = {}
    if not trace:
        for m in bench["end_to_end"]:
            if applies(m, workload):
                if m["name"] not in out["end_to_end"]:
                    raise KeyError(f"the {loaded['traffic']['driver']} driver reports no {m['name']}")
                metrics[m["name"]] = {"value": out["end_to_end"][m["name"]], "unit": m["unit"]}
    else:
        for m in bench["per_layer"]:
            if applies(m, workload):
                sys.path.insert(0, str(HERE / "metrics"))
                reader = load_module(HERE / "metrics" / f"{m['name']}.py", "bench_metric_" + m["name"].replace(".", "_"))
                value = reader.read(out["layer"])
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev: Dict[str, Any] = {"platform": out["platform"], "kind": out["kind"], "count": out["count"],
                           "memory_peak_bytes": out["memory_peak_bytes"]}
    if device == "cuda":
        dev.update(nvidia_smi())
    result: Dict[str, Any] = {"correct": out["correct"], "attempted": out["attempted"], "failed": out["failed"],
                              "metrics": metrics, "device": dev}
    tr = out["layer"].get("trace")
    if trace and tr is not None and tr.busy_s is not None:
        dev["busy_s"], dev["window_s"] = tr.busy_s, tr.window_s
        result["breakdown"] = tr.breakdown()
    result["readings"] = out["readings"]  # every number the check worked out; those with a limit follow
    result["checks"] = out["checks"]
    return result


def check_lines(checks: Dict[str, Dict[str, Any]]) -> List[str]:
    return [f"check {name}: {c['value']!r} limit {c['limit']!r} ({'ok' if c['ok'] else 'FAILED'})"
            for name, c in checks.items()]


def judge(value: float, limit: float, ok_if: str = "le") -> Dict[str, Any]:
    ok = value <= limit if ok_if == "le" else value >= limit
    return {"value": value, "limit": limit, "ok": bool(ok)}


class Phases:
    """Seconds of each set-up phase, printed to standard error as they end."""

    def __init__(self, t0: float):
        self.last = t0

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        print(f"bench_port: {name} {now - self.last:.2f} s", file=sys.stderr, flush=True)
        self.last = now
