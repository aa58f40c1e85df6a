"""The port's benchmark: one cell of BENCHMARK.json, run once.

    python3 bench_port/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. Measures `bridgelang_tpu_torch` on the
CUDA cards of this machine and prints one JSON line last on standard
output: `correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end
metrics with --trace 0, its per-layer metrics with --trace 1), `device`,
with --trace 1 `breakdown`, and `checks` (each number the correctness check
compared, with its limit), whose lines also end standard error.

Exits non-zero and prints no result when there is no CUDA card, fewer
cards than the cell asks for, or when a module of `jax`, `jaxlib`, `flax`
or `bridgelang_tpu` was loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()  # set-up runs from here to the first timed request or step

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = Path.cwd()


def use_checkout_caches(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout (the
    port builds its CUDA kernels into build/torch_kernels itself)."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "bench_port" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "bench_port" / "triton")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    use_checkout_caches(ROOT)
    sys.path[:0] = [str(HERE), str(ROOT)]
    import harness

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    chips = harness.find_cell(bench, args.workload)["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"bench_port: the cell needs {chips} CUDA card(s), this machine has {found}", file=sys.stderr)
        return 2
    result = harness.run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace), T0)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"bench_port: modules the benchmark must not load were loaded: {loaded}", file=sys.stderr)
        return 3
    for line in harness.check_lines(result["checks"]):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
