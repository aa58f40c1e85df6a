"""Readings that set a cell's correctness limits, on the chip at the cell's size.

    python3 bench_port/control.py --workload <name> --seeds 11,12,13 --kind sound --seconds 12
    python3 bench_port/control.py --workload <name> --seeds 21,22,23 --kind control --seconds 12
    python3 bench_port/control.py --workload <name> --seeds 31,32,33 --kind fault:half_batch --seconds 2

Runs the cell once per seed in this one process, as run.py would, and
prints one JSON line per seed with every number the check worked out:

* sound: the program as the configuration states it (the lower readings);
* control: one precision below the configuration, as `limits/<workload>.json`
  names it under "control": the port's own int4 w4a8 path for int8 serving;
  for the bf16 LoRA step, the reference computed w8a8 in the program's place;
* fault:<name>: a fault of faults.py planted under the timed path.

The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = Path.cwd()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--kind", default="sound")
    ap.add_argument("--seconds", type=float, default=12.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(HERE), str(ROOT)]
    import faults
    import harness

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    loaded = harness.load_cell(ROOT, bench, args.workload)
    over = {}
    if args.kind == "control":
        over = dict(loaded["limits"]["control"])
    elif args.kind.startswith("fault:"):
        hook = faults.FAULTS[loaded["traffic"]["driver"]][args.kind.split(":", 1)[1]]
        over = {"hooks": [hook]}
    elif args.kind != "sound":
        raise SystemExit(f"unknown kind {args.kind!r}")
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        result = harness.run_cell(ROOT, args.workload, seed, args.seconds, False, t0, overrides=over)
        print(json.dumps({"workload": args.workload, "kind": args.kind, "seed": seed, "correct": result["correct"],
                          "checks": {k: c["value"] for k, c in result["checks"].items()},
                          "readings": result["readings"],
                          "metrics": {k: m["value"] for k, m in result["metrics"].items()},
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
