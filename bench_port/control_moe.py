"""Readings that set the DeepSeek-V2 cell's limits: every control at once.

    python3 bench_port/control_moe.py --seeds 31,32,33 --seconds 12

control.py runs the one control that `limits/<workload>.json` names. This
runs the cell once per seed, as run.py would, and checks the served ids
of that one window against the sound reference and against each variant
of reference/mla_moe.VARIANTS in the program's place (the whole decoder
in fp8, the routed experts' weights in fp8, `norm_topk_prob` flipped, the
shared experts left out). It prints one JSON line per seed and variant
with every reading of the check (drivers/act_moe.py): the logit gaps and
the routed experts' `moe_err_max`.

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
CELL = "dsv2lite-bf16-act-1robot"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default=CELL)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=12.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(HERE), str(HERE / "drivers"), str(ROOT)]
    import act_moe
    import harness
    from reference import mla_moe

    sound_check = act_moe.check

    def check(ctx, reqs, passes):
        out = sound_check(ctx, reqs, passes)
        for variant in mla_moe.VARIANTS:
            _, readings, _ = sound_check(dict(ctx, reference_variant=variant), reqs, passes)
            print(json.dumps({"seed": ctx["seed"], "variant": variant, **readings}), flush=True)
        return out

    act_moe.check = check  # run() calls the module's check after the window
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        result = harness.run_cell(ROOT, args.workload, seed, args.seconds, False, t0, overrides={"driver": act_moe})
        print(json.dumps({"seed": seed, "variant": "sound", "correct": result["correct"], **result["readings"],
                          "metrics": {k: m["value"] for k, m in result["metrics"].items()},
                          "memory_peak_bytes": result["device"]["memory_peak_bytes"],
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
