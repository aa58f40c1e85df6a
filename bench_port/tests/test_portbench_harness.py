"""The harness on the CPU: what it imports, how it finds a cell's files,
what it does without a card, the yardstick's frozen numbers, and that a
fault planted under the timed path turns `correct` false."""

from __future__ import annotations

import ast
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

import tiny
import yardstick

BENCH, ROOT = tiny.BENCH, tiny.ROOT
FORBIDDEN = ("jax", "jaxlib", "flax", "bridgelang_tpu")


def top_level_imports(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_flash_bounds_reproduce_the_smoke():
    """PERF.md's bounds: the B=1 T=352 prefill, the B=16 T=352 backward pair."""
    assert round(1e3 * yardstick.flash_fwd_bound_s(1, 352, 352, 32, 32, 128, [331]), 5) == 0.00335
    lens = [352 - (37 * i) % 90 for i in range(16)]
    assert round(1e3 * yardstick.flash_bwd_bound_s("dq", 16, 352, 352, 32, 32, 128, lens), 4) == 0.0661
    assert round(1e3 * yardstick.flash_bwd_bound_s("dkv", 16, 352, 352, 32, 32, 128, lens), 4) == 0.0798


def test_useful_flops_count_the_parts():
    cfg = json.loads((BENCH / "configs" / "mistral7b-vla.json").read_text())
    one, more = yardstick.act_useful_flops(cfg, 329, 7), yardstick.act_useful_flops(cfg, 330, 7)
    llm = cfg["port"]["llm"]
    assert 5.0e12 < one < 5.3e12
    assert more - one > 2 * llm["n_layers"] * yardstick.decoder_layer_matmul_params(llm)
    assert yardstick.lora_step_useful_flops(10, 1, 2, 3, 4) == 4 * 10 * 3 + 6 * 1 * 3 + 2 * 2 * 4


def test_reference_imports_nothing_of_the_port():
    for path in list((BENCH / "reference").glob("*.py")) + [BENCH / n for n in ("weights.py", "gen.py", "yardstick.py")]:
        assert not top_level_imports(path) & {"bridgelang_tpu_torch", *FORBIDDEN}, path
    code = ("import sys; sys.path.insert(0, %r); import reference.model, reference.lora, reference.tokens, weights, gen, "
            "yardstick; print(sorted({m.split('.')[0] for m in sys.modules}))" % str(BENCH))
    loaded = json.loads(subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True,
                                       cwd=ROOT).stdout.replace("'", '"'))
    assert not set(loaded) & {"bridgelang_tpu_torch", *FORBIDDEN}


def test_a_run_reaches_no_jax_module():
    """Both drivers end to end (tiny, CPU) in a fresh process; then no
    loaded module's top-level name is jax, jaxlib, flax or bridgelang_tpu
    (compared whole: bridgelang_tpu_torch is the port)."""
    code = f"""
import sys, json, time
sys.path.insert(0, {str(BENCH / 'tests')!r})
import tiny, harness
tiny.run("mistral7b-int8-act-1robot", tiny.config("mistral7b-vla", True), tiny.traffic("act-1robot"), seconds=0.5)
tiny.run("phi2-lora-b32", tiny.config("phi2-vla"), tiny.traffic("lora-b32"), seconds=0.2)
print(json.dumps(harness.forbidden_modules()))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
    for path in BENCH.rglob("*.py"):
        assert not top_level_imports(path) & set(FORBIDDEN), path


def test_forbidden_names_are_compared_whole(monkeypatch):
    import harness

    monkeypatch.setitem(sys.modules, "bridgelang_tpu_torch_fake", object())
    assert "bridgelang_tpu_torch_fake" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert "jax.numpy" in harness.forbidden_modules()


def test_without_a_card_a_run_prints_no_result():
    out = subprocess.run([sys.executable, "bench_port/run.py", "--workload", "mistral7b-int8-act-1robot", "--seed",
                          "2147483999", "--seconds", "1", "--trace", "0"], capture_output=True, text=True, cwd=ROOT,
                         timeout=300)
    assert out.returncode != 0
    assert "{" not in out.stdout and "CUDA" in out.stderr


def test_the_harness_finds_new_files_by_name(tmp_path):
    """A configuration, a mix, a metric and limits that exist only as new
    files (and BENCHMARK.json entries) in a copy: the harness runs the new
    cell and reads the new metric, with no edit to a file it had."""
    shutil.copytree(BENCH, tmp_path / "bench_port", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    new = tmp_path / "bench_port"
    cfg = tiny.config("phi2-vla")
    cfg["name"] = "phi2-tiny-new"
    (new / "configs" / "phi2-tiny-new.json").write_text(json.dumps(cfg))
    (new / "traffic" / "act-2robots-new.json").write_text(json.dumps(tiny.traffic("act-1robot", robots=2, max_batch=2)))
    (new / "limits" / "phi2-tiny-new-act.json").write_text(json.dumps(tiny.LOOSE))
    (new / "metrics" / "robots_seen_new.py").write_text(
        "def read(ctx):\n    return float(ctx['counters']['requests'])\n")
    bench["configs"].append({"name": "phi2-tiny-new", "source": "https://example.org/x", "reduced": [], "why": "t",
                             "file": "bench_port/configs/phi2-tiny-new.json"})
    bench["workloads"].append({"name": "phi2-tiny-new-act", "config": "phi2-tiny-new", "traffic": "act-2robots-new",
                               "chips": 1, "why": "t"})
    bench["per_layer"].append({"name": "robots_seen_new", "unit": "requests", "better": "higher", "source":
                               "program_counter", "layer": "REST server", "moves": "actions_per_s",
                               "workloads": ["phi2-tiny-new-act"]})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "mistral7b-int8-act-1robot" in m.get("workloads", ()):
            m["workloads"].append("phi2-tiny-new-act")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = f"""
import sys, json, time
sys.path[:0] = [{str(new)!r}, {str(ROOT)!r}]
import harness
out = harness.run_cell(__import__('pathlib').Path({str(tmp_path)!r}), "phi2-tiny-new-act", 3, 0.8, True,
                       time.perf_counter(), device="cpu")
print(json.dumps(out["metrics"]))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=tmp_path, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    metrics = json.loads(out.stdout.strip().splitlines()[-1])
    assert metrics["robots_seen_new"]["value"] > 0
    assert metrics["requests_per_pass.act"]["value"] >= 1.0


ACT_FAULTS = [(1, "token_altered"), (1, "half_batch"), (8, "token_altered"), (8, "half_batch")]


@pytest.mark.parametrize("robots,fault", ACT_FAULTS)
def test_an_act_fault_fails_the_check(robots, fault):
    """One robot, and eight robots batched up to 8 (the same mix widened)."""
    import faults

    cfg = tiny.config("mistral7b-vla", quantize_int8=True)
    mix = tiny.traffic("act-1robot", robots=robots, max_batch=robots)
    limits = {"check_requests": 6 if robots == 1 else 16}  # enough rows from both halves of the batches
    sound = tiny.run("mistral7b-int8-act-1robot", cfg, mix, seconds=2.5, limits=limits)
    broken = tiny.run("mistral7b-int8-act-1robot", cfg, mix, seconds=2.5, limits=limits,
                      hooks=[faults.FAULTS["act"][fault]])
    assert sound["correct"], sound["checks"]
    assert not broken["correct"], broken["checks"]


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "token_altered"])
def test_a_lora_fault_fails_the_check(fault):
    import faults

    limits = {"loss_rel_gap": 1e-4, "grad1_norm_gap": 1e-3, "change_norm_gap": 1e-3}
    broken = tiny.run("phi2-lora-b32", tiny.config("phi2-vla"), tiny.traffic("lora-b32"), seconds=0.2, limits=limits,
                      hooks=[faults.FAULTS["lora"][fault]])
    assert not broken["correct"], broken["checks"]


@pytest.mark.parametrize("robots", [1, 8])
def test_the_control_reads_above_the_program(robots):
    """The control (the port's own int4 path, as the cell's limits file
    names it) lies further from the reference than the int8 program: the
    widest logit gap of the served ids, at a tiny size."""
    workload = "mistral7b-int8-act-1robot"
    limits = json.loads((BENCH / "limits" / f"{workload}.json").read_text())
    cfg = tiny.config("mistral7b-vla", quantize_int8=True)
    mix = tiny.traffic("act-1robot", robots=robots, max_batch=robots)
    sound = tiny.run(workload, cfg, mix, seconds=1.5, seed=8, limits={"check_requests": 12})
    control = tiny.run(workload, cfg, mix, seconds=1.5, seed=8, limits={"check_requests": 12}, **limits["control"])
    assert control["checks"]["logit_gap_max"]["value"] > sound["checks"]["logit_gap_max"]["value"]


def test_the_lora_control_reads_above_the_program():
    """The LoRA cell's control (the reference w8a8 in the program's place)
    lies further from the fp32 reference than the port's fp32 step."""
    control = json.loads((BENCH / "limits" / "phi2-lora-b32.json").read_text())["control"]
    sound = tiny.run("phi2-lora-b32", tiny.config("phi2-vla"), tiny.traffic("lora-b32"), seconds=0.2)
    low = tiny.run("phi2-lora-b32", tiny.config("phi2-vla"), tiny.traffic("lora-b32"), seconds=0.2, **control)
    for name in ("loss_rel_gap", "grad1_norm_gap", "change_median_gap"):
        assert low["readings"][name] > 10 * sound["readings"][name], name


def test_a_check_line_names_each_number_and_limit():
    import harness

    lines = harness.check_lines({"gap": harness.judge(0.5, 1.0), "n": harness.judge(3, 4, ok_if="ge")})
    assert lines == ["check gap: 0.5 limit 1.0 (ok)", "check n: 3 limit 4 (FAILED)"]
    assert time.perf_counter() > 0
