"""Tiny configurations and mixes for the CPU tests: the same drivers and
reference as the chip cells, at sizes a test run holds."""

from __future__ import annotations

import copy
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

DINO = {"image_size": 32, "patch_size": 8, "width": 32, "depth": 3, "num_heads": 4, "mlp_dim": 64,
        "use_cls_token": True, "num_reg_tokens": 2, "no_embed_class": True, "layerscale_init": 1e-05,
        "act": "gelu", "pre_norm": False, "ln_eps": 1e-06, "mean": [0.485, 0.456, 0.406], "std": [0.229, 0.224, 0.225]}
SIGLIP = {"image_size": 32, "patch_size": 8, "width": 48, "depth": 3, "num_heads": 4, "mlp_dim": 96,
          "use_cls_token": False, "num_reg_tokens": 0, "no_embed_class": False, "layerscale_init": None,
          "act": "gelu_tanh", "pre_norm": False, "ln_eps": 1e-06, "mean": [0.5, 0.5, 0.5], "std": [0.5, 0.5, 0.5]}


def config(name: str, quantize_int8: bool = False) -> dict:
    """The chip configuration `name` with its widths and depths cut for the CPU."""
    cfg = copy.deepcopy(json.loads((BENCH / "configs" / f"{name}.json").read_text()))
    port = cfg["port"]
    port["registry_check"] = False
    port["towers"] = [copy.deepcopy(DINO), copy.deepcopy(SIGLIP)]
    if port["llm"]["arch"] == "phi":
        port["llm"].update(dim=80, n_layers=2, n_heads=4, n_kv_heads=4, intermediate_size=160)
    else:
        port["llm"].update(dim=64, n_layers=2, n_heads=4, n_kv_heads=2, intermediate_size=128, sliding_window=24)
    cfg["serving"] = dict(cfg["serving"], dtype="float32", quantize_int8=quantize_int8)
    return cfg


def traffic(name: str, **changes) -> dict:
    t = json.loads((BENCH / "traffic" / f"{name}.json").read_text())
    t.update(frame_hw=[40, 40], check_block=3)
    if t["driver"] == "lora":
        t.update(batch=8, prebuilt_batches=4, check_row_block=4)
    t["trace"] = {"start_s": 0.2, "seconds": 0.5} if t["driver"] == "act" else {"first_step": 1, "steps": 1}
    t.update(changes)
    return t


LOOSE = {"check_requests": 6, "action_abs_err": 0.0, "logit_gap_max": 1e-3, "loss_rel_gap": 1e-4, "grad1_norm_gap": 1e-3,
         "change_norm_gap": 1e-3}


def run(workload: str, cfg: dict, mix: dict, seed: int = 5, seconds: float = 1.5, hooks=(), limits=None, **extra):
    import time

    import harness

    over = {"config": cfg, "traffic": mix, "limits": dict(LOOSE, **(limits or {})), "hooks": list(hooks), **extra}
    return harness.run_cell(ROOT, workload, seed, seconds, False, time.perf_counter(), device="cpu", overrides=over)
