"""Driver "lora": the port's LoRA fine-tuning step, fed batches from the seed.

Set-up builds what `finetune` builds: the configuration's model, the
benchmark's seeded base weights (bf16), r-rank fp32
adapters from the port's `add_lora_params` on the run's LoRA generator
(`root_key`), the LoRA mask, AdamW (`make_optimizer`, constant learning
rate) and `make_vla_train_step` with the mix's remat policy. Batches go
through the port's `RLDSBatchTransform` and `PaddedCollatorForActionPrediction`
(rows from `gen.train_rows`), and their frames are drawn on the device
(`gen.train_frames`): the mix's `prebuilt_batches` of each, all in set-up.
Set-up then drives that one step object through the checked steps (the
first three), reading each loss, the first gradient from AdamW's first
moment after step 1, and the adapters' change after the last.

Window: the same step object, the next prebuilt batch per step (its ids
copied to the device as `finetune`'s loader hands them over), each step's
loss read as `finetune` reads it; it runs whole steps until `seconds` have
passed. `train_tokens_per_s` = real fused tokens of all steps over the time
they took.

Check (after the window, the program's state freed): the reference's fp32
steps from the same weights, batches and LoRA draws; the worst relative gap
of the losses, of the first gradient's norm per adapter and of the change's
norm per adapter (over the leaves the reference moves).
"""

from __future__ import annotations

import gc
import statistics
import sys
import time
from pathlib import Path
from typing import Any, Dict, List

import numpy as np

BENCH = Path(__file__).resolve().parent.parent


def lora_seed(seed: int) -> int:
    import weights

    return weights.group_seed(seed, 99)


def run(ctx: Dict) -> Dict[str, Any]:
    import torch

    sys.path.insert(0, str(BENCH))
    import devtrace
    import gen
    import portside
    import weights
    import yardstick

    from bridgelang_tpu_torch.training.lora import add_lora_params, lora_trainable_mask
    from bridgelang_tpu_torch.training.trainer import (
        OptimConfig, init_train_state, make_optimizer, make_vla_train_step, trainable_tensors)
    from bridgelang_tpu_torch.util.seeding import root_key
    from bridgelang_tpu_torch.vla.action_tokenizer import ActionTokenizer
    from bridgelang_tpu_torch.vla.datasets.datasets import PaddedCollatorForActionPrediction, RLDSBatchTransform

    from harness import Phases

    phase = Phases(ctx["t0"])
    phase("import")
    cfg, traffic, seed, device = ctx["config"], ctx["traffic"], ctx["seed"], ctx["device"]
    dtype = portside.DTYPES[cfg["serving"]["dtype"]]
    b, hw = traffic["batch"], traffic["frame_hw"]
    model = portside.build_model(cfg, dtype, device)
    params = weights.make_weights(cfg, seed, dtype, device)
    portside.check_layout(model, params)
    params = dict(params, llm=add_lora_params(root_key(lora_seed(seed), device), params["llm"],
                                              rank=traffic["lora_rank"], alpha=traffic["lora_alpha"]))
    mask = lora_trainable_mask(params)
    ocfg = OptimConfig(learning_rate=traffic["learning_rate"], lr_scheduler_type="constant")
    optimizer = make_optimizer(ocfg, params, trainable_mask=mask)
    step_fn = make_vla_train_step(model, optimizer, trainable_mask=mask, compute_dtype=dtype,
                                  image_transform=model.image_transform, remat_policy=traffic["remat_policy"])
    state = init_train_state(params, optimizer, trainable_mask=mask)
    del params
    phase("model, weights, adapters, optimizer")
    for hook in ctx.get("hooks", ()):  # tests: break the timed path underneath
        step_fn = hook(step_fn)
    name_of = {id(v): f"{i}.{k}" for i, lp in enumerate(state.params["llm"]["layers"]) for k, v in lp.items()
               if "_lora_" in k}
    trainable = trainable_tensors(state.params, mask)
    names = [name_of[id(t)] for t in trainable]

    tok = model.tokenizer
    transform = RLDSBatchTransform(ActionTokenizer(tok), tok, llm_family=model.cfg.llm_family)
    collate = PaddedCollatorForActionPrediction(max_length=traffic["max_length"], pad_token_id=model.cfg.llm.pad_token_id)
    placeholder = np.zeros((1, 1, 1, 3), np.uint8)  # the frames come from the device

    def host_batch(s: int) -> Dict[str, torch.Tensor]:
        instructions, actions = gen.train_rows(seed, s, b, traffic["instructions"])
        examples = [transform({"dataset_name": "bench", "action": actions[j][None], "observation": {"image_primary": placeholder},
                               "task": {"language_instruction": instructions[j]}}) for j in range(b)]
        longest = max(len(e["input_ids"]) for e in examples)
        if longest > traffic["max_length"]:
            raise ValueError(f"an example of {longest} ids exceeds the mix's max_length {traffic['max_length']}")
        batch = collate(examples)
        return {k: torch.as_tensor(batch[k]) for k in ("input_ids", "labels", "attention_mask")}

    prebuilt = [host_batch(s) for s in range(traffic["prebuilt_batches"])]
    frames = [gen.train_frames(seed, s, b, hw, device) for s in range(len(prebuilt))]
    phase("batches")

    def device_batch(s: int) -> Dict[str, torch.Tensor]:
        batch = {k: v.to(device, non_blocking=True) for k, v in prebuilt[s % len(prebuilt)].items()}
        batch["frames"] = frames[s % len(frames)]
        return batch

    patches = (cfg["port"]["towers"][0]["image_size"] // cfg["port"]["towers"][0]["patch_size"]) ** 2
    real_tokens = int(prebuilt[0]["attention_mask"].sum()) + b * patches

    # the checked steps, through the same step object the window drives
    p0 = [t.detach().clone() for t in trainable]
    losses, g1 = [], {}
    b1 = ocfg.b1
    for s in range(traffic["checked_steps"]):
        state, m = step_fn(state, device_batch(s))
        losses.append(float(m["loss"]))
        if s == 0:
            g1 = {n: float(mu.double().norm()) / (1.0 - b1) for n, mu in zip(names, state.opt_state["mu"])}
    change = {n: float((t.detach() - p).double().norm()) for n, t, p in zip(names, trainable, p0)}
    del p0
    phase("checked steps")

    setup_s = time.perf_counter() - ctx["t0"]
    tr, tw = None, traffic["trace"]
    traced_steps, steps, failed, s = 0, 0, 0, traffic["checked_steps"]
    t_w0 = time.perf_counter()
    while True:
        if ctx["trace"] and steps == tw["first_step"]:
            tr = devtrace.DeviceTrace()
            tr.start()
        state, m = step_fn(state, device_batch(s))
        loss = float(m["loss"])
        failed += int(not np.isfinite(loss))
        s += 1
        steps += 1
        if tr is not None and traced_steps == 0 and steps == tw["first_step"] + tw["steps"]:
            tr.stop()
            traced_steps = tw["steps"]
        if time.perf_counter() - t_w0 >= ctx["seconds"] and (not ctx["trace"] or traced_steps):
            break
    t_w1 = time.perf_counter()
    memory_peak = portside.memory_peak(device)
    platform, kind, count = portside.device_facts(device)

    llm = cfg["port"]["llm"]
    n_lora = sum(t.numel() for t in trainable)
    n_vision = sum(t.numel() for part in ("vision", "projector") for t in state.params[part].values())
    n_base = llm["n_layers"] * yardstick.decoder_layer_matmul_params(llm) + llm["padded_vocab_size"] * llm["dim"]
    step_flops = yardstick.lora_step_useful_flops(n_base, n_lora, n_vision, real_tokens, b * (patches + 5))
    layer: Dict[str, Any] = {}
    if tr is not None:
        hd = llm["dim"] // llm["n_heads"]
        t_len = prebuilt[0]["input_ids"].shape[1] + patches  # the width the collator padded to
        lens = (prebuilt[0]["attention_mask"].sum(dim=1) + patches).tolist()
        shape = (b, t_len, t_len, llm["n_heads"], llm["n_kv_heads"], hd, lens, llm.get("sliding_window"))
        layer = {"trace": tr, "traced": {
            "steps": traced_steps, "useful_flops": step_flops * traced_steps,
            "flash_bound_per_launch_s": {"flash_fwd": yardstick.flash_fwd_bound_s(*shape),
                                         "flash_bwd_dq": yardstick.flash_bwd_bound_s("dq", *shape),
                                         "flash_bwd_dkv": yardstick.flash_bwd_bound_s("dkv", *shape)}}}
    end_to_end = {"train_tokens_per_s": real_tokens * steps / (t_w1 - t_w0), "setup_s": setup_s}
    del state, trainable, optimizer, step_fn, model, frames
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    phase("window")
    checks, readings = check(ctx, losses, g1, change, ocfg)
    phase("reference check")
    return {"end_to_end": end_to_end, "layer": layer, "correct": failed == 0 and all(c["ok"] for c in checks.values()),
            "checks": checks, "readings": readings, "attempted": steps, "failed": failed, "memory_peak_bytes": memory_peak,
            "platform": platform, "kind": kind, "count": count}


def check(ctx: Dict, losses: List[float], g1: Dict[str, float], change: Dict[str, float], ocfg):
    """The reference's steps against the program's -> (checks, readings):
    every gap number; those with a limit are checked."""
    import torch

    import gen
    import portside
    import weights
    from harness import judge
    from reference import lora as ref_lora
    from reference.model import no_tf32
    from reference.tokens import training_batch

    cfg, traffic, seed, device = ctx["config"], ctx["traffic"], ctx["seed"], ctx["device"]
    limits = ctx["limits"]
    no_tf32()
    params = weights.make_weights(cfg, seed, portside.DTYPES[cfg["serving"]["dtype"]], device)
    adapters = ref_lora.lora_init(params["llm"]["layers"], traffic["lora_rank"], traffic["lora_alpha"],
                                  lora_seed(seed), device)
    llm = cfg["port"]["llm"]
    batches = []
    for s in range(traffic["checked_steps"]):
        instructions, actions = gen.train_rows(seed, s, traffic["batch"], traffic["instructions"])
        host = training_batch(instructions, actions, cfg["port"]["llm_family"], traffic["max_length"],
                              llm["pad_token_id"])
        batch = {k: torch.as_tensor(v, device=device) for k, v in host.items()}
        batch["frames"] = gen.train_frames(seed, s, traffic["batch"], traffic["frame_hw"], device)
        batches.append(batch)
    opt = {"lr": ocfg.learning_rate, "b1": ocfg.b1, "b2": ocfg.b2, "eps": 1e-8, "max_norm": ocfg.max_grad_norm}
    start = {k: v.clone() for k, v in adapters.items()}
    ref = ref_lora.lora_steps(params, cfg, adapters, batches, opt, traffic["check_row_block"])
    if ctx.get("reference_control"):  # the control: the reference one precision lower in the program's place
        low = ref_lora.lora_steps(params, cfg, start, batches, opt, traffic["check_row_block"],
                                  lowp=ctx["reference_control"])
        losses, g1, change = low["losses"], low["grad_norms"][0], low["change"]
    del params, adapters, batches, start

    def rel(p: float, r: float, floor: float) -> float:
        return abs(p - r) / max(abs(r), floor)

    g_ref = ref["grad_norms"][0]
    g_med = statistics.median(g_ref.values())
    grad_gaps = [rel(g1[n], g_ref[n], g_med) for n in g_ref]
    # leaves whose reference gradient is nought to rounding move by round-off alone
    moved = {n: max(gn[n] for gn in ref["grad_norms"]) for n in g_ref}
    moved_med = statistics.median(moved.values())
    kept = [n for n in g_ref if moved[n] >= 1e-3 * moved_med]
    c_med = statistics.median(ref["change"][n] for n in kept)
    change_gaps = [rel(change[n], ref["change"][n], c_med) for n in kept]
    readings = {
        "loss_rel_gap": max(rel(p, r, 0.0) for p, r in zip(losses, ref["losses"])),
        "loss1_rel_gap": rel(losses[0], ref["losses"][0], 0.0),
        "grad1_norm_gap": max(grad_gaps),
        "grad1_median_gap": statistics.median(grad_gaps),
        "change_norm_gap": max(change_gaps),
        "change_median_gap": statistics.median(change_gaps),
        "leaves_left_out": float(len(g_ref) - len(kept)),
    }
    return {k: judge(v, limits[k]) for k, v in readings.items() if k in limits}, readings
