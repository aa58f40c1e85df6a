"""Frozen arithmetic of the DeepSeek-V2 configuration: the useful FLOPs of one
/act action, the least time of the (192, 128) flash forward and of the
grouped expert products, beside yardstick.py's (whose peaks it uses).

Useful FLOPs count what the model needs per token: the attention
projections (wq, wkv_a, wkv_b, wo), the dense SwiGLU of the leading layers,
and in each MoE layer the router, the top-k routed experts and the shared
experts: never all the experts. Attention counts the published expanded
form, 2 (Dqk + Dv) per head and attended (row, key) pair. Towers, projector
and the head as yardstick.act_useful_flops counts them.

A grouped expert launch's least time is the larger of its bytes at the HBM
rate and its FLOPs at the bf16 peak. Bytes: the weights of the experts the
launch touched (both matrices, gated), each once, plus its activations read
once and its output written once. The prefill's touched experts and rows
come from the port's per-pass expert counts; a batch-1 decode step touches
top_k experts of one row each.

Nothing here imports the port or torch.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import yardstick
from yardstick import HBM_BYTES_PER_S, PEAK_FLOPS, attended_pairs, keys_read


def layer_matmul_params(llm: Dict, i: int) -> int:
    """Weights of layer i that one token multiplies by."""
    d, h, r = llm["dim"], llm["n_heads"], llm["kv_lora_rank"]
    n, p, dv = llm["qk_nope_head_dim"], llm["qk_rope_head_dim"], llm["v_head_dim"]
    attn = h * (n + p) * d + (r + p) * d + h * (n + dv) * r + d * h * dv
    if i < llm["first_k_dense_replace"]:
        return attn + 3 * d * llm["intermediate_size"]
    ie = llm["moe_intermediate_size"]
    return attn + llm["n_routed_experts"] * d + (llm["num_experts_per_tok"] + llm["n_shared_experts"]) * 3 * d * ie


def act_useful_flops(cfg: Dict, real_fused_len: int, new_tokens: int) -> float:
    """One action: towers and projector on one frame, the decoder over the
    `real_fused_len` real prefill rows, `new_tokens - 1` decode steps over
    the cache so far, and the head once per emitted token."""
    llm, towers = cfg["port"]["llm"], cfg["port"]["towers"]
    patches = (towers[0]["image_size"] // towers[0]["patch_size"]) ** 2
    flops = sum(yardstick.vit_forward_flops(t, 1) for t in towers)
    flops += yardstick.projector_flops(sum(t["width"] for t in towers), llm["dim"], patches)
    per_token = 2.0 * sum(layer_matmul_params(llm, i) for i in range(llm["n_layers"]))
    per_pair = 2.0 * llm["n_heads"] * (llm["qk_nope_head_dim"] + llm["qk_rope_head_dim"] + llm["v_head_dim"]) \
        * llm["n_layers"]
    n = real_fused_len
    flops += per_token * n + per_pair * n * (n + 1) / 2
    for i in range(new_tokens - 1):
        flops += per_token + per_pair * (n + i + 1)
    return flops + new_tokens * 2.0 * llm["padded_vocab_size"] * llm["dim"]


def mla_flash_bound_s(b: int, t: int, s: int, h: int, dqk: int, dv: int, lengths: Sequence[int],
                      elem_bytes: int = 2) -> float:
    """Least seconds of one flash forward launch with v's own head dim:
    q read and o written once, k (Dqk) and v (Dv) read once per key some row
    attends, lse written, lengths read; 2 (Dqk + Dv) FLOPs per attended
    (row, key) pair and head (causal, no window, one KV head per head)."""
    keys = keys_read(t, s, lengths, None)
    n_bytes = b * t * h * (dqk + dv) * elem_bytes + keys * h * (dqk + dv) * elem_bytes + 4 * b * h * t + 4 * b
    flops = 2.0 * (dqk + dv) * attended_pairs(t, s, lengths, None) * h
    return max(n_bytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS["bfloat16"])


def grouped_launch_bound_s(picks: int, touched: int, n: int, k: int, gated: bool, elem_bytes: int = 2) -> float:
    """Least seconds of one grouped product over `picks` rows routed to
    `touched` experts, each expert's [n, k] weight (two, gated) read once."""
    mats = 2 if gated else 1
    n_bytes = (touched * mats * n * k + picks * k + picks * n) * elem_bytes
    flops = 2.0 * picks * n * k * mats
    return max(n_bytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS["bfloat16"])


def moe_pass_bound_s(llm: Dict, prefill_load: Sequence[Sequence[int]], new_tokens: int,
                     rows: int = 1) -> Optional[float]:
    """The least seconds of every grouped launch of one greedy pass of
    `rows` requests: per MoE layer the prefill's gated and down products from
    its load (picks per expert), then `new_tokens - 1` decode steps that
    route `rows` tokens each."""
    d, ie, k = llm["dim"], llm["moe_intermediate_size"], llm["num_experts_per_tok"]
    total = 0.0
    for counts in prefill_load:
        picks, touched = int(sum(counts)), sum(1 for c in counts if c > 0)
        total += grouped_launch_bound_s(picks, touched, ie, d, True) + grouped_launch_bound_s(picks, touched, d, ie,
                                                                                               False)
    step_picks = rows * k
    step_touched = min(step_picks, llm["n_routed_experts"]) if rows == 1 else None
    if step_touched is None:
        return None  # a batched step's touched experts are not counted
    step = grouped_launch_bound_s(step_picks, step_touched, ie, d, True) + grouped_launch_bound_s(
        step_picks, step_touched, d, ie, False)
    return total + (new_tokens - 1) * len(prefill_load) * step
