"""The benchmark's frozen arithmetic: published H100 peaks, the flash kernels'
least times, and the useful FLOPs of one /act action and of one LoRA step.

The flash bounds are copied from the port's chip smoke (`bound_ms`,
`bwd_bound_ms`) and take shapes instead of tensors. The FLOP counts follow
the issue's rules: towers, projector, the prefill over the real tokens and
the decode steps for an action; the LoRA step's count of useful FLOPs
(4 N of the frozen base and 6 N of the adapters per token, the towers'
forward) for a step. Recompute and padding are never counted.

Nothing here imports the port or torch.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

# NVIDIA H100 SXM data sheet: dense rates without sparsity, at the 700 W limit.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}
MFU_PEAK = PEAK_FLOPS["bfloat16"]  # every mfu metric is a share of the bf16 peak


def attended_pairs(t: int, s: int, lengths: Sequence[int], window: Optional[int]) -> int:
    """(row, key) pairs some example attends, summed over the batch: row r
    sees key c when c <= r, c < the example's length and (with a window)
    c > r - window. Rows at or past the length attend the valid keys too
    (the kernels compute them), as the smoke's `valid_mask` counts them."""
    total = 0
    for n in lengths:
        for r in range(t):
            hi = min(r, n - 1, s - 1)
            lo = 0 if window is None or window >= s else max(0, r - window + 1)
            if hi >= lo:
                total += hi - lo + 1
    return total


def keys_read(t: int, s: int, lengths: Sequence[int], window: Optional[int]) -> int:
    """Keys that some row of an example attends, summed over the batch (the
    smoke's `read_keys` without the bytes per key)."""
    total = 0
    for n in lengths:
        hi = min(t - 1, n - 1, s - 1)  # the largest key any row can reach
        total += max(0, hi + 1)
    return total


def flash_fwd_bound_s(b: int, t: int, s: int, h: int, hkv: int, d: int, lengths: Sequence[int],
                      window: Optional[int] = None, elem_bytes: int = 2, dtype: str = "bfloat16",
                      out_bytes: Optional[int] = None) -> float:
    """Least seconds of one flash forward launch: max(bytes / HBM rate,
    FLOPs / peak). Bytes: q read once and o written once, k and v read once
    for each key some row attends, lse (f32) written, lengths read. FLOPs:
    4 D per attended (row, key) pair and head."""
    if len(lengths) != b:
        raise ValueError(f"{len(lengths)} lengths for a batch of {b}")
    ob = elem_bytes if out_bytes is None else out_bytes
    q_elems = b * t * h * d
    n_bytes = q_elems * elem_bytes + q_elems * ob + 2 * keys_read(t, s, lengths, window) * hkv * d * elem_bytes \
        + 4 * b * h * t + 4 * b
    flops = 4.0 * d * attended_pairs(t, s, lengths, window) * h
    return max(n_bytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])


def flash_bwd_bound_s(which: str, b: int, t: int, s: int, h: int, hkv: int, d: int, lengths: Sequence[int],
                      window: Optional[int] = None, elem_bytes: int = 2, dtype: str = "bfloat16") -> float:
    """Least seconds of one backward launch, `which` "dq" or "dkv" (or
    "both"): q and dO read once, k and v once per attended key, lse and
    delta (f32 [B, H, T]) once, lengths once; dq (or dk and dv, whole) written
    once. FLOPs per attended pair and head: 6 D for dq, 8 D for dk/dv."""
    q_elems, k_elems = b * t * h * d, b * s * hkv * d
    inputs = 2 * q_elems * elem_bytes + 2 * keys_read(t, s, lengths, window) * hkv * d * elem_bytes \
        + 2 * 4 * b * h * t + 4 * b
    outputs = {"dq": q_elems, "dkv": 2 * k_elems, "both": q_elems + 2 * k_elems}[which] * elem_bytes
    flops = {"dq": 6, "dkv": 8, "both": 10}[which] * d * attended_pairs(t, s, lengths, window) * h
    return max((inputs + outputs) / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])


# --- useful FLOPs ----------------------------------------------------------------------


def vit_forward_flops(tower: Dict, n_images: int) -> float:
    """Matmul and attention FLOPs of one tower's forward up to its tap
    (depth - 1 blocks) over `n_images` frames: patch embedding, qkv, proj,
    the MLP, and 4 T^2 width per block for attention."""
    w, mlp, depth = tower["width"], tower["mlp_dim"], tower["depth"]
    patches = (tower["image_size"] // tower["patch_size"]) ** 2
    tokens = patches + (1 if tower.get("use_cls_token", True) else 0) + tower.get("num_reg_tokens", 0)
    patch = 2.0 * patches * 3 * tower["patch_size"] ** 2 * w
    per_block = 2.0 * tokens * (3 * w * w + w * w + 2 * w * mlp) + 4.0 * tokens * tokens * w
    return n_images * (patch + (depth - 1) * per_block)


def projector_flops(vision_dim: int, llm_dim: int, patches: int) -> float:
    """fused-gelu-mlp: vision -> 4 vision -> llm -> llm, per patch."""
    return 2.0 * patches * (vision_dim * 4 * vision_dim + 4 * vision_dim * llm_dim + llm_dim * llm_dim)


def decoder_layer_matmul_params(llm: Dict) -> int:
    """Weights of one decoder layer's projections."""
    d, i, h, hkv = llm["dim"], llm["intermediate_size"], llm["n_heads"], llm["n_kv_heads"]
    hd = d // h
    attn = d * h * hd + 2 * d * hkv * hd + h * hd * d
    mlp = (3 if llm["arch"] == "llama" else 2) * d * i
    return attn + mlp


def act_useful_flops(cfg: Dict, real_fused_len: int, new_tokens: int) -> float:
    """Useful FLOPs of one action: both towers and the projector on one
    frame, the decoder's projections and attention over the `real_fused_len`
    real prefill tokens, then `new_tokens - 1` decode steps, each over the
    cache so far, and the LM head once per emitted token."""
    llm = cfg["port"]["llm"]
    towers = cfg["port"]["towers"]
    patches = (towers[0]["image_size"] // towers[0]["patch_size"]) ** 2
    vision_dim = sum(t["width"] for t in towers)
    flops = sum(vit_forward_flops(t, 1) for t in towers) + projector_flops(vision_dim, llm["dim"], patches)
    per_token = 2.0 * llm["n_layers"] * decoder_layer_matmul_params(llm)
    attn_per_pair = 4.0 * llm["dim"] * llm["n_layers"]  # QK^T and PV over all heads
    n = real_fused_len
    flops += per_token * n + attn_per_pair * n * (n + 1) / 2
    for i in range(new_tokens - 1):
        flops += per_token + attn_per_pair * (n + i + 1)
    flops += new_tokens * 2.0 * llm["padded_vocab_size"] * llm["dim"]
    return flops


def lora_step_useful_flops(n_base_matmul: int, n_lora: int, n_vision: int, real_tokens: int,
                           vision_tokens: int) -> float:
    """The chip smoke's LoRA count: 4 N per token through the frozen base
    (forward and the input gradient), 6 N per token through the adapters,
    2 N per token through the frozen towers and projector. `n_base_matmul`
    leaves out the embedding table, which is a lookup."""
    return 4.0 * n_base_matmul * real_tokens + 6.0 * n_lora * real_tokens + 2.0 * n_vision * vision_tokens
