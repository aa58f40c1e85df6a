"""The DeepSeek-V2 decoder in plain fp32 PyTorch, under the Prismatic towers.

Written from the DeepSeek-V2 paper (arXiv:2405.04434) and the published
config.json and modelling code of deepseek-ai/DeepSeek-V2-Lite, not from the
port. Each layer, in the published *expanded* form:

* attention: RMSNorm; q = W_q x split per head into q_nope and q_pe;
  [c | k_pe] = W_kv_a x, c RMS-normed by kv_norm, k_pe one rope key that
  every head shares; [k_nope | v] = W_kv_b c per head; q_pe and k_pe rotated
  as the published `apply_rotary_pos_emb` rotates them (the rope dims
  de-interleaved, then rotated by halves) with YaRN's frequencies and
  cos/sin times mscale / mscale_all_dim; q = [q_nope | q_pe], k = [k_nope |
  k_pe]; causal softmax of q k^T times (nope + rope)^-0.5 times the square
  of YaRN's mscale_all_dim factor; the heads' outputs through W_o;
* FFN: RMSNorm, then the dense SwiGLU (the leading dense layers) or the
  router's softmax over the experts, the top k greedy, their weights
  renormalised when `norm_topk_prob` else scaled by the routing factor,
  every expert's SwiGLU computed for the tokens routed to it, weighted and
  summed, plus the shared experts' SwiGLU.

Departures from the published code: everything runs in fp32 (the published
model runs in bf16 and casts the RMSNorm output to bf16 before its weight);
one layer's weights are upcast at a time; no cache, no batching tricks: each
sequence attends over itself. TF32 is off (`reference.model.no_tf32`).

`variant` (the controls that set the cell's limits, never a timed run):
"fp8" computes every product of the decoder and the head one precision
below bf16, in float8 e4m3: its weights per output row and its inputs per
token rounded through e4m3 (absmax / 448), the router left in fp32;
"fp8_experts" rounds the routed experts' weights alone so; "norm_topk"
flips `norm_topk_prob`; "no_shared" leaves the shared experts out.

Nothing here imports `jax`, the JAX package or the port.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from reference.model import lm_head, rms_norm, token_embeddings, vision_embeddings
from reference.tokens import inference_prompt_ids

VARIANTS = ("fp8", "fp8_experts", "norm_topk", "no_shared")


def yarn_inv_freq(llm: Dict) -> torch.Tensor:
    """The published DeepseekV2YarnRotaryEmbedding's inverse frequencies."""
    dim, base, factor = llm["qk_rope_head_dim"], llm["rope_theta"], llm["yarn_factor"]
    orig = llm["yarn_original_max_position"]
    freq_extra = 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim))
    if factor <= 1:
        return freq_extra
    freq_inter = 1.0 / (factor * base ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim))

    def find_dim(num_rotations):
        return (dim * math.log(orig / (num_rotations * 2 * math.pi))) / (2 * math.log(base))

    low = max(math.floor(find_dim(llm["yarn_beta_fast"])), 0)
    high = min(math.ceil(find_dim(llm["yarn_beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32) - low) / (high - low), 0, 1)
    inv_freq_mask = 1.0 - ramp
    return freq_inter * (1 - inv_freq_mask) + freq_extra * inv_freq_mask


def yarn_get_mscale(scale: float, mscale: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def softmax_scale(llm: Dict) -> float:
    scale = (llm["qk_nope_head_dim"] + llm["qk_rope_head_dim"]) ** -0.5
    if llm["yarn_factor"] > 1 and llm["yarn_mscale_all_dim"]:
        m = yarn_get_mscale(llm["yarn_factor"], llm["yarn_mscale_all_dim"])
        scale = scale * m * m
    return scale


def rope(x: torch.Tensor, positions: torch.Tensor, llm: Dict) -> torch.Tensor:
    """x [N, heads, p] at positions [N]: de-interleave, rotate by halves."""
    inv = yarn_inv_freq(llm).to(x.device)
    freqs = positions.float()[:, None] * inv
    emb = torch.cat([freqs, freqs], dim=-1)
    m = yarn_get_mscale(llm["yarn_factor"], llm["yarn_mscale"]) / yarn_get_mscale(llm["yarn_factor"],
                                                                                  llm["yarn_mscale_all_dim"])
    cos, sin = (emb.cos() * m)[:, None], (emb.sin() * m)[:, None]
    n, h, d = x.shape
    x = x.view(n, h, d // 2, 2).transpose(3, 2).reshape(n, h, d)
    rotated = torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)
    return x * cos + rotated * sin


def fp8_rows(w: torch.Tensor) -> torch.Tensor:
    """w (fp32) rounded through float8 e4m3 per row (absmax / 448): a
    weight's output rows, an activation's tokens."""
    scale = w.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12) / 448.0
    return (w / scale).to(torch.float8_e4m3fn).float() * scale


def linear(x: torch.Tensor, w: torch.Tensor, variant: Optional[str]) -> torch.Tensor:
    """x @ w^T, both rounded through e4m3 first under the "fp8" variant."""
    return fp8_rows(x) @ fp8_rows(w).T if variant == "fp8" else x @ w.T


def swiglu(x: torch.Tensor, gate: torch.Tensor, up: torch.Tensor, down: torch.Tensor,
           variant: Optional[str] = None) -> torch.Tensor:
    return linear(F.silu(linear(x, gate, variant)) * linear(x, up, variant), down, variant)


def moe(x: torch.Tensor, f: Dict[str, torch.Tensor], llm: Dict, variant: Optional[str]) -> torch.Tensor:
    """The routed experts over rows x [N, D] (fp32)."""
    scores = torch.softmax(x @ f["router"].T, dim=-1)
    w, ids = torch.topk(scores, llm["num_experts_per_tok"], dim=-1)
    norm = llm["norm_topk_prob"] != (variant == "norm_topk")
    w = w / (w.sum(dim=-1, keepdim=True) + 1e-20) if norm else w * llm["routed_scaling_factor"]
    out = torch.zeros_like(x)
    for e in torch.unique(ids).tolist():
        tok, slot = (ids == e).nonzero(as_tuple=True)
        gate, up, down = f["we_gate"][e], f["we_up"][e], f["we_down"][e]
        if variant == "fp8_experts":
            gate, up, down = fp8_rows(gate), fp8_rows(up), fp8_rows(down)
        out.index_add_(0, tok, w[tok, slot][:, None] * swiglu(x[tok], gate, up, down, variant))
    return out


def decoder_logits(lw: Dict, llm: Dict, embeds: List[torch.Tensor], out_rows: Sequence[Sequence[int]],
                   variant: Optional[str] = None, moe_probe: Optional[Callable] = None) -> List[torch.Tensor]:
    """Each sequence's fp32 input embeddings [n_i, D] through the decoder
    (causal, positions 0..n_i-1) -> the logits [len(out_rows[i]), V] at the
    asked rows.

    `moe_probe(layer, lp, f, x, chunks)`, if given, is called at each MoE
    layer with its index, its leaves as given (`lp`) and upcast (`f`), the routed
    experts' input rows x [N, D] (fp32, every sequence's rows end to end)
    and `chunks`, the (first, end) rows a server would hand the experts at
    once: each sequence's rows up to its first asked row (the prefill), then
    each later row alone (a decode step)."""
    if variant is not None and variant not in VARIANTS:
        raise ValueError(f"variant {variant!r}: one of {VARIANTS}")
    h, r = llm["n_heads"], llm["kv_lora_rank"]
    n_d, p, dv = llm["qk_nope_head_dim"], llm["qk_rope_head_dim"], llm["v_head_dim"]
    eps = llm["norm_eps"]
    dev = embeds[0].device
    lens = [e.shape[0] for e in embeds]
    starts = np.cumsum([0] + lens)
    x = torch.cat(embeds, dim=0)
    pos = torch.cat([torch.arange(n, device=dev) for n in lens])
    scale = softmax_scale(llm)
    chunks = []  # moe_probe's: each sequence's prefill rows, then its decode rows one by one
    for i, rr in enumerate(out_rows):
        a, end = int(starts[i]), int(starts[i + 1])
        first = a + int(rr[0]) + 1 if len(rr) else end
        chunks += [(a, first)] + [(j, j + 1) for j in range(first, end)]
    for li, lp in enumerate(lw["layers"]):
        f = {k: v.float() for k, v in lp.items()}
        hin = rms_norm(x, f["attn_norm"], eps)
        q = linear(hin, f["wq"], variant).view(-1, h, n_d + p)
        kv_a = linear(hin, f["wkv_a"], variant)
        c = rms_norm(kv_a[:, :r], f["kv_norm"], eps)
        k_pe = rope(kv_a[:, None, r:], pos, llm)
        q = torch.cat([q[..., :n_d], rope(q[..., n_d:], pos, llm)], dim=-1)
        kv = linear(c, f["wkv_b"], variant).view(-1, h, n_d + dv)
        k = torch.cat([kv[..., :n_d], k_pe.expand(-1, h, p)], dim=-1)
        v = kv[..., n_d:]
        attn = torch.empty((x.shape[0], h, dv), device=dev)
        for i, n in enumerate(lens):
            a, b = starts[i], starts[i + 1]
            scores = torch.einsum("thd,shd->hts", q[a:b], k[a:b]) * scale
            idx = torch.arange(n, device=dev)
            scores = scores.masked_fill(idx[None, :] > idx[:, None], float("-inf"))
            attn[a:b] = torch.einsum("hts,shd->thd", scores.softmax(dim=-1), v[a:b])
        x = x + linear(attn.reshape(-1, h * dv), f["wo"], variant)
        h2 = rms_norm(x, f["mlp_norm"], eps)
        ffn = 0.0 if variant == "no_shared" and "router" in f else swiglu(h2, f["w_gate"], f["w_up"], f["w_down"],
                                                                          variant)
        if "router" in f:
            if moe_probe is not None:
                moe_probe(li, lp, f, h2, chunks)
            ffn = ffn + moe(h2, f, llm, variant)
        x = x + ffn
        del f
    x = rms_norm(x, lw["final_norm"].float(), eps)
    rows = torch.cat([torch.as_tensor(list(rr), device=dev) + int(starts[i]) for i, rr in enumerate(out_rows)])
    logits = linear(x[rows], lm_head(lw, None), variant)
    out, at = [], 0
    for rr in out_rows:
        out.append(logits[at:at + len(rr)])
        at += len(rr)
    return out


def served_logits(params: Dict, cfg: Dict, frames_u8: torch.Tensor, instructions: Sequence[str],
                  tokens: np.ndarray, variant: Optional[str] = None,
                  moe_probe: Optional[Callable] = None) -> List[torch.Tensor]:
    """Teacher-forced logits [n_tokens, V] of each request over
    [BOS | patches | prompt | served tokens[:-1]]: the prefill's last real
    row, then one row per served token fed back."""
    llm_family = cfg["port"]["llm_family"]
    lw = params["llm"]
    dev = frames_u8.device
    patches = vision_embeddings(params, cfg, frames_u8)
    embeds, out_rows = [], []
    for i, text in enumerate(instructions):
        prompt = torch.as_tensor(inference_prompt_ids(text, llm_family), device=dev)
        fed = torch.as_tensor(np.asarray(tokens[i][:-1], np.int64), device=dev)
        te = token_embeddings(lw, torch.cat([prompt, fed]), None)
        embeds.append(torch.cat([te[:1], patches[i], te[1:]], dim=0))
        n_prompt = len(prompt) + patches.shape[1]
        out_rows.append(range(n_prompt - 1, n_prompt - 1 + len(tokens[i])))
    return decoder_logits(lw, cfg["port"]["llm"], embeds, out_rows, variant, moe_probe)
