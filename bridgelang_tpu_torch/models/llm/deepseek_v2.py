"""The DeepSeek-V2 decoder in torch: multi-head latent attention (MLA) and a
mixture of experts, over a parameter dict like the Llama block's.

No JAX counterpart: the JAX package has no such decoder. Written from the
DeepSeek-V2 paper (arXiv:2405.04434) and the published config.json and
modelling code of deepseek-ai/DeepSeek-V2-Lite. Leaves of layer i (D the
hidden size, H heads, r = kv_lora_rank, p = qk_rope_head_dim, n =
qk_nope_head_dim, dv = v_head_dim, E experts of width I_e):

    attention: "attn_norm" [D], "wq" [H*(n+p), D], "wkv_a" [r+p, D],
               "kv_norm" [r], "wkv_b" [H*(n+dv), r], "wo" [D, H*dv]
    FFN:       "mlp_norm" [D], then for i < first_k_dense_replace the dense
               SwiGLU "w_gate"/"w_up" [I, D], "w_down" [D, I]; otherwise the
               router "router" [E, D], the experts "we_gate"/"we_up"
               [E, I_e, D] and "we_down" [E, D, I_e], and the shared experts as
               one SwiGLU "w_gate"/"w_up" [S*I_e, D], "w_down" [D, S*I_e]

nn.Linear's [out, in] layout throughout, as the published weights store
them (each head's rows of wkv_b: its n k_nope rows, then its dv v rows).

Attention. q = wq x splits per head into q_nope (n) and q_pe (p); wkv_a x
into the latent c (r, then RMS-normed by kv_norm) and one rope key k_pe (p)
that every head shares. The rope halves are rotated as the published code
rotates them: the p dims de-interleaved (even dims, then odd), then rotated
by halves, with YaRN's inverse frequencies and cos/sin scaled by
mscale / mscale_all_dim (1 for DeepSeek-V2-Lite). The softmax scale is
(n+p)^-0.5 * mscale_all_dim-factor^2 (`softmax_scale`).

* A chunk from slot 0 (the prefill, or no cache) runs the expanded form:
  [k_nope | v] = wkv_b c per head, k = [k_nope | k_pe], q = [q_nope | q_pe],
  through the flash forward at D = n + p with v's own Dv (`attn:mla_flash`).
  The prefill writes the cache: [c | k_pe] per token, `init_kv_cache`'s
  "latent" [L, B, S, r + p].
* Decode runs the absorbed form over the cache (`attn:mla_absorbed`): q_nope
  times each head's k_nope rows of wkv_b gives a query in latent space,
  scored against the cached c, plus q_pe . k_pe; the fp32 softmax weights
  the cached c, and each head's v rows of wkv_b bring the result back to dv
  dims. The products with wkv_b run in the weights' dtype, the scores and
  the weighted latent in fp32. Plain torch: a few hundred cached slots.

FFN. RMSNorm, then the dense SwiGLU through `proj`, or the routed experts
(ops/moe.py: the router's fp32 softmax, a greedy top-k, each expert's
SwiGLU over its tokens, their outputs weighted in fp32, summed, cast) plus
the shared experts through `proj`, added in the activations' dtype, as the
published code adds them.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from bridgelang_tpu_torch.models.llm.llama import (
    DeepSeekV2Config,
    lengths_from_mask,
    proj,
    refuse_mla,
    rms_norm,
)
from bridgelang_tpu_torch.ops.flash_attention import flash_attention
from bridgelang_tpu_torch.ops.moe import moe_experts
from bridgelang_tpu_torch.util import profiling

Params = Dict[str, Any]


# --- YaRN ---------------------------------------------------------------------


def _yarn_mscale(scale: float, mscale: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def yarn_inv_freq(cfg: DeepSeekV2Config, device=None) -> torch.Tensor:
    """The rope dims' inverse frequencies [p / 2] (fp32, computed on
    `device`: no host copy inside a captured graph): the published YaRN
    blend of the interpolated (theta^-i / factor) and the extrapolated
    (theta^-i) frequencies by a linear ramp between the correction dims of
    beta_fast and beta_slow rotations."""
    p, base = cfg.qk_rope_head_dim, cfg.rope_theta
    powers = base ** (torch.arange(0, p, 2, dtype=torch.float32, device=device) / p)
    extra = 1.0 / powers
    if cfg.yarn_factor <= 1:
        return extra
    inter = 1.0 / (cfg.yarn_factor * powers)

    def correction_dim(rotations: float) -> float:
        return (p * math.log(cfg.yarn_original_max_position / (rotations * 2 * math.pi))) / (2 * math.log(base))

    low = max(math.floor(correction_dim(cfg.yarn_beta_fast)), 0)
    high = min(math.ceil(correction_dim(cfg.yarn_beta_slow)), p - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(p // 2, dtype=torch.float32, device=device) - low) / (high - low), 0, 1)
    keep = 1.0 - ramp  # 1: extrapolate (high frequencies), 0: interpolate
    return inter * (1 - keep) + extra * keep


def yarn_cos_sin(cfg: DeepSeekV2Config, positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos, sin [..., p] (fp32) at `positions`, halves duplicated, times
    mscale / mscale_all_dim."""
    inv = yarn_inv_freq(cfg, positions.device)
    angles = positions.float()[..., None] * inv
    emb = torch.cat([angles, angles], dim=-1)
    m = _yarn_mscale(cfg.yarn_factor, cfg.yarn_mscale) / _yarn_mscale(cfg.yarn_factor, cfg.yarn_mscale_all_dim)
    return emb.cos() * m, emb.sin() * m


def softmax_scale(cfg: DeepSeekV2Config) -> float:
    """(n + p)^-0.5, times the square of YaRN's mscale_all_dim factor."""
    scale = cfg.qk_head_dim ** -0.5
    if cfg.yarn_factor > 1 and cfg.yarn_mscale_all_dim:
        scale *= _yarn_mscale(cfg.yarn_factor, cfg.yarn_mscale_all_dim) ** 2
    return scale


def rope_deinterleaved(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [B, T, heads, p] -> its dims de-interleaved (x0, x2, .., x1, x3, ..)
    and rotated by halves; cos/sin [B, T, 1, p] already in x's dtype (the
    tables cast once per forward, as the Llama block casts them)."""
    b, t, h, p = x.shape
    x = x.view(b, t, h, p // 2, 2).transpose(3, 4).reshape(b, t, h, p)
    rotated = torch.cat([-x[..., p // 2:], x[..., :p // 2]], dim=-1)
    return x * cos + rotated * sin


# --- init -----------------------------------------------------------------------


def init_params(generator: torch.Generator, cfg: DeepSeekV2Config, dtype: torch.dtype = torch.float32,
                device: Optional[torch.device] = None) -> Params:
    """Random leaves (module docstring) with the port's scales: matrices
    normal * fan_in^-0.5, the embedding normal * 0.02, norms one."""
    D, H, V = cfg.dim, cfg.n_heads, cfg.padded_vocab_size
    r, n, p, dv = cfg.kv_lora_rank, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    E, Ie = cfg.n_routed_experts, cfg.moe_intermediate_size

    def dense(*shape: int) -> torch.Tensor:
        return torch.randn(shape, generator=generator, device=device, dtype=dtype).mul_(shape[-1] ** -0.5)

    def ones(k: int) -> torch.Tensor:
        return torch.ones(k, device=device, dtype=dtype)

    layers: List[Params] = []
    for i in range(cfg.n_layers):
        lp = {"attn_norm": ones(D), "wq": dense(H * (n + p), D), "wkv_a": dense(r + p, D), "kv_norm": ones(r),
              "wkv_b": dense(H * (n + dv), r), "wo": dense(D, H * dv), "mlp_norm": ones(D)}
        width = cfg.intermediate_size if i < cfg.first_k_dense_replace else cfg.n_shared_experts * Ie
        if i >= cfg.first_k_dense_replace:
            lp.update(router=dense(E, D), we_gate=dense(E, Ie, D), we_up=dense(E, Ie, D), we_down=dense(E, D, Ie))
        lp.update(w_gate=dense(width, D), w_up=dense(width, D), w_down=dense(D, width))
        layers.append(lp)
    embed = torch.randn((V, D), generator=generator, device=device, dtype=dtype).mul_(0.02)
    return {"embed": embed, "layers": layers, "final_norm": ones(D), "lm_head": dense(V, D)}


# --- the block --------------------------------------------------------------------


def _latent_heads(cfg: DeepSeekV2Config, lp: Params) -> Tuple[torch.Tensor, torch.Tensor]:
    """wkv_b as each head's k_nope rows [H, n, r] and v rows [H, dv, r] (views)."""
    w = lp["wkv_b"].view(cfg.n_heads, cfg.qk_nope_head_dim + cfg.v_head_dim, cfg.kv_lora_rank)
    return w[:, :cfg.qk_nope_head_dim], w[:, cfg.qk_nope_head_dim:]


def mla_expanded(cfg: DeepSeekV2Config, lp: Params, q_nope: torch.Tensor, q_pe: torch.Tensor, c: torch.Tensor,
                 k_pe: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Attention of a chunk over itself from slot 0 -> [B, T, H, dv]:
    per-head k and v expanded from the latent, then the flash forward."""
    b, t, h, _ = q_nope.shape
    kv = F.linear(c, lp["wkv_b"]).view(b, t, h, cfg.qk_nope_head_dim + cfg.v_head_dim)
    k_nope, v = kv.split([cfg.qk_nope_head_dim, cfg.v_head_dim], dim=-1)
    q = torch.cat([q_nope, q_pe], dim=-1)
    k = torch.cat([k_nope, k_pe.expand(b, t, h, cfg.qk_rope_head_dim)], dim=-1)
    profiling.count("attn:mla_flash")
    return flash_attention(q, k, v.contiguous(), lengths=lengths, causal=True, scale=softmax_scale(cfg))[0]


def mla_absorbed(cfg: DeepSeekV2Config, lp: Params, q_nope: torch.Tensor, q_pe: torch.Tensor,
                 latent: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Attention of a short chunk over the latent cache [B, S, r + p] under
    `mask` [B, 1, T, S] -> [B, T, H, dv]: wkv_b's k_nope rows absorbed into
    the query, its v rows applied after the weighted latent. Batched
    products over the heads read wkv_b's rows in place, and the heads' rows
    of the scores stack ([B, H T, S]), so no weight or cache is copied per
    head; the cache is read once in fp32."""
    b, t, h, n = q_nope.shape
    r = cfg.kv_lora_rank
    w_uk, w_uv = _latent_heads(cfg, lp)
    q_lat = torch.bmm(q_nope.permute(2, 0, 1, 3).reshape(h, b * t, n), w_uk)  # [H, B T, r]
    q_lat = q_lat.view(h, b, t, r).transpose(0, 1).reshape(b, h * t, r).float()  # rows h T + t
    q_pe = q_pe.new_empty((b, h, t, q_pe.shape[-1]), dtype=torch.float32).copy_(q_pe.transpose(1, 2)).view(b, h * t, -1)
    cache = latent.float()
    scale = softmax_scale(cfg)
    scores = torch.baddbmm(torch.bmm(q_pe, cache[..., r:].transpose(1, 2)), q_lat, cache[..., :r].transpose(1, 2),
                           beta=scale, alpha=scale).view(b, h, t, -1)
    probs = torch.softmax(torch.where(mask, scores, -1e30), dim=-1)
    o_lat = torch.bmm(probs.view(b, h * t, -1), cache[..., :r]).to(q_nope.dtype)  # [B, H T, r]
    o = torch.bmm(o_lat.view(b, h, t, r).transpose(0, 1).reshape(h, b * t, r), w_uv.transpose(1, 2))
    profiling.count("attn:mla_absorbed")
    return o.view(h, b, t, -1).permute(1, 2, 0, 3)


def _ffn(cfg: DeepSeekV2Config, lp: Params, x: torch.Tensor, load: Optional[torch.Tensor]) -> torch.Tensor:
    h = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    shared = proj(F.silu(proj(h, lp, "w_gate", cfg)) * proj(h, lp, "w_up", cfg), lp, "w_down", cfg)
    if "router" not in lp:
        return shared
    routed = moe_experts(h.reshape(-1, h.shape[-1]), lp["router"], lp["we_gate"], lp["we_up"], lp["we_down"],
                         cfg.num_experts_per_tok, cfg.norm_topk_prob, cfg.routed_scaling_factor, load)
    return routed.view_as(shared) + shared


def _block(cfg: DeepSeekV2Config, lp: Params, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
           mask: torch.Tensor, latent: Optional[torch.Tensor], cache_positions: Optional[torch.Tensor],
           lengths: Optional[torch.Tensor], load: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer over a T-token chunk. With `latent` (one layer's cache view
    [B, S, r + p]) the chunk's [c | k_pe] is written at `cache_positions`
    and attention runs absorbed over the cache under `mask`; without, it
    runs expanded over the chunk with `lengths`. Returns (x, the chunk's
    [c | k_pe] [B, T, r + p])."""
    b, t, _ = x.shape
    h_in = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    q = proj(h_in, lp, "wq", cfg).view(b, t, cfg.n_heads, cfg.qk_head_dim)
    q_nope, q_pe = q.split([cfg.qk_nope_head_dim, cfg.qk_rope_head_dim], dim=-1)
    q_pe = rope_deinterleaved(q_pe, cos, sin)
    c, k_pe = proj(h_in, lp, "wkv_a", cfg).split([cfg.kv_lora_rank, cfg.qk_rope_head_dim], dim=-1)
    c = rms_norm(c, lp["kv_norm"], cfg.norm_eps)
    k_pe = rope_deinterleaved(k_pe[:, :, None], cos, sin)  # [B, T, 1, p]
    new = torch.cat([c, k_pe[:, :, 0]], dim=-1)
    if latent is None:
        attn = mla_expanded(cfg, lp, q_nope, q_pe, c, k_pe, lengths)
    else:
        rows = torch.arange(b, device=x.device)[:, None]
        latent[rows, cache_positions] = new.to(latent.dtype)
        attn = mla_absorbed(cfg, lp, q_nope, q_pe, latent, mask)
    x = x + proj(attn.reshape(b, t, -1), lp, "wo", cfg)
    return x + _ffn(cfg, lp, x, load), new


def forward(params: Params, cfg: DeepSeekV2Config, embeds: torch.Tensor, positions: torch.Tensor,
            mask: torch.Tensor, cache: Optional[Params] = None, cache_positions: Optional[torch.Tensor] = None,
            cache_write: str = "scatter", lengths: Optional[torch.Tensor] = None, attention: str = "flash",
            expert_load: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Optional[Params]]:
    """llama.llm_forward for this decoder (same arguments): a chunk without
    a cache or the contiguous prefill attends over itself (expanded, flash);
    scatter mode attends over the latent cache (absorbed). `expert_load`
    [MoE layers, E] int32 receives each MoE layer's picks per expert. Other
    attention kinds are refused."""
    if attention != "flash":
        refuse_mla(cfg, f"attention={attention!r} (the parallel decode, the masked or ring attention)")
    cos, sin = (table[:, :, None].to(embeds.dtype) for table in yarn_cos_sin(cfg, positions))
    contiguous = cache is not None and cache_write == "contiguous"
    if (cache is None or contiguous) and lengths is None:
        lengths = lengths_from_mask(mask)
    x = embeds
    t = x.shape[1]
    for i, lp in enumerate(params["layers"]):
        j = i - cfg.first_k_dense_replace
        load = expert_load[j] if expert_load is not None and j >= 0 else None
        if cache is None or contiguous:
            x, new = _block(cfg, lp, x, cos, sin, mask, None, None, lengths, load)
            if contiguous:
                cache["latent"][i, :, :t] = new.to(cache["latent"].dtype)
        else:
            x, _ = _block(cfg, lp, x, cos, sin, mask, cache["latent"][i], cache_positions, None, load)
    return rms_norm(x, params["final_norm"], cfg.norm_eps), cache
