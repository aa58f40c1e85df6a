"""Llama-2 decoder in torch: plain tensor functions over a parameter dict.

Counterpart of bridgelang_tpu/models/llm/llama.py for `arch="llama"` (bf16 or
fp32 weights, GQA, bf16 KV cache). Parameters follow nn.Linear's layout:

    {"embed": [V, D], "final_norm": [D], "lm_head": [V, D],
     "layers": [{"wq": [H*hd, D], "wk": [Hkv*hd, D], "wv": [Hkv*hd, D],
                 "wo": [D, H*hd], "attn_norm": [D], "w_gate": [I, D],
                 "w_up": [I, D], "w_down": [D, I], "mlp_norm": [D]}, ...]}

i.e. each JAX [in, out] kernel transposed, and the scan-stacked layer axis
unstacked into a list (see bridgelang_tpu_torch.convert).

Attention over a chunk that starts at cache slot 0 (no cache, or the
contiguous prefill) goes through the flash-attention kernel with per-example
valid lengths; single-token decode and scatter-mode chunks use the masked
`cached_attention` over the whole cache, as in the JAX package.

Cast points match the JAX order: `rms_norm` computes in fp32 and casts back;
RoPE tables are cast to x.dtype before the rotation; `cached_attention`
forms scores in q.dtype, softmaxes in fp32 and casts the probabilities back.

Not yet ported: int8 / int4 weights and LoRA adapters (convert.py refuses
such parameter trees), the int8 KV cache (`init_kv_cache` refuses it) and
the Phi block (`_require_llama`); each raises NotImplementedError.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from bridgelang_tpu_torch.ops.flash_attention import flash_attention

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class LLMConfig:
    vocab_size: int = 32000           # ORIGINAL vocab (action-token id math uses this)
    padded_vocab_size: int = 32064    # +<PAD>, resized to a multiple of 64
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 32
    intermediate_size: int = 11008
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    max_seq_len: int = 2048
    pad_token_id: int = 32000
    bos_token_id: int = 1
    eos_token_id: int = 2
    arch: str = "llama"               # "llama" (RMSNorm+SwiGLU) | "phi" (not yet ported)
    rotary_pct: float = 1.0
    use_bias: bool = False
    sliding_window: Optional[int] = None
    w8a8: bool = False
    int4_shards: int = 1

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @property
    def rotary_dim(self) -> int:
        rd = int(self.rotary_pct * self.head_dim)
        assert rd % 2 == 0, f"rotary_dim must be even, got {rd} (head_dim={self.head_dim})"
        return rd


LLM_CONFIGS: Dict[str, LLMConfig] = {
    "llama2-7b-pure": LLMConfig(),
    "llama2-7b-chat": LLMConfig(),
    "vicuna-v15-7b": LLMConfig(),
    "llama2-13b-pure": LLMConfig(dim=5120, n_layers=40, n_heads=40, n_kv_heads=40, intermediate_size=13824),
    "llama2-13b-chat": LLMConfig(dim=5120, n_layers=40, n_heads=40, n_kv_heads=40, intermediate_size=13824),
    "vicuna-v15-13b": LLMConfig(dim=5120, n_layers=40, n_heads=40, n_kv_heads=40, intermediate_size=13824),
    "mistral-v0.1-7b-pure": LLMConfig(n_kv_heads=8, intermediate_size=14336, max_seq_len=2048, sliding_window=4096),
    "mistral-v0.1-7b-instruct": LLMConfig(n_kv_heads=8, intermediate_size=14336, max_seq_len=2048, sliding_window=4096),
    "phi-2-3b": LLMConfig(
        vocab_size=51200, padded_vocab_size=51264, dim=2560, n_layers=32, n_heads=32, n_kv_heads=32,
        intermediate_size=10240, arch="phi", rotary_pct=0.4, use_bias=True, norm_eps=1e-5,
        pad_token_id=51200, bos_token_id=50256, eos_token_id=50256,
    ),
}

LLM_FAMILIES: Dict[str, str] = {
    "llama2-7b-pure": "llama2-pure", "llama2-13b-pure": "llama2-pure",
    "llama2-7b-chat": "llama2-chat", "llama2-13b-chat": "llama2-chat",
    "vicuna-v15-7b": "vicuna", "vicuna-v15-13b": "vicuna",
    "mistral-v0.1-7b-pure": "mistral-pure", "mistral-v0.1-7b-instruct": "mistral-instruct",
    "phi-2-3b": "phi",
}


def _require_llama(cfg: LLMConfig) -> None:
    if cfg.arch != "llama" or cfg.use_bias or cfg.rotary_pct != 1.0:
        raise NotImplementedError(f"arch={cfg.arch!r} (Phi block) is not yet ported to torch")


# --- init ---------------------------------------------------------------------


def init_llm_params(
    generator: torch.Generator, cfg: LLMConfig, dtype: torch.dtype = torch.float32,
    device: Optional[torch.device] = None,
) -> Params:
    """Random init with the JAX package's scales (normal * fan_in^-0.5,
    embed normal * 0.02, norms one), drawn on `device` in `dtype` from
    `generator` (which must live on that device)."""
    _require_llama(cfg)
    D, I, V = cfg.dim, cfg.intermediate_size, cfg.padded_vocab_size
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def dense(out_f: int, in_f: int) -> torch.Tensor:
        w = torch.randn((out_f, in_f), generator=generator, device=device, dtype=dtype)
        return w.mul_(in_f ** -0.5)

    def ones(n: int) -> torch.Tensor:
        return torch.ones(n, device=device, dtype=dtype)

    layers: List[Params] = []
    for _ in range(cfg.n_layers):
        layers.append({
            "wq": dense(H * hd, D), "wk": dense(Hkv * hd, D), "wv": dense(Hkv * hd, D),
            "wo": dense(D, H * hd), "attn_norm": ones(D),
            "w_gate": dense(I, D), "w_up": dense(I, D), "w_down": dense(D, I), "mlp_norm": ones(D),
        })
    embed = torch.randn((V, D), generator=generator, device=device, dtype=dtype).mul_(0.02)
    return {"embed": embed, "layers": layers, "final_norm": ones(D), "lm_head": dense(V, D)}


def init_kv_cache(
    cfg: LLMConfig, batch: int, max_len: int, dtype: torch.dtype = torch.bfloat16,
    device: Optional[torch.device] = None,
) -> Params:
    """KV cache [L, B, S, Hkv, hd] in bf16 (the int8 cache is not yet ported)."""
    if dtype != torch.bfloat16:
        raise NotImplementedError(f"KV cache dtype {dtype} is not yet ported; the torch cache is bf16")
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device), "v": torch.zeros(shape, dtype=dtype, device=device)}


# --- building blocks ----------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    normed = x32 * torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (normed * weight.float()).to(x.dtype)


def rope_cos_sin(positions: torch.Tensor, rotary_dim: int, theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """HF-Llama RoPE tables [..., rotary_dim] (half-split duplication)."""
    exps = torch.arange(0, rotary_dim, 2, dtype=torch.float32, device=positions.device) / rotary_dim
    inv_freq = 1.0 / (theta ** exps)
    angles = positions.float()[..., None] * inv_freq
    emb = torch.cat([angles, angles], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, rotary_dim: int) -> torch.Tensor:
    """x: [B, T, H, hd]; cos/sin: [B, T, rotary_dim] (broadcast over heads)."""
    xr, xp = x[..., :rotary_dim], x[..., rotary_dim:]
    half = rotary_dim // 2
    rotated = torch.cat([-xr[..., half:], xr[..., :half]], dim=-1)
    xr = xr * cos[:, :, None, :].to(x.dtype) + rotated * sin[:, :, None, :].to(x.dtype)
    return torch.cat([xr, xp], dim=-1) if rotary_dim < x.shape[-1] else xr


def _repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    if n_rep == 1:
        return x
    b, s, h, d = x.shape
    return x[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(b, s, h * n_rep, d)


def cached_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked attention of a short query chunk over the whole cache (the
    single-token decode path): scores in q.dtype, fp32 softmax, probs cast
    back to q.dtype."""
    hd = q.shape[-1]
    n_rep = q.shape[2] // k.shape[2]
    kk = _repeat_kv(k, n_rep)
    vv = _repeat_kv(v, n_rep)
    scale = torch.tensor(math.sqrt(hd), dtype=q.dtype).item()  # sqrt(hd) rounded to q.dtype, as in JAX
    scores = torch.einsum("bqhd,bshd->bhqs", q, kk) / scale
    scores = torch.where(mask, scores.float(), -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqs,bshd->bqhd", probs, vv)


def lengths_from_mask(mask: torch.Tensor) -> torch.Tensor:
    """Valid-key counts [B] of a causal + right-padding [B, 1, T, S] mask:
    the number of keys any query row attends (the JAX kernel path's rule)."""
    return mask[:, 0].any(dim=1).sum(dim=-1).to(torch.int32)


# --- decoder forward ----------------------------------------------------------


def _block(
    cfg: LLMConfig,
    lp: Params,
    x: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    mask: torch.Tensor,
    kv: Optional[Tuple[torch.Tensor, torch.Tensor]],
    cache_positions: Optional[torch.Tensor],
    lengths: Optional[torch.Tensor],
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """One decoder block over a T-token chunk. With `kv` (one layer's cache
    views), K/V are written IN PLACE at `cache_positions` [B, T] and attention
    runs over the whole cache under `mask`; without, attention runs over the
    chunk itself through the flash kernel with `lengths` valid keys.
    Returns (x, the chunk's (k, v))."""
    B, T, _ = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    h_in = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    q = F.linear(h_in, lp["wq"]).view(B, T, H, hd)
    k = F.linear(h_in, lp["wk"]).view(B, T, Hkv, hd)
    v = F.linear(h_in, lp["wv"]).view(B, T, Hkv, hd)
    q = apply_rope(q, cos, sin, cfg.rotary_dim)
    k = apply_rope(k, cos, sin, cfg.rotary_dim)

    if kv is None:
        attn_out, _ = flash_attention(q, k, v, lengths=lengths, causal=True, window=cfg.sliding_window)
    else:
        cache_k, cache_v = kv
        rows = torch.arange(B, device=x.device)[:, None]
        cache_k[rows, cache_positions] = k.to(cache_k.dtype)
        cache_v[rows, cache_positions] = v.to(cache_v.dtype)
        attn_out = cached_attention(q, cache_k.to(q.dtype), cache_v.to(q.dtype), mask)

    x = x + F.linear(attn_out.reshape(B, T, H * hd), lp["wo"])
    h2 = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    mlp_out = F.linear(F.silu(F.linear(h2, lp["w_gate"])) * F.linear(h2, lp["w_up"]), lp["w_down"])
    return x + mlp_out, (k, v)


def llm_forward(
    params: Params,
    cfg: LLMConfig,
    embeds: torch.Tensor,
    positions: torch.Tensor,
    mask: torch.Tensor,
    cache: Optional[Params] = None,
    cache_positions: Optional[torch.Tensor] = None,
    cache_write: str = "scatter",
    lengths: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[Params]]:
    """Run the decoder stack over input embeddings.

    embeds [B, T, D]; positions [B, T] RoPE positions; mask [B, 1, T, S]
    bool (S = T, or the cache length); cache from `init_kv_cache`;
    cache_positions [B, T] write slots (scatter mode).

    cache_write="scatter" writes K/V at `cache_positions` and attends over the
    whole cache under `mask` (decode steps). "contiguous" is the prefill: the
    chunk occupies slots 0..T-1 of every example, K/V are copied there, and
    attention runs over the chunk itself through the flash kernel. Without a
    cache, attention also runs over the chunk through the kernel.
    Chunk attention needs `lengths` [B] (valid keys per example); when not
    given it is recovered from `mask`, which must then be causal +
    right-padding (+ window), the family the kernel computes.

    The cache is updated IN PLACE and returned (JAX returns a new one):
    this saves a copy of the whole cache per step. Returns (hidden [B, T, D],
    cache or None).
    """
    _require_llama(cfg)
    cos, sin = rope_cos_sin(positions, cfg.rotary_dim, cfg.rope_theta)
    contiguous = cache is not None and cache_write == "contiguous"
    chunk_attention = cache is None or contiguous
    if chunk_attention and lengths is None:
        lengths = lengths_from_mask(mask)
    x = embeds
    T = x.shape[1]
    for i, lp in enumerate(params["layers"]):
        if chunk_attention:
            x, (k, v) = _block(cfg, lp, x, cos, sin, mask, None, None, lengths)
            if contiguous:
                cache["k"][i, :, :T] = k.to(cache["k"].dtype)
                cache["v"][i, :, :T] = v.to(cache["v"].dtype)
        else:
            x, _ = _block(cfg, lp, x, cos, sin, mask, (cache["k"][i], cache["v"][i]), cache_positions, None)
    return rms_norm(x, params["final_norm"], cfg.norm_eps), cache


def embed_tokens(params: Params, input_ids: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    emb = F.embedding(input_ids.long(), params["embed"])
    return emb.to(dtype) if dtype is not None else emb


def lm_logits(params: Params, hidden: torch.Tensor, cfg: LLMConfig) -> torch.Tensor:
    """Logits over the PADDED vocabulary (argmax runs over all of it)."""
    _require_llama(cfg)
    return F.linear(hidden, params["lm_head"])
