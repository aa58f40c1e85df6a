"""Decoder-only LLM backbones (Llama-2, Mistral, Phi-2) in torch: plain
tensor functions over a parameter dict.

Counterpart of bridgelang_tpu/models/llm/llama.py: the Llama block
(RMSNorm, SwiGLU; GQA and Mistral's sliding window) and the Phi block
(`arch="phi"`: one LayerNorm with bias, biased projections, partial rotary
embedding over `rotary_dim` of each head, the parallel residual
x + attn(ln x) + mlp(ln x) with a tanh-GELU MLP, a final LayerNorm and an LM
head bias); bf16 or fp32 weights; a bf16, fp32 or int8 KV cache.
Parameters follow nn.Linear's layout:

    {"embed": [V, D], "final_norm": [D], "lm_head": [V, D],
     "layers": [{"wq": [H*hd, D], "wk": [Hkv*hd, D], "wv": [Hkv*hd, D],
                 "wo": [D, H*hd], "attn_norm": [D], "w_gate": [I, D],
                 "w_up": [I, D], "w_down": [D, I], "mlp_norm": [D]}, ...]}

i.e. each JAX [in, out] kernel transposed, and the scan-stacked layer axis
unstacked into a list (see bridgelang_tpu_torch.convert). A Phi layer has no
`w_gate` and `mlp_norm`; it adds `attn_norm_bias` [D], `bq`/`bk`/`bv`
[H*hd or Hkv*hd], `bo` [D], `b_up` [I] and `b_down` [D], and the top level
adds `final_norm_bias` [D] and `lm_head_bias` [V].

The int8 KV cache (`init_kv_cache(dtype=torch.int8)`) holds int8 codes
`k`/`v` [L, B, S, Hkv, hd] and bf16 scales `k_scale`/`v_scale`
[L, B, S, Hkv]: symmetric absmax over each (token, head) row, as the JAX
package. Decode and the speculative verify chunk quantize their new K/V,
scatter codes and scales, and attend over the dequantized cache; the
contiguous prefill attends over its own unquantized K/V and only writes the
cache quantized, as the JAX package does.

Attention over a chunk that starts at cache slot 0 (no cache, or the
contiguous prefill) goes through the flash-attention kernel with per-example
valid lengths; single-token decode and scatter-mode chunks (the speculative
verify chunk too) use the masked `cached_attention` over the whole cache, as
in the JAX package. A chunk whose mask lies outside the kernel's causal +
length family (the parallel decode's query rows) asks for it by name:
`llm_forward(..., attention="masked")` runs `full_attention`, the JAX
`attention_impl="xla"`; "einsum" runs `cached_attention` over the chunk, and
"ring" / "ring:<axis>" ring attention over a training mesh's axis
(ops/ring_attention.py), the JAX `impl="ring"`.

Cast points match the JAX order: `rms_norm` computes in fp32 and casts back;
RoPE tables are cast to x.dtype before the rotation; `cached_attention`
forms scores in q.dtype, softmaxes in fp32 and casts the probabilities back.

LoRA adapters are extra per-layer leaves `<proj>_lora_a` [r, in] and
`<proj>_lora_b` [out, r] (training/lora.py): a projection adds
(x A^T) B^T with the adapters cast to the activation dtype, as the JAX `proj`.
Training runs `llm_forward` with `remat`: each decoder layer under
`torch.utils.checkpoint` (non-reentrant), recomputing the whole layer
("full") or all but its matmul outputs ("dots") in the backward.

Quantized weights (ops/quant.py): a packed-int4 projection keeps the JAX
package's bytes, `<proj>` [in, out/2] int8 with `<proj>_scale4`
[in/group, out] bf16, and `proj` runs it through the int4 kernels
(ops/int4_matmul.py); an int8 projection is `<proj>` [out, in] int8 with
`<proj>_scale` [out, 1] bf16; the int8 embedding [V, D] and head [V, D] carry
`embed_scale` / `lm_head_scale` [V, 1]. Without w8a8, a short bf16 product
over int8 codes (decode, the verify chunk, the head) goes through the int8
weight-only GEMV (ops/int8_matmul.py) instead of casting the weight. Under
the "dots" remat policy the int4 kernel's output is recomputed in the
backward: its launch is no aten `mm`, so `_save_dots` does not keep it.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from bridgelang_tpu_torch.ops.flash_attention import flash_attention
from bridgelang_tpu_torch.ops.int4_matmul import matmul_int4, matmul_int4_a8
from bridgelang_tpu_torch.ops.int8_matmul import int8_gemv, int8_gemv_plain
from bridgelang_tpu_torch.ops.quant import INT4_COLUMN_PARALLEL, quantize_activations_per_token
from bridgelang_tpu_torch.parallel.collectives import row_product
from bridgelang_tpu_torch.util import profiling

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
    arch: str = "llama"               # "llama" (RMSNorm+SwiGLU) | "phi" (LN + parallel GELU block)
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


@dataclasses.dataclass(frozen=True)
class TensorParallelLLMConfig(LLMConfig):
    """An LLMConfig whose decoder runs on a device mesh: `tp` (a
    parallel/collectives.TensorParallel, set by OpenVLA.use_mesh for serving
    and by parallel/fsdp.MeshTraining.bind for training) says which leaves
    are this rank's blocks and runs the collectives; `mesh` (training) is the
    DeviceMesh whose axes ring attention runs over. A subclass, so that the
    plain config keeps exactly the JAX config's fields; `dataclasses.replace`
    keeps both."""

    tp: Optional[Any] = dataclasses.field(default=None, compare=False, repr=False)
    mesh: Optional[Any] = dataclasses.field(default=None, compare=False, repr=False)

    @classmethod
    def of(cls, cfg: LLMConfig, tp, mesh=None) -> "TensorParallelLLMConfig":
        return cls(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(LLMConfig)}, tp=tp, mesh=mesh)


def tensor_parallel(cfg: LLMConfig):
    """The config's TensorParallel, or None on one device."""
    return getattr(cfg, "tp", None)


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


# --- init ---------------------------------------------------------------------


def init_llm_params(
    generator: torch.Generator, cfg: LLMConfig, dtype: torch.dtype = torch.float32,
    device: Optional[torch.device] = None,
) -> Params:
    """Random init with the JAX package's scales (normal * fan_in^-0.5,
    embed normal * 0.02, norms one, biases zero) and leaves, drawn on
    `device` in `dtype` from `generator` (which must live on that device).
    Each layer draws its projections in the JAX order (wq, wk, wv, wo, then
    w_gate, w_up, w_down; a Phi layer has no w_gate). The numbers are not the
    JAX package's (another generator): the tests hand both packages the
    same numpy arrays through `convert`."""
    D, I, V = cfg.dim, cfg.intermediate_size, cfg.padded_vocab_size
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    phi = cfg.arch == "phi"

    def dense(out_f: int, in_f: int) -> torch.Tensor:
        w = torch.randn((out_f, in_f), generator=generator, device=device, dtype=dtype)
        return w.mul_(in_f ** -0.5)

    def ones(n: int) -> torch.Tensor:
        return torch.ones(n, device=device, dtype=dtype)

    def zeros(n: int) -> torch.Tensor:
        return torch.zeros(n, device=device, dtype=dtype)

    layers: List[Params] = []
    for _ in range(cfg.n_layers):
        lp = {"wq": dense(H * hd, D), "wk": dense(Hkv * hd, D), "wv": dense(Hkv * hd, D),
              "wo": dense(D, H * hd), "attn_norm": ones(D)}
        if phi:  # parallel block: one LayerNorm (with bias), biased projections
            lp.update(w_up=dense(I, D), w_down=dense(D, I), attn_norm_bias=zeros(D), bq=zeros(H * hd),
                      bk=zeros(Hkv * hd), bv=zeros(Hkv * hd), bo=zeros(D), b_up=zeros(I), b_down=zeros(D))
        else:
            lp.update(w_gate=dense(I, D), w_up=dense(I, D), w_down=dense(D, I), mlp_norm=ones(D))
        layers.append(lp)
    embed = torch.randn((V, D), generator=generator, device=device, dtype=dtype).mul_(0.02)
    params = {"embed": embed, "layers": layers, "final_norm": ones(D), "lm_head": dense(V, D)}
    if phi:
        params.update(final_norm_bias=zeros(D), lm_head_bias=zeros(V))
    return params


def init_kv_cache(
    cfg: LLMConfig, batch: int, max_len: int, dtype: torch.dtype = torch.bfloat16,
    device: Optional[torch.device] = None,
) -> Params:
    """KV cache [L, B, S, Hkv, hd] of zeros (bf16 serves, fp32 gives the
    exact speculative contract). dtype=torch.int8 stores codes plus bf16
    per-(token, head) scales `k_scale`/`v_scale` [L, B, S, Hkv]: half the
    bytes of the bf16 cache. Under tensor parallelism with split heads the
    cache holds this rank's KV heads."""
    tp = tensor_parallel(cfg)
    n_kv = tp.local_kv_heads(cfg.n_kv_heads) if tp is not None else cfg.n_kv_heads
    shape = (cfg.n_layers, batch, max_len, n_kv, cfg.head_dim)
    cache = {"k": torch.zeros(shape, dtype=dtype, device=device), "v": torch.zeros(shape, dtype=dtype, device=device)}
    if dtype == torch.int8:
        cache["k_scale"] = torch.zeros(shape[:-1], dtype=torch.bfloat16, device=device)
        cache["v_scale"] = torch.zeros(shape[:-1], dtype=torch.bfloat16, device=device)
    return cache


def _quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., hd] -> (int8 codes [..., hd], bf16 scale [...]): symmetric
    absmax over hd, the JAX `_quantize_kv`. The scale is absmax times fp32
    1/127 (XLA compiles the JAX division by 127 so inside the jitted decoder,
    and a tensor factor keeps CUDA torch from its own scalar rewrite); the
    codes divide by that fp32 scale and round half to even, clipped at
    +-127; only the stored scale is rounded to bf16."""
    x32 = x.float()
    absmax = x32.abs().amax(dim=-1)
    scale = torch.where(absmax == 0, torch.ones_like(absmax), absmax * torch.full_like(absmax, 1.0 / 127.0))
    q = torch.clamp(torch.round(x32 / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale.to(torch.bfloat16)


def _dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return q.to(dtype) * scale[..., None].to(dtype)


# --- building blocks ----------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    normed = x32 * torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (normed * weight.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm in fp32 (mean, biased variance), cast back to x's dtype."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)


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


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Attention of a chunk over itself under any bool mask [B, 1, T, S] (the
    JAX `full_attention` with impl="xla", i.e. jax.nn.dot_product_attention):
    scores in fp32 times 1/sqrt(hd), masked entries set to a large negative
    number, fp32 softmax, probabilities cast back to q.dtype. Plain torch on
    both devices; the JAX package has no kernel here either."""
    n_rep = q.shape[2] // k.shape[2]
    kk = _repeat_kv(k, n_rep)
    vv = _repeat_kv(v, n_rep)
    scores = torch.einsum("bqhd,bshd->bhqs", q.float(), kk.float()) * (q.shape[-1] ** -0.5)
    scores = torch.where(mask, scores, -0.7 * torch.finfo(torch.float32).max)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqs,bshd->bqhd", probs, vv)


def lengths_from_mask(mask: torch.Tensor) -> torch.Tensor:
    """Valid-key counts [B] of a causal + right-padding [B, 1, T, S] mask:
    the number of keys any query row attends (the JAX kernel path's rule)."""
    return mask[:, 0].any(dim=1).sum(dim=-1).to(torch.int32)


# --- decoder forward ----------------------------------------------------------

# Shortest chunk (tokens) that runs an int8 weight on the int8 x int8 product
# under `cfg.w8a8` (the JAX package's gate): shorter chunks, decode and the
# speculative verify chunk, cast the weight to the activation dtype.
W8A8_MIN_CHUNK = 8
# Most rows (B x T) of a bf16 product over int8 codes that runs the int8
# weight-only GEMV (ops/int8_matmul.py) rather than casting the weight: the
# largest M at which the kernel beat the cast at every Mistral-7B shape on an
# H100 (PERF.md), at most the kernel's 16.
INT8_GEMV_M = 16
# Attention over a chunk without a cache: the flash kernel, `full_attention`
# under the mask ("masked", JAX impl "xla"), `cached_attention` ("einsum"),
# or ring attention over a mesh axis ("ring", "ring:<axis>"; fsdp by default).
ATTENTION_KINDS = ("flash", "masked", "einsum")
ROW_PARALLEL = ("wo", "w_down")


def check_attention(attention: str) -> str:
    if attention in ATTENTION_KINDS or attention == "ring" or attention.startswith("ring:"):
        return attention
    raise ValueError(f"attention={attention!r}: use one of {ATTENTION_KINDS}, 'ring' or 'ring:<axis>'")

# Matmul ops whose outputs the "dots" policy keeps (JAX:
# dots_with_no_batch_dims_saveable); everything else is recomputed.
_DOT_OPS = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default, torch.ops.aten.bmm.default}


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return CheckpointPolicy.MUST_SAVE if op in _DOT_OPS else CheckpointPolicy.PREFER_RECOMPUTE


def _remat_context(name: Optional[str]):
    """The checkpoint `context_fn` for a named policy, as the JAX
    `_remat_policy`: None/"full" recomputes the whole layer in the backward,
    "dots" keeps matmul outputs and recomputes the rest."""
    if name in (None, "full"):
        return noop_context_fn
    if name == "dots":
        return functools.partial(create_selective_checkpoint_contexts, _save_dots)
    raise ValueError(f"Unknown remat policy {name!r} (use 'full' or 'dots')")


def proj(x: torch.Tensor, lp: Params, name: str, cfg: LLMConfig, row_tp=None) -> torch.Tensor:
    """Base projection plus the optional LoRA update (x A^T) B^T, with the
    adapters cast to the activation dtype (JAX `_block.proj`).

    A packed-int4 weight (sibling `<name>_scale4`) goes through the int4
    kernels with no chunk-length gate: `matmul_int4_a8` when `cfg.w8a8` (the
    serving posture), else `matmul_int4` (the QLoRA forward). Column-parallel
    leaves take `cfg.int4_shards` as their pack's shard count; row-parallel
    leaves are packed unblocked (`quantize_llm_int4`) and run as one block.

    An int8 weight (sibling `<name>_scale`) takes the JAX package's two
    routes. With `cfg.w8a8` and a chunk of at least W8A8_MIN_CHUNK tokens
    (x is [B, T, in]): the activations quantized per token
    (`quantize_activations_per_token`), the exact int8 x int8 -> int32
    product (`_int8_product`), then acc * token scale * column scale in fp32,
    cast to x's dtype. Otherwise the product takes `int8_gemv` (the int8
    weight-only GEMV, the column scale in its epilogue) where
    `_int8_gemv_route` says so, else its plain version: the weight cast to
    x's dtype, multiplied, each output column scaled in x's dtype, with the
    same two roundings.

    `row_tp` (a TensorParallel): x and the weight are this rank's blocks of
    the contraction dim, multiplied under `TensorParallel.row_product`'s
    policy (the partial sums meet in int32 for w8a8, in f32 for w4a8, in x's
    dtype otherwise). A column block of a shard-blocked int4 pack is one
    plain pack on its rank. Adapters under tensor parallelism:
    `_lora_update`."""
    s4 = lp.get(name + "_scale4")
    s8 = lp.get(name + "_scale")
    tp = tensor_parallel(cfg)
    column_block = tp is not None and tp.split.get(name, False) and name not in ROW_PARALLEL
    lora = _lora_update(lp, name, tp, column_block, row_tp is not None)
    joins_reduce = lora is not None and row_tp is not None  # a row block's adapter partial, summed with the base's
    if s8 is not None and s8.shape[0] != lp[name].shape[0]:  # a whole per-column scale beside a column block
        s8 = tp.block(s8, 0)
    if s4 is not None:
        if joins_reduce:
            raise ValueError(f"{name}: adapters over a row-split int4 leaf (train with tensor = 1 over int4)")
        shards = cfg.int4_shards if name in INT4_COLUMN_PARALLEL and not column_block else 1
        y = (matmul_int4_a8 if cfg.w8a8 else matmul_int4)(x, lp[name], s4, shards, row_tp=row_tp)
    elif s8 is not None and cfg.w8a8 and x.shape[1] >= W8A8_MIN_CHUNK:
        if joins_reduce:
            raise ValueError(f"{name}: adapters over a row-split int8 leaf with w8a8 on (training runs w8a8 off)")
        acc, xs = row_product(row_tp, x, lambda q: _int8_product(q.reshape(-1, q.shape[-1]), lp[name]).view(
            *q.shape[:-1], -1), quantize_activations_per_token)
        y = (acc.float() * xs * s8[:, 0].float()).to(x.dtype)
    elif s8 is not None and joins_reduce:  # each column scaled before the reduce, which the partial joins
        y = row_product(row_tp, x, lambda x: F.linear(x, lp[name].to(x.dtype)) * s8[:, 0].to(x.dtype) + lora(x))[0]
    elif s8 is not None:
        product = int8_gemv if _int8_gemv_route(x) else int8_gemv_plain
        if row_tp is None:
            y = product(x, lp[name], s8[:, 0])
        else:  # the rounded partials meet in x's dtype, then each column is scaled
            y = row_tp.row_product(x, lambda x: product(x, lp[name]))[0] * s8[:, 0].to(x.dtype)
    elif joins_reduce:
        y = row_product(row_tp, x, lambda x: F.linear(x, lp[name]) + lora(x))[0]
    else:
        y = row_product(row_tp, x, lambda x: F.linear(x, lp[name]))[0]
    if lora is not None and not joins_reduce:
        y = y + lora(x)
    return y


def _int8_gemv_route(x: torch.Tensor) -> bool:
    """Whether a product of x [..., K] over int8 codes runs `int8_gemv`:
    bf16 x (the kernel's type) of at most INT8_GEMV_M rows, K % 16 == 0, and
    no gradient wanted (training over an int8 base keeps the cast, whose
    backward autograd knows). Counts each decision as `proj:int8_gemv` or
    `proj:int8_cast` (under a CUDA graph: once, at capture)."""
    take = (x.dtype == torch.bfloat16 and x.numel() <= INT8_GEMV_M * x.shape[-1] and x.shape[-1] % 16 == 0
            and not (torch.is_grad_enabled() and x.requires_grad))
    profiling.count("proj:int8_gemv" if take else "proj:int8_cast")
    return take


def _lora_update(lp: Params, name: str, tp, column_block: bool, row_block: bool):
    """x -> (x A^T) B^T of the projection's adapters (None without), cast to
    x's dtype. On a tensor-parallel rank the adapters (replicated leaves)
    are used by block: a column block takes B's rows of its output columns,
    a row block A's columns of its input rows (its partial then joins the
    base product's before the reduce). Each rank's adapter gradients are
    then its share, which the trainer sums over the tensor axis."""
    a = lp.get(name + "_lora_a")
    if a is None:
        return None
    b = lp[name + "_lora_b"]
    if column_block:
        b = tp.block(b, 0)
    if row_block:
        a = tp.block(a, 1)
    return lambda x: F.linear(F.linear(x, a.to(x.dtype)), b.to(x.dtype))


def _int8_product(q: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """int8 q [M, K] times int8 w [N, K] transposed -> the exact int32 [M, N]
    (`torch._int_mm`: cuBLAS's int8 GEMM on the card, exact on the CPU too;
    the JAX package runs a plain XLA dot here, no Pallas kernel). The card's
    GEMM wants more than 16 rows, so a shorter q is padded with zero rows and
    the padding's rows dropped."""
    m = q.shape[0]
    if q.is_cuda and m <= 16:
        q = torch.cat([q, q.new_zeros((32 - m, q.shape[1]))])
    return torch._int_mm(q.contiguous(), w.t())[:m]


def _row_proj(x: torch.Tensor, lp: Params, name: str, cfg: LLMConfig, x_split: bool) -> torch.Tensor:
    """A row-parallel product (wo, w_down) under tensor parallelism: a split
    leaf takes this rank's block of x (x's own block when the column
    products before it were split, else a slice) and sums the partials; a
    replicated leaf (an int4 leaf that cannot be row-split) takes the whole x,
    gathered from the column blocks when they were split."""
    tp = tensor_parallel(cfg)
    if tp is None:
        return proj(x, lp, name, cfg)
    w_split = tp.split.get(name, False)
    if w_split and not x_split:
        x = tp.block(x)
    elif x_split and not w_split:
        x = tp.gather(x)
    return proj(x, lp, name, cfg, row_tp=tp if w_split else None)


def _ring_or_flash(cfg: LLMConfig, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lengths: torch.Tensor,
                   attention: str) -> torch.Tensor:
    """`attention` "ring" / "ring:<axis>" (fsdp by default) over a chunk
    without a cache, as the JAX `full_attention(impl="ring")`: ring attention
    (ops/ring_attention.py) over the axis of the config's training mesh when
    it has more than one rank, all per-example lengths implied by causality;
    otherwise the default attention, the flash kernel with `lengths` (the
    JAX package falls back to its XLA path there). A sliding window, or a
    chunk that does not split over the axis, raises, as in the JAX package;
    so does a ring over a `tensor` axis that splits the heads."""
    from bridgelang_tpu_torch.ops.ring_attention import ring_attention_sharded

    axis = attention.split(":", 1)[1] if ":" in attention else "fsdp"
    mesh = getattr(cfg, "mesh", None)
    if mesh is None or axis not in mesh.mesh_dim_names or mesh.size(mesh.mesh_dim_names.index(axis)) <= 1:
        return flash_attention(q, k, v, lengths=lengths, causal=True, window=cfg.sliding_window)[0]
    if cfg.sliding_window is not None:
        raise ValueError("ring attention does not support sliding windows")
    tp = tensor_parallel(cfg)
    if axis == "tensor" and tp is not None and tp.heads_split():
        raise ValueError("ring attention over the tensor axis, whose ranks hold different heads: ring over fsdp")
    return ring_attention_sharded(q, k, v, mesh, axis, causal=True)


def _block(
    cfg: LLMConfig,
    lp: Params,
    x: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    mask: torch.Tensor,
    kv: Optional[Tuple[torch.Tensor, ...]],
    cache_positions: Optional[torch.Tensor],
    lengths: Optional[torch.Tensor],
    attention: str = "flash",
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """One decoder block over a T-token chunk. With `kv` (one layer's cache
    views: (k, v), or (k, v, k_scale, v_scale) for the int8 cache), K/V are
    written IN PLACE at `cache_positions` [B, T] (int8: quantized) and
    attention runs over the whole (dequantized) cache under `mask`; without,
    attention runs over the chunk itself: through the flash kernel with
    `lengths` valid keys (`attention="flash"`), under `mask` ("masked",
    `full_attention`; "einsum", `cached_attention`), or as ring attention
    ("ring", `_ring_or_flash`). Returns (x, the chunk's unquantized (k, v)).

    Under tensor parallelism (a TensorParallelLLMConfig) the layer's leaves
    are this rank's blocks: the column products give this rank's heads (and
    MLP columns), attention runs on them, and the row products sum over the
    group (`_row_proj`)."""
    B, T, _ = x.shape
    hd = cfg.head_dim
    phi = cfg.arch == "phi"
    tp = tensor_parallel(cfg)
    heads_split = tp is not None and tp.split.get("wq", False)

    if phi:
        h_in = layer_norm(x, lp["attn_norm"], lp["attn_norm_bias"], cfg.norm_eps)
    else:
        h_in = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    h_cols = tp.copy(h_in) if heads_split else h_in
    q, k, v = (proj(h_cols, lp, name, cfg) for name in ("wq", "wk", "wv"))
    if cfg.use_bias:
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    q = apply_rope(q.view(B, T, -1, hd), cos, sin, cfg.rotary_dim)
    k = apply_rope(k.view(B, T, -1, hd), cos, sin, cfg.rotary_dim)
    v = v.view(B, T, -1, hd)

    if kv is None and attention == "masked":
        attn_out = full_attention(q, k, v, mask)
    elif kv is None and attention == "einsum":
        attn_out = cached_attention(q, k, v, mask)
    elif kv is None and attention != "flash":
        attn_out = _ring_or_flash(cfg, q, k, v, lengths, attention)
    elif kv is None:
        attn_out, _ = flash_attention(q, k, v, lengths=lengths, causal=True, window=cfg.sliding_window)
    else:
        rows = torch.arange(B, device=x.device)[:, None]
        if len(kv) == 4:  # int8 cache: codes and per-(token, head) scales
            cache_k, cache_v, k_scale, v_scale = kv
            for codes, scales, new in ((cache_k, k_scale, k), (cache_v, v_scale, v)):
                qn, sn = _quantize_kv(new)
                codes[rows, cache_positions] = qn
                scales[rows, cache_positions] = sn
            attn_k = _dequantize_kv(cache_k, k_scale, q.dtype)
            attn_v = _dequantize_kv(cache_v, v_scale, q.dtype)
        else:
            cache_k, cache_v = kv
            cache_k[rows, cache_positions] = k.to(cache_k.dtype)
            cache_v[rows, cache_positions] = v.to(cache_v.dtype)
            attn_k, attn_v = cache_k.to(q.dtype), cache_v.to(q.dtype)
        attn_out = cached_attention(q, attn_k, attn_v, mask)

    attn_out = _row_proj(attn_out.reshape(B, T, -1), lp, "wo", cfg, heads_split)
    if cfg.use_bias:
        attn_out = attn_out + lp["bo"]  # replicated: added once, after the reduction
    mlp_split = tp is not None and tp.split.get("w_up", False)
    if phi:  # the parallel residual: x + attn(ln x) + mlp(ln x)
        h_mlp = h_cols if mlp_split == heads_split else (tp.copy(h_in) if mlp_split else h_in)
        up = F.gelu(proj(h_mlp, lp, "w_up", cfg) + lp["b_up"], approximate="tanh")
        mlp_out = _row_proj(up, lp, "w_down", cfg, mlp_split) + lp["b_down"]
        return x + attn_out + mlp_out, (k, v)
    x = x + attn_out
    h2 = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    if mlp_split:
        h2 = tp.copy(h2)
    mlp_out = _row_proj(F.silu(proj(h2, lp, "w_gate", cfg)) * proj(h2, lp, "w_up", cfg), lp, "w_down", cfg,
                        mlp_split)
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
    remat: bool = False,
    remat_policy: Optional[str] = None,
    attention: str = "flash",
) -> Tuple[torch.Tensor, Optional[Params]]:
    """Run the decoder stack over input embeddings.

    embeds [B, T, D]; positions [B, T] RoPE positions; mask [B, 1, T, S]
    bool (S = T, or the cache length); cache from `init_kv_cache`;
    cache_positions [B, T] write slots (scatter mode).

    cache_write="scatter" writes K/V at `cache_positions` and attends over the
    whole cache under `mask` (decode steps). "contiguous" is the prefill: the
    chunk occupies slots 0..T-1 of every example, K/V are copied there, and
    attention runs over the chunk itself through the flash kernel. Without a
    cache, attention also runs over the chunk through the kernel. An int8
    cache (with `k_scale`) is written quantized in both modes; scatter mode
    attends over its dequantized codes, the prefill over its own K/V.
    Chunk attention needs `lengths` [B] (valid keys per example); when not
    given it is recovered from `mask`, which must then be causal +
    right-padding (+ window), the family the kernel computes. A chunk under
    any other mask (no cache only) passes `attention="masked"`: it then runs
    `full_attention` under `mask` and never reaches the kernel. "einsum" and
    "ring" (no cache only) are the JAX `attention_impl`s of those names.

    The cache is updated IN PLACE and returned (JAX returns a new one):
    this saves a copy of the whole cache per step. Returns (hidden [B, T, D],
    cache or None).

    `remat` (no cache only: the training forward) runs each layer under
    non-reentrant `torch.utils.checkpoint` with the `remat_policy` of
    `_remat_context`. The backward then runs each layer's forward again, so
    the flash forward launches twice per layer per training step.
    """
    if remat and cache is not None:
        raise ValueError("remat is for the training forward, which runs without a KV cache")
    if check_attention(attention) != "flash" and cache is not None:
        raise ValueError(f"attention={attention!r} is for a chunk without a cache; the cached paths take 'flash'")
    context_fn = _remat_context(remat_policy) if remat else None
    cos, sin = rope_cos_sin(positions, cfg.rotary_dim, cfg.rope_theta)
    contiguous = cache is not None and cache_write == "contiguous"
    chunk_attention = cache is None or contiguous
    if chunk_attention and lengths is None and attention not in ("masked", "einsum"):
        lengths = lengths_from_mask(mask)
    x = embeds
    T = x.shape[1]
    cache_keys = ("k", "v", "k_scale", "v_scale") if cache is not None and "k_scale" in cache else ("k", "v")
    for i, lp in enumerate(params["layers"]):
        if remat:
            x, _ = checkpoint(_block, cfg, lp, x, cos, sin, mask, None, None, lengths, attention,
                              use_reentrant=False, context_fn=context_fn)
        elif chunk_attention:
            x, (k, v) = _block(cfg, lp, x, cos, sin, mask, None, None, lengths, attention)
            if contiguous and len(cache_keys) == 4:  # attention ran over the unquantized chunk
                for name, new in (("k", k), ("v", v)):
                    codes, scales = _quantize_kv(new)
                    cache[name][i, :, :T] = codes
                    cache[name + "_scale"][i, :, :T] = scales
            elif contiguous:
                cache["k"][i, :, :T] = k.to(cache["k"].dtype)
                cache["v"][i, :, :T] = v.to(cache["v"].dtype)
        else:
            x, _ = _block(cfg, lp, x, cos, sin, mask, tuple(cache[key][i] for key in cache_keys), cache_positions, None)
    if cfg.arch == "phi":
        return layer_norm(x, params["final_norm"], params["final_norm_bias"], cfg.norm_eps), cache
    return rms_norm(x, params["final_norm"], cfg.norm_eps), cache


def embed_tokens(params: Params, input_ids: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Token embeddings; an int8 table ([V, D] with `embed_scale` [V, 1])
    gathers codes and scales and multiplies them in `dtype` (bf16 when not
    given), as the JAX package."""
    table = params["embed"]
    ids = input_ids.long()
    if table.dtype == torch.int8:
        dt = dtype or torch.bfloat16
        return table[ids].to(dt) * params["embed_scale"][ids].to(dt)
    emb = F.embedding(ids, table)
    return emb.to(dtype) if dtype is not None else emb


def lm_logits(params: Params, hidden: torch.Tensor, cfg: LLMConfig) -> torch.Tensor:
    """Logits over the PADDED vocabulary (argmax runs over all of it). An
    int8 head ([V, D] with `lm_head_scale` [V, 1]) runs in the hidden dtype
    and scales each vocabulary column after the product, as the JAX package
    (through `int8_gemv` where `_int8_gemv_route` takes it);
    a Phi head adds `lm_head_bias` after both. A vocab-split head (tensor
    parallelism) computes this rank's block of the vocabulary and gathers the
    blocks in order, so an argmax over the result breaks ties at the lowest
    global index, as on one device."""
    head = params["lm_head"]
    tp = tensor_parallel(cfg)
    vocab_split = tp is not None and tp.split.get("lm_head", False)
    if vocab_split:
        hidden = tp.copy(hidden)  # training: the hidden state's gradient sums the vocab blocks'
    if head.dtype == torch.int8:
        scale = params["lm_head_scale"]
        if scale.shape[0] != head.shape[0]:  # a whole per-row scale beside a vocab block
            scale = tp.block(scale, 0)
        logits = (int8_gemv if _int8_gemv_route(hidden) else int8_gemv_plain)(hidden, head, scale[:, 0])
    else:
        logits = F.linear(hidden, head)
    if cfg.arch == "phi":
        logits = logits + params["lm_head_bias"]
    if vocab_split:
        logits = tp.gather(logits, dim=-1)
    return logits
