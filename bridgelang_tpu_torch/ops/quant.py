"""Weight quantization: int8 and packed-int4 decoder layers, int8 embedding and head.

Counterpart of bridgelang_tpu/ops/quant.py. The bytes at the public
functions are the JAX package's; the leaves that change orientation are
transposed, nothing else:

* an int8 decoder leaf `<proj>` takes the port's [out, in] orientation,
  with `<proj>_scale` [out, 1] bf16 (per output column): the JAX [in, out]
  leaf and its [1, out] scale, transposed, like every dense weight of the
  port;
* a packed int4 leaf `<proj>` is [K, N/2] int8 in the `out-paired-lobias/v2`
  layout (byte [r, c] holds code[r, c] + 8 in the low nibble and
  code[r, N/2 + c], signed, in the high nibble), and its `<proj>_scale4` is
  [K/group, N] bf16. Neither is transposed into nn.Linear's [out, in]: a
  JAX-packed tensor and the port's are the same bytes, and
  `INT4_PACK_LAYOUT` keeps meaning what it says;
* the int8 `embed` is [V, D] with `embed_scale` [V, 1] (per token row), as in
  the JAX package (not transposed);
* the int8 `lm_head` takes the port's [V, D] orientation, with
  `lm_head_scale` [V, 1] (per vocabulary entry): the JAX [D, V] leaf and its
  [1, V] scale, transposed.

Dense layers stay in the port's [out, in] layout; `quantize_llm_int8` and
`quantize_llm_int4` read them one layer at a time and `dequantize_llm_int8`
returns them so.

Weight scales follow the JAX package's arithmetic. Where it quantizes under
`jax.jit` (the decoder layers, int8 and int4, and the random inits), XLA
turns `absmax / 127` (or `/ 7`) into a multiplication by the fp32
reciprocal, and so does the port on either device (`by_reciprocal`); an
int4 pack from an int8 source hits exact rounding ties, where the two
differ. Where it runs op by op (the embedding and the head of a float tree)
the port divides by the Python number, a true division on the CPU (CUDA
torch multiplies by the reciprocal there).

`pack_layout_tag` has no caller in the port yet: the tag is what a
torch-format training checkpoint will record (the JAX trainer's
`int4_pack_layout`).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch

Params = Dict[str, Any]

QUANT_TARGETS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
INT4_GROUP = 128
# The byte layout of pack_int4 (the JAX package's tag, quant.py:212).
INT4_PACK_LAYOUT = "out-paired-lobias/v2"
# Column-parallel leaves: with n_shards > 1 their pairing is shard-blocked.
INT4_COLUMN_PARALLEL = ("wq", "wk", "wv", "w_gate", "w_up")


def quantize_activations_per_token(x: torch.Tensor, absmax: Optional[torch.Tensor] = None
                                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token symmetric absmax/127 int8 quantization -> (q int8 [..., K],
    scale f32 [..., 1]); dequant is `acc * scale`. torch.round and jnp.round
    both round half to even, so the codes equal the JAX package's. The 127
    is a tensor, not a Python number: CUDA torch turns a division by a CPU
    scalar into a multiplication by its reciprocal, which rounds differently
    for some absmax; a tensor divisor is one IEEE division on either device
    (as the card's quantize_a8 kernel and the CPU compute it). `absmax`
    [..., 1] fp32, when given, replaces x's own: a row-parallel product
    quantizes its K shard with the whole row's absmax (the maximum over the
    tensor group), so its codes are the unsharded ones."""
    xf = x.float()
    if absmax is None:
        absmax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(absmax == 0, torch.ones_like(absmax), absmax / torch.full_like(absmax, 127.0))
    return torch.round(xf / scale).to(torch.int8), scale


def _absmax_scale(absmax: torch.Tensor, top: float, by_reciprocal: bool) -> torch.Tensor:
    """absmax / top, 1 where absmax is 0. `by_reciprocal`: absmax times
    fp32(1 / top), as XLA compiles the division under jit, on either device."""
    scaled = absmax * torch.full_like(absmax, 1.0 / top) if by_reciprocal else absmax / top
    return torch.where(absmax == 0, torch.ones_like(absmax), scaled)


def _quantize_2d(w32: torch.Tensor, dim: int, by_reciprocal: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 over `dim`-reduced absmax -> (codes int8, scale bf16)."""
    absmax = w32.abs().amax(dim=dim, keepdim=True)
    scale = _absmax_scale(absmax, 127.0, by_reciprocal)
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.bfloat16)


def _quantize_tensor(w: torch.Tensor, dim: int, by_reciprocal: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    return _quantize_2d(w.float(), dim, by_reciprocal)


def quantize_layer_int8(lp: Params, targets: Sequence[str] = QUANT_TARGETS) -> Params:
    """One decoder layer (or any part of one) with its float projections in
    `targets` quantized to int8 per output column: each [out, in] weight
    becomes int8 codes [out, in] and a bf16 `<name>_scale` [out, 1]."""
    lp = dict(lp)
    for name in targets:
        if name in lp and lp[name].dtype != torch.int8:
            lp[name], lp[name + "_scale"] = _quantize_tensor(lp[name].detach(), dim=1, by_reciprocal=True)
    return lp


def quantize_rows_int8(table: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The embedding [V, D] or LM head [V, D] to int8 per row -> (codes,
    bf16 scale [V, 1])."""
    return _quantize_tensor(table.detach(), dim=1)


def refuse_experts(llm_params: Params, kind: str) -> None:
    """Raise for a decoder with routed experts (DeepSeek-V2): their leaves
    have no quantized path yet."""
    if any("we_gate" in lp for lp in llm_params["layers"]):
        raise ValueError(f"{kind} quantization of a decoder with routed experts (DeepSeek-V2) is not supported "
                         "yet: serve it in bf16 (deploy --quantize_int8 false --quantize_int4 false)")


def quantize_llm_int8(
    llm_params: Params,
    targets: Sequence[str] = QUANT_TARGETS,
    quantize_embed: bool = True,
    quantize_head: bool = True,
) -> Params:
    """Quantize the decoder's projections to int8 per output column (one
    matrix of one layer at a time, `quantize_layer_int8`), and optionally the
    embedding (per token row) and the LM head (per vocabulary entry). The
    returned dict shares every other tensor with `llm_params`: a target the
    tree lacks is skipped (a Phi layer has no `w_gate`) and biases stay
    float, as in the JAX package. Expert leaves are refused."""
    refuse_experts(llm_params, "int8")
    out = dict(llm_params, layers=[quantize_layer_int8(lp, targets) for lp in llm_params["layers"]])
    if quantize_embed and out["embed"].dtype != torch.int8:
        out["embed"], out["embed_scale"] = quantize_rows_int8(out["embed"])  # [V, D], [V, 1]
    if quantize_head and out["lm_head"].dtype != torch.int8:
        out["lm_head"], out["lm_head_scale"] = quantize_rows_int8(out["lm_head"])  # [V, D], [V, 1]
    return out


def init_llm_params_int8(generator: torch.Generator, cfg, device: Optional[torch.device] = None) -> Params:
    """Random int8 decoder drawn one matrix of one layer at a time on
    `device` from `generator` (bf16 normal * fan_in^-0.5, then quantized), so
    no float copy of the model exists; embedding normal * 0.02, head normal *
    D^-0.5, norms one. The JAX package's scales; not its numbers (another
    generator)."""
    D, I, V = cfg.dim, cfg.intermediate_size, cfg.padded_vocab_size
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if cfg.arch != "llama":
        raise NotImplementedError("int8 init targets the Llama family")
    shapes = {"wq": (H * hd, D), "wk": (Hkv * hd, D), "wv": (Hkv * hd, D), "wo": (D, H * hd),
              "w_gate": (I, D), "w_up": (I, D), "w_down": (D, I)}

    def normal(shape, std: float) -> torch.Tensor:
        w = torch.randn(shape, generator=generator, device=device, dtype=torch.bfloat16)
        return w * torch.tensor(std, dtype=torch.bfloat16, device=device)

    layers = []
    for _ in range(cfg.n_layers):
        lp: Params = {"attn_norm": torch.ones(D, dtype=torch.bfloat16, device=device),
                      "mlp_norm": torch.ones(D, dtype=torch.bfloat16, device=device)}
        for name, (n, k) in shapes.items():
            lp[name], lp[name + "_scale"] = _quantize_tensor(normal((n, k), k ** -0.5), dim=1, by_reciprocal=True)
        layers.append(lp)
    embed_q, embed_s = _quantize_tensor(normal((V, D), 0.02), dim=1, by_reciprocal=True)
    head_q, head_s = _quantize_tensor(normal((V, D), D ** -0.5), dim=1, by_reciprocal=True)
    return {"embed": embed_q, "embed_scale": embed_s, "layers": layers,
            "final_norm": torch.ones(D, dtype=torch.bfloat16, device=device),
            "lm_head": head_q, "lm_head_scale": head_s}


def dequantize_layer(lp: Params, dtype: torch.dtype = torch.bfloat16, int4_shards: int = 1) -> Params:
    """One decoder layer (or any part of one) with float weights back from
    its quantized projections, the scale leaves dropped: int8 (codes * scale
    in fp32, then `dtype`) and packed int4, in the port's [out, in] layout.
    `int4_shards` must equal the pack-time n_shards."""
    lp = dict(lp)
    for name in [k for k in lp if k + "_scale4" in lp]:
        shards = int4_shards if name in INT4_COLUMN_PARALLEL else 1
        lp[name] = dequant_int4(lp[name], lp.pop(name + "_scale4"), dtype, n_shards=shards).t().contiguous()
    for name in [k for k in lp if k + "_scale" in lp]:
        lp[name] = (lp[name].float() * lp.pop(name + "_scale").float()).to(dtype)
    return lp


def dequantize_rows(codes: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """An int8 embedding or head [V, D] with its [V, 1] scale -> `dtype`."""
    return (codes.float() * scale.float()).to(dtype)


def dequantize_llm_int8(llm_params: Params, dtype: torch.dtype = torch.bfloat16, int4_shards: int = 1) -> Params:
    """Float weights back from a quantized decoder (`dequantize_layer` on
    every layer), the int8 embedding and head as [V, D]."""
    out = dict(llm_params, layers=[dequantize_layer(lp, dtype, int4_shards) for lp in llm_params["layers"]])
    for name in ("embed", "lm_head"):
        if out[name].dtype == torch.int8:
            out[name] = dequantize_rows(out[name], out.pop(name + "_scale"), dtype)
    return out


dequantize_llm_int4 = dequantize_llm_int8  # the JAX package's alias: one function dequantizes both


def quantized_bytes(params) -> int:
    """Bytes of every tensor in a (nested dict / list) parameter tree."""
    if isinstance(params, dict):
        return sum(quantized_bytes(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(quantized_bytes(v) for v in params)
    return params.numel() * params.element_size()


def pack_layout_tag(n_shards: int = 1) -> str:
    """The layout string an artifact records; the shard count is part of it."""
    n = int(n_shards or 1)
    return INT4_PACK_LAYOUT if n <= 1 else f"{INT4_PACK_LAYOUT}+shardblocked-{n}"


def pack_int4(codes: torch.Tensor, n_shards: int = 1) -> torch.Tensor:
    """[..., in, out] int8 codes in [-8, 7] -> [..., in, out/2] packed int8.
    With `n_shards` > 1 the pairing runs inside each of `n_shards`
    contiguous column blocks."""
    *lead, n_in, n = codes.shape
    blocks = codes.reshape(*lead, n_in, n_shards, n // n_shards)
    half = blocks.shape[-1] // 2
    lo = (blocks[..., :half].to(torch.int8) + 8) & 0x0F
    hi = blocks[..., half:].to(torch.int8) << 4
    return (hi | lo).to(torch.int8).reshape(*lead, n_in, n // 2)


def unpack_int4(packed: torch.Tensor, n_shards: int = 1) -> torch.Tensor:
    """Inverse of pack_int4: [..., in, out/2] -> [..., in, out] int8 codes.
    The low nibble un-biases (-8); the high nibble sign-extends."""
    *lead, n_in, n2 = packed.shape
    blocks = packed.reshape(*lead, n_in, n_shards, n2 // n_shards)
    lo = (blocks & 0x0F) - 8
    hi = blocks >> 4
    return torch.cat([lo, hi], dim=-1).to(torch.int8).reshape(*lead, n_in, 2 * n2)


def dequant_int4(packed: torch.Tensor, scale4: torch.Tensor, dtype: torch.dtype = torch.bfloat16,
                 n_shards: int = 1) -> torch.Tensor:
    """[..., in, out/2] packed + [..., in/group, out] scales -> [..., in, out]
    in `dtype` (codes and scales cast to `dtype`, then multiplied, as the JAX
    package). Scales are in global column order whatever `n_shards` is."""
    codes = unpack_int4(packed, n_shards=n_shards)
    n_in, out = codes.shape[-2], codes.shape[-1]
    n_groups = scale4.shape[-2]
    grouped = codes.reshape(*codes.shape[:-2], n_groups, n_in // n_groups, out).to(dtype)
    return (grouped * scale4[..., :, None, :].to(dtype)).reshape(codes.shape)


def _quantize4_2d(w32: torch.Tensor, group: int, n_shards: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """[in, out] fp32 -> (packed [in, out/2] int8, scales [in/group, out]
    bf16): per-(group, column) absmax/7, codes clipped to [-7, 7]."""
    n_in, out = w32.shape
    group = min(group, n_in)  # tiny test dims: one group per matrix
    if n_in % group or out % (2 * n_shards):
        raise ValueError(f"cannot pack [{n_in}, {out}] with group {group} and {n_shards} shard(s)")
    grouped = w32.reshape(n_in // group, group, out)
    absmax = grouped.abs().amax(dim=1, keepdim=True)
    scale = _absmax_scale(absmax, 7.0, by_reciprocal=True)  # as the card computed `/ 7.0` already
    codes = torch.clamp(torch.round(grouped / scale), -7, 7).to(torch.int8).reshape(n_in, out)
    # contiguous whatever the source's strides (a transposed [out, in] weight): the kernels read rows
    return pack_int4(codes, n_shards=n_shards).contiguous(), scale[:, 0, :].to(torch.bfloat16).contiguous()


def quantize_layer_int4(lp: Params, targets: Sequence[str] = QUANT_TARGETS, group: int = INT4_GROUP,
                        n_shards: int = 1) -> Params:
    """One decoder layer (or any part of one) with its projections in
    `targets` packed to int4: each float [out, in] weight is read, transposed
    to [in, out] in fp32, packed, and the float leaf dropped from the
    returned dict, so the transient is one fp32 matrix. Column-parallel
    leaves get shard-blocked pairing when `n_shards` > 1. An int8 leaf (with
    `<name>_scale`) is packed from codes * scale in fp32, and its scale leaf
    dropped (the JAX int8-source branch); a leaf that is already packed
    raises."""
    lp = dict(lp)
    for name in targets:
        if name not in lp:
            continue
        w = lp[name].detach()
        if w.dtype == torch.int8:
            if name + "_scale" not in lp:
                raise ValueError(f"{name} is int8 without `{name}_scale`: already packed to int4")
            w32 = w.float() * lp.pop(name + "_scale").float()
        else:
            w32 = w.float()
        shards = n_shards if name in INT4_COLUMN_PARALLEL else 1
        lp[name], lp[name + "_scale4"] = _quantize4_2d(w32.t(), group, n_shards=shards)
    return lp


def quantize_llm_int4(
    llm_params: Params,
    targets: Sequence[str] = QUANT_TARGETS,
    group: int = INT4_GROUP,
    n_shards: int = 1,
) -> Params:
    """Quantize the decoder's projections to packed int4 with per-(input
    group, output column) scales, one matrix of one layer at a time
    (`quantize_layer_int4`); the embedding and the LM head become int8. The
    returned dict shares every other tensor with `llm_params`; drop
    `llm_params` to free the float weights. Expert leaves are refused."""
    refuse_experts(llm_params, "int4")
    out = dict(llm_params, layers=[quantize_layer_int4(lp, targets, group, n_shards) for lp in llm_params["layers"]])
    if out["embed"].dtype != torch.int8:
        out["embed"], out["embed_scale"] = quantize_rows_int8(out["embed"])  # [V, D], [V, 1]
    if out["lm_head"].dtype != torch.int8:
        out["lm_head"], out["lm_head_scale"] = quantize_rows_int8(out["lm_head"])  # [V, D], [V, 1]
    return out


def init_llm_params_int4(generator: torch.Generator, cfg, group: int = INT4_GROUP,
                         device: Optional[torch.device] = None) -> Params:
    """Random int4 decoder drawn one matrix of one layer at a time on
    `device` from `generator` (normal * fan_in^-0.5 in fp32, then packed), so
    no float copy of the model exists; int8 embedding (normal * 0.02) and
    head (normal * D^-0.5), norms one. The JAX package's scales; not its
    numbers (another generator)."""
    D, I, V = cfg.dim, cfg.intermediate_size, cfg.padded_vocab_size
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if cfg.arch != "llama":
        raise NotImplementedError("int4 init targets the Llama family")
    shapes = {"wq": (D, H * hd), "wk": (D, Hkv * hd), "wv": (D, Hkv * hd), "wo": (H * hd, D),
              "w_gate": (D, I), "w_up": (D, I), "w_down": (I, D)}
    layers = []
    for _ in range(cfg.n_layers):
        lp: Params = {"attn_norm": torch.ones(D, dtype=torch.bfloat16, device=device),
                      "mlp_norm": torch.ones(D, dtype=torch.bfloat16, device=device)}
        for name, (k, n) in shapes.items():
            w = torch.randn((k, n), generator=generator, device=device).mul_(k ** -0.5)
            lp[name], lp[name + "_scale4"] = _quantize4_2d(w, group)
        layers.append(lp)
    embed = torch.randn((V, D), generator=generator, device=device, dtype=torch.bfloat16) * 0.02
    head = torch.randn((V, D), generator=generator, device=device, dtype=torch.bfloat16) * D ** -0.5
    embed_q, embed_s = _quantize_tensor(embed, dim=1, by_reciprocal=True)
    head_q, head_s = _quantize_tensor(head, dim=1, by_reciprocal=True)
    return {"embed": embed_q, "embed_scale": embed_s, "layers": layers,
            "final_norm": torch.ones(D, dtype=torch.bfloat16, device=device),
            "lm_head": head_q, "lm_head_scale": head_s}
