"""LoRA fine-tuning: low-rank adapters as extra per-layer tensors.

Counterpart of bridgelang_tpu/training/lora.py. Adapters live inside each
decoder layer's dict as `<proj>_lora_a` [r, in] and `<proj>_lora_b`
[out, r] (the JAX [in, r] / [r, out] leaves transposed into nn.Linear's
layout), so `llama.proj` picks them up, freezing is a mask that selects
`*_lora_*` tensors, and merge-and-unload is W += B A. The alpha/r scale is
folded into A at init (B starts at zero, so this is exact). Over a packed
int4 base (QLoRA) the adapters are full-width: A [r, in], B [out, r] with
out twice the packed width.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import torch

from bridgelang_tpu_torch.ops.quant import INT4_COLUMN_PARALLEL, _quantize4_2d, _quantize_tensor, dequant_int4

Params = Dict[str, Any]

ALL_LINEAR = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def add_lora_params(
    generator: torch.Generator,
    llm_params: Params,
    rank: int = 32,
    alpha: float = 32.0,
    targets: Sequence[str] = ALL_LINEAR,
    dtype: torch.dtype = torch.float32,
) -> Params:
    """A copy of `llm_params` (sharing the base tensors) with adapters added
    to each layer: A ~ N(0, 1/r) * alpha/r drawn from `generator` on its
    device, B = 0, so the model starts unchanged."""
    device = generator.device
    scale = alpha / rank
    layers = []
    for lp in llm_params["layers"]:
        lp = dict(lp)
        for t in targets:
            if t not in lp:
                continue
            if t + "_scale4" in lp:  # packed int4 [in, out/2]: the out-paired nibbles halve the stored width
                d_in, d_out = lp[t].shape[0], 2 * lp[t].shape[1]
            else:
                d_out, d_in = lp[t].shape
            a = torch.randn((rank, d_in), generator=generator, device=device, dtype=dtype).mul_(rank ** -0.5)
            lp[t + "_lora_a"] = a.mul_(scale) if scale != 1.0 else a
            lp[t + "_lora_b"] = torch.zeros((d_out, rank), device=device, dtype=dtype)
        layers.append(lp)
    return dict(llm_params, layers=layers)


def merge_lora(llm_params: Params, int4_shards: int = 1) -> Params:
    """Fold adapters into the base weights and drop them. Float bases:
    W + B A in fp32, cast back to W's dtype. Packed int4 bases (a QLoRA
    run): per layer, dequantize to fp32 [in, out], add (B A)^T, and
    requantize with the group read off the scales' shape (JAX lora.py:86-93).
    int8 bases (a QLoRA run with 8 bits): dequantize with the sibling
    `<name>_scale` [out, 1], add B A, and requantize per output column
    (JAX lora.py:94-97, there over [in, out]); the scale divides by 127 as a
    multiplication by its fp32 reciprocal, as XLA compiles the JAX merge's
    `lax.map`, so the codes equal the JAX package's. `int4_shards` must
    equal the base's pack-time n_shards."""
    layers = []
    for lp in llm_params["layers"]:
        merged = {k: v for k, v in lp.items() if "_lora_" not in k}
        for name in [k for k in merged if not k.endswith(("_scale", "_scale4"))]:
            a, b = lp.get(name + "_lora_a"), lp.get(name + "_lora_b")
            if a is None or b is None:
                continue
            w = merged[name]
            delta = b.detach().float() @ a.detach().float()  # [out, in]
            s4 = merged.get(name + "_scale4")
            if s4 is not None:
                shards = int4_shards if name in INT4_COLUMN_PARALLEL else 1
                w32 = dequant_int4(w, s4, dtype=torch.float32, n_shards=shards)  # [in, out]
                group = w32.shape[0] // s4.shape[0]
                merged[name], merged[name + "_scale4"] = _quantize4_2d(w32 + delta.t(), group, n_shards=shards)
            elif w.dtype == torch.int8:
                w32 = w.float() * merged[name + "_scale"].float()
                merged[name], merged[name + "_scale"] = _quantize_tensor(w32 + delta, dim=1, by_reciprocal=True)
            else:
                merged[name] = (w.detach().float() + delta).to(w.dtype)
        layers.append(merged)
    return dict(llm_params, layers=layers)


def lora_trainable_mask(params: Params) -> Params:
    """Bools in the structure of `params`: True only on `*_lora_*` tensors."""

    def mark(tree, lora: bool):
        if isinstance(tree, dict):
            return {k: mark(v, lora or "_lora_" in k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [mark(v, lora) for v in tree]
        return lora

    return mark(params, False)


def split_lora(llm_params: Params) -> Tuple[Params, Params]:
    """(base, adapters): adapters as {"layers": [per-layer dicts]}, to save
    on their own like a PEFT adapter directory."""
    base = [{k: v for k, v in lp.items() if "_lora_" not in k} for lp in llm_params["layers"]]
    adapters = [{k: v for k, v in lp.items() if "_lora_" in k} for lp in llm_params["layers"]]
    return dict(llm_params, layers=base), {"layers": adapters}
