"""Seeded random weights of a Prismatic VLA on the DeepSeek-V2 decoder, in
the port's parameter layout (models/llm/deepseek_v2.py's leaf names).

Drawn as weights.py draws the other configurations' (its groups, seeds and
scales): the towers (groups 0 and 1) and the projector (group 2) by
weights.py itself; the decoder (group 3) as one `torch.randn` for its
matrices and one for its norms, in the served type on the device, each
leaf a view of the draw scaled in place. A matrix [.., out, in] (an
expert slab [E, out, in] too) takes normal * in^-0.5, the embedding normal
* 0.02, a norm 1 + 0.02 normal. Layer i's leaves, in draw order:

    attn_norm, wq, wkv_a, kv_norm, wkv_b, wo, mlp_norm, then
    i < first_k_dense_replace: w_gate, w_up, w_down (the dense SwiGLU);
    otherwise router, we_gate, we_up, we_down, w_gate, w_up, w_down (the
    routed experts, then the shared experts as one SwiGLU)

This module imports torch and weights.py only.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

import weights
from weights import Spec

_MATRIX_KINDS = ("dense", "embed")


def decoder_layer_specs(llm: Dict, i: int) -> List[Spec]:
    """Layer i's leaves (module docstring)."""
    d, h, r = llm["dim"], llm["n_heads"], llm["kv_lora_rank"]
    n, p, dv = llm["qk_nope_head_dim"], llm["qk_rope_head_dim"], llm["v_head_dim"]
    e, ie = llm["n_routed_experts"], llm["moe_intermediate_size"]
    specs: List[Spec] = [("attn_norm", (d,), "norm"), ("wq", (h * (n + p), d), "dense"),
                         ("wkv_a", (r + p, d), "dense"), ("kv_norm", (r,), "norm"),
                         ("wkv_b", (h * (n + dv), r), "dense"), ("wo", (d, h * dv), "dense"),
                         ("mlp_norm", (d,), "norm")]
    if i < llm["first_k_dense_replace"]:
        width = llm["intermediate_size"]
    else:
        width = llm["n_shared_experts"] * ie
        specs += [("router", (e, d), "dense"), ("we_gate", (e, ie, d), "dense"), ("we_up", (e, ie, d), "dense"),
                  ("we_down", (e, d, ie), "dense")]
    return specs + [("w_gate", (width, d), "dense"), ("w_up", (width, d), "dense"), ("w_down", (d, width), "dense")]


def _draw(specs: List[Spec], seed: int, group: int, dtype: torch.dtype, device) -> Dict[str, torch.Tensor]:
    """weights._draw with a matrix's fan-in its last dim (an expert slab's
    too); the same for the 2-D matrices."""
    out: Dict[str, torch.Tensor] = {}
    for part, kinds in enumerate((_MATRIX_KINDS, ("norm", "bias", "layerscale"))):
        chosen = [s for s in specs if s[2] in kinds]
        if not chosen:
            continue
        total = sum(math.prod(shape) for _, shape, _ in chosen)
        gen = torch.Generator(device=device).manual_seed(weights.group_seed(seed, 2 * group + part))
        flat = torch.randn(total, generator=gen, dtype=dtype, device=device)
        at = 0
        for name, shape, kind in chosen:
            size = math.prod(shape)
            leaf = flat[at:at + size].view(shape)
            out[name] = leaf.mul_(shape[-1] ** -0.5) if kind == "dense" else weights._scale_(leaf, kind, shape)
            at += size
    return {name: out[name] for name, _, _ in specs}


def make_weights(cfg: Dict, seed: int, dtype: torch.dtype, device) -> Dict:
    """The whole VLA's parameters {"vision", "projector", "llm"} for the
    configuration file `cfg` (its "port" section), drawn from `seed`."""
    port = cfg["port"]
    towers, llm = port["towers"], port["llm"]
    vision: Dict[str, torch.Tensor] = {}
    prefixes = ("featurizer.", "fused_featurizer.") if len(towers) == 2 else ("",)
    for g, (prefix, t) in enumerate(zip(prefixes, towers)):
        vision.update({prefix + k: v for k, v in weights._draw(weights.tower_specs(t), seed, g, dtype, device).items()})
    projector = weights._draw(weights.projector_specs(sum(t["width"] for t in towers), llm["dim"]), seed, 2, dtype,
                              device)
    per_layer = [decoder_layer_specs(llm, i) for i in range(llm["n_layers"])]
    flat_specs = [(f"{i}.{name}", shape, kind) for i, specs in enumerate(per_layer) for name, shape, kind in specs]
    top = weights.decoder_top_specs(llm)
    drawn = _draw(flat_specs + top, seed, 3, dtype, device)
    layers = [{name: drawn[f"{i}.{name}"] for name, _, _ in specs} for i, specs in enumerate(per_layer)]
    return {"vision": vision, "projector": projector, "llm": dict({name: drawn[name] for name, _, _ in top},
                                                                  layers=layers)}

