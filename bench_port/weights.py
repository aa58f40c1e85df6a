"""Seeded random weights of a Prismatic VLA in the port's parameter layout.

The benchmark makes the weights and hands the same tensors to the program
and to the plain reference, which draws them again from the same seed after
the timed window. Each group of leaves (a tower, the projector, the
decoder's matrices, and each group's small leaves) is one `torch.randn`
call on the device from its own generator, in the type the weights are
served in; the leaves are views of that draw, scaled in place:

* matrices: normal * fan_in^-0.5 (the port's init); the token embedding and
  the position embeddings: normal * 0.02;
* norm weights 1 + 0.02 normal, biases, class and register tokens 0.02
  normal, LayerScale 0.1 + 0.02 normal: nonzero, so that the check covers
  every term of the arithmetic.

A group's matrices and its small leaves are separate draws, so that when
the program replaces the matrices (int8 quantization) the small leaves do
not keep the whole draw alive.

This module imports torch and numpy only: the reference uses it too.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

Spec = Tuple[str, Tuple[int, ...], str]  # (name, shape, init kind)


def group_seed(seed: int, group: int) -> int:
    """A generator seed for one group of leaves, independent of the others."""
    return int(np.random.SeedSequence([int(seed), group]).generate_state(1, dtype=np.uint64)[0] >> 1)


def tower_specs(t: Dict) -> List[Spec]:
    """The leaves of one ViT (models/vision/vit.py's names), depth - 1 blocks."""
    w, p, mlp = t["width"], t["patch_size"], t["mlp_dim"]
    patches = (t["image_size"] // p) ** 2
    cls = t.get("use_cls_token", True)
    n_pos = patches + (0 if t.get("no_embed_class", False) else (1 if cls else 0))
    specs: List[Spec] = [("patch_embed.weight", (w, 3, p, p), "dense"), ("patch_embed.bias", (w,), "bias"),
                         ("pos_embed", (1, n_pos, w), "embed")]
    if cls:
        specs.append(("cls_token", (1, 1, w), "bias"))
    if t.get("num_reg_tokens", 0):
        specs.append(("reg_tokens", (1, t["num_reg_tokens"], w), "bias"))
    if t.get("pre_norm", False):
        specs += [("norm_pre.weight", (w,), "norm"), ("norm_pre.bias", (w,), "bias")]
    for i in range(t["depth"] - 1):
        b = f"blocks.{i}."
        specs += [(b + "norm1.weight", (w,), "norm"), (b + "norm1.bias", (w,), "bias"),
                  (b + "qkv.weight", (3 * w, w), "dense"), (b + "qkv.bias", (3 * w,), "bias"),
                  (b + "proj.weight", (w, w), "dense"), (b + "proj.bias", (w,), "bias"),
                  (b + "norm2.weight", (w,), "norm"), (b + "norm2.bias", (w,), "bias"),
                  (b + "mlp_fc1.weight", (mlp, w), "dense"), (b + "mlp_fc1.bias", (mlp,), "bias"),
                  (b + "mlp_fc2.weight", (w, mlp), "dense"), (b + "mlp_fc2.bias", (w,), "bias")]
        if t.get("layerscale_init") is not None:
            specs += [(b + "ls1", (w,), "layerscale"), (b + "ls2", (w,), "layerscale")]
    return specs


def projector_specs(vision_dim: int, llm_dim: int) -> List[Spec]:
    """fused-gelu-mlp: fc1 [4v, v], fc2 [llm, 4v], fc3 [llm, llm], with biases."""
    dims = [(vision_dim, 4 * vision_dim), (4 * vision_dim, llm_dim), (llm_dim, llm_dim)]
    specs: List[Spec] = []
    for i, (din, dout) in enumerate(dims, start=1):
        specs += [(f"fc{i}.weight", (dout, din), "dense"), (f"fc{i}.bias", (dout,), "bias")]
    return specs


def decoder_layer_specs(llm: Dict) -> List[Spec]:
    """One decoder layer's leaves (models/llm/llama.py's names)."""
    d, i, h, hkv = llm["dim"], llm["intermediate_size"], llm["n_heads"], llm["n_kv_heads"]
    hd = d // h
    specs: List[Spec] = [("wq", (h * hd, d), "dense"), ("wk", (hkv * hd, d), "dense"), ("wv", (hkv * hd, d), "dense"),
                         ("wo", (d, h * hd), "dense"), ("attn_norm", (d,), "norm")]
    if llm["arch"] == "phi":
        specs += [("w_up", (i, d), "dense"), ("w_down", (d, i), "dense"), ("attn_norm_bias", (d,), "bias"),
                  ("bq", (h * hd,), "bias"), ("bk", (hkv * hd,), "bias"), ("bv", (hkv * hd,), "bias"),
                  ("bo", (d,), "bias"), ("b_up", (i,), "bias"), ("b_down", (d,), "bias")]
    else:
        specs += [("w_gate", (i, d), "dense"), ("w_up", (i, d), "dense"), ("w_down", (d, i), "dense"),
                  ("mlp_norm", (d,), "norm")]
    return specs


def decoder_top_specs(llm: Dict) -> List[Spec]:
    d, v = llm["dim"], llm["padded_vocab_size"]
    specs: List[Spec] = [("embed", (v, d), "embed"), ("final_norm", (d,), "norm"), ("lm_head", (v, d), "dense")]
    if llm["arch"] == "phi":
        specs += [("final_norm_bias", (d,), "bias"), ("lm_head_bias", (v,), "bias")]
    return specs


def _scale_(t: torch.Tensor, kind: str, shape: Tuple[int, ...]) -> torch.Tensor:
    if kind == "dense":
        return t.mul_(math.prod(shape[1:]) ** -0.5)
    if kind == "embed":
        return t.mul_(0.02)
    if kind == "norm":
        return t.mul_(0.02).add_(1.0)
    if kind == "layerscale":
        return t.mul_(0.02).add_(0.1)
    return t.mul_(0.02)  # bias, tokens


def _draw(specs: List[Spec], seed: int, group: int, dtype: torch.dtype, device) -> Dict[str, torch.Tensor]:
    """One randn for the group's matrices, one for its small leaves."""
    out: Dict[str, torch.Tensor] = {}
    for part, (kinds, g) in enumerate(((("dense", "embed"), 2 * group), (("norm", "bias", "layerscale"), 2 * group + 1))):
        chosen = [s for s in specs if s[2] in kinds]
        if not chosen:
            continue
        n = sum(math.prod(shape) for _, shape, _ in chosen)
        gen = torch.Generator(device=device).manual_seed(group_seed(seed, g))
        flat = torch.randn(n, generator=gen, dtype=dtype, device=device)
        at = 0
        for name, shape, kind in chosen:
            size = math.prod(shape)
            out[name] = _scale_(flat[at:at + size].view(shape), kind, shape)
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
        vision.update({prefix + k: v for k, v in _draw(tower_specs(t), seed, g, dtype, device).items()})
    vision_dim = sum(t["width"] for t in towers)
    projector = _draw(projector_specs(vision_dim, llm["dim"]), seed, 2, dtype, device)
    layer_specs = decoder_layer_specs(llm)
    flat_specs = [(f"{i}.{name}", shape, kind) for i in range(llm["n_layers"]) for name, shape, kind in layer_specs]
    drawn = _draw(flat_specs + decoder_top_specs(llm), seed, 3, dtype, device)
    layers = [{name: drawn[f"{i}.{name}"] for name, _, _ in layer_specs} for i in range(llm["n_layers"])]
    top = {name: drawn[name] for name, _, _ in decoder_top_specs(llm)}
    return {"vision": vision, "projector": projector, "llm": dict(top, layers=layers)}
