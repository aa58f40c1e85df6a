"""Convert the JAX package's parameter pytree (as numpy arrays) into the port's.

    state = params_from_jax(jax.tree.map(np.asarray, jax_params))

Rules:
  * Dense kernels [in, out] -> nn.Linear weights [out, in].
  * Scan-stacked layers (leading L axis) are unstacked: the LLM's `layers`
    dict of [L, ...] arrays becomes a list of L dicts, and a ViT's `blocks`
    become `blocks.{i}.*` entries.
  * The flax patch Conv kernel HWIO -> torch OIHW.
  * flax LayerNorm `scale`/`bias` -> `weight`/`bias`.
  * `pos_embed`, `cls_token`, `reg_tokens` and LayerScale `ls1`/`ls2` keep
    their names and shapes.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

_LLM_LINEAR = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def _t(x: np.ndarray, device, dtype) -> torch.Tensor:
    x = np.array(x)  # a writable, contiguous copy (JAX hands out read-only views)
    if x.dtype.name == "bfloat16":  # ml_dtypes bf16, which torch.from_numpy does not take
        t = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(x)
    return t.to(device=device, dtype=dtype or t.dtype)


def _dense(prefix: str, p: Dict[str, np.ndarray], out: Dict[str, np.ndarray]) -> None:
    if "kernel" in p:
        out[f"{prefix}.weight"] = np.asarray(p["kernel"]).T
        if "bias" in p:
            out[f"{prefix}.bias"] = np.asarray(p["bias"])
    else:  # LayerNorm
        out[f"{prefix}.weight"] = np.asarray(p["scale"])
        out[f"{prefix}.bias"] = np.asarray(p["bias"])


def vit_state_from_jax(tree: Dict[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    """One flax `ViT` params dict -> ViT state-dict entries (numpy)."""
    out: Dict[str, np.ndarray] = {}
    out[f"{prefix}patch_embed.weight"] = np.asarray(tree["patch_embed"]["kernel"]).transpose(3, 2, 0, 1)
    out[f"{prefix}patch_embed.bias"] = np.asarray(tree["patch_embed"]["bias"])
    for name in ("pos_embed", "cls_token", "reg_tokens"):
        if name in tree:
            out[f"{prefix}{name}"] = np.asarray(tree[name])
    if "norm_pre" in tree:
        _dense(f"{prefix}norm_pre", tree["norm_pre"], out)
    blocks = tree["blocks"]
    n_blocks = np.asarray(blocks["qkv"]["kernel"]).shape[0]
    for i in range(n_blocks):
        for sub, leaf in blocks.items():
            key = f"{prefix}blocks.{i}.{sub}"
            if isinstance(leaf, dict):
                _dense(key, {k: np.asarray(v)[i] for k, v in leaf.items()}, out)
            else:  # ls1 / ls2
                out[key] = np.asarray(leaf)[i]
    return out


def vision_state_from_jax(tree: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """flax `FusedViT` ({"featurizer", "fused_featurizer"}) or `ViT` params."""
    if "featurizer" in tree:
        out = vit_state_from_jax(tree["featurizer"], "featurizer.")
        out.update(vit_state_from_jax(tree["fused_featurizer"], "fused_featurizer."))
        return out
    return vit_state_from_jax(tree)


def projector_state_from_jax(tree: Dict[str, Any]) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for name, p in tree.items():
        _dense(name, p, out)
    return out


def _packed_int4(name: str, stacked: Dict[str, np.ndarray]) -> bool:
    """A packed int4 leaf or its scales: the JAX bytes, kept untransposed."""
    return name.endswith("_scale4") or name + "_scale4" in stacked


def _layer_leaf(name: str, x: np.ndarray, packed: bool) -> np.ndarray:
    """One layer's slice of a stacked leaf in the port's layout: dense linear
    kernels, int8 kernels with their scales and LoRA adapters are transposed
    ([in, out] -> [out, in]; an int8 `<proj>_scale` [1, out] -> [out, 1]; A
    [in, r] -> [r, in]; B [r, out] -> [out, r]); packed int4 leaves ([in,
    out/2] int8, scales [in/group, out] bf16) and norms keep theirs."""
    if packed:
        return x
    if name in _LLM_LINEAR or name.endswith(("_lora_a", "_lora_b", "_scale")):
        return x.T
    return x


def llm_params_from_jax(tree: Dict[str, Any], device=None, dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """The JAX Llama params -> the port's {"embed", "layers": [...], ...}.
    LoRA adapters (`<proj>_lora_a` [L, in, r], `<proj>_lora_b` [L, r, out])
    come across per layer as [r, in] and [out, r]. Quantized trees
    (ops/quant.py): packed int4 layers come across byte for byte; int8 layers
    (`<proj>` [in, out] int8 with `<proj>_scale` [1, out]) are transposed to
    [out, in] and [out, 1], bit for bit; the int8 embedding keeps [V, D] and
    its [V, 1] scale; the int8 head [D, V] and its [1, V] scale are transposed
    to [V, D] and [V, 1]. Quantized leaves and their scales keep their dtypes
    whatever `dtype` is. A Phi tree's biases and norm biases (`bq`, `bk`,
    `bv`, `bo`, `b_up`, `b_down`, `attn_norm_bias`; `final_norm_bias`,
    `lm_head_bias`) keep their shapes and stay float in every tree."""
    stacked = {k: np.asarray(v) for k, v in tree["layers"].items()}
    n_layers = stacked["wq"].shape[0]
    layers = []
    for i in range(n_layers):
        layer = {}
        for k, v in stacked.items():
            packed = _packed_int4(k, stacked)
            keep = packed or v.dtype == np.int8 or k.endswith("_scale")
            layer[k] = _t(_layer_leaf(k, v[i], packed), device, None if keep else dtype)
        layers.append(layer)
    top = {"embed": np.asarray(tree["embed"]), "layers": layers, "final_norm": np.asarray(tree["final_norm"]),
           "lm_head": np.asarray(tree["lm_head"]).T}
    if "embed_scale" in tree:
        top["embed_scale"] = np.asarray(tree["embed_scale"])
    if "lm_head_scale" in tree:
        top["lm_head_scale"] = np.asarray(tree["lm_head_scale"]).T
    for name in ("final_norm_bias", "lm_head_bias"):  # Phi
        if name in tree:
            top[name] = np.asarray(tree[name])
    return {k: v if k == "layers" else _t(v, device, None if v.dtype == np.int8 or k.endswith("_scale") else dtype)
            for k, v in top.items()}


def params_from_jax(np_tree: Dict[str, Any], device=None, dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """Full VLM params {"vision", "projector", "llm"} -> the port's params
    on `device` (default CPU), cast to `dtype` if given."""
    return {
        "vision": {k: _t(v, device, dtype) for k, v in vision_state_from_jax(np_tree["vision"]).items()},
        "projector": {k: _t(v, device, dtype) for k, v in projector_state_from_jax(np_tree["projector"]).items()},
        "llm": llm_params_from_jax(np_tree["llm"], device, dtype),
    }
