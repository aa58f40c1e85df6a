"""Export the port's parameters to the HF OpenVLA checkpoint format.

Counterpart of bridgelang_tpu/extern/hf_export.py (the reference's
vla-scripts/extern/convert_openvla_weights_to_hf.py run forward): the flat
`language_model.* / vision_backbone.* / projector.*` state dict, an
OpenVLAConfig-schema config.json and dataset_statistics.json, written as
safetensors with the port's own writer. The same keys, shapes, dtypes (fp32)
and values as the JAX exporter.

The state dict is a dict of `safetensors_io.Lazy` entries: each tensor is
made (moved to the host, cast, dequantized if int8 or int4) only when the
writer writes it, so a 7B export holds one tensor in host memory, not the
~30 GB fp32 state dict.

Known delta (as in the JAX package): the final ViT block of each tower and
SigLIP's attention-pooling head are never materialized. Exports carry zeros
for that block unless `source_hf` passes the checkpoint's own tensors
through (then the export loads strictly on the HF side).
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Any, Dict, Optional, Set, Union

import torch

from bridgelang_tpu_torch.models.load import LLM_LAYER, LLM_TOP, VIT_BLOCK, VIT_TOP
from bridgelang_tpu_torch.util.safetensors_io import Lazy, SafetensorsFile, checkpoint_files, save_file

_VIT_TOP_HF = {port: hf for hf, port in VIT_TOP.items()}
_VIT_BLOCK_HF = {port: hf for hf, port in VIT_BLOCK.items() if not hf.endswith(".gamma")}
_LLM_TOP_HF = {port: hf for hf, port in LLM_TOP.items()}
_LLM_LAYER_HF = {port: hf for hf, port in LLM_LAYER.items()}
_BLOCK = re.compile(r"blocks\.(\d+)\.(.+)")


def export_llm_state_dict(llm: Dict[str, Any], prefix: str = "language_model.", int4_shards: int = 1,
                          dtype: torch.dtype = torch.float32) -> Dict[str, Lazy]:
    """The decoder under HF LlamaForCausalLM names. int8 and packed-int4
    leaves are dequantized first (to bf16, then `dtype`, as the JAX exporter
    does); `int4_shards` must equal the pack-time n_shards (quant.py
    `pack_layout_tag`: another value permutes columns silently). LoRA
    adapters are not exported (merge them first)."""
    from bridgelang_tpu_torch.ops.quant import dequantize_layer, dequantize_rows

    out: Dict[str, Lazy] = {}
    for key in ("embed", "final_norm", "lm_head"):
        t = llm[key]
        if t.dtype == torch.int8:
            out[prefix + _LLM_TOP_HF[key]] = Lazy(dtype, tuple(t.shape), lambda t=t, s=llm[key + "_scale"]: (
                dequantize_rows(t, s).to(dtype).cpu()))
        else:
            out[prefix + _LLM_TOP_HF[key]] = _as_lazy(t, dtype)
    for i, lp in enumerate(llm["layers"]):
        b = f"{prefix}model.layers.{i}."
        for key, hf in _LLM_LAYER_HF.items():
            if key + "_scale4" in lp:  # packed [in, out/2] -> float [out, in]
                part = {key: lp[key], key + "_scale4": lp[key + "_scale4"]}
                shape = (2 * lp[key].shape[1], lp[key].shape[0])
            elif key + "_scale" in lp:
                part = {key: lp[key], key + "_scale": lp[key + "_scale"]}
                shape = tuple(lp[key].shape)
            else:
                out[b + hf] = _as_lazy(lp[key], dtype)
                continue
            out[b + hf] = Lazy(dtype, shape, lambda part=part, key=key: (
                dequantize_layer(part, int4_shards=int4_shards)[key].to(dtype).cpu()))
    return out


def _as_lazy(t: torch.Tensor, dtype: torch.dtype) -> Lazy:
    return Lazy(dtype, tuple(t.shape), lambda: t.detach().to(dtype).cpu().contiguous())


def export_vit_state_dict(tower: Dict[str, torch.Tensor], depth: int, prefix: str,
                          dead_keys: Optional[Set[str]] = None, dtype: torch.dtype = torch.float32) -> Dict[str, Lazy]:
    """One tower (the port's ViT state dict) under timm names with `prefix`.
    The final block (`depth - 1`, never run) is zero-filled; `dead_keys`
    collects those names so a caller can pass source values through."""
    out: Dict[str, Lazy] = {}
    n_keep = 0
    for key, t in tower.items():
        m = _BLOCK.fullmatch(key)
        if m:
            n_keep = max(n_keep, int(m.group(1)) + 1)
            out[f"{prefix}blocks.{m.group(1)}.{_VIT_BLOCK_HF[m.group(2)]}"] = _as_lazy(t, dtype)
        else:
            out[prefix + _VIT_TOP_HF[key]] = _as_lazy(t, dtype)
    last = f"{prefix}blocks.{n_keep - 1}."
    for k in [k for k in out if k.startswith(last)]:
        dead = f"{prefix}blocks.{depth - 1}." + k[len(last):]
        out[dead] = Lazy(dtype, out[k].shape, lambda shape=out[k].shape: torch.zeros(shape, dtype=dtype))
        if dead_keys is not None:
            dead_keys.add(dead)
    return out


def _towers(vision: Dict[str, torch.Tensor]) -> Dict[str, Dict[str, torch.Tensor]]:
    if any(k.startswith("featurizer.") for k in vision):
        return {name: {k[len(name) + 1:]: v for k, v in vision.items() if k.startswith(name + ".")}
                for name in ("featurizer", "fused_featurizer")}
    return {"featurizer": dict(vision)}


def export_state_dict(params: Dict[str, Any], dead_keys: Optional[Set[str]] = None,
                      dtype: torch.dtype = torch.float32) -> Dict[str, Lazy]:
    """The whole HF state dict of {"vision", "projector", "llm"} as `Lazy`
    entries in `dtype` (fp32, the JAX contract, by default)."""
    tensors = export_llm_state_dict(params["llm"], dtype=dtype)
    for key, t in params["projector"].items():
        tensors[f"projector.{key}"] = _as_lazy(t, dtype)
    for name, tower in _towers(params["vision"]).items():
        n_keep = 1 + max(int(_BLOCK.fullmatch(k).group(1)) for k in tower if _BLOCK.fullmatch(k))
        tensors.update(export_vit_state_dict(tower, n_keep + 1, f"vision_backbone.{name}.", dead_keys, dtype))
    return tensors


def hf_config(model) -> Dict[str, Any]:
    """The OpenVLAConfig-schema config.json of the JAX exporter. A decoder
    with a sliding window (Mistral) also writes it, as HF's MistralConfig
    does (`text_config.model_type` "mistral", `sliding_window`): the JAX
    exporter drops it, and its loader takes the window from the registry id
    alone."""
    cfg = model.cfg
    out = {
        "model_type": "openvla",
        "architectures": ["OpenVLAForActionPrediction"],
        "vision_backbone_id": cfg.vision_backbone_id,
        "llm_backbone_id": cfg.llm_backbone_id,
        "arch_specifier": cfg.arch_specifier,
        "image_resize_strategy": cfg.image_resize_strategy,
        "llm_max_length": cfg.llm_max_length,
        "pad_token_id": cfg.llm.pad_token_id,
        "pad_to_multiple_of": 64,
        "n_action_bins": 256,
        "norm_stats": getattr(model, "norm_stats", {}),
        "text_config": {"model_type": "llama", "vocab_size": cfg.llm.padded_vocab_size,
                        "hidden_size": cfg.llm.dim, "num_hidden_layers": cfg.llm.n_layers,
                        "num_attention_heads": cfg.llm.n_heads, "num_key_value_heads": cfg.llm.n_kv_heads,
                        "intermediate_size": cfg.llm.intermediate_size, "rms_norm_eps": cfg.llm.norm_eps},
    }
    if cfg.llm.sliding_window is not None:
        out["text_config"].update(model_type="mistral", sliding_window=cfg.llm.sliding_window)
    return out


def write_sidecars(model, out_dir: Union[Path, str]) -> None:
    """config.json, and dataset_statistics.json when the model has stats."""
    out_dir = Path(out_dir)
    with open(out_dir / "config.json", "w") as f:
        json.dump(hf_config(model), f, indent=2, default=str)
    if getattr(model, "norm_stats", None):
        with open(out_dir / "dataset_statistics.json", "w") as f:
            json.dump(model.norm_stats, f, indent=2, default=float)


def source_dtype(source_hf: Union[Path, str]) -> torch.dtype:
    """The dtype a checkpoint stores its float tensors in (the first one's)."""
    for f in checkpoint_files(source_hf):
        sf = SafetensorsFile(f)
        for key in sf.keys():
            dtype, _ = sf.dtype_shape(key)
            if dtype.is_floating_point:
                return dtype
    return torch.float32


def export_checkpoint(model, params: Dict[str, Any], out_dir, source_hf: Union[Path, str, None] = None,
                      dtype: torch.dtype = torch.float32) -> Path:
    """Write config.json + model.safetensors (fp32, the JAX exporter's
    contract, unless `dtype` says otherwise) + dataset_statistics.json.

    `source_hf`: the HF checkpoint directory this model was loaded from.
    Its tensors that the port never materializes (the final ViT blocks, the
    towers' `norm`, SigLIP's pooling head, ...) are passed through in their
    stored dtype instead of zero-filled."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    dead_keys: Set[str] = set()
    tensors: Dict[str, Lazy] = export_state_dict(params, dead_keys, dtype=dtype)
    if source_hf is not None:
        for f in checkpoint_files(source_hf):
            sf = SafetensorsFile(f)
            for key in sf.keys():
                if key in dead_keys or key not in tensors:
                    dtype, shape = sf.dtype_shape(key)
                    tensors[key] = Lazy(dtype, shape, lambda sf=sf, key=key: sf.get_tensor(key))
    save_file(tensors, out_dir / "model.safetensors")
    write_sidecars(model, out_dir)
    return out_dir
