"""Checkpoint loading: HF OpenVLA/Prismatic safetensors -> the port's params.

Counterpart of bridgelang_tpu/models/load.py (the reference's
prismatic/models/load.py run on the published HF `openvla/openvla-7b`
layout: config.json + model*.safetensors + dataset_statistics.json).

The port's layout is HF's already (torch [out, in] linears, OIHW patch
convolutions, one dict per decoder layer), so a tensor goes from the file to
the device by a rename, a dtype cast and one copy: no transpose, no stacking.
Loading streams: `util/safetensors_io` maps one tensor's bytes at a time, the
tensor is copied to the device and cast there, and, when the decoder is
quantized on load, each projection is quantized as soon as it arrives with
the same per-tensor arithmetic as `ops/quant.quantize_llm_int8` /
`quantize_llm_int4` of the whole float tree (bit-equal to it). Host memory
holds one tensor's pages and the device the model plus one staged tensor; an
int4 load never holds the float decoder on the device.

Tensors the model never runs are skipped: the final ViT block of each tower
(the feature tap is the second-to-last block), the towers' final `norm` and
SigLIP's attention-pooling head. A tensor the model needs and the checkpoint
lacks raises `KeyError`; a shape other than the model's raises `ValueError`.

No network: a checkpoint is a local directory (`resolve_checkpoint_dir`).
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Any, Dict, Iterable, Mapping, Optional, Tuple, Union

import torch

from bridgelang_tpu_torch.util.safetensors_io import iter_tensors

# Registered model ids -> descriptions (the JAX package's abbreviated
# registry of the reference's prismatic/models/registry.py).
MODEL_REGISTRY: Dict[str, str] = {
    # --- VLA checkpoints ---
    "openvla-7b": "OpenVLA 7B: fused DINOv2+SigLIP 224px, Llama-2-7B, OXE Magic Soup++ (flagship)",
    "openvla-v01-7b": "OpenVLA v0.1 7B: SigLIP 224px, Vicuna-v1.5-7B, OXE Magic Soup",
    # --- LLaVA reproductions ---
    "reproduction-llava-v15+7b": "LLaVA v1.5 reproduction: CLIP ViT-L 336px letterbox, Vicuna-v1.5-7B",
    "reproduction-llava-v15+13b": "LLaVA v1.5 reproduction at 13B",
    "one-stage+7b": "single-stage (no align) LLaVA-style training, 7B",
    "one-stage+13b": "single-stage at 13B",
    "full-ft-multi-stage+7b": "two-stage with full vision fine-tuning",
    "full-ft-one-stage+7b": "one-stage with full vision fine-tuning",
    # --- vision backbone ablations (224px) ---
    "in1k-224px+7b": "IN1K ViT-L backbone ablation",
    "dinov2-224px+7b": "DINOv2 ViT-L backbone ablation",
    "clip-224px+7b": "CLIP ViT-L backbone ablation",
    "siglip-224px+7b": "SigLIP so400m backbone ablation",
    # --- resolution / resize-strategy ablations ---
    "clip-336px-resize-crop+7b": "CLIP 336px resize-crop",
    "clip-336px-resize-naive+7b": "CLIP 336px naive resize",
    "siglip-384px-letterbox+7b": "SigLIP 384px letterbox",
    "siglip-384px-resize-crop+7b": "SigLIP 384px resize-crop",
    "siglip-384px-resize-naive+7b": "SigLIP 384px naive resize",
    # --- fused-backbone ablations ---
    "dinoclip-336px-letterbox+7b": "fused DINOv2+CLIP 336px letterbox",
    "dinoclip-336px-resize-naive+7b": "fused DINOv2+CLIP 336px naive resize",
    "dinosiglip-384px-letterbox+7b": "fused DINOv2+SigLIP 384px letterbox",
    "dinosiglip-384px-resize-naive+7b": "fused DINOv2+SigLIP 384px naive resize",
    # --- LLM backbone ablations ---
    "llama2+7b": "Llama-2-7B base LLM",
    "llama2+13b": "Llama-2-13B base LLM",
    "llama2-chat+7b": "Llama-2-7B chat LLM",
    "llama2-chat+13b": "Llama-2-13B chat LLM",
    "mistral-v0.1+7b": "Mistral-v0.1-7B base LLM",
    "mistral-instruct-v0.1+7b": "Mistral-v0.1-7B instruct LLM",
    "phi-2+3b": "Phi-2 3B LLM",
    "vicuna-no-cotraining+7b": "Vicuna without language-only co-training",
    "llama2-no-cotraining+7b": "Llama-2 without language-only co-training",
    # --- training-duration / data ablations ---
    "train-1.25-epochs+7b": "1.25-epoch schedule",
    "train-1.5-epochs+7b": "1.5-epoch schedule",
    "train-2-epochs+7b": "2-epoch schedule",
    "train-3-epochs+7b": "3-epoch schedule",
    "llava-lvis4v+7b": "+LVIS-Instruct-4V data",
    "llava-lrv+7b": "+LRV-Instruct data",
    "llava-lvis4v-lrv+7b": "+both extra data mixes",
    # --- Prism family ---
    "prism-clip-controlled+7b": "Prism CLIP, controlled comparison",
    "prism-clip-controlled+13b": "Prism CLIP controlled, 13B",
    "prism-clip+7b": "Prism CLIP full recipe",
    "prism-clip+13b": "Prism CLIP full recipe, 13B",
    "prism-siglip-controlled+7b": "Prism SigLIP, controlled comparison",
    "prism-siglip+7b": "Prism SigLIP full recipe",
    "prism-siglip+13b": "Prism SigLIP full recipe, 13B",
    "prism-dinosiglip-controlled+7b": "Prism fused DINOv2+SigLIP, controlled",
    "prism-dinosiglip-controlled+13b": "Prism fused controlled, 13B",
    "prism-dinosiglip+7b": "Prism fused DINOv2+SigLIP 384px",
    "prism-dinosiglip+13b": "Prism fused 384px, 13B",
    "prism-dinosiglip-224px-controlled+7b": "Prism fused 224px, controlled",
    "prism-dinosiglip-224px+7b": "Prism fused 224px (the openvla-7b base VLM)",
}

# The published checkpoints' repos (reference load.py:39 VLA_HF_HUB_REPO).
VLA_HUB_ORG = "openvla"

# HF names -> the port's. Vision, under `vision_backbone.<tower>.` (timm
# naming; the HF twin renames LayerScale `gamma` to `scale_factor`):
VIT_TOP = {"patch_embed.proj.weight": "patch_embed.weight", "patch_embed.proj.bias": "patch_embed.bias",
           "cls_token": "cls_token", "reg_token": "reg_tokens", "pos_embed": "pos_embed",
           "norm_pre.weight": "norm_pre.weight", "norm_pre.bias": "norm_pre.bias"}
VIT_BLOCK = {"norm1.weight": "norm1.weight", "norm1.bias": "norm1.bias",
             "attn.qkv.weight": "qkv.weight", "attn.qkv.bias": "qkv.bias",
             "attn.proj.weight": "proj.weight", "attn.proj.bias": "proj.bias",
             "norm2.weight": "norm2.weight", "norm2.bias": "norm2.bias",
             "mlp.fc1.weight": "mlp_fc1.weight", "mlp.fc1.bias": "mlp_fc1.bias",
             "mlp.fc2.weight": "mlp_fc2.weight", "mlp.fc2.bias": "mlp_fc2.bias",
             "ls1.scale_factor": "ls1", "ls2.scale_factor": "ls2", "ls1.gamma": "ls1", "ls2.gamma": "ls2"}
# Decoder, under `language_model.` (HF LlamaForCausalLM):
LLM_TOP = {"model.embed_tokens.weight": "embed", "model.norm.weight": "final_norm", "lm_head.weight": "lm_head"}
LLM_LAYER = {"self_attn.q_proj.weight": "wq", "self_attn.k_proj.weight": "wk", "self_attn.v_proj.weight": "wv",
             "self_attn.o_proj.weight": "wo", "mlp.gate_proj.weight": "w_gate", "mlp.up_proj.weight": "w_up",
             "mlp.down_proj.weight": "w_down", "input_layernorm.weight": "attn_norm",
             "post_attention_layernorm.weight": "mlp_norm"}
TOWERS = ("featurizer", "fused_featurizer")
_BLOCK = re.compile(r"blocks\.(\d+)\.(.+)")
_LAYER = re.compile(r"model\.layers\.(\d+)\.(.+)")


def available_models():
    return sorted(MODEL_REGISTRY)


def available_model_names():
    return available_models()


def hf_to_port(name: str, llm_n_layers: int, vit_depths: Mapping[str, int]) -> Optional[Tuple[str, Any]]:
    """An HF tensor name -> ("vision", "<tower>.<key>"), ("projector",
    key), ("llm", key) or ("layer", (index, key)); None for a tensor the
    model does not run (final ViT block, tower `norm`, pooling head, decoder
    layers past `llm_n_layers`, anything unknown). `vit_depths`: each
    tower's full depth; blocks 0..depth-2 are kept."""
    if name.startswith("vision_backbone."):
        tower, _, rest = name[len("vision_backbone."):].partition(".")
        if tower not in vit_depths:
            return None
        if rest in VIT_TOP:
            return "vision", f"{tower}.{VIT_TOP[rest]}"
        m = _BLOCK.fullmatch(rest)
        if m and int(m.group(1)) < vit_depths[tower] - 1 and m.group(2) in VIT_BLOCK:
            return "vision", f"{tower}.blocks.{m.group(1)}.{VIT_BLOCK[m.group(2)]}"
        return None
    if name.startswith("projector."):
        return "projector", name[len("projector."):]
    if name.startswith("language_model."):
        rest = name[len("language_model."):]
        if rest in LLM_TOP:
            return "llm", LLM_TOP[rest]
        m = _LAYER.fullmatch(rest)
        if m and int(m.group(1)) < llm_n_layers and m.group(2) in LLM_LAYER:
            return "layer", (int(m.group(1)), LLM_LAYER[m.group(2)])
    return None


def _place(t: torch.Tensor, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """A fresh tensor on `device` in `dtype`: copied as stored, cast there
    (fp32 -> bf16 rounds to nearest even on either device)."""
    if device.type == "cpu":
        return t.to(dtype=dtype, copy=True)
    return t.to(device).to(dtype)


def convert_hf_state_dict(
    tensors: Union[Mapping[str, torch.Tensor], Iterable[Tuple[str, torch.Tensor]]],
    llm_n_layers: int,
    vit_depths: Dict[str, int],
    target_dtype: Optional[torch.dtype] = None,
    device=None,
    quantize: Optional[str] = None,
    int4_group: int = 128,
    int4_shards: int = 1,
) -> Dict[str, Any]:
    """A flat HF OpenVLA state dict (a mapping, or (name, tensor) pairs
    taken one at a time) -> {"vision", "projector", "llm"} on `device` (CPU
    by default) in `target_dtype` (bf16 by default). `vit_depths`:
    {"featurizer": depth, "fused_featurizer": depth}; a single tower
    ({"featurizer"} only) flattens to the top of "vision". `quantize`:
    "int8" or "int4" quantizes each decoder projection (and the embedding
    and head to int8) as it arrives."""
    from bridgelang_tpu_torch.ops.quant import quantize_layer_int4, quantize_layer_int8, quantize_rows_int8

    dt = target_dtype or torch.bfloat16
    dev = torch.device("cpu" if device is None else device)
    items = tensors.items() if isinstance(tensors, Mapping) else tensors
    single = set(vit_depths) == {"featurizer"}
    out: Dict[str, Any] = {"vision": {}, "projector": {}, "llm": {"layers": [{} for _ in range(llm_n_layers)]}}
    for name, t in items:
        where = hf_to_port(name, llm_n_layers, vit_depths)
        if where is None:
            continue
        part, key = where
        x = _place(t, dev, dt)
        del t
        if part == "vision":
            out["vision"][key[len("featurizer."):] if single else key] = x
        elif part == "projector":
            out["projector"][key] = x
        elif part == "llm":
            if quantize and key in ("embed", "lm_head"):
                out["llm"][key], out["llm"][key + "_scale"] = quantize_rows_int8(x)
            else:
                out["llm"][key] = x
        else:
            i, key = key
            layer = {key: x}
            if quantize == "int8":
                layer = quantize_layer_int8(layer)
            elif quantize == "int4":
                layer = quantize_layer_int4(layer, group=int4_group, n_shards=int4_shards)
            out["llm"]["layers"][i].update(layer)
    return out


def _expected_llm_shapes(cfg) -> Dict[str, Tuple[int, ...]]:
    d, hd, v, inter = cfg.dim, cfg.head_dim, cfg.padded_vocab_size, cfg.intermediate_size
    return {"wq": (cfg.n_heads * hd, d), "wk": (cfg.n_kv_heads * hd, d), "wv": (cfg.n_kv_heads * hd, d),
            "wo": (d, cfg.n_heads * hd), "w_gate": (inter, d), "w_up": (inter, d), "w_down": (d, inter),
            "attn_norm": (d,), "mlp_norm": (d,), "embed": (v, d), "final_norm": (d,), "lm_head": (v, d)}


def check_loaded(model, params: Dict[str, Any], quantized: bool) -> None:
    """Every tensor the model runs is present with the model's shape
    (quantized decoder leaves are checked for presence only)."""
    missing, wrong = [], []
    for part, module in (("vision", model.vision_module), ("projector", model.projector)):
        for key, p in module.named_parameters():
            if key not in params[part]:
                missing.append(f"{part}.{key}")
            elif tuple(params[part][key].shape) != tuple(p.shape):
                wrong.append(f"{part}.{key}: {list(params[part][key].shape)} != {list(p.shape)}")
    shapes = _expected_llm_shapes(model.cfg.llm)
    layer_keys = [k for k in shapes if k not in ("embed", "final_norm", "lm_head")]
    llm = params["llm"]
    leaves = [(f"llm.{k}", llm.get(k), shapes[k]) for k in ("embed", "final_norm", "lm_head")]
    leaves += [(f"llm.layers.{i}.{k}", lp.get(k), shapes[k]) for i, lp in enumerate(llm["layers"]) for k in layer_keys]
    for key, t, shape in leaves:
        if t is None:
            missing.append(key)
        elif not (quantized and t.dtype == torch.int8) and tuple(t.shape) != shape:
            wrong.append(f"{key}: {list(t.shape)} != {list(shape)}")
    if missing:
        raise KeyError(f"checkpoint lacks {len(missing)} tensors the model runs, e.g. {missing[:5]}")
    if wrong:
        raise ValueError(f"checkpoint shapes differ from the model's: {wrong[:5]}")


def resolve_checkpoint_dir(model_id_or_path: str, hf_token: Optional[str] = None, cache_dir=None) -> Path:
    """A local checkpoint directory, as given. The port does not fetch from
    the HF Hub: any other id raises `FileNotFoundError` naming the repo it
    maps to (a bare registered id -> `openvla/<id>`, an `org/name` id as is)
    and the files to pre-stage. `hf_token` and `cache_dir` are accepted for
    the JAX signature."""
    path = Path(model_id_or_path)
    if path.exists():
        return path
    repo_id = model_id_or_path if "/" in model_id_or_path else f"{VLA_HUB_ORG}/{model_id_or_path}"
    raise FileNotFoundError(
        f"{model_id_or_path!r} is not a local checkpoint directory, and the port does not fetch the HF Hub "
        f"repo {repo_id!r}. In zero-egress environments pre-download the HF checkpoint "
        "(config.json + *.safetensors + dataset_statistics.json) and pass its path."
    )


def load_vla(
    model_id_or_path: str,
    hf_token: Optional[str] = None,
    load_weights: bool = True,
    dtype: Optional[torch.dtype] = None,
    quantize_int8: bool = False,
    quantize_int4: bool = False,
    int4_group: Optional[int] = None,
    int4_shards: int = 1,
    w8a8: Optional[bool] = None,
    cache_dir=None,
    device=None,
):
    """Build an OpenVLA from a checkpoint directory -> (model, params), or
    (model, None) with `load_weights=False`.

    `dtype`: the float weights' dtype (bf16 by default). `quantize_int8` /
    `quantize_int4` (int4 wins) quantize the decoder while it loads, int4
    with scale groups of `int4_group` input rows (128 by default) packed for
    `int4_shards` shards. `w8a8` (default: on when quantized, the serving
    posture) also quantizes activations per token; pass False for a QLoRA
    base. `device`: CUDA by default (raises without a card); "cpu" runs the
    plain path. The tokenizer is left unset, as in the JAX package (deploy
    sets it). The decoder's config comes from the registry id; a
    `text_config.sliding_window` in config.json (the port's export of a
    windowed decoder) overrides the registry's window."""
    from bridgelang_tpu_torch._device import resolve_device
    from bridgelang_tpu_torch.models.vision import vit as vit_mod
    from bridgelang_tpu_torch.models.vla import OpenVLA
    from bridgelang_tpu_torch.models.vlm import VLMConfig
    from bridgelang_tpu_torch.ops.quant import INT4_GROUP

    dt = dtype or torch.bfloat16
    dev = resolve_device(device)
    path = resolve_checkpoint_dir(model_id_or_path, hf_token=hf_token, cache_dir=cache_dir)
    with open(path / "config.json") as f:
        hf_cfg = json.load(f)
    if w8a8 is None:
        w8a8 = quantize_int8 or quantize_int4
    overrides = {"w8a8": bool(w8a8), "int4_shards": int4_shards} if (w8a8 or int4_shards > 1) else {}
    window = hf_cfg.get("text_config", {}).get("sliding_window")
    if window is not None:  # the export's window wins over the registry's (a JAX export writes none)
        overrides["sliding_window"] = int(window)
    cfg = VLMConfig.from_ids(
        model_id=hf_cfg.get("_name_or_path", str(path.name)),
        vision_backbone_id=hf_cfg["vision_backbone_id"],
        llm_backbone_id=hf_cfg["llm_backbone_id"],
        arch_specifier=hf_cfg["arch_specifier"],
        image_resize_strategy=hf_cfg["image_resize_strategy"],
        llm_max_length=hf_cfg.get("llm_max_length", 2048),
        llm_overrides=overrides or None,
    )
    norm_stats = hf_cfg.get("norm_stats") or {}
    stats_file = path / "dataset_statistics.json"
    if stats_file.exists():
        with open(stats_file) as f:
            norm_stats = {**norm_stats, **json.load(f)}  # the sidecar wins, key by key
    model = OpenVLA(cfg, norm_stats, dtype=dt, device=dev)
    if not load_weights:
        return model, None

    vit_ids = vit_mod.FUSED_BACKBONES.get(cfg.vision_backbone_id)
    if vit_ids:
        vit_depths = {"featurizer": vit_mod.VIT_CONFIGS[vit_ids[0]].depth,
                      "fused_featurizer": vit_mod.VIT_CONFIGS[vit_ids[1]].depth}
    else:
        vit_depths = {"featurizer": vit_mod.VIT_CONFIGS[cfg.vision_backbone_id].depth}
    quantize = "int4" if quantize_int4 else ("int8" if quantize_int8 else None)
    params = convert_hf_state_dict(iter_tensors(path), cfg.llm.n_layers, vit_depths, target_dtype=dt, device=dev,
                                   quantize=quantize, int4_group=int4_group or INT4_GROUP, int4_shards=int4_shards)
    check_loaded(model, params, quantized=quantize is not None)
    return model, params


def load(model_id_or_path: str, **kwargs):
    """VLM loader (reference load.py:52); VLA checkpoints are a superset, so
    this delegates (norm_stats stay empty for a pure VLM)."""
    return load_vla(model_id_or_path, **kwargs)
