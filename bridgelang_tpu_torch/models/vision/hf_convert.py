"""HF `transformers` vision checkpoints -> the port's ViT parameters.

Counterpart of bridgelang_tpu/models/vision/hf_convert.py: a
`Dinov2WithRegistersModel` (or `Dinov2Model`) or `SiglipVisionModel` state
dict (torch tensors, e.g. of a real `facebook/dinov2-*` / `google/siglip-*`
checkpoint) becomes the state dict of `models/vision/vit.ViT`:

  * nn.Linear [out, in] stays [out, in]; the separate q/k/v projections stack
    into one [3D, D] `qkv` weight (q rows, then k, then v).
  * HF DINOv2 adds a positional embedding to the CLS token; the port's ViT
    (timm `no_embed_class`) never does, so the CLS position folds into
    `cls_token`, in fp32 (exact: CLS always sits at the same position).
  * Only blocks 0..depth-2 are converted (the second-to-last feature tap
    never runs the final block); SigLIP's pooling head is dropped.
  * A checkpoint's patch grid other than the config's is resampled
    (`resample_pos_embed`), as timm does when it creates a model.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

from bridgelang_tpu_torch.models.vision.vit import ViTConfig


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic convolution kernel at a = -0.5, for x >= 0."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _resize_weights(m: int, n: int) -> torch.Tensor:
    """[m, n] fp32 weights taking m samples to n: `jax.image.resize`'s
    scale-and-translate matrix for "bicubic" with antialias (the kernel
    widened by the scale when it shrinks, columns normalized to sum 1)."""
    f32 = torch.float32
    inv_scale = torch.tensor(1.0 / (n / m), dtype=f32)  # JAX: scale n / m, then its inverse, in double
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample = (torch.arange(n, dtype=f32) + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(m, dtype=f32)[:, None]).abs() / kernel_scale
    w = _keys_cubic(x)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(f32).eps, w / torch.where(total != 0, total, 1.0),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= m - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resample_pos_embed(pos: torch.Tensor, target_len: int) -> torch.Tensor:
    """[1, P, D] square patch-grid pos embed -> [1, target_len, D], resampled
    bicubically in fp32 as the JAX package's `jax.image.resize(...,
    "bicubic", antialias=True)` (Keys a = -0.5; not torch's bicubic, which
    takes a = -0.75 and no antialias)."""
    p = pos.shape[1]
    side_old, side_new = int(round(p ** 0.5)), int(round(target_len ** 0.5))
    if side_old * side_old != p or side_new * side_new != target_len:
        raise ValueError(f"non-square pos embed resample {p}->{target_len}")
    grid = pos.float().reshape(side_old, side_old, -1)
    w = _resize_weights(side_old, side_new)
    out = torch.einsum("hwd,hH,wW->HWd", grid, w, w)
    return out.reshape(1, target_len, -1)


def _fit_pos_embed(pos: torch.Tensor, target_len: int) -> torch.Tensor:
    return pos if pos.shape[1] == target_len else resample_pos_embed(pos, target_len)


def _t(v) -> torch.Tensor:
    return torch.as_tensor(v).detach()


def convert_hf_dinov2(state_dict: Mapping[str, torch.Tensor], cfg: ViTConfig) -> Dict[str, torch.Tensor]:
    """`Dinov2WithRegistersModel` (or `Dinov2Model`, no registers) state dict
    -> the port's ViT state dict."""
    sd = {k: _t(v) for k, v in state_dict.items()}
    pos = sd["embeddings.position_embeddings"]  # [1, 1+P, D]
    out: Dict[str, torch.Tensor] = {
        "patch_embed.weight": sd["embeddings.patch_embeddings.projection.weight"],
        "patch_embed.bias": sd["embeddings.patch_embeddings.projection.bias"],
        # HF adds pos BEFORE inserting the registers; they get none, as in the port's prefix
        "cls_token": sd["embeddings.cls_token"].float() + pos[:, :1].float(),
        "pos_embed": _fit_pos_embed(pos[:, 1:], cfg.num_patches),
    }
    if cfg.num_reg_tokens:
        out["reg_tokens"] = sd["embeddings.register_tokens"]
    for i in range(cfg.depth - 1):
        b, o = f"encoder.layer.{i}.", f"blocks.{i}."
        att = b + "attention.attention."
        out[o + "norm1.weight"], out[o + "norm1.bias"] = sd[b + "norm1.weight"], sd[b + "norm1.bias"]
        out[o + "qkv.weight"] = torch.cat([sd[f"{att}{m}.weight"] for m in ("query", "key", "value")], dim=0)
        out[o + "qkv.bias"] = torch.cat([sd[f"{att}{m}.bias"] for m in ("query", "key", "value")])
        out[o + "proj.weight"] = sd[b + "attention.output.dense.weight"]
        out[o + "proj.bias"] = sd[b + "attention.output.dense.bias"]
        out[o + "ls1"] = sd[b + "layer_scale1.lambda1"]
        out[o + "norm2.weight"], out[o + "norm2.bias"] = sd[b + "norm2.weight"], sd[b + "norm2.bias"]
        for fc in ("fc1", "fc2"):
            out[o + f"mlp_{fc}.weight"], out[o + f"mlp_{fc}.bias"] = sd[b + f"mlp.{fc}.weight"], sd[b + f"mlp.{fc}.bias"]
        out[o + "ls2"] = sd[b + "layer_scale2.lambda1"]
    return out


def convert_hf_siglip(state_dict: Mapping[str, torch.Tensor], cfg: ViTConfig) -> Dict[str, torch.Tensor]:
    """`SiglipVisionModel` state dict -> the port's ViT state dict (no CLS;
    the attention-pooling head past the feature tap is dropped)."""
    sd = {k: _t(v) for k, v in state_dict.items()}
    prefix = "vision_model." if any(k.startswith("vision_model.") for k in sd) else ""
    e = prefix + "embeddings."
    out: Dict[str, torch.Tensor] = {
        "patch_embed.weight": sd[e + "patch_embedding.weight"],
        "patch_embed.bias": sd[e + "patch_embedding.bias"],
        "pos_embed": _fit_pos_embed(sd[e + "position_embedding.weight"][None], cfg.num_patches),  # [P, D] -> [1, P, D]
    }
    for i in range(cfg.depth - 1):
        b, o = f"{prefix}encoder.layers.{i}.", f"blocks.{i}."
        att = b + "self_attn."
        out[o + "norm1.weight"], out[o + "norm1.bias"] = sd[b + "layer_norm1.weight"], sd[b + "layer_norm1.bias"]
        out[o + "qkv.weight"] = torch.cat([sd[f"{att}{m}_proj.weight"] for m in ("q", "k", "v")], dim=0)
        out[o + "qkv.bias"] = torch.cat([sd[f"{att}{m}_proj.bias"] for m in ("q", "k", "v")])
        out[o + "proj.weight"], out[o + "proj.bias"] = sd[att + "out_proj.weight"], sd[att + "out_proj.bias"]
        out[o + "norm2.weight"], out[o + "norm2.bias"] = sd[b + "layer_norm2.weight"], sd[b + "layer_norm2.bias"]
        for fc in ("fc1", "fc2"):
            out[o + f"mlp_{fc}.weight"], out[o + f"mlp_{fc}.bias"] = sd[b + f"mlp.{fc}.weight"], sd[b + f"mlp.{fc}.bias"]
    return out
