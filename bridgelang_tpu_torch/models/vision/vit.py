"""Vision Transformer backbones (DINOv2 / SigLIP / CLIP / IN1K) as nn.Modules.

Counterpart of bridgelang_tpu/models/vision/vit.py with the same feature
contract: patch tokens from block `depth - 2` (the Prismatic tap),
un-normalized, prefix tokens stripped. Only the blocks up to the tap are
built. Blocks are an `nn.ModuleList` (the JAX package scans over stacked
block parameters; `convert.params_from_jax` unstacks them).

Attention is plain torch: scores in fp32, fp32 softmax, probabilities cast
back to the value dtype, as `jax.nn.dot_product_attention` computes it.

`PrismaticVLM` builds these modules on the `meta` device and runs them with
`torch.func.functional_call` over a parameter dict, so the module holds no
weights of its own; `init_vision_params` draws that dict.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 14
    width: int = 1024
    depth: int = 24
    num_heads: int = 16
    mlp_dim: int = 4096
    use_cls_token: bool = True
    num_reg_tokens: int = 0
    # timm `no_embed_class`: pos embed covers patch tokens only (DINOv2 style)
    no_embed_class: bool = False
    layerscale_init: Optional[float] = None
    act: str = "gelu"  # "gelu" (exact) | "gelu_tanh" (SigLIP) | "quick_gelu" (CLIP)
    pre_norm: bool = False
    ln_eps: float = 1e-6

    @property
    def grid_size(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid_size * self.grid_size

    @property
    def num_prefix_tokens(self) -> int:
        return (1 if self.use_cls_token else 0) + self.num_reg_tokens

    @property
    def head_dim(self) -> int:
        return self.width // self.num_heads


VIT_CONFIGS: Dict[str, ViTConfig] = {
    "dinov2-vit-l": ViTConfig(
        image_size=224, patch_size=14, width=1024, depth=24, num_heads=16, mlp_dim=4096,
        use_cls_token=True, num_reg_tokens=4, no_embed_class=True, layerscale_init=1e-5,
    ),
    "siglip-vit-so400m": ViTConfig(
        image_size=224, patch_size=14, width=1152, depth=27, num_heads=16, mlp_dim=4304,
        use_cls_token=False, act="gelu_tanh",
    ),
    "siglip-vit-so400m-384px": ViTConfig(
        image_size=384, patch_size=14, width=1152, depth=27, num_heads=16, mlp_dim=4304,
        use_cls_token=False, act="gelu_tanh",
    ),
    "clip-vit-l": ViTConfig(
        image_size=224, patch_size=14, width=1024, depth=24, num_heads=16, mlp_dim=4096,
        use_cls_token=True, act="quick_gelu", pre_norm=True, ln_eps=1e-5,
    ),
    "clip-vit-l-336px": ViTConfig(
        image_size=336, patch_size=14, width=1024, depth=24, num_heads=16, mlp_dim=4096,
        use_cls_token=True, act="quick_gelu", pre_norm=True, ln_eps=1e-5,
    ),
    "in1k-vit-l": ViTConfig(
        image_size=224, patch_size=16, width=1024, depth=24, num_heads=16, mlp_dim=4096,
        use_cls_token=True,
    ),
    "clip-vit-b": ViTConfig(
        image_size=224, patch_size=16, width=768, depth=12, num_heads=12, mlp_dim=3072,
        use_cls_token=True, act="quick_gelu", pre_norm=True, ln_eps=1e-5,
    ),
    "siglip-vit-b16-224px": ViTConfig(
        image_size=224, patch_size=16, width=768, depth=12, num_heads=12, mlp_dim=3072,
        use_cls_token=False, act="gelu_tanh",
    ),
    "siglip-vit-b16-256px": ViTConfig(
        image_size=256, patch_size=16, width=768, depth=12, num_heads=12, mlp_dim=3072,
        use_cls_token=False, act="gelu_tanh",
    ),
    "siglip-vit-b16-384px": ViTConfig(
        image_size=384, patch_size=16, width=768, depth=12, num_heads=12, mlp_dim=3072,
        use_cls_token=False, act="gelu_tanh",
    ),
}


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "gelu":
        return F.gelu(x)
    if name == "gelu_tanh":
        return F.gelu(x, approximate="tanh")
    if name == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    raise ValueError(f"Unknown activation {name!r}")


class ViTBlock(nn.Module):
    """Pre-norm transformer block: x += ls1*attn(ln1 x); x += ls2*mlp(ln2 x)."""

    def __init__(self, cfg: ViTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        w = cfg.width
        self.norm1 = nn.LayerNorm(w, eps=cfg.ln_eps, device=device)
        self.qkv = nn.Linear(w, 3 * w, device=device)
        self.proj = nn.Linear(w, w, device=device)
        self.norm2 = nn.LayerNorm(w, eps=cfg.ln_eps, device=device)
        self.mlp_fc1 = nn.Linear(w, cfg.mlp_dim, device=device)
        self.mlp_fc2 = nn.Linear(cfg.mlp_dim, w, device=device)
        if cfg.layerscale_init is not None:
            self.ls1 = nn.Parameter(torch.empty(w, device=device))
            self.ls2 = nn.Parameter(torch.empty(w, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        b, t, _ = x.shape
        y = self.norm1(x)
        q, k, v = self.qkv(y).view(b, t, 3, cfg.num_heads, cfg.head_dim).unbind(dim=2)
        logits = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * (1.0 / math.sqrt(cfg.head_dim))
        probs = torch.softmax(logits, dim=-1).to(v.dtype)  # bidirectional, fp32 softmax
        attn = torch.einsum("bhts,bshd->bthd", probs, v).reshape(b, t, cfg.width)
        y = self.proj(attn)
        if cfg.layerscale_init is not None:
            y = y * self.ls1
        x = x + y
        y = self.mlp_fc2(_act(cfg.act, self.mlp_fc1(self.norm2(x))))
        if cfg.layerscale_init is not None:
            y = y * self.ls2
        return x + y


class ViT(nn.Module):
    """Generic ViT featurizer: [B, 3, H, W] -> [B, num_patches, width], the
    patch features after block `depth - 2` (blocks 0..depth-2 are built)."""

    def __init__(self, cfg: ViTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        if cfg.depth < 2:
            raise ValueError(f"the depth-2 feature tap needs depth >= 2, got {cfg.depth}")
        w = cfg.width
        self.patch_embed = nn.Conv2d(3, w, cfg.patch_size, stride=cfg.patch_size, device=device)
        n_pos = cfg.num_patches + (0 if cfg.no_embed_class else (1 if cfg.use_cls_token else 0))
        self.pos_embed = nn.Parameter(torch.empty(1, n_pos, w, device=device))
        if cfg.use_cls_token:
            self.cls_token = nn.Parameter(torch.empty(1, 1, w, device=device))
        if cfg.num_reg_tokens:
            self.reg_tokens = nn.Parameter(torch.empty(1, cfg.num_reg_tokens, w, device=device))
        if cfg.pre_norm:
            self.norm_pre = nn.LayerNorm(w, eps=cfg.ln_eps, device=device)
        self.blocks = nn.ModuleList([ViTBlock(cfg, device=device) for _ in range(cfg.depth - 1)])

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = self.patch_embed(pixel_values.to(self.pos_embed.dtype))  # [B, D, gh, gw]
        b = x.shape[0]
        x = x.flatten(2).transpose(1, 2)  # [B, P, D], row-major over the grid
        prefix = []
        if cfg.use_cls_token:
            prefix.append(self.cls_token.expand(b, 1, cfg.width))
        if cfg.num_reg_tokens:
            prefix.append(self.reg_tokens.expand(b, cfg.num_reg_tokens, cfg.width))
        if cfg.no_embed_class:
            x = x + self.pos_embed  # DINOv2: pos embed on patches, prefix after
            x = torch.cat(prefix + [x], dim=1) if prefix else x
        else:
            x = torch.cat(prefix + [x], dim=1) if prefix else x
            x = x + self.pos_embed
        if cfg.pre_norm:
            x = self.norm_pre(x)
        for blk in self.blocks:
            x = blk(x)
        return x[:, cfg.num_prefix_tokens :, :]


class FusedViT(nn.Module):
    """Dual tower (DINOv2 + SigLIP / DINOv2 + CLIP): [B, 6, H, W] -> split the
    channel-stacked input, run both towers, concat on the embedding dim."""

    def __init__(self, cfg_a: ViTConfig, cfg_b: ViTConfig, device=None):
        super().__init__()
        self.cfg_a, self.cfg_b = cfg_a, cfg_b
        self.featurizer = ViT(cfg_a, device=device)
        self.fused_featurizer = ViT(cfg_b, device=device)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        feat_a = self.featurizer(pixel_values[:, :3])
        feat_b = self.fused_featurizer(pixel_values[:, 3:])
        return torch.cat([feat_a, feat_b], dim=2)


FUSED_BACKBONES: Dict[str, Tuple[str, str]] = {
    "dinosiglip-vit-so-224px": ("dinov2-vit-l", "siglip-vit-so400m"),
    "dinosiglip-vit-so-384px": ("dinov2-vit-l", "siglip-vit-so400m-384px"),
    "dinoclip-vit-l-336px": ("dinov2-vit-l", "clip-vit-l-336px"),
}


def build_vision_backbone(vision_backbone_id: str, device=None) -> Tuple[nn.Module, int, int]:
    """Return (module, embed_dim, num_patches) for a registered backbone id."""
    if vision_backbone_id in FUSED_BACKBONES:
        id_a, id_b = FUSED_BACKBONES[vision_backbone_id]
        cfg_a, cfg_b = VIT_CONFIGS[id_a], VIT_CONFIGS[id_b]
        if vision_backbone_id.endswith("384px"):
            cfg_a = dataclasses.replace(cfg_a, image_size=384)
        if vision_backbone_id.endswith("336px") and id_a == "dinov2-vit-l":
            cfg_a = dataclasses.replace(cfg_a, image_size=336)
        assert cfg_a.num_patches == cfg_b.num_patches, "fused towers must emit equal patch counts"
        return FusedViT(cfg_a, cfg_b, device=device), cfg_a.width + cfg_b.width, cfg_a.num_patches
    if vision_backbone_id not in VIT_CONFIGS:
        raise KeyError(f"Unknown vision backbone {vision_backbone_id!r}")
    cfg = VIT_CONFIGS[vision_backbone_id]
    return ViT(cfg, device=device), cfg.width, cfg.num_patches


def init_vision_params(
    module: nn.Module, generator: torch.Generator, dtype: torch.dtype, device: torch.device,
) -> Dict[str, torch.Tensor]:
    """Random parameters for a (meta) ViT / FusedViT, drawn on `device`:
    dense and patch kernels normal * fan_in^-0.5, pos_embed normal * 0.02,
    biases, cls and register tokens zero, norms one, LayerScale at its init."""
    out: Dict[str, torch.Tensor] = {}
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        owner = module.get_submodule(name.rsplit(".", 1)[0]) if "." in name else module
        if isinstance(owner, nn.LayerNorm):
            t = torch.ones(p.shape, device=device, dtype=dtype) if leaf == "weight" else torch.zeros(p.shape, device=device, dtype=dtype)
        elif leaf == "weight":
            fan_in = math.prod(p.shape[1:])
            t = torch.randn(p.shape, generator=generator, device=device, dtype=dtype).mul_(fan_in ** -0.5)
        elif leaf == "pos_embed":
            t = torch.randn(p.shape, generator=generator, device=device, dtype=dtype).mul_(0.02)
        elif leaf in ("ls1", "ls2"):
            t = torch.full(p.shape, owner.cfg.layerscale_init, device=device, dtype=dtype)
        else:  # biases, cls_token, reg_tokens
            t = torch.zeros(p.shape, device=device, dtype=dtype)
        out[name] = t
    return out
