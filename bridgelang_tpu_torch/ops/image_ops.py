"""Image preprocessing on the device, in torch.

Counterpart of bridgelang_tpu/ops/image_ops.py: per tower Resize ->
(CenterCrop | letterbox pad) -> Normalize, towers stacked on channels into
[B, n_towers * 3, size, size]. Runs batched on whatever device the frames
are on.

Resize parity: `jax.image.resize(method="bicubic", antialias=True)` matches
`F.interpolate(mode="bicubic", antialias=True, align_corners=False)` (the
Keys kernel with A = -0.5). `antialias=True` is passed even when upsampling:
without it torch upsamples with A = -0.75.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

IMAGENET_DEFAULT_MEAN = (0.485, 0.456, 0.406)
IMAGENET_DEFAULT_STD = (0.229, 0.224, 0.225)
OPENAI_CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
INCEPTION_MEAN = (0.5, 0.5, 0.5)  # SigLIP
INCEPTION_STD = (0.5, 0.5, 0.5)


@dataclasses.dataclass(frozen=True)
class ImageTowerSpec:
    """One vision tower's preprocessing: target size + normalization."""

    size: int = 224
    mean: Tuple[float, float, float] = INCEPTION_MEAN
    std: Tuple[float, float, float] = INCEPTION_STD
    interpolation: str = "bicubic"


@dataclasses.dataclass(frozen=True)
class ImageTransformConfig:
    """Resize strategy + one spec per (fused) tower.

      resize-naive : resize directly to (size, size)
      resize-crop  : resize shortest side to size, then center crop
      letterbox    : pad to square with per-tower mean fill, then resize
    """

    strategy: str = "resize-naive"
    towers: Tuple[ImageTowerSpec, ...] = (ImageTowerSpec(),)

    @property
    def num_towers(self) -> int:
        return len(self.towers)


TOWER_SPECS: Dict[str, ImageTowerSpec] = {
    "dinov2": ImageTowerSpec(224, IMAGENET_DEFAULT_MEAN, IMAGENET_DEFAULT_STD),
    "siglip": ImageTowerSpec(224, INCEPTION_MEAN, INCEPTION_STD),
    "siglip-384": ImageTowerSpec(384, INCEPTION_MEAN, INCEPTION_STD),
    "clip": ImageTowerSpec(224, OPENAI_CLIP_MEAN, OPENAI_CLIP_STD),
    "clip-336": ImageTowerSpec(336, OPENAI_CLIP_MEAN, OPENAI_CLIP_STD),
    "in1k": ImageTowerSpec(224, IMAGENET_DEFAULT_MEAN, IMAGENET_DEFAULT_STD),
}


def resize(img: torch.Tensor, out_hw: Tuple[int, int], method: str = "bicubic") -> torch.Tensor:
    """Antialiased resize of a [B, C, H, W] float image (values in [0, 1])."""
    return F.interpolate(img, size=tuple(out_hw), mode=method, antialias=True, align_corners=False)


def resize_shortest_side(img: torch.Tensor, size: int, method: str = "bicubic") -> torch.Tensor:
    """torchvision Resize(int): shortest side to `size`, aspect preserved."""
    h, w = img.shape[-2], img.shape[-1]
    if h <= w:
        new_h, new_w = size, max(1, int(round(w * size / h)))
    else:
        new_h, new_w = max(1, int(round(h * size / w))), size
    return resize(img, (new_h, new_w), method)


def center_crop(img: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """torchvision CenterCrop (pads with zeros if the image is smaller)."""
    h, w = img.shape[-2], img.shape[-1]
    th, tw = out_hw
    if h < th or w < tw:
        ph, pw = max(th - h, 0), max(tw - w, 0)
        img = F.pad(img, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
        h, w = img.shape[-2], img.shape[-1]
    top = int(round((h - th) / 2.0))
    left = int(round((w - tw) / 2.0))
    return img[..., top : top + th, left : left + tw]


def letterbox_pad(img: torch.Tensor, fill: Sequence[float]) -> torch.Tensor:
    """Pad to square with a per-channel constant fill: int((max - d) / 2) per
    side, under-padding by one pixel on odd deltas like TVF.pad."""
    h, w = img.shape[-2], img.shape[-1]
    max_wh = max(h, w)
    ph, pw = int((max_wh - h) / 2), int((max_wh - w) / 2)
    if ph == 0 and pw == 0:
        return img
    fill_t = torch.as_tensor(fill, dtype=img.dtype, device=img.device)[:, None, None]
    out = fill_t.expand(img.shape[0], img.shape[1], h + 2 * ph, w + 2 * pw).clone()
    out[..., ph : ph + h, pw : pw + w] = img
    return out


def normalize(img: torch.Tensor, mean: Sequence[float], std: Sequence[float]) -> torch.Tensor:
    mean_t = torch.as_tensor(mean, dtype=img.dtype, device=img.device)[:, None, None]
    std_t = torch.as_tensor(std, dtype=img.dtype, device=img.device)[:, None, None]
    return (img - mean_t) / std_t


def _transform_one_tower(img01: torch.Tensor, spec: ImageTowerSpec, strategy: str) -> torch.Tensor:
    if strategy == "resize-naive":
        out = resize(img01, (spec.size, spec.size), spec.interpolation)
    elif strategy == "resize-crop":
        out = center_crop(resize_shortest_side(img01, spec.size, spec.interpolation), (spec.size, spec.size))
    elif strategy == "letterbox":
        out = resize(letterbox_pad(img01, spec.mean), (spec.size, spec.size), spec.interpolation)
    else:
        raise ValueError(f"Unknown image resize strategy {strategy!r}")
    return normalize(out, spec.mean, spec.std)


def preprocess_batch(
    images_u8: torch.Tensor,
    config: ImageTransformConfig,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """[B, H, W, 3] uint8 -> [B, num_towers * 3, size, size] in `dtype`,
    on the frames' device."""
    img01 = images_u8.permute(0, 3, 1, 2).float() / 255.0
    towers = [_transform_one_tower(img01, spec, config.strategy) for spec in config.towers]
    return torch.cat(towers, dim=1).to(dtype)


def transform_config_for_backbone(vision_backbone_id: str, image_resize_strategy: str) -> ImageTransformConfig:
    """Registered vision backbone id -> its transform config."""
    table: Dict[str, Tuple[ImageTowerSpec, ...]] = {
        "clip-vit-l": (TOWER_SPECS["clip"],),
        "clip-vit-l-336px": (TOWER_SPECS["clip-336"],),
        "siglip-vit-so400m": (TOWER_SPECS["siglip"],),
        "siglip-vit-so400m-384px": (TOWER_SPECS["siglip-384"],),
        "dinov2-vit-l": (TOWER_SPECS["dinov2"],),
        "in1k-vit-l": (TOWER_SPECS["in1k"],),
        "clip-vit-b": (TOWER_SPECS["clip"],),
        "siglip-vit-b16-224px": (TOWER_SPECS["siglip"],),
        "siglip-vit-b16-256px": (dataclasses.replace(TOWER_SPECS["siglip"], size=256),),
        "siglip-vit-b16-384px": (TOWER_SPECS["siglip-384"],),
        "dinoclip-vit-l-336px": (
            dataclasses.replace(TOWER_SPECS["dinov2"], size=336),
            TOWER_SPECS["clip-336"],
        ),
        "dinosiglip-vit-so-224px": (TOWER_SPECS["dinov2"], TOWER_SPECS["siglip"]),
        "dinosiglip-vit-so-384px": (
            dataclasses.replace(TOWER_SPECS["dinov2"], size=384),
            TOWER_SPECS["siglip-384"],
        ),
    }
    if vision_backbone_id not in table:
        raise KeyError(f"Unknown vision backbone {vision_backbone_id!r}")
    return ImageTransformConfig(strategy=image_resize_strategy, towers=table[vision_backbone_id])


def frames_to_tensor(frames: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host uint8 [B, H, W, 3] frames -> a tensor on `device`."""
    return torch.from_numpy(np.ascontiguousarray(frames, dtype=np.uint8)).to(device)
