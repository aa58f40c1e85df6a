"""Frame-level (observation) transforms on the host: resize and augment uint8
frames with numpy.

Counterpart of bridgelang_tpu/vla/datasets/rlds/obs_transforms.py, which
runs TensorFlow's image ops inside tf.data. Here each op is written out:

* `resize_lanczos3` is `tf.image.resize(x, size, method="lanczos3")` with
  antialias off (TF's scale_and_translate: a 3-lobe Lanczos kernel sampled at
  the input scale, each output's weights normalized to sum 1), applied tap
  by tap, columns first, as TF gathers them.
  `decode_and_resize` then rounds half to even and casts to uint8, as the
  JAX package does, except that the port saturates at 0 and 255: TF's cast
  wraps an overshooting value modulo 256 (255.6 rounds to 256 and becomes 0).
* `resize_bilinear` is TF's half-pixel-centre bilinear resize.
* The colour ops follow TF's kernels: brightness adds a delta, contrast
  scales about each channel's mean over H and W, saturation scales S and hue
  shifts H through TF's RGB <-> HSV formulas.

Augmentation (`augment`) runs the ops in `augment_order`, each a
deterministic function of a factor drawn first from an explicit
`torch.Generator` (`draw_augment_factors`); the draws cannot match TF's
stateless ones bit for bit, only their ranges. JPEG-encoded (string) frames
raise: the port has no image decoder yet.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

AUGMENT_OPS = ("random_resized_crop", "random_brightness", "random_contrast", "random_saturation", "random_hue")
_PI = np.float32(3.14159265359)  # TF's kPI
_LANCZOS3_RADIUS = np.float32(3.0)


def _lanczos3(x: np.ndarray) -> np.ndarray:
    x = np.abs(x).astype(np.float32)
    safe = np.where(x <= 1e-3, np.float32(1), x)
    value = _LANCZOS3_RADIUS * np.sin(_PI * safe) * np.sin(_PI * safe / _LANCZOS3_RADIUS) / (_PI * _PI * safe * safe)
    return np.where(x > _LANCZOS3_RADIUS, np.float32(0), np.where(x <= 1e-3, np.float32(1), value)).astype(np.float32)


@functools.lru_cache(maxsize=64)
def lanczos3_spans(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """TF's scale_and_translate spans along one axis (antialias off, no
    translation): each output's first input index [out] and its normalized
    weights [out, span] (zero past the input's end)."""
    scale = np.float32(out_size) / np.float32(in_size)
    inv_scale = np.float32(1.0) / scale
    span = min(2 * int(math.ceil(_LANCZOS3_RADIUS)) + 1, in_size)
    starts = np.zeros(out_size, np.int64)
    weights = np.zeros((out_size, span), np.float32)
    for x in range(out_size):
        sample = np.float32(x + 0.5) * inv_scale
        if sample < 0 or sample > in_size:
            continue
        start = int(math.ceil(sample - _LANCZOS3_RADIUS - np.float32(0.5)))
        end = int(math.floor(sample + _LANCZOS3_RADIUS - np.float32(0.5)))
        start = min(max(start, 0), in_size - 1)
        end = min(max(end, 0), in_size - 1) + 1
        w = _lanczos3(np.arange(start, end, dtype=np.float32) + np.float32(0.5) - sample)
        total = np.float32(w.sum(dtype=np.float32))
        if abs(total) >= 1000.0 * np.finfo(np.float32).tiny:
            weights[x, :end - start] = w * (np.float32(1.0) / total)
        starts[x] = start
    return starts, weights


@functools.lru_cache(maxsize=64)
def bilinear_spans(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """TF's bilinear resize with half-pixel centres (align_corners off) as
    2-tap spans: lower = max(floor(s), 0) with 1 - lerp, upper =
    min(ceil(s), in - 1) with lerp, s = (x + 0.5) in/out - 0.5."""
    scale = np.float32(in_size) / np.float32(out_size)
    starts = np.zeros(out_size, np.int64)
    weights = np.zeros((out_size, 2), np.float32)
    for x in range(out_size):
        s = (np.float32(x) + np.float32(0.5)) * scale - np.float32(0.5)
        s_floor = np.float32(math.floor(s))
        lower, upper = max(int(s_floor), 0), min(int(math.ceil(s)), in_size - 1)
        lerp = s - s_floor
        starts[x] = lower
        weights[x] = (np.float32(1) - lerp, lerp) if upper > lower else (np.float32(1), np.float32(0))
    return starts, weights


def _gather_axis(x: np.ndarray, starts: np.ndarray, weights: np.ndarray, axis: int) -> np.ndarray:
    """sum_k weights[:, k] * x[starts + k] along `axis`, tap by tap in float32
    (TF's GatherColumns / GatherRows order), with no BLAS call: the host
    pipeline runs this on several threads beside a training loop."""
    n_in = x.shape[axis]
    shape = [1] * x.ndim
    shape[axis] = len(starts)
    out = None
    for k in range(weights.shape[1]):
        tap = np.take(x, np.minimum(starts + k, n_in - 1), axis=axis)
        term = weights[:, k].reshape(shape) * tap
        out = term if out is None else np.add(out, term, out=out)
    return out


def _separable(image: np.ndarray, size: Tuple[int, int], spans_fn) -> np.ndarray:
    """[H, W, C] float32 -> [h, w, C]: the width axis, then the height, as TF does."""
    h_in, w_in, _ = image.shape
    cols = _gather_axis(image, *spans_fn(w_in, size[1]), axis=1)
    return _gather_axis(cols, *spans_fn(h_in, size[0]), axis=0)


def resize_lanczos3(image: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """float32 [H, W, C] -> float32 [size[0], size[1], C]."""
    return _separable(np.asarray(image, np.float32), tuple(size), lanczos3_spans)


def resize_bilinear(image: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    return _separable(np.asarray(image, np.float32), tuple(size), bilinear_spans)


# --- colour ops (float images in [0, 1], TF's kernels) ------------------------


def adjust_brightness(image: np.ndarray, delta: float) -> np.ndarray:
    return (image + np.float32(delta)).astype(np.float32)


def adjust_contrast(image: np.ndarray, factor: float) -> np.ndarray:
    mean = image.mean(axis=(0, 1), keepdims=True, dtype=np.float32)
    return ((image - mean) * np.float32(factor) + mean).astype(np.float32)


def _rgb_to_hsv(image: np.ndarray):
    """TF's adjust_saturation RGB -> HSV (h in [0, 1))."""
    r, g, b = image[..., 0], image[..., 1], image[..., 2]
    v = np.maximum(r, np.maximum(g, b))
    rng = v - np.minimum(r, np.minimum(g, b))
    s = np.where(v > 0, rng / np.where(v > 0, v, 1), np.float32(0))
    with np.errstate(divide="ignore", invalid="ignore"):
        norm = np.float32(1.0) / (np.float32(6.0) * rng)
        h = np.where(r == v, norm * (g - b),
                     np.where(g == v, norm * (b - r) + np.float32(2.0 / 6.0), norm * (r - g) + np.float32(4.0 / 6.0)))
    h = np.where(rng <= 0, np.float32(0), h)
    h = np.where(h < 0, h + 1, h)
    return h.astype(np.float32), s.astype(np.float32), v


def _hsv_to_rgb(h: np.ndarray, s: np.ndarray, v: np.ndarray) -> np.ndarray:
    c = s * v
    m = v - c
    dh = h * np.float32(6)
    category = np.trunc(dh).astype(np.int32)
    fmodu = np.mod(dh, np.float32(2))  # TF folds into (0, 2) by adding or subtracting 2
    fmodu = np.where(fmodu <= 0, fmodu + 2, fmodu)
    x = c * (1 - np.abs(fmodu - 1))
    zero = np.zeros_like(c)
    table = [(c, x, zero), (x, c, zero), (zero, c, x), (zero, x, c), (x, zero, c), (c, zero, x)]
    rgb = [np.select([category == i for i in range(6)], [t[ch] for t in table], zero) for ch in range(3)]
    return (np.stack(rgb, axis=-1) + m[..., None]).astype(np.float32)


def adjust_saturation(image: np.ndarray, factor: float) -> np.ndarray:
    h, s, v = _rgb_to_hsv(image)
    return _hsv_to_rgb(h, np.clip(s * np.float32(factor), 0.0, 1.0).astype(np.float32), v)


def adjust_hue(image: np.ndarray, delta: float) -> np.ndarray:
    """TF's hue kernel: RGB -> (hue in [0, 6), v_min, v_max), hue + 6 delta
    folded into [0, 6), then back."""
    r, g, b = image[..., 0], image[..., 1], image[..., 2]
    v_max = np.maximum(r, np.maximum(g, b))
    v_min = np.minimum(r, np.minimum(g, b))
    # the middle channel and the hue sextant, by the channels' order (TF's rgb_to_hv_range)
    conds = [(r < g) & (b < r), (r < g) & (b > g), (r < g) & ~(b < r) & ~(b > g),
             ~(r < g) & (b < g), ~(r < g) & (b > r), ~(r < g) & ~(b < g) & ~(b > r)]
    category = np.select(conds, [1, 3, 2, 0, 4, 5]).astype(np.int32)
    v_mid = np.select(conds, [r, g, b, g, r, b])
    span = v_max - v_min
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = (v_mid - v_min) / span
    increase = (category & 1) == 0
    h = np.where(span == 0, np.float32(0), category.astype(np.float32) + np.where(increase, ratio, 1 - ratio))
    h = h.astype(np.float32) + np.float32(delta) * np.float32(6)
    h = np.where(h < 0, h + 6, h)
    h = np.where(h >= 6, h - 6, h).astype(np.float32)
    cat = np.trunc(h).astype(np.int32)
    frac = h - cat
    frac = np.where((cat & 1) == 0, frac, 1 - frac)
    mid = v_min + frac * (v_max - v_min)
    table = [(v_max, mid, v_min), (mid, v_max, v_min), (v_min, v_max, mid),
             (v_min, mid, v_max), (mid, v_min, v_max), (v_max, v_min, mid)]
    rgb = [np.select([cat == i for i in range(5)], [t[ch] for t in table[:5]], table[5][ch]) for ch in range(3)]
    return np.stack(rgb, axis=-1).astype(np.float32)


# --- augmentation ----------------------------------------------------------------


def _uniform(generator: torch.Generator, lo: float, hi: float) -> float:
    return lo + (hi - lo) * float(torch.rand((), generator=generator, dtype=torch.float64))


def draw_augment_factors(generator: torch.Generator, shape: Tuple[int, int], **kwargs: Any) -> Dict[str, Any]:
    """The random factors of one frame's augmentation, drawn from
    `generator` in `augment_order`, with the JAX package's ranges: the crop's
    size (area scale x H x W at an aspect ratio, rounded) and offset, the
    brightness and hue deltas, the contrast and saturation factors."""
    factors: Dict[str, Any] = {}
    h, w = shape
    for op in kwargs.get("augment_order", []):
        if op == "random_resized_crop":
            rrc = kwargs["random_resized_crop"]
            scale, ratio = rrc.get("scale", [0.9, 0.9]), rrc.get("ratio", [1.0, 1.0])
            area = _uniform(generator, *scale) * h * w
            aspect = _uniform(generator, *ratio)
            ch = min(int(round(math.sqrt(area / aspect))), h)
            cw = min(int(round(math.sqrt(area * aspect))), w)
            top = int(torch.randint(h - ch + 1, (), generator=generator))
            left = int(torch.randint(w - cw + 1, (), generator=generator))
            factors[op] = (top, left, ch, cw)
        elif op == "random_brightness":
            d = kwargs[op][0]
            factors[op] = _uniform(generator, -d, d)
        elif op in ("random_contrast", "random_saturation"):
            factors[op] = _uniform(generator, *kwargs[op])
        elif op == "random_hue":
            d = kwargs[op][0]
            factors[op] = _uniform(generator, -d, d)
        else:
            raise ValueError(f"Unknown augmentation op {op!r}")
    return factors


def augment_image(image: np.ndarray, factors: Mapping[str, Any], augment_order) -> np.ndarray:
    """uint8 [H, W, 3] -> uint8: the ops of `augment_order` at the drawn
    `factors` on the image in [0, 1], then clip and truncate to uint8, as the
    JAX package's `_augment_image` casts."""
    x = np.asarray(image, np.float32) / np.float32(255.0) if image.dtype == np.uint8 else np.asarray(image, np.float32)
    for op in augment_order:
        f = factors[op]
        if op == "random_resized_crop":
            top, left, ch, cw = f
            x = resize_bilinear(x[top:top + ch, left:left + cw], x.shape[:2])
        elif op == "random_brightness":
            x = adjust_brightness(x, f)
        elif op == "random_contrast":
            x = adjust_contrast(x, f)
        elif op == "random_saturation":
            x = adjust_saturation(x, f)
        elif op == "random_hue":
            x = adjust_hue(x, f)
        else:
            raise ValueError(f"Unknown augmentation op {op!r}")
    return (np.clip(x, 0.0, 1.0) * np.float32(255.0)).astype(np.uint8)


def augment(obs: Dict[str, Any], generator: torch.Generator,
            augment_kwargs: Union[Mapping, Dict[str, Mapping]]) -> Dict[str, Any]:
    """Augment every image_* key of one frame (per-name kwargs allowed), in
    sorted name order, each with its own draws from `generator`."""
    image_names = {k[len("image_"):] for k in obs if k.startswith("image_")}
    if not isinstance(augment_kwargs, Mapping) or (augment_kwargs and "augment_order" not in augment_kwargs):
        per_name = dict(augment_kwargs)
    else:
        per_name = {name: augment_kwargs for name in image_names}
    obs = dict(obs)
    for name in sorted(image_names):
        if name not in per_name:
            continue
        key = f"image_{name}"
        kw = per_name[name]
        factors = draw_augment_factors(generator, obs[key].shape[:2], **kw)
        obs[key] = augment_image(obs[key], factors, kw.get("augment_order", []))
    return obs


def decode_and_resize(
    obs: Dict[str, Any],
    resize_size: Union[Optional[Tuple[int, int]], Dict[str, Tuple[int, int]]],
    depth_resize_size: Union[Optional[Tuple[int, int]], Dict[str, Tuple[int, int]]] = None,
) -> Dict[str, Any]:
    """One frame's image_* (uint8 [H, W, 3]) and depth_* (float [H, W]) keys
    resized; an empty string (a padding camera) becomes a zero image of the
    target size. Images: lanczos3, rounded half to even, saturated to uint8.
    Depth: bilinear. Encoded (string) frames raise: the port has no JPEG
    decoder; reading TFDS datasets waits for one."""
    image_names = {k[len("image_"):] for k in obs if k.startswith("image_")}
    depth_names = {k[len("depth_"):] for k in obs if k.startswith("depth_")}
    if isinstance(resize_size, tuple) or resize_size is None:
        resize_size = {name: resize_size for name in image_names}
    if isinstance(depth_resize_size, tuple) or depth_resize_size is None:
        depth_resize_size = {name: depth_resize_size for name in depth_names}
    obs = dict(obs)
    for name in image_names:
        key = f"image_{name}"
        image = np.asarray(obs[key])
        size = resize_size.get(name)
        if image.dtype.kind in "SUO":
            if _is_empty(image):
                obs[key] = np.zeros((*(size or (1, 1)), 3), np.uint8)
                continue
            raise NotImplementedError(f"{key}: encoded (JPEG/PNG) frames need an image decoder, which the port "
                                      "does not have yet (ROADMAP.md: TFDS/RLDS reading without TF)")
        if image.dtype != np.uint8:
            raise ValueError(f"Unsupported image dtype {image.dtype} for {key}")
        if size is not None:
            image = np.clip(np.round(resize_lanczos3(image, size)), 0, 255).astype(np.uint8)
        obs[key] = image
    for name in depth_names:
        key = f"depth_{name}"
        depth = np.asarray(obs[key])
        size = depth_resize_size.get(name)
        if depth.dtype.kind in "SUO":
            if _is_empty(depth):
                obs[key] = np.zeros(size or (1, 1), np.float32)
                continue
            raise NotImplementedError(f"{key}: encoded depth frames need an image decoder, which the port "
                                      "does not have yet")
        if size is not None:
            depth = resize_bilinear(depth[..., None], size)[..., 0]
        obs[key] = depth
    return obs


def _is_empty(x: np.ndarray) -> bool:
    return len(x.item() if x.ndim == 0 else x.flat[0]) == 0
