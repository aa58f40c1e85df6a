"""The port's PIL-equal image reader (bridgelang_tpu_torch/native/image.py:
`open_rgb`, `resize_bicubic_pil`, `load_image`, and `decode_jpeg` with the
accurate integer IDCT) against Pillow and TensorFlow, on the CPU.

Every comparison is bit-equal (tolerance 0):
* `open_rgb(f)` against np.asarray(Image.open(f).convert("RGB")): every
  committed fixture (and its manifest hash, so that a stale manifest fails),
  JPEGs encoded here (4:2:0, 4:2:2, 4:4:4, progressive, restart markers,
  gray; 1x1, odd sizes, 640x480), PNGs in every mode the reader handles
  (1-, 2-, 4-, 8-bit gray, gray with tRNS, gray+alpha, palette of 1 to 8
  bits with and without tRNS, RGB with and without tRNS, RGBA, 16-bit gray,
  gray+alpha, RGB and RGBA, Adam7).
* `resize_bicubic_pil` against Image.resize up and down, square and not,
  one side unchanged (PIL runs only the pass whose size changes), 1x1.
* `load_image` against the pretraining datasets' PIL read, at 224.
* `decode_jpeg(dct_method="INTEGER_ACCURATE")` against
  tf.io.decode_jpeg(dct_method="INTEGER_ACCURATE"), and the default fast
  path still against tf.io.decode_image.
* BMP, WebP and CMYK JPEGs raise ValueError naming what they are; a GIF reads
  as PIL reads it (its first frame).
"""

import hashlib
import io
import json
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest
import tensorflow as tf
from PIL import Image

from bridgelang_tpu_torch.native import image as im

FIXTURES = Path(__file__).resolve().parent / "data" / "images"
MANIFEST = json.loads((FIXTURES / "manifest.json").read_text())
JPEG_FIXTURES = sorted(n for n in MANIFEST if n.endswith(".jpg"))


def _pil_rgb(data: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as img:
        return np.asarray(img.convert("RGB"))


def _assert_same(got, want, label=""):
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape, (label, got.shape, want.shape)
    if not np.array_equal(got, want):
        d = np.abs(got.astype(np.int64) - want.astype(np.int64))
        raise AssertionError(f"{label}: max |diff| {d.max()}, {(d > 0).mean():.4%} of the samples differ")


def _frame(h, w, seed):
    """A smooth frame with noise (JPEG-like content), from a seed."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([128 + 80 * np.sin(xx / (5 + 3 * c) + rng.uniform(0, 6)) * np.cos(yy / (7 + 2 * c))
                     for c in range(3)], -1)
    return np.clip(base + rng.normal(0, 12, (h, w, 3)), 0, 255).astype(np.uint8)


def _pil_encode(arr, fmt, **kw) -> bytes:
    buf = io.BytesIO()
    (arr if isinstance(arr, Image.Image) else Image.fromarray(arr)).save(buf, fmt, **kw)
    return buf.getvalue()


def _png(samples: np.ndarray, color: int, depth: int, plte=None, trns=None, filters=(0, 1, 2, 4)) -> bytes:
    """A PNG of raw samples [H, W, C] (values below 2^depth) in any color
    type and bit depth, rows filtered None / Sub / Up / Paeth in turn."""
    h, w, c = samples.shape
    if depth < 8:
        per = 8 // depth
        padded = np.zeros((h, -(-w // per) * per), np.uint8)
        padded[:, :w] = samples[..., 0]
        packed = np.zeros((h, padded.shape[1] // per), np.uint8)
        for i in range(per):
            packed |= (padded[:, i::per] << (8 - depth * (i + 1))).astype(np.uint8)
        rows, bpp = packed, 1
    elif depth == 8:
        rows, bpp = samples.astype(np.uint8).reshape(h, w * c), c
    else:
        rows, bpp = samples.astype(">u2").view(np.uint8).reshape(h, w * c * 2), 2 * c
    raw = bytearray()
    prev = np.zeros(rows.shape[1], np.int64)
    for r, row in enumerate(rows.astype(np.int64)):
        kind = filters[r % len(filters)]
        left = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if kind == 0:
            pred = np.zeros_like(row)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prev
        else:
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        raw += bytes([kind]) + ((row - pred) % 256).astype(np.uint8).tobytes()
        prev = row

    def chunk(kind: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0))
    if plte is not None:
        out += chunk(b"PLTE", np.asarray(plte, np.uint8).tobytes())
    if trns is not None:
        out += chunk(b"tRNS", trns)
    return out + chunk(b"IDAT", zlib.compress(bytes(raw), 6)) + chunk(b"IEND", b"")


# --- open_rgb ------------------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(MANIFEST))
def test_open_rgb_fixture_matches_pil_and_manifest(name):
    data = (FIXTURES / name).read_bytes()
    want = _pil_rgb(data)
    got = im.open_rgb(FIXTURES / name)
    _assert_same(got, want, name)
    assert hashlib.sha256(want.tobytes()).hexdigest() == MANIFEST[name]["sha256_pil_rgb"], "stale manifest"
    _assert_same(im.open_rgb(data), want, f"{name} from bytes")


JPEG_CASES = {
    "420_q90_640x480": ((480, 640), dict(quality=90)),
    "420_q75_1x1": ((1, 1), dict(quality=75)),
    "420_q95_7x9": ((7, 9), dict(quality=95)),
    "422_q90_61x83": ((61, 83), dict(quality=90, subsampling=1)),
    "444_q100_61x83": ((61, 83), dict(quality=100, subsampling=0)),
    "444_q50_33x17": ((33, 17), dict(quality=50, subsampling=0)),
    "progressive_q85_97x131": ((97, 131), dict(quality=85, progressive=True)),
    "progressive_444_restart_61x83": ((61, 83), dict(quality=80, subsampling=0, progressive=True,
                                                     restart_marker_rows=1)),
    "restart_blocks_420_45x70": ((45, 70), dict(quality=90, restart_marker_blocks=3)),
    "optimized_420_64x64": ((64, 64), dict(quality=70, optimize=True)),
}


@pytest.mark.parametrize("case", sorted(JPEG_CASES))
def test_open_rgb_jpeg_matches_pil(case):
    (h, w), kw = JPEG_CASES[case]
    data = _pil_encode(_frame(h, w, seed=len(case)), "JPEG", **kw)
    _assert_same(im.open_rgb(data), _pil_rgb(data), case)


@pytest.mark.parametrize("hw", [(1, 1), (61, 83), (480, 640)])
def test_open_rgb_gray_jpeg_replicates_like_pil(hw):
    data = _pil_encode(_frame(*hw, seed=5)[..., 1], "JPEG", quality=88)
    got = im.open_rgb(data)
    _assert_same(got, _pil_rgb(data), f"gray {hw}")
    assert (got[..., 0] == got[..., 2]).all()


def _png_cases():
    rng = np.random.default_rng(21)
    h, w = 13, 19
    gray = lambda bits: rng.integers(0, 1 << bits, (h, w, 1))  # noqa: E731
    pal = rng.integers(0, 256, (256, 3))
    return {
        "gray1": _png(gray(1), 0, 1),
        "gray2": _png(gray(2), 0, 2),
        "gray4": _png(gray(4), 0, 4),
        "gray8": _png(gray(8), 0, 8),
        "gray8_trns": _png(gray(8), 0, 8, trns=struct.pack(">H", 7)),
        "gray16": _png(rng.integers(0, 1 << 16, (h, w, 1)), 0, 16),
        "gray16_low": _png(rng.integers(0, 600, (h, w, 1)), 0, 16),
        "gray_alpha8": _png(gray(8).repeat(2, -1) ^ rng.integers(0, 256, (h, w, 2)), 4, 8),
        "gray_alpha16": _png(rng.integers(0, 1 << 16, (h, w, 2)), 4, 16),
        "palette1": _png(gray(1), 3, 1, plte=pal[:2]),
        "palette2": _png(gray(2), 3, 2, plte=pal[:4]),
        "palette4": _png(gray(4), 3, 4, plte=pal[:16]),
        "palette8": _png(gray(8), 3, 8, plte=pal),
        "palette8_trns": _png(gray(8), 3, 8, plte=pal, trns=bytes(range(0, 250, 3))),
        "rgb8": _png(rng.integers(0, 256, (h, w, 3)), 2, 8),
        "rgb8_trns": _png(rng.integers(0, 256, (h, w, 3)), 2, 8, trns=struct.pack(">HHH", 1, 2, 3)),
        "rgb16": _png(rng.integers(0, 1 << 16, (h, w, 3)), 2, 16),
        "rgba8": _png(rng.integers(0, 256, (h, w, 4)), 6, 8),
        "rgba16": _png(rng.integers(0, 1 << 16, (h, w, 4)), 6, 16),
        "pil_la": _pil_encode(Image.fromarray(rng.integers(0, 256, (h, w, 2), dtype=np.uint8), "LA"), "PNG"),
        "pil_p_bits4": _pil_encode(Image.fromarray(_frame(h, w, 3)).quantize(16), "PNG", bits=4),
        "pil_i16": _pil_encode(Image.fromarray(rng.integers(0, 1 << 16, (h, w), dtype=np.uint16)), "PNG"),
        "adam7_rgb": (FIXTURES / "adam7_rgb_61x83.png").read_bytes(),
    }


PNG_CASES = _png_cases()


@pytest.mark.parametrize("case", sorted(PNG_CASES))
def test_open_rgb_png_modes_match_pil(case):
    data = PNG_CASES[case]
    _assert_same(im.open_rgb(data), _pil_rgb(data), case)


def test_unsupported_formats_raise_naming_them():
    rgb = _frame(16, 16, seed=1)
    for fmt, word in (("BMP", "BMP"), ("WEBP", "WebP")):
        with pytest.raises(ValueError, match=word):
            im.open_rgb(_pil_encode(rgb, fmt))
    gif = _pil_encode(Image.fromarray(rgb).quantize(64), "GIF")  # GIF reads as PIL reads it (native/image.decode_gif)
    _assert_same(im.open_rgb(gif), _pil_rgb(gif), "gif")
    cmyk = _pil_encode(Image.fromarray(rgb).convert("CMYK"), "JPEG")
    assert Image.open(io.BytesIO(cmyk)).mode == "CMYK"
    with pytest.raises(ValueError, match="component"):
        im.open_rgb(cmyk)
    with pytest.raises(ValueError, match="not a JPEG or PNG"):
        im.open_rgb(b"plain text, not an image")
    with pytest.raises(ValueError, match="dct_method"):
        im.decode_jpeg((FIXTURES / "camera_00.jpg").read_bytes(), dct_method="FLOAT")


# --- resize_bicubic_pil ----------------------------------------------------------------------------

RESIZE_CASES = [
    ((480, 640), (224, 224)),   # COCO frame to the towers' size (down 2.1x, 2.9x)
    ((32, 32), (224, 224)),     # up 7x
    ((61, 83), (17, 29)),       # odd sizes down
    ((61, 83), (200, 150)),     # up in one direction, down in the other
    ((224, 300), (224, 224)),   # only the vertical pass (PIL skips the other)
    ((300, 224), (224, 224)),   # only the horizontal pass
    ((1, 1), (224, 224)),
    ((224, 224), (1, 1)),
    ((5, 640), (224, 3)),
]


@pytest.mark.parametrize("src,size", RESIZE_CASES, ids=[f"{s[0]}x{s[1]}-to-{t[0]}x{t[1]}" for s, t in RESIZE_CASES])
def test_resize_bicubic_matches_pil(src, size):
    rgb = _frame(*src, seed=src[0] + src[1])
    want = np.asarray(Image.fromarray(rgb).resize(size))
    _assert_same(im.resize_bicubic_pil(rgb, size), want, f"{src} -> {size}")


def test_resize_bicubic_saturates_like_pil():
    """A checkerboard of 0 and 255 overshoots below 0 and above 255 under
    the bicubic taps: clip8's saturation, not a wrap."""
    board = (np.indices((40, 40)).sum(0) % 2 * 255).astype(np.uint8)[..., None].repeat(3, -1)
    for size in ((97, 97), (13, 29)):
        _assert_same(im.resize_bicubic_pil(board, size), np.asarray(Image.fromarray(board).resize(size)), str(size))


@pytest.mark.parametrize("name", [n for n in sorted(MANIFEST) if n.startswith(("coco", "camera_00", "rgba8",
                                                                               "gray_", "palette_trns"))])
def test_load_image_matches_pil_and_manifest(name):
    path = FIXTURES / name
    got = im.load_image(path, 224)
    with Image.open(path) as img:
        want = np.asarray(img.convert("RGB").resize((224, 224)))
    _assert_same(got, want, name)
    assert hashlib.sha256(got.tobytes()).hexdigest() == MANIFEST[name]["sha256_pil_224"]


# --- decode_jpeg's two IDCTs against TensorFlow ---------------------------------------------------


@pytest.mark.parametrize("name", JPEG_FIXTURES)
def test_accurate_idct_matches_tf_and_fast_is_unchanged(name):
    data = (FIXTURES / name).read_bytes()
    want = tf.io.decode_jpeg(data, dct_method="INTEGER_ACCURATE").numpy()
    _assert_same(im.decode_jpeg(data, dct_method="INTEGER_ACCURATE"), want, f"{name} accurate")
    fast = tf.io.decode_image(data, expand_animations=False).numpy()
    _assert_same(im.decode_jpeg(data), fast, f"{name} fast")
    _assert_same(im.decode_image(data), fast, f"{name} decode_image")
