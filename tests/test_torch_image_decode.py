"""The port's JPEG/PNG decoder (bridgelang_tpu_torch/native/image.py over
native/src/image_decode.cc) against tf.io.decode_image, on the CPU.

* Every committed fixture under tests/data/images decodes bit-equal to
  tf.io.decode_image, and TensorFlow's decode still hashes to the manifest
  (a stale manifest fails): uint8, and float32 for the PNGs and one JPEG.
* JPEGs encoded here from seeded numpy frames: sizes from 1x1 to 256x256 with
  odd ones (partial MCUs), qualities 50-100, 4:2:0 and 4:4:4, baseline and
  progressive, optimized Huffman tables; Pillow's 4:2:2, restart intervals,
  progressive with restarts and grayscale; the fixture script's own encoder
  for 4:4:0 and 4:1:1: bit-equal (tolerance 0).
* PNGs: 8 and 16 bits; gray, gray+alpha, RGB, RGBA; palette with and
  without tRNS; 1-bit gray; Adam7 interlaced; compression 0 and 9: uint8 and
  float32 bit-equal.
* Truncated and corrupt streams raise ValueError where TensorFlow raises; a
  flipped byte inside the entropy-coded data decodes to TensorFlow's image
  (both skip to the next marker); unsupported codings raise naming the
  marker.
"""

import hashlib
import importlib.util
import io
import json
from pathlib import Path

import numpy as np
import pytest
import tensorflow as tf
from PIL import Image, ImageFile

from bridgelang_tpu_torch.native import image as im

FIXTURES = Path(__file__).resolve().parent / "data" / "images"
MANIFEST = json.loads((FIXTURES / "manifest.json").read_text())
ImageFile.MAXBLOCK = 1 << 22


def _fixture_script():
    spec = importlib.util.spec_from_file_location("make_fixtures", FIXTURES / "make_fixtures.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tf(data, dtype=tf.uint8):
    return tf.io.decode_image(data, expand_animations=False, dtype=dtype).numpy()


def _assert_equal_tf(data, dtype=np.uint8, label=""):
    want = _tf(data, tf.uint8 if dtype == np.uint8 else tf.float32)
    got = im.decode_image(data, dtype)
    assert got.shape == want.shape and got.dtype == want.dtype, (label, got.shape, want.shape, got.dtype)
    if not np.array_equal(got, want):
        d = np.abs(got.astype(np.float64) - want.astype(np.float64))
        raise AssertionError(f"{label}: max |diff| {d.max()}, {(d > 0).mean():.4%} of the samples differ")


def _frame(h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 90 * np.sin(xx / (7 + seed % 5 + c) + c) * np.cos(yy / (11 + c)) for c in range(3)], -1)
    return np.clip(base + rng.normal(0, 12, (h, w, 3)), 0, 255).astype(np.uint8)


def _pil(arr, fmt, **kw) -> bytes:
    buf = io.BytesIO()
    (arr if isinstance(arr, Image.Image) else Image.fromarray(arr)).save(buf, fmt, **kw)
    return buf.getvalue()


@pytest.mark.parametrize("name", sorted(MANIFEST))
def test_fixture_decodes_bit_equal_to_tf_and_manifest(name):
    data = (FIXTURES / name).read_bytes()
    entry = MANIFEST[name]
    for dtype, key in ((np.uint8, "sha256_uint8"), (np.float32, "sha256_float32")):
        if key not in entry:
            continue
        want = _tf(data, tf.uint8 if dtype == np.uint8 else tf.float32)
        assert list(want.shape) == entry["shape"] and hashlib.sha256(want.tobytes()).hexdigest() == entry[key], \
            f"{name}: TensorFlow's decode no longer matches manifest.json (rerun make_fixtures.py)"
        _assert_equal_tf(data, dtype, name)


def test_fixtures_cover_the_layouts():
    names = set(MANIFEST)
    assert sum(n.startswith("camera_") for n in names) == 16
    assert all(MANIFEST[f"camera_{i:02d}.jpg"]["shape"] == [256, 256, 3] for i in range(16))
    for layout in ("444", "progressive", "gray", "422", "restart", "440", "411", "adam7", "palette_trns", "depth16",
                   "gray1bit", "rgba8"):
        assert any(layout in n for n in names), layout
    assert sum((FIXTURES / n).stat().st_size for n in names) < 1_000_000


@pytest.mark.parametrize("hw", [(256, 256), (17, 33), (1, 1), (9, 15), (123, 77), (3, 200)])
def test_jpegs_encoded_here_decode_bit_equal(hw):
    h, w = hw
    for q in (50, 75, 90, 95, 100):
        x = _frame(h, w, h * 7 + w + q)
        for chroma in (True, False):
            for progressive in (False, True):
                for optimize in (False, True):
                    data = tf.io.encode_jpeg(x, quality=q, chroma_downsampling=chroma, progressive=progressive,
                                             optimize_size=optimize).numpy()
                    _assert_equal_tf(data, label=f"{hw} q{q} 420={chroma} prog={progressive} opt={optimize}")
        _assert_equal_tf(tf.io.encode_jpeg(x[..., :1], quality=q).numpy(), label=f"{hw} q{q} gray")
        _assert_equal_tf(tf.io.encode_jpeg(x, quality=q).numpy(), np.float32, label=f"{hw} q{q} float32")


@pytest.mark.parametrize("hw", [(64, 48), (17, 33), (1, 1)])
def test_pillow_and_own_layouts_decode_bit_equal(hw):
    h, w = hw
    enc = _fixture_script()
    for q in (60, 90):
        x = _frame(h, w, h + w + q)
        for sub in (0, 1, 2):
            _assert_equal_tf(_pil(x, "JPEG", quality=q, subsampling=sub), label=f"pil {hw} q{q} sub{sub}")
            _assert_equal_tf(_pil(x, "JPEG", quality=q, subsampling=sub, progressive=True),
                             label=f"pil progressive {hw} q{q} sub{sub}")
        for blocks in (1, 3):
            _assert_equal_tf(_pil(x, "JPEG", quality=q, subsampling=2, restart_marker_blocks=blocks),
                             label=f"restart every {blocks} {hw}")
        _assert_equal_tf(_pil(x, "JPEG", quality=q, progressive=True, restart_marker_rows=1), label=f"prog rst {hw}")
        _assert_equal_tf(_pil(x[..., 0], "JPEG", quality=q), label=f"pil gray {hw}")
        for sampling in (((1, 2), (1, 1), (1, 1)), ((4, 1), (1, 1), (1, 1)), ((2, 2), (1, 2), (2, 1))):
            _assert_equal_tf(enc.encode_baseline_jpeg(x, sampling, q), label=f"own {sampling} {hw}")


@pytest.mark.parametrize("hw", [(13, 17), (64, 64), (1, 1)])
def test_pngs_decode_bit_equal(hw):
    h, w = hw
    rng = np.random.default_rng(h * w)
    enc = _fixture_script()
    cases = []
    for ch in (1, 2, 3, 4):
        cases.append((f"8-bit {ch}ch", tf.io.encode_png(rng.integers(0, 256, (h, w, ch), dtype=np.uint8)).numpy()))
        cases.append((f"16-bit {ch}ch", tf.io.encode_png(rng.integers(0, 65536, (h, w, ch), dtype=np.uint16)).numpy()))
    for level in (0, 9):
        cases.append((f"level {level}", tf.io.encode_png(_frame(h, w, 3), compression=level).numpy()))
    pal = Image.fromarray(_frame(h, w, 4)).quantize(16)
    cases += [("palette", _pil(pal, "PNG")), ("palette tRNS", _pil(pal, "PNG", transparency=3)),
              ("palette 4-bit", _pil(pal, "PNG", bits=4)),
              ("1-bit", _pil(Image.fromarray(_frame(h, w, 5)[..., 0]).convert("1"), "PNG")),
              ("adam7", enc.encode_adam7_png(_frame(h, w, 6)))]
    for label, data in cases:
        for dtype in (np.uint8, np.float32):
            _assert_equal_tf(data, dtype, f"{hw} {label}")


def test_truncated_and_corrupt_streams_raise_where_tf_raises():
    x = _frame(64, 64, 9)
    for progressive in (False, True):
        data = tf.io.encode_jpeg(x, quality=90, progressive=progressive).numpy()
        for cut in (len(data) - 1, len(data) - 2, len(data) - 10, len(data) // 2, 300, 100, 4):
            with pytest.raises(tf.errors.InvalidArgumentError):
                _tf(data[:cut])
            with pytest.raises(ValueError, match="truncated"):
                im.decode_image(data[:cut])
        for pos in (len(data) // 2, 3 * len(data) // 4):  # inside the scan: both skip to the next marker
            bad = bytearray(data)
            bad[pos] ^= 0xFF
            _assert_equal_tf(bytes(bad), label=f"flipped byte {pos}")
    data = tf.io.encode_jpeg(x, quality=90).numpy()
    sof = data.index(b"\xff\xc0")
    broken = {
        "no SOI": b"\x00" + data[1:],
        "SOF length": data[:sof + 2] + b"\x00\x05" + data[sof + 4:],
        "Huffman table": data[:data.index(b"\xff\xc4") + 5] + b"\x03" + data[data.index(b"\xff\xc4") + 6:],
    }
    for label, stream in broken.items():
        with pytest.raises(Exception):
            _tf(stream)
        with pytest.raises(ValueError):
            im.decode_image(stream)
    png = tf.io.encode_png(x).numpy()
    for stream in (png[:len(png) // 2], png[:-13], png[:30] + bytes([png[30] ^ 1]) + png[31:]):
        with pytest.raises(Exception):
            _tf(stream)
        with pytest.raises(ValueError):
            im.decode_image(stream)


def test_unsupported_codings_raise_naming_the_marker():
    data = tf.io.encode_jpeg(_frame(16, 16, 1), quality=90).numpy()
    sof = data.index(b"\xff\xc0")
    for marker, words in ((0xC3, "lossless"), (0xC9, "arithmetic"), (0xC1, None)):
        stream = data[:sof + 1] + bytes([marker]) + data[sof + 2:]
        if words is None:  # SOF1 (extended sequential, Huffman) decodes like SOF0
            np.testing.assert_array_equal(im.decode_image(stream), _tf(data))
            continue
        with pytest.raises(ValueError, match=f"{words}.*0xFF{marker:02X}"):
            im.decode_image(stream)
    twelve = data[:sof + 4] + b"\x0c" + data[sof + 5:]
    with pytest.raises(ValueError, match="12-bit"):
        im.decode_image(twelve)
    with pytest.raises(ValueError, match="GIF"):
        im.decode_image(b"GIF89a" + b"\x00" * 20)
    with pytest.raises(ValueError, match="dtype"):
        im.decode_image(data, np.uint16)
