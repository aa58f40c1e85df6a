"""The OCR-VQA GIF/PNG -> JPEG conversion without PIL (native/image.py,
native/src/gif_decode.cc, native/src/jpeg_encode.cc) against Pillow and the
JAX package, on the CPU.

* every fixture of tests/data/images/ocr (tests/data/images/ocr/
  make_fixtures.py: GIF with global and local tables, interlaced, an offset
  or oversized frame, transparency, grey and identity tables, comments,
  indices past the table; PNG at every colour type and bit depth, with and
  without tRNS, 16-bit gray past 255): open_rgb_and_comment equals
  np.asarray(Image.open(f).convert("RGB")) pixel for pixel and
  im.info.get("comment"), and the manifest's Pillow hash (a stale manifest
  fails);
* encode_jpeg's bytes equal Pillow's Image.fromarray(rgb).save(f, "JPEG")
  at sizes that are not multiples of 16 (1x1, 17x9, 640x480 among them),
  on noise and on smooth images, with and without a comment;
* the port's convert_gif_png_to_jpg and the JAX package's, each over a copy
  of the fixtures' folder, write the same files with the same bytes, and
  the manifest's hashes;
* corrupt and cut GIF streams raise ValueError, as Pillow refuses them.
"""

import hashlib
import io
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from bridgelang_tpu.preprocessing import download as jdl
from bridgelang_tpu_torch.native.image import decode_gif, encode_jpeg, open_rgb_and_comment
from bridgelang_tpu_torch.preprocessing import download as tdl

FIXTURES = Path(__file__).resolve().parent / "data" / "images" / "ocr"
MANIFEST = json.loads((FIXTURES / "manifest.json").read_text())
SOURCES = sorted(MANIFEST["sources"])


def _pil(data: bytes, **save):
    buf = io.BytesIO()
    Image.fromarray(data).save(buf, "JPEG", **save)
    return buf.getvalue()


@pytest.mark.parametrize("name", SOURCES)
def test_fixture_reads_as_pil_converts_it(name):
    with Image.open(FIXTURES / name) as im:
        want, want_comment = np.asarray(im.convert("RGB")), im.info.get("comment")
    got, comment = open_rgb_and_comment(FIXTURES / name)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert comment == want_comment
    assert hashlib.sha256(want.tobytes()).hexdigest() == MANIFEST["sources"][name]["sha256_pil_rgb"], "stale manifest"


def _image(h: int, w: int, kind: str, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "noise":
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1), (3 * xx + 5 * yy) % 256], axis=-1)
    return np.clip(base + rng.normal(0, 4, base.shape), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("kind", ["noise", "smooth"])
@pytest.mark.parametrize("hw", [(1, 1), (9, 17), (7, 3), (8, 8), (16, 16), (15, 33), (31, 17), (61, 97), (480, 640)],
                         ids=lambda hw: f"{hw[1]}x{hw[0]}")
def test_encode_jpeg_is_pillows_bytes(hw, kind):
    rgb = _image(*hw, kind, seed=hw[0] * 1000 + hw[1])
    assert encode_jpeg(rgb) == _pil(rgb)


@pytest.mark.parametrize("comment", [b"hello", b"\xff\x00 two\nlines", bytes(range(256)) * 3])
def test_encode_jpeg_carries_a_comment_as_pillow_does(comment):
    rgb = _image(23, 29, "smooth", seed=3)
    got = encode_jpeg(rgb, comment)
    assert got == _pil(rgb, comment=comment)
    assert got[20:24] == b"\xff\xfe" + (len(comment) + 2).to_bytes(2, "big")  # right after the JFIF APP0


def test_encode_jpeg_refuses_what_it_cannot_write():
    with pytest.raises(ValueError, match="uint8"):
        encode_jpeg(np.zeros((4, 4), np.uint8))
    with pytest.raises(ValueError, match="comment"):
        encode_jpeg(np.zeros((4, 4, 3), np.uint8), b"x" * 65534)


def test_conversion_equals_the_jax_packages(tmp_path):
    port, jax_dir = tmp_path / "port", tmp_path / "jax"
    for d in (port, jax_dir):
        d.mkdir()
        for name in SOURCES:
            shutil.copy(FIXTURES / name, d / name)
    tdl.convert_gif_png_to_jpg(port)
    jdl.convert_gif_png_to_jpg(jax_dir)
    got = {p.name: p.read_bytes() for p in port.iterdir()}
    want = {p.name: p.read_bytes() for p in jax_dir.iterdir()}
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name
    assert {n: hashlib.sha256(b).hexdigest() for n, b in got.items() if n.endswith(".jpg")} == MANIFEST["jpegs"]
    assert got["pair.jpg"] == encode_jpeg(np.asarray(Image.open(FIXTURES / "pair.png").convert("RGB")))


def test_corrupt_gif_streams_raise():
    data = (FIXTURES / "pillow_p_97x61.gif").read_bytes()
    with pytest.raises(ValueError, match="truncated"):
        decode_gif(data[:len(data) // 2])
    with pytest.raises(ValueError, match="not a GIF"):
        decode_gif(b"GIF90a" + data[6:])
    with pytest.raises(ValueError, match="no image"):
        decode_gif(data[:13 + 768] + b";")
    for cut in (data[:len(data) // 2], data[:13 + 768] + b";"):
        with pytest.raises(OSError):
            Image.open(io.BytesIO(cut)).convert("RGB")
