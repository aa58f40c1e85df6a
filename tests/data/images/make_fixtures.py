#!/usr/bin/env python3
"""Writes the image fixtures of this folder and their manifest.

    python tests/data/images/make_fixtures.py

needs TensorFlow and Pillow (the encoders, and the decoder the manifest
records). It writes:

* camera_00.jpg ... camera_15.jpg: 16 distinct 256x256 RGB frames, quality
  95, 4:2:0 (TFDS's Image default), encoded with tf.io.encode_jpeg. They are
  the camera frames of the TFDS datasets the smoke run writes on the card.
* JPEG layouts: 4:4:4, progressive with optimized Huffman tables, odd sizes
  with partial MCUs, grayscale, 4:2:2 and restart intervals (Pillow), and
  4:4:0 and 4:1:1 (neither encoder writes them: `encode_baseline_jpeg`
  below, a minimal baseline encoder with JFIF YCbCr).
* PNG: 8-bit RGB and RGBA, 16-bit gray (a depth map, decoded to float32 on
  the depth path), palette with and without tRNS, 1-bit gray, and an Adam7
  interlaced RGB image (`encode_adam7_png` below).
* coco_00_640x480.jpg ... coco_02_640x480.jpg: 640x480 frames (COCO's
  common size, the VLM pretraining images): Pillow quality 90 4:2:0, Pillow
  quality 85 progressive, tf.io.encode_jpeg quality 95.
* manifest.json: each file's shape and the sha256 of
  tf.io.decode_image(data, expand_animations=False) as uint8 bytes, and for
  the PNGs and one JPEG also of the float32 decode; and the sha256 of what
  Pillow gives: np.asarray(Image.open(f).convert("RGB")) (`sha256_pil_rgb`)
  and the same resized to 224x224 (`sha256_pil_224`, the pretraining
  datasets' frames).

Every frame comes from a seed, so a rerun writes the same pixels (the
encoders' bytes may differ across library versions; the manifest follows
whatever this run wrote).
"""

from __future__ import annotations

import hashlib
import io
import json
import struct
import zlib
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
N_CAMERA = 16
N_COCO = 3
PIL_SIZE = 224

# zigzag index -> natural index
ZIGZAG = [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14,
          21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53,
          60, 61, 54, 47, 55, 62, 63]


def camera_frame(i: int, h: int = 256, w: int = 256) -> np.ndarray:
    """A table-top-like frame: a lit backdrop, a few shaded blocks, sensor
    noise; frame i from seed i."""
    rng = np.random.default_rng(1000 + i)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([90 + 60 * np.sin(xx / (37 + 4 * c + i) + rng.uniform(0, 6)) * np.cos(yy / (53 + 3 * c))
                     + 40 * yy / h for c in range(3)], -1)
    for _ in range(3 + i % 4):
        y0, x0 = rng.integers(0, h - 40), rng.integers(0, w - 40)
        bh, bw = rng.integers(16, 72), rng.integers(16, 72)
        color = rng.uniform(20, 235, 3)
        shade = 1 - 0.3 * (yy[y0:y0 + bh, x0:x0 + bw] - y0) / max(bh, 1)
        base[y0:y0 + bh, x0:x0 + bw] = color * shade[..., None]
    return np.clip(base + rng.normal(0, 4, (h, w, 3)), 0, 255).astype(np.uint8)


def _std_quant(quality: int, chroma: bool) -> np.ndarray:
    """The Annex K tables (natural order) scaled to `quality` as libjpeg does."""
    lum = [16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55, 14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22,
           29, 51, 87, 80, 62, 18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92, 49, 64, 78, 87,
           103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99]
    chr_ = [17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99, 24, 26, 56, 99, 99, 99, 99, 99, 47, 66,
            99, 99, 99, 99, 99, 99] + [99] * 32
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    t = (np.asarray(chr_ if chroma else lum) * scale + 50) // 100
    return np.clip(t, 1, 255).astype(np.int64)


class _BitWriter:
    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, value: int, length: int) -> None:
        for i in range(length - 1, -1, -1):
            self.acc = (self.acc << 1) | ((value >> i) & 1)
            self.n += 1
            if self.n == 8:
                self.out.append(self.acc)
                if self.acc == 0xFF:
                    self.out.append(0)
                self.acc, self.n = 0, 0

    def flush(self) -> bytes:
        while self.n:
            self.put(1, 1)
        return bytes(self.out)


def _size(v: int) -> int:
    return int(abs(v)).bit_length()


def _bits_of(v: int, s: int) -> int:
    return v if v >= 0 else v + (1 << s) - 1


def encode_baseline_jpeg(rgb: np.ndarray, sampling, quality: int = 90) -> bytes:
    """A baseline JFIF JPEG with per-component sampling factors `sampling`
    ((h, v) for Y, Cb, Cr): float FDCT, the Annex K quantization tables,
    one Huffman table per class with every used symbol at 8 bits (DC at 4).
    Valid, not small: it exists to give the decoders layouts no library
    encoder here writes."""
    from scipy.fft import dctn

    h, w = rgb.shape[:2]
    x = rgb.astype(np.float64)
    ycc = np.stack([0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2],
                    -0.168736 * x[..., 0] - 0.331264 * x[..., 1] + 0.5 * x[..., 2] + 128,
                    0.5 * x[..., 0] - 0.418688 * x[..., 1] - 0.081312 * x[..., 2] + 128], -1)
    max_h, max_v = max(s[0] for s in sampling), max(s[1] for s in sampling)
    mcux, mcuy = -(-w // (8 * max_h)), -(-h // (8 * max_v))
    pad = np.pad(ycc, ((0, mcuy * 8 * max_v - h), (0, mcux * 8 * max_h - w), (0, 0)), mode="edge")
    quant = [_std_quant(quality, False), _std_quant(quality, True)]
    comps = []
    for c, (ch, cv) in enumerate(sampling):
        fx, fy = max_h // ch, max_v // cv
        plane = pad[..., c].reshape(pad.shape[0] // fy, fy, pad.shape[1] // fx, fx).mean(axis=(1, 3)) - 128
        q = quant[min(c, 1)]
        blocks = plane.reshape(plane.shape[0] // 8, 8, plane.shape[1] // 8, 8).transpose(0, 2, 1, 3)
        coefs = np.round(dctn(blocks, axes=(2, 3), norm="ortho") / q.reshape(8, 8)).astype(np.int64)
        comps.append(coefs.reshape(*coefs.shape[:2], 64)[..., ZIGZAG])
    # symbols per class, to size the Huffman tables
    order = []
    for my in range(mcuy):
        for mx in range(mcux):
            for c, (ch, cv) in enumerate(sampling):
                for by in range(cv):
                    for bx in range(ch):
                        order.append((c, comps[c][my * cv + by, mx * ch + bx]))
    ac_syms = [set(), set()]
    for c, blk in order:
        run = 0
        for k in range(1, 64):
            if blk[k] == 0:
                run += 1
                continue
            while run > 15:
                ac_syms[min(c, 1)].add(0xF0)
                run -= 16
            ac_syms[min(c, 1)].add((run << 4) | _size(blk[k]))
            run = 0
        if run:
            ac_syms[min(c, 1)].add(0x00)
    dc_codes = {s: (s, 4) for s in range(12)}
    ac_codes = [{s: (i, 8) for i, s in enumerate(sorted(ac_syms[t]))} for t in range(2)]
    bw = _BitWriter()
    pred = [0, 0, 0]
    for c, blk in order:
        t = min(c, 1)
        diff = int(blk[0]) - pred[c]
        pred[c] = int(blk[0])
        s = _size(diff)
        bw.put(*dc_codes[s])
        bw.put(_bits_of(diff, s), s)
        run = 0
        for k in range(1, 64):
            v = int(blk[k])
            if v == 0:
                run += 1
                continue
            while run > 15:
                bw.put(*ac_codes[t][0xF0])
                run -= 16
            s = _size(v)
            bw.put(*ac_codes[t][(run << 4) | s])
            bw.put(_bits_of(v, s), s)
            run = 0
        if run:
            bw.put(*ac_codes[t][0x00])
    scan = bw.flush()

    def segment(marker: int, body: bytes) -> bytes:
        return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body

    out = b"\xff\xd8" + segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    for t in range(2):
        out += segment(0xDB, bytes([t]) + bytes(int(quant[t][ZIGZAG[i]]) for i in range(64)))
    out += segment(0xC0, struct.pack(">BHHB", 8, h, w, 3) + b"".join(
        bytes([c + 1, (sh << 4) | sv, min(c, 1)]) for c, (sh, sv) in enumerate(sampling)))
    for t in range(2):
        out += segment(0xC4, bytes([t]) + bytes([0, 0, 0, 12] + [0] * 12) + bytes(range(12)))
        syms = sorted(ac_syms[t])
        out += segment(0xC4, bytes([0x10 | t]) + bytes([0] * 7 + [len(syms)] + [0] * 8) + bytes(syms))
    out += segment(0xDA, bytes([3]) + b"".join(bytes([c + 1, (min(c, 1) << 4) | min(c, 1)]) for c in range(3))
                   + bytes([0, 63, 0]))
    return out + scan + b"\xff\xd9"


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def encode_adam7_png(rgb: np.ndarray) -> bytes:
    """An 8-bit RGB PNG, Adam7 interlaced, rows filtered Sub / Up / Paeth in
    turn (no encoder here writes interlaced PNGs)."""
    h, w = rgb.shape[:2]
    raw = bytearray()
    passes = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
    for x0, y0, dx, dy in passes:
        sub = rgb[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        prev = np.zeros(sub.shape[1] * 3, np.int64)
        for r, row in enumerate(sub.reshape(sub.shape[0], -1).astype(np.int64)):
            kind = 1 + r % 3 if r else 1
            left = np.concatenate([np.zeros(3, np.int64), row[:-3]])
            upleft = np.concatenate([np.zeros(3, np.int64), prev[:-3]])
            if kind == 1:
                pred = left
            elif kind == 2:
                pred = prev
            else:
                p = left + prev - upleft
                pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
                pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
            raw += bytes([kind]) + ((row - pred) % 256).astype(np.uint8).tobytes()
            prev = row
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 1)
    return (b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", ihdr) + _png_chunk(b"IDAT", zlib.compress(bytes(raw), 9))
            + _png_chunk(b"IEND", b""))


def depth_map(h: int, w: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    d = 20000 + 15000 * np.sin(xx / 17.0) * np.cos(yy / 11.0) + rng.normal(0, 300, (h, w))
    return np.clip(d, 0, 65535).astype(np.uint16)


def fixtures() -> dict:
    """name -> encoded bytes."""
    import tensorflow as tf
    from PIL import Image, ImageFile

    ImageFile.MAXBLOCK = 1 << 22

    def pil(arr, fmt, **kw) -> bytes:
        buf = io.BytesIO()
        (arr if isinstance(arr, Image.Image) else Image.fromarray(arr)).save(buf, fmt, **kw)
        return buf.getvalue()

    out = {f"camera_{i:02d}.jpg": tf.io.encode_jpeg(camera_frame(i), quality=95).numpy() for i in range(N_CAMERA)}
    small = camera_frame(20, 61, 83)  # odd sizes: partial MCUs in both directions
    out["q75_444_61x83.jpg"] = tf.io.encode_jpeg(small, quality=75, chroma_downsampling=False).numpy()
    out["progressive_optimized_61x83.jpg"] = tf.io.encode_jpeg(small, quality=90, progressive=True,
                                                               optimize_size=True).numpy()
    out["q50_420_1x1.jpg"] = tf.io.encode_jpeg(small[:1, :1], quality=50).numpy()
    out["gray_61x83.jpg"] = pil(small[..., 0], "JPEG", quality=85)
    out["pil_422_61x83.jpg"] = pil(small, "JPEG", quality=90, subsampling=1)
    out["pil_420_restart_61x83.jpg"] = pil(small, "JPEG", quality=90, subsampling=2, restart_marker_blocks=2)
    out["pil_progressive_restart_61x83.jpg"] = pil(small, "JPEG", quality=80, subsampling=0, progressive=True,
                                                   restart_marker_rows=1)
    out["baseline_440_61x83.jpg"] = encode_baseline_jpeg(small, ((1, 2), (1, 1), (1, 1)))
    out["baseline_411_61x83.jpg"] = encode_baseline_jpeg(small, ((4, 1), (1, 1), (1, 1)))
    out["rgb8_61x83.png"] = tf.io.encode_png(small).numpy()
    rgba = np.concatenate([small, camera_frame(21, 61, 83)[..., :1]], -1)
    out["rgba8_61x83.png"] = tf.io.encode_png(rgba).numpy()
    out["depth16_64x80.png"] = tf.io.encode_png(depth_map(64, 80, 3)[..., None]).numpy()
    pal = Image.fromarray(small).quantize(32)
    out["palette_61x83.png"] = pil(pal, "PNG")
    out["palette_trns_61x83.png"] = pil(pal, "PNG", transparency=5)
    out["gray1bit_61x83.png"] = pil(Image.fromarray(small[..., 1]).convert("1"), "PNG")
    out["adam7_rgb_61x83.png"] = encode_adam7_png(small)
    coco = [camera_frame(40 + i, 480, 640) for i in range(N_COCO)]
    out["coco_00_640x480.jpg"] = pil(coco[0], "JPEG", quality=90)
    out["coco_01_640x480.jpg"] = pil(coco[1], "JPEG", quality=85, progressive=True)
    out["coco_02_640x480.jpg"] = tf.io.encode_jpeg(coco[2], quality=95).numpy()
    return out


def manifest_entry(data: bytes, float32: bool) -> dict:
    import tensorflow as tf
    from PIL import Image

    u8 = tf.io.decode_image(data, expand_animations=False, dtype=tf.uint8).numpy()
    entry = {"shape": list(u8.shape), "sha256_uint8": hashlib.sha256(u8.tobytes()).hexdigest()}
    with Image.open(io.BytesIO(data)) as im:
        rgb = im.convert("RGB")
        entry["sha256_pil_rgb"] = hashlib.sha256(np.asarray(rgb).tobytes()).hexdigest()
        entry["sha256_pil_224"] = hashlib.sha256(np.asarray(rgb.resize((PIL_SIZE, PIL_SIZE))).tobytes()).hexdigest()
    if float32:
        f32 = tf.io.decode_image(data, expand_animations=False, dtype=tf.float32).numpy()
        entry["sha256_float32"] = hashlib.sha256(f32.tobytes()).hexdigest()
    return entry


def main() -> None:
    files = fixtures()
    manifest = {}
    for name, data in sorted(files.items()):
        (HERE / name).write_bytes(data)
        manifest[name] = manifest_entry(data, float32=name.endswith(".png") or name == "q75_444_61x83.jpg")
    (HERE / "manifest.json").write_text(json.dumps(manifest, indent=1, sort_keys=True) + "\n")
    total = sum(len(d) for d in files.values())
    print(f"{len(files)} fixtures, {total / 1e3:.1f} kB, manifest.json")


if __name__ == "__main__":
    main()
