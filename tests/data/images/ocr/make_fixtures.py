#!/usr/bin/env python3
"""Writes the OCR-VQA conversion fixtures of this folder and their manifest.

    python tests/data/images/ocr/make_fixtures.py

needs Pillow (12.1 wrote the committed set). OCR-VQA ships GIF and PNG
images that preprocessing turns into JPEG with
Image.open(p).convert("RGB").save(p.with_suffix(".jpg"), "JPEG"); these
files cover what that path meets:

* GIF written by Pillow: a 256-colour palette image large enough for the
  LZW table to fill and clear (interlaced: Pillow interlaces frames 16 rows
  and taller), one under 16 rows (not interlaced), a transparency index, a
  comment, a greyscale palette that is not the identity (mode "P"), and an
  "L" image (its levels in a palette: mode "P" again).
* GIF written here byte by byte (`gif_bytes`, literal LZW codes with clear
  codes: Pillow writes none of these): a local colour table without a
  global one on an interlaced frame, a frame smaller than the screen and
  offset in it (with and without a transparency index, which then fills
  the rest of the canvas), a frame running past the screen (the canvas
  grows), no colour table at all, an identity grey table (mode "L"), two
  comment extensions, and indices past a short table (black).
* PNG written here (`png_bytes`, filter 0): every colour type at every bit
  depth it allows, with tRNS where the type takes one, 16-bit gray past 255
  (Pillow clips it); and an RGBA image written by Pillow (its filters).
* pair.gif and pair.png: one stem, so the PNG's JPEG replaces the GIF's.
* jpeg_content.gif: a JPEG with a COM marker under a .gif name (PIL opens by
  content and carries the comment).
* manifest.json: for each source, the sha256 of
  np.asarray(Image.open(f).convert("RGB")) (`sha256_pil_rgb`) and its shape;
  for each JPEG the conversion writes, the sha256 of Pillow's bytes
  (`jpegs`), which the card check (chip_smoke.py phase `leftovers`) holds
  the port's conversion to where there is no Pillow.

Every image comes from a seed, so a rerun writes the same files.
"""

from __future__ import annotations

import hashlib
import io
import json
import shutil
import struct
import tempfile
import zlib
from pathlib import Path

import numpy as np
from PIL import Image

HERE = Path(__file__).resolve().parent


def smooth_rgb(h: int, w: int, seed: int) -> np.ndarray:
    """A page-like image: gradients, a few dark bars of 'text', noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([200 + 40 * np.sin(xx / 9 + seed), 180 + 50 * np.cos(yy / 7), 160 + 30 * np.sin((xx + yy) / 11)],
                   axis=-1)
    for _ in range(max(1, h // 6)):
        y0, x0 = rng.integers(0, max(1, h - 3)), rng.integers(0, max(1, w - 8))
        img[y0:y0 + 2, x0:x0 + rng.integers(3, 12)] = rng.integers(0, 80, 3)
    img += rng.normal(0, 6, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def lzw_literal(indices: np.ndarray, min_code_size: int) -> bytes:
    """GIF LZW data of literal codes only, a clear code before the table
    would widen the codes: valid, if not compact."""
    clear, end = 1 << min_code_size, (1 << min_code_size) + 1
    per_clear = max(1, (1 << min_code_size) - 3)
    codes = [clear]
    for i, v in enumerate(indices.ravel()):
        if i and i % per_clear == 0:
            codes.append(clear)
        codes.append(int(v))
    codes.append(end)
    out, acc, n, width = bytearray(), 0, 0, min_code_size + 1
    for c in codes:
        acc |= c << n
        n += width
        while n >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            n -= 8
    if n:
        out.append(acc & 0xFF)
    return bytes(out)


def sub_blocks(data: bytes) -> bytes:
    return b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255] for i in range(0, len(data), 255)) + b"\x00"


def table_bits(palette: bytes) -> int:
    return (len(palette) // 3).bit_length() - 2  # 2^(bits + 1) entries


def gif_bytes(screen, indices, global_palette=None, local_palette=None, offset=(0, 0), interlace=False,
              transparency=None, comments=(), min_code_size=None) -> bytes:
    """A one-frame GIF89a: `indices` [h, w] at `offset` on a `screen`
    (width, height); colour tables as RGB bytes of 2^k entries."""
    h, w = indices.shape
    flags = (0x80 | table_bits(global_palette)) if global_palette else 0
    out = b"GIF89a" + struct.pack("<HHBBB", screen[0], screen[1], flags, 0, 0) + (global_palette or b"")
    for text in comments:
        out += b"!\xfe" + sub_blocks(text)
    if transparency is not None:
        out += b"!\xf9\x04" + struct.pack("<BHB", 1, 0, transparency) + b"\x00"
    fflags = (0x80 | table_bits(local_palette) if local_palette else 0) | (0x40 if interlace else 0)
    out += b"," + struct.pack("<HHHHB", offset[0], offset[1], w, h, fflags) + (local_palette or b"")
    rows = indices
    if interlace:  # rows in GIF's four passes
        order = [r for start, step in ((0, 8), (4, 8), (2, 4), (1, 2)) for r in range(start, h, step)]
        rows = indices[order]
    m = min_code_size or max(2, int(indices.max()).bit_length())
    return out + bytes([m]) + sub_blocks(lzw_literal(rows, m)) + b";"


def palette_bytes(n: int, seed: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, (n, 3), dtype=np.uint8).tobytes()


def png_bytes(samples: np.ndarray, color: int, depth: int, plte: bytes = None, trns: bytes = None) -> bytes:
    """A PNG of `samples` [h, w, c] (uint8 or uint16) at `depth`, every row
    with filter 0."""
    h, w = samples.shape[:2]
    if depth < 8:
        per = 8 // depth
        idx = samples[..., 0].astype(np.uint8)
        pad = (-w) % per
        idx = np.pad(idx, ((0, 0), (0, pad)))
        packed = np.zeros((h, idx.shape[1] // per), np.uint8)
        for k in range(per):
            packed |= idx[:, k::per] << (8 - depth * (k + 1))
        rows = packed
    elif depth == 8:
        rows = samples.astype(np.uint8).reshape(h, -1)
    else:
        rows = samples.astype(">u2").reshape(h, -1).view(np.uint8)
    raw = b"".join(b"\x00" + r.tobytes() for r in rows)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0))
    if plte is not None:
        out += chunk(b"PLTE", plte)
    if trns is not None:
        out += chunk(b"tRNS", trns)
    return out + chunk(b"IDAT", zlib.compress(raw, 9)) + chunk(b"IEND", b"")


def pillow_bytes(im: Image.Image, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    im.save(buf, fmt, **kw)
    return buf.getvalue()


def fixtures() -> dict:
    """name -> file bytes."""
    out = {}
    rng = np.random.default_rng(0)
    # Pillow's GIF writer
    page = Image.fromarray(smooth_rgb(61, 97, 1))
    noisy = np.asarray(page).copy()
    noisy[::3] = rng.integers(0, 256, noisy[::3].shape)  # enough distinct runs to fill the LZW table
    out["pillow_p_97x61.gif"] = pillow_bytes(Image.fromarray(noisy).quantize(256), "GIF")
    out["pillow_p_40x12.gif"] = pillow_bytes(Image.fromarray(smooth_rgb(12, 40, 2)).quantize(64), "GIF")
    out["pillow_transparency_33x20.gif"] = pillow_bytes(Image.fromarray(smooth_rgb(20, 33, 3)).quantize(16), "GIF",
                                                        transparency=1)
    out["pillow_comment_24x18.gif"] = pillow_bytes(Image.fromarray(smooth_rgb(18, 24, 4)).quantize(32), "GIF",
                                                   comment=b"hello")
    grey = Image.fromarray((rng.integers(0, 16, (20, 30)) ).astype(np.uint8), "P")
    grey.putpalette([v for i in range(16) for v in (i * 17,) * 3])
    out["pillow_grey_palette_30x20.gif"] = pillow_bytes(grey, "GIF")
    out["pillow_from_l_29x19.gif"] = pillow_bytes(Image.fromarray(smooth_rgb(19, 29, 5)).convert("L"), "GIF")
    # GIF byte by byte
    out["local_palette_interlaced_21x13.gif"] = gif_bytes(
        (21, 13), rng.integers(0, 8, (13, 21)).astype(np.uint8), local_palette=palette_bytes(8, 10), interlace=True)
    small = rng.integers(0, 4, (6, 9)).astype(np.uint8)
    out["offset_frame_20x14.gif"] = gif_bytes((20, 14), small, global_palette=palette_bytes(4, 11), offset=(5, 3))
    out["offset_transparent_20x14.gif"] = gif_bytes((20, 14), small, global_palette=palette_bytes(4, 12),
                                                    offset=(5, 3), transparency=2)
    out["frame_past_screen_12x10.gif"] = gif_bytes((12, 10), rng.integers(0, 4, (8, 10)).astype(np.uint8),
                                                   global_palette=palette_bytes(4, 13), offset=(6, 5))
    out["no_palette_15x11.gif"] = gif_bytes((15, 11), rng.integers(0, 256, (11, 15)).astype(np.uint8))
    identity = bytes(v for i in range(16) for v in (i, i, i))
    out["identity_palette_16x8.gif"] = gif_bytes((16, 8), rng.integers(0, 16, (8, 16)).astype(np.uint8),
                                                 global_palette=identity)
    out["two_comments_16x9.gif"] = gif_bytes((16, 9), rng.integers(0, 4, (9, 16)).astype(np.uint8),
                                             global_palette=palette_bytes(4, 14), comments=(b"first", b"second"),
                                             transparency=3)
    out["index_past_palette_8x8.gif"] = gif_bytes((8, 8), rng.integers(0, 8, (8, 8)).astype(np.uint8),
                                                  global_palette=palette_bytes(2, 15), min_code_size=3)
    # PNG byte by byte: every colour type and depth
    h, w = 7, 13
    for depth in (1, 2, 4, 8, 16):
        g = rng.integers(0, 1 << depth, (h, w, 1))
        out[f"gray{depth}.png"] = png_bytes(g, 0, depth)
        if depth == 8:
            out["gray8_trns.png"] = png_bytes(g, 0, 8, trns=struct.pack(">H", int(g[0, 0, 0])))
        if depth == 16:
            out["gray16_small.png"] = png_bytes(rng.integers(0, 600, (h, w, 1)), 0, 16)  # mostly under 256
    for depth in (8, 16):
        c = rng.integers(0, 1 << depth, (h, w, 3))
        out[f"rgb{depth}.png"] = png_bytes(c, 2, depth)
        out[f"gray_alpha{depth}.png"] = png_bytes(rng.integers(0, 1 << depth, (h, w, 2)), 4, depth)
        out[f"rgba{depth}.png"] = png_bytes(rng.integers(0, 1 << depth, (h, w, 4)), 6, depth)
    out["rgb8_trns.png"] = png_bytes(rng.integers(0, 256, (h, w, 3)), 2, 8, trns=struct.pack(">HHH", 1, 2, 3))
    for depth in (1, 2, 4, 8):
        n = 1 << depth
        idx = rng.integers(0, n, (h, w, 1))
        out[f"palette{depth}.png"] = png_bytes(idx, 3, depth, plte=palette_bytes(n, 20 + depth))
    idx = rng.integers(0, 256, (h, w, 1))
    out["palette8_trns.png"] = png_bytes(idx, 3, 8, plte=palette_bytes(256, 30),
                                         trns=rng.integers(0, 256, 100, dtype=np.uint8).tobytes())
    rgba = np.concatenate([smooth_rgb(17, 31, 6), rng.integers(0, 256, (17, 31, 1), dtype=np.uint8)], axis=-1)
    out["pillow_rgba_31x17.png"] = pillow_bytes(Image.fromarray(rgba, "RGBA"), "PNG")
    # one stem twice; a JPEG under a GIF name
    out["pair.gif"] = pillow_bytes(Image.fromarray(smooth_rgb(10, 14, 7)).quantize(16), "GIF")
    out["pair.png"] = pillow_bytes(Image.fromarray(smooth_rgb(10, 14, 8)), "PNG")
    out["jpeg_content.gif"] = pillow_bytes(Image.fromarray(smooth_rgb(9, 11, 9)), "JPEG", comment=b"a jpeg")
    return out


def pil_conversion(directory: Path) -> None:
    """The JAX package's conversion (bridgelang_tpu/preprocessing/download.py)."""
    for p in list(directory.glob("*.gif")) + list(directory.glob("*.png")):
        with Image.open(p) as im:
            im.convert("RGB").save(p.with_suffix(".jpg"), "JPEG")


def main() -> None:
    files = fixtures()
    for old in HERE.iterdir():
        if old.suffix in (".gif", ".png", ".jpg"):
            old.unlink()
    manifest = {"sources": {}, "jpegs": {}}
    for name, data in files.items():
        (HERE / name).write_bytes(data)
        with Image.open(io.BytesIO(data)) as im:
            rgb = np.asarray(im.convert("RGB"))
        manifest["sources"][name] = {"shape": list(rgb.shape),
                                     "sha256_pil_rgb": hashlib.sha256(rgb.tobytes()).hexdigest()}
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        for name in files:
            shutil.copy(HERE / name, work / name)
        pil_conversion(work)
        for jpg in sorted(work.glob("*.jpg")):
            manifest["jpegs"][jpg.name] = hashlib.sha256(jpg.read_bytes()).hexdigest()
    (HERE / "manifest.json").write_text(json.dumps(manifest, indent=1, sort_keys=True) + "\n")
    total = sum(len(d) for d in files.values())
    print(f"wrote {len(files)} sources ({total} bytes) and {len(manifest['jpegs'])} JPEG hashes")


if __name__ == "__main__":
    main()
