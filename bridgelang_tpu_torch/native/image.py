"""JPEG and PNG decoding without TensorFlow, PIL, libjpeg or libpng:
`decode_image(data, dtype)` gives what

    tf.io.decode_image(data, expand_animations=False, dtype=dtype)

gives for the frames of RLDS datasets, bit for bit (uint8, and float32 for
the depth path).

JPEG decodes in the native library (`src/image_decode.cc`: libjpeg-turbo's
fast integer IDCT, fancy upsampling and YCbCr tables, which is what
TensorFlow's decode_image uses). PNG inflates with the standard library's
zlib, unfilters rows in the native library and unpacks in numpy, following
TensorFlow's libpng set-up: palette images expand to RGB (RGBA when a tRNS
chunk is present), gray images of 1, 2 or 4 bits scale to 8, 16-bit samples
keep their high byte for uint8. float32 is TensorFlow's
DecodeImageV2: a JPEG's uint8 times float32(1/255); a PNG decoded at 16 bits
(8-bit samples times 257) times float32(1/65535). Interlaced (Adam7) PNGs
decode too. Any other format, and any stream the decoders refuse, raises
ValueError: nothing falls back to another decoder.

The VLM pretraining data and the `generate` / `demo` entry points read
images as PIL does instead: `open_rgb(path)` gives what

    np.asarray(Image.open(path).convert("RGB"))

gives, and `load_image(path, size)` what `...convert("RGB").resize((size,
size))` gives (Pillow's BICUBIC resample, `resize_bicubic_pil`), bit for bit.
PIL decodes JPEG with libjpeg-turbo's accurate integer IDCT (JDCT_ISLOW),
which `decode_jpeg(data, dct_method="INTEGER_ACCURATE")` selects (TF's name
for it); the rest of the JPEG path is shared with decode_image. open_rgb
also reads GIF's first frame as Pillow 12.1 does (`decode_gif`: the LZW
stream in `src/gif_decode.cc`).

`encode_jpeg(rgb, comment)` writes the bytes Pillow 12.1 writes for
`Image.fromarray(rgb).save(path, "JPEG")` (`src/jpeg_encode.cc`: quality
75, 4:2:0, libjpeg-turbo's accurate integer DCT and standard Huffman
tables), with the image's comment as a COM marker as Pillow carries it:
the OCR-VQA conversion of preprocessing/download.py.
"""

from __future__ import annotations

import ctypes
import struct
import zlib
from typing import Optional, Tuple

import numpy as np

from bridgelang_tpu_torch import native

JPEG_MAGIC = b"\xff\xd8\xff"
PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
GIF_MAGICS = (b"GIF87a", b"GIF89a")
_OTHER_MAGIC = {b"GIF8": "GIF", b"BM": "BMP", b"RIFF": "WebP"}
_ERR_LEN = 256

# Adam7 passes: (first column, first row, column step, row step)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
DCT_METHODS = {"INTEGER_FAST": 0, "INTEGER_ACCURATE": 1}


def decode_image(data, dtype=np.uint8) -> np.ndarray:
    """An encoded JPEG or PNG as [H, W, C] (C = 1 gray, 2 gray+alpha, 3 RGB,
    4 RGBA): uint8, or float32 in [0, 1]."""
    data = bytes(data)
    dtype = np.dtype(dtype)
    if dtype not in (np.uint8, np.float32):
        raise ValueError(f"decode_image: dtype must be uint8 or float32, got {dtype}")
    if data[:3] == JPEG_MAGIC:
        image = decode_jpeg(data)
        return image if dtype == np.uint8 else image.astype(np.float32) * np.float32(1.0 / 255)
    if data[:8] == PNG_MAGIC:
        if dtype == np.uint8:
            return decode_png(data, bits=8)
        return decode_png(data, bits=16).astype(np.float32) * np.float32(1.0 / 65535)
    _refuse(data, "decode_image")


def _refuse(data: bytes, caller: str):
    for magic, name in _OTHER_MAGIC.items():
        if data.startswith(magic):
            raise ValueError(f"{caller}: {name} images are not supported (JPEG and PNG are)")
    raise ValueError(f"{caller}: not a JPEG or PNG stream (first bytes {data[:8]!r})")


def decode_jpeg(data: bytes, dct_method: str = "INTEGER_FAST") -> np.ndarray:
    """A JPEG as uint8 [H, W, 1] (gray) or [H, W, 3] (RGB), through
    libjpeg-turbo's fast ("INTEGER_FAST", TensorFlow's default) or accurate
    ("INTEGER_ACCURATE", PIL's) integer IDCT."""
    if dct_method not in DCT_METHODS:
        raise ValueError(f"decode_jpeg: dct_method must be one of {sorted(DCT_METHODS)}, got {dct_method!r}")
    accurate = DCT_METHODS[dct_method]
    lib = native._load()
    hwc = (ctypes.c_int32 * 3)()
    err = ctypes.create_string_buffer(_ERR_LEN)
    if lib.blx_jpeg_decode(data, len(data), None, 0, hwc, accurate, err, _ERR_LEN) < 0:
        raise ValueError(err.value.decode(errors="replace"))
    out = np.empty((hwc[0], hwc[1], hwc[2]), np.uint8)
    if lib.blx_jpeg_decode(data, len(data), out.ctypes.data, out.nbytes, hwc, accurate, err, _ERR_LEN) != 0:
        raise ValueError(err.value.decode(errors="replace"))
    return out


def _chunks(data: bytes):
    pos = 8
    while True:
        if pos + 12 > len(data):
            raise ValueError("truncated PNG: the stream ends before IEND")
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        end = pos + 12 + length
        if end > len(data):
            raise ValueError(f"truncated PNG: the {kind!r} chunk runs past the end")
        body = data[pos + 8:pos + 8 + length]
        crc_ok = zlib.crc32(kind + body) == struct.unpack(">I", data[end - 4:end])[0]
        critical = not kind[0] & 0x20
        if not crc_ok and critical:
            raise ValueError(f"corrupt PNG: bad CRC in the {kind!r} chunk")
        pos = end
        if crc_ok:
            yield kind, body
        if kind == b"IEND":
            return


def _unfilter(raw: memoryview, height: int, rowbytes: int, bpp: int) -> np.ndarray:
    out = np.empty((height, rowbytes), np.uint8)
    n = height * (rowbytes + 1)
    if len(raw) < n:
        raise ValueError("truncated PNG: not enough image data")
    if native._load().blx_png_unfilter(bytes(raw[:n]), n, height, rowbytes, bpp, out.ctypes.data) != 0:
        raise ValueError("corrupt PNG: bad row filter type")
    return out


def _samples(rows: np.ndarray, width: int, channels: int, depth: int) -> np.ndarray:
    """Unfiltered rows -> [h, width, channels] samples (uint8 or uint16)."""
    h = rows.shape[0]
    if depth == 8:
        return rows[:, :width * channels].reshape(h, width, channels)
    if depth == 16:
        return rows[:, :width * channels * 2].copy().view(">u2").astype(np.uint16).reshape(h, width, channels)
    per_byte = 8 // depth
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    vals = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
    return vals.reshape(h, rows.shape[1] * per_byte)[:, :width, None].astype(np.uint8)


def decode_png(data: bytes, bits: int = 8) -> np.ndarray:
    """A PNG as [H, W, C] samples at `bits` (8: uint8, 16: uint16)."""
    ihdr = plte = trns = None
    idat = []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = body
        elif kind == b"IDAT":
            idat.append(body)
        elif kind != b"IEND" and not kind[0] & 0x20:
            raise ValueError(f"unsupported PNG: unknown critical chunk {kind!r}")
    if ihdr is None or not idat:
        raise ValueError("corrupt PNG: no IHDR or IDAT chunk")
    width, height, depth, color, compression, filtering, interlace = ihdr
    if color not in _PNG_CHANNELS or depth not in (1, 2, 4, 8, 16) or compression or filtering or interlace > 1:
        raise ValueError(f"corrupt PNG: bad IHDR (color type {color}, bit depth {depth})")
    if width == 0 or height == 0:
        raise ValueError("corrupt PNG: empty image")
    channels = _PNG_CHANNELS[color]
    if (depth < 8 and color not in (0, 3)) or (color == 3 and depth == 16):
        raise ValueError(f"corrupt PNG: bit depth {depth} with color type {color}")
    inflater = zlib.decompressobj()
    try:
        raw = memoryview(inflater.decompress(b"".join(idat)))
    except zlib.error as e:
        raise ValueError(f"corrupt PNG: {e}") from None
    if not inflater.eof:
        raise ValueError("truncated PNG: the compressed image data ends early")
    pixel_bits = channels * depth
    bpp = max(1, pixel_bits // 8)
    if not interlace:
        rows = _unfilter(raw, height, (width * pixel_bits + 7) // 8, bpp)
        samples = _samples(rows, width, channels, depth)
    else:
        dt = np.uint16 if depth == 16 else np.uint8
        samples = np.empty((height, width, channels), dt)
        pos = 0
        for x0, y0, dx, dy in _ADAM7:
            pw, ph = (width - x0 + dx - 1) // dx, (height - y0 + dy - 1) // dy
            if pw <= 0 or ph <= 0:
                continue
            rowbytes = (pw * pixel_bits + 7) // 8
            rows = _unfilter(raw[pos:], ph, rowbytes, bpp)
            pos += ph * (rowbytes + 1)
            samples[y0::dy, x0::dx] = _samples(rows, pw, channels, depth)
    if color == 3:
        if plte is None:
            raise ValueError("corrupt PNG: palette image without PLTE")
        idx = samples[..., 0]
        if int(idx.max()) >= len(plte):
            raise ValueError("corrupt PNG: palette index out of range")
        out = plte[idx]
        if trns is not None:
            alpha = np.full(256, 255, np.uint8)
            alpha[:len(trns)] = np.frombuffer(trns, np.uint8)[:256]
            out = np.concatenate([out, alpha[idx][..., None]], axis=-1)
        depth = 8
    elif depth < 8:
        out = samples * np.uint8(255 // ((1 << depth) - 1))
        depth = 8
    else:
        out = samples
    if bits == 8 and depth == 16:  # libpng's png_set_strip_16: the high byte
        return (out >> 8).astype(np.uint8)
    if bits == 16 and depth == 8:
        return out.astype(np.uint16) * np.uint16(257)
    return np.ascontiguousarray(out)


def open_rgb(src) -> np.ndarray:
    """What np.asarray(Image.open(src).convert("RGB")) gives, as uint8
    [H, W, 3]; `src` is a path or the encoded bytes.

    JPEG: the accurate integer IDCT; gray replicated to RGB. PNG, by PIL's
    mode: "1", "L" (1-, 2-, 4-, 8-bit gray scaled to 8 bits) and "LA"
    replicate the gray samples; "P" takes the palette's colours (a tRNS
    chunk is dropped); "RGB" and "RGBA" keep the colour samples. Alpha is
    dropped, never composited. 16-bit samples keep their high byte (PIL's
    RGB;16B, RGBA;16B and LA;16B unpackers), except 16-bit gray, which PIL
    opens as "I;16" and converts by clipping each value to 255. GIF: the
    first frame (`decode_gif`). Any other format raises ValueError naming
    it."""
    return _open(_read(src), "open_rgb")[0]


def open_rgb_and_comment(src) -> Tuple[np.ndarray, Optional[bytes]]:
    """`open_rgb`'s pixels and the comment PIL keeps in the image's
    info["comment"] (and its JPEG writer carries): a GIF's comment
    extensions before the first frame, a JPEG's last COM marker; None where
    there is none (and for PNG, whose text chunks PIL files under other
    keys)."""
    return _open(_read(src), "open_rgb_and_comment")


def _open(data: bytes, caller: str) -> Tuple[np.ndarray, Optional[bytes]]:
    comment = None
    if data[:3] == JPEG_MAGIC:
        image = decode_jpeg(data, dct_method="INTEGER_ACCURATE")
        comment = _jpeg_comment(data)
    elif data[:8] == PNG_MAGIC:
        color, depth = _png_color_and_depth(data)
        if color == 0 and depth == 16:
            image = np.minimum(decode_png(data, bits=16), 255).astype(np.uint8)
        else:
            image = decode_png(data, bits=8)
    elif data[:6] in GIF_MAGICS:
        return decode_gif(data)
    else:
        _refuse(data, caller)
    if image.shape[-1] in (1, 2):
        return np.repeat(image[..., :1], 3, axis=-1), comment
    return np.ascontiguousarray(image[..., :3]), comment


def _jpeg_comment(data: bytes) -> Optional[bytes]:
    """The body of the last COM marker before the first scan (PIL's JPEG
    reader keeps that one in info["comment"])."""
    comment, pos = None, 2
    while pos + 4 <= len(data) and data[pos] == 0xFF:
        marker = data[pos + 1]
        if marker == 0xFF:  # fill byte
            pos += 1
            continue
        if marker == 0xDA:
            break
        length = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        if marker == 0xFE:
            comment = data[pos + 4:pos + 2 + length]
        pos += 2 + length
    return comment


def _gif_blocks(data: bytes, pos: int) -> Tuple[list, int]:
    """A GIF's data sub-blocks from `pos` up to the empty one -> (blocks, the position after it)."""
    blocks = []
    while pos < len(data) and data[pos]:
        blocks.append(data[pos + 1:pos + 1 + data[pos]])
        pos += 1 + data[pos]
    return blocks, pos + 1


def _gif_palette(p: bytes) -> Optional[np.ndarray]:
    """A GIF colour table as [n, 3] uint8, or None where every entry i is
    (i, i, i): PIL then opens the frame as "L" (the indices are the grays)."""
    table = np.frombuffer(p, np.uint8).reshape(-1, 3)
    if np.array_equal(table, np.repeat(np.arange(len(table), dtype=np.uint8)[:, None], 3, axis=1)):
        return None
    return table


def decode_gif(data) -> Tuple[np.ndarray, Optional[bytes]]:
    """A GIF's first frame as Pillow 12.1 gives it after
    Image.open(p).convert("RGB") (uint8 [H, W, 3]) and the comment it keeps
    in info["comment"] (None where there is none).

    As Pillow: the frame's local colour table, else the global one; a table
    whose entries i are all (i, i, i) is no palette (the indices are gray
    levels, mode "L"), nor is a missing one; indices past the table are
    black. The canvas is the logical screen, grown to hold a frame that
    runs past it; a frame smaller than the canvas, or offset within it,
    lies on a canvas filled with the transparency index of the frame's
    graphic control extension where there is one (the last such extension
    before the frame), else with index 0; the transparency index is
    otherwise ignored (convert("RGB") keeps its colour). Comment extensions
    before the frame are joined with b"\n"; an empty result is no comment.
    An interlaced frame's rows are put back in order (`src/gif_decode.cc`,
    which also decodes the LZW stream). A stream that ends before the frame
    is full, or holds a code its table does not, raises ValueError."""
    data = bytes(data)
    if data[:6] not in GIF_MAGICS or len(data) < 13:
        raise ValueError(f"decode_gif: not a GIF stream (first bytes {data[:8]!r})")
    width, height, flags = struct.unpack("<HHB", data[6:11])
    pos, palette = 13, None
    if flags & 0x80:
        n = 3 << ((flags & 7) + 1)
        palette = _gif_palette(data[pos:pos + n])
        pos += n
    transparency, comment = None, None
    while True:
        if pos >= len(data) or data[pos] == 0x3B:
            raise ValueError("decode_gif: no image in the GIF stream")
        kind = data[pos]
        pos += 1
        if kind == 0x21:  # an extension
            label = data[pos] if pos < len(data) else 0
            blocks, pos = _gif_blocks(data, pos + 1)
            if label == 0xF9 and blocks and len(blocks[0]) >= 4 and blocks[0][0] & 1:
                transparency = blocks[0][3]
            elif label == 0xFE:
                text = b"".join(blocks)
                comment = text if comment is None else comment + b"\n" + text
        elif kind == 0x2C:  # the first image descriptor
            x0, y0, fw, fh, fflags = struct.unpack("<HHHHB", data[pos:pos + 9])
            pos += 9
            if fflags & 0x80:
                n = 3 << ((fflags & 7) + 1)
                palette = _gif_palette(data[pos:pos + n])
                pos += n
            min_code_size = data[pos]
            blocks, _ = _gif_blocks(data, pos + 1)
            break
    canvas = np.full((max(height, y0 + fh), max(width, x0 + fw)), 0 if transparency is None else transparency,
                     np.uint8)
    if fw and fh:
        frame = np.ascontiguousarray(canvas[y0:y0 + fh, x0:x0 + fw])
        stream = b"".join(blocks)
        got = native._load().blx_gif_lzw(stream, len(stream), min_code_size, fw, fh, int(bool(fflags & 0x40)),
                                         frame.ctypes.data)
        if got < 0:
            raise ValueError({-1: "decode_gif: corrupt LZW stream (a code past the table)",
                              -2: f"decode_gif: bad LZW minimum code size {min_code_size}",
                              -3: "decode_gif: truncated LZW stream"}[got])
        canvas[y0:y0 + fh, x0:x0 + fw] = frame
    if palette is None:
        rgb = np.repeat(canvas[..., None], 3, axis=-1)
    else:
        table = np.zeros((256, 3), np.uint8)
        table[:len(palette)] = palette[:256]
        rgb = table[canvas]
    return rgb, (comment or None)


def encode_jpeg(rgb: np.ndarray, comment: Optional[bytes] = None) -> bytes:
    """The JPEG Pillow 12.1 writes for Image.fromarray(rgb).save(f, "JPEG")
    of uint8 [H, W, 3], byte for byte (`src/jpeg_encode.cc`), with
    `comment` (bytes, up to 65533) as a COM marker after the JFIF header,
    where PIL writes an image's info["comment"]."""
    rgb = np.ascontiguousarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[-1] != 3 or 0 in rgb.shape:
        raise ValueError(f"encode_jpeg: needs uint8 [H, W, 3], got {rgb.dtype} {list(rgb.shape)}")
    comment = bytes(comment or b"")
    h, w = rgb.shape[:2]
    # headers, then at most 420 bytes per block (26 bits a coefficient, each byte stuffed) and 6 blocks per MCU
    cap = 1024 + len(comment) + ((h + 15) // 16) * ((w + 15) // 16) * 6 * 420
    out = np.empty(cap, np.uint8)
    n = native._load().blx_jpeg_encode(rgb.ctypes.data, h, w, comment, len(comment), out.ctypes.data, cap)
    if n < 0:
        raise ValueError(f"encode_jpeg: cannot encode a {w}x{h} image with a comment of {len(comment)} bytes "
                         "(at most 65535 pixels a side, 65533 comment bytes)")
    return out[:n].tobytes()


def resize_bicubic_pil(rgb: np.ndarray, size) -> np.ndarray:
    """What PIL's Image.resize(size) gives for an RGB image: BICUBIC
    (a = -0.5, the support scaled by the downscale factor), fixed-point taps
    with 22 fractional bits, the horizontal pass first. `size` is (width,
    height), as PIL's."""
    rgb = np.ascontiguousarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[-1] != 3:
        raise ValueError(f"resize_bicubic_pil: needs uint8 [H, W, 3], got {rgb.dtype} {list(rgb.shape)}")
    w, h = int(size[0]), int(size[1])
    if (h, w) == rgb.shape[:2]:
        return rgb.copy()
    out = np.empty((h, w, 3), np.uint8)
    if native._load().blx_resize_bicubic_pil(rgb.ctypes.data, rgb.shape[0], rgb.shape[1], 3, out.ctypes.data,
                                             h, w) != 0:
        raise ValueError(f"resize_bicubic_pil: bad size {(w, h)}")
    return out


def load_image(src, size: int) -> np.ndarray:
    """What np.asarray(Image.open(src).convert("RGB").resize((size, size)))
    gives: the VLM pretraining datasets' frames."""
    return resize_bicubic_pil(open_rgb(src), (size, size))


def _read(src) -> bytes:
    if isinstance(src, (bytes, bytearray, memoryview)):
        return bytes(src)
    with open(src, "rb") as f:
        return f.read()


def _png_color_and_depth(data: bytes):
    if data[12:16] != b"IHDR" or len(data) < 29:
        raise ValueError("corrupt PNG: no IHDR chunk first")
    depth, color = data[24], data[25]
    return color, depth
