"""ctypes bindings for the port's native (C++) library: TFRecord framing with
CRC32C checks and the action bin codec (`src/tfrecord.cc`), and the JPEG
decoder, PNG unfilter and PIL-equal bicubic resize (`src/image_decode.cc`),
GIF LZW decoding (`src/gif_decode.cc`) and the PIL-equal JPEG encoder
(`src/jpeg_encode.cc`) of `native.image`.

Counterpart of bridgelang_tpu/native/__init__.py, over the port's own copy
of the record source. The library is compiled at first use with

    g++ -O2 -shared -fPIC -std=c++17 -o native/build/libbridgelang_native-<hash>.so src/*.cc

into a git-ignored directory; the hash covers every source and the flags, so
an edited source is rebuilt. Unlike the JAX package, nothing degrades: if
`g++` is missing or the build fails, the first call raises. Files written
by either package's writer read back byte-equal through the other's reader.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
import threading
from pathlib import Path
from typing import Iterator, List, Optional

import numpy as np

SOURCES = tuple(Path(__file__).resolve().parent / "src" / name
                for name in ("tfrecord.cc", "image_decode.cc", "gif_decode.cc", "jpeg_encode.cc"))
BUILD_DIR = Path(__file__).resolve().parent / "build"
CXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    digest = hashlib.sha256(b"".join(s.read_bytes() for s in SOURCES) + " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libbridgelang_native-{digest}.so"


def build() -> Path:
    """Compile the library unless it exists (written under a temporary name,
    then renamed, so concurrent builders never load half a file)."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the port's native library (records, image decoding and encoding) is "
                           "built with g++ at first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), *map(str, SOURCES)], capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {', '.join(s.name for s in SOURCES)} (exit {proc.returncode}):\n"
                           f"{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            u8p = ctypes.POINTER(ctypes.c_uint8)
            lib.blx_crc32c.restype = ctypes.c_uint32
            lib.blx_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
            lib.blx_reader_open.restype = ctypes.c_void_p
            lib.blx_reader_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
            lib.blx_reader_next.restype = ctypes.c_int
            lib.blx_reader_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(u8p), ctypes.POINTER(ctypes.c_int64)]
            lib.blx_reader_seek.restype = ctypes.c_int
            lib.blx_reader_seek.argtypes = [ctypes.c_void_p, ctypes.c_int64]
            lib.blx_reader_close.argtypes = [ctypes.c_void_p]
            lib.blx_count_records.restype = ctypes.c_int64
            lib.blx_count_records.argtypes = [ctypes.c_char_p, ctypes.c_int]
            lib.blx_writer_open.restype = ctypes.c_void_p
            lib.blx_writer_open.argtypes = [ctypes.c_char_p]
            lib.blx_writer_write.restype = ctypes.c_int
            lib.blx_writer_write.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64]
            lib.blx_writer_close.argtypes = [ctypes.c_void_p]
            codec = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p]
            lib.blx_actions_to_tokens.argtypes = codec
            lib.blx_tokens_to_actions.argtypes = codec
            lib.blx_jpeg_decode.restype = ctypes.c_int
            lib.blx_jpeg_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
                                            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32, ctypes.c_char_p,
                                            ctypes.c_int]
            lib.blx_png_unfilter.restype = ctypes.c_int
            lib.blx_png_unfilter.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int64,
                                             ctypes.c_int32, ctypes.c_void_p]
            lib.blx_resize_bicubic_pil.restype = ctypes.c_int
            lib.blx_resize_bicubic_pil.argtypes = [ctypes.c_void_p] + [ctypes.c_int32] * 3 + [ctypes.c_void_p] + \
                [ctypes.c_int32] * 2
            lib.blx_gif_lzw.restype = ctypes.c_int64
            lib.blx_gif_lzw.argtypes = [ctypes.c_char_p, ctypes.c_int64] + [ctypes.c_int32] * 4 + [ctypes.c_void_p]
            lib.blx_jpeg_encode.restype = ctypes.c_int64
            lib.blx_jpeg_encode.argtypes = [ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_char_p,
                                            ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64]
            _lib = lib
    return _lib


def crc32c(data: bytes) -> int:
    return _load().blx_crc32c(data, len(data))


class TFRecordWriter:
    def __init__(self, path):
        self._lib = _load()
        self._h = self._lib.blx_writer_open(str(path).encode())
        if not self._h:
            raise OSError(f"cannot open {path}")

    def write(self, record: bytes) -> None:
        if self._lib.blx_writer_write(self._h, record, len(record)) != 0:
            raise OSError("write failed")

    def close(self) -> None:
        if self._h:
            self._lib.blx_writer_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_tfrecords(path, check_crc: bool = True, offset: int = 0) -> Iterator[bytes]:
    """Each record's bytes, in file order, from the record at byte `offset`
    (one of `record_offsets(path)`) on; OSError on a bad CRC or a cut file."""
    lib = _load()
    h = lib.blx_reader_open(str(path).encode(), 1 if check_crc else 0)
    if not h:
        raise OSError(f"cannot open {path}")
    try:
        if offset and lib.blx_reader_seek(h, offset) != 0:
            raise OSError(f"cannot seek to {offset} in {path}")
        ptr = ctypes.POINTER(ctypes.c_uint8)()
        length = ctypes.c_int64()
        while True:
            status = lib.blx_reader_next(h, ctypes.byref(ptr), ctypes.byref(length))
            if status == 0:
                return
            if status < 0:
                raise OSError(f"corrupt TFRecord in {path}")
            yield ctypes.string_at(ptr, length.value)
    finally:
        lib.blx_reader_close(h)


def record_offsets(path) -> List[int]:
    """The byte offset of each record of a TFRecord file, from the length
    fields alone (each record's CRCs are checked when it is read)."""
    size = os.path.getsize(path)
    offsets, pos = [], 0
    with open(path, "rb") as f:
        while pos < size:
            header = f.read(8)
            if len(header) != 8:
                raise OSError(f"cut TFRecord in {path}")
            offsets.append(pos)
            pos += 12 + struct.unpack("<Q", header)[0] + 4
            f.seek(pos)
    if pos != size:
        raise OSError(f"cut TFRecord in {path}")
    return offsets


def count_records(path, check_crc: bool = True) -> int:
    n = _load().blx_count_records(str(path).encode(), 1 if check_crc else 0)
    if n < 0:
        raise OSError(f"corrupt TFRecord in {path}")
    return int(n)


def actions_to_tokens(actions: np.ndarray, n_bins: int = 256, vocab_size: int = 32000) -> np.ndarray:
    a = np.ascontiguousarray(actions, dtype=np.float32)
    out = np.empty(a.shape, dtype=np.int32)
    _load().blx_actions_to_tokens(a.ctypes.data, a.size, n_bins, vocab_size, out.ctypes.data)
    return out


def tokens_to_actions(tokens: np.ndarray, n_bins: int = 256, vocab_size: int = 32000) -> np.ndarray:
    t = np.ascontiguousarray(tokens, dtype=np.int32)
    out = np.empty(t.shape, dtype=np.float32)
    _load().blx_tokens_to_actions(t.ctypes.data, t.size, n_bins, vocab_size, out.ctypes.data)
    return out
