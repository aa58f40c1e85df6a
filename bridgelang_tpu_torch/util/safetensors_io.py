"""The safetensors format, read and written with numpy and torch only.

A file is an 8-byte little-endian header length N, N bytes of JSON
`{"__metadata__": {str: str}, name: {"dtype", "shape", "data_offsets"}, ...}`
(padded with spaces to a multiple of 8), then the raw little-endian bytes of
every tensor, contiguous, at `data_offsets` = [begin, end) from the end of
the header.

Reading memory-maps each tensor's byte range on its own when it is asked
for, so iterating over a 15 GB checkpoint holds one tensor's pages at a
time; the tensor returned aliases that map (copy it to keep it). Writing is
streaming: the header comes from dtypes and shapes alone, then each tensor is
produced and written in file order, so a writer of `Lazy` entries holds one
tensor at a time. The order, header and padding are the ones the
`safetensors` library writes (dtype size descending, then name), so either
side reads the other's files.
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct
from pathlib import Path
from typing import Callable, Dict, Iterator, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

# safetensors dtype -> (torch dtype, numpy dtype the bytes are mapped as), in
# the library's file order (bigger elements first).
DTYPES: Dict[str, Tuple[torch.dtype, np.dtype]] = {
    "I64": (torch.int64, np.dtype("<i8")),
    "F32": (torch.float32, np.dtype("<f4")),
    "I32": (torch.int32, np.dtype("<i4")),
    "BF16": (torch.bfloat16, np.dtype("<u2")),  # viewed as bfloat16 after the map
    "F16": (torch.float16, np.dtype("<f2")),
    "I8": (torch.int8, np.dtype("i1")),
    "U8": (torch.uint8, np.dtype("u1")),
    "BOOL": (torch.bool, np.dtype("?")),
}
_NAMES = {t: name for name, (t, _) in DTYPES.items()}
_RANK = {name: i for i, name in enumerate(DTYPES)}
HEADER_LIMIT = 100 * 1024 * 1024  # the library's bound on the header size


@dataclasses.dataclass(frozen=True)
class Lazy:
    """A tensor the writer asks for only when it writes it."""

    dtype: torch.dtype
    shape: Tuple[int, ...]
    make: Callable[[], torch.Tensor]


TensorLike = Union[torch.Tensor, Lazy]


class SafetensorsFile:
    """One file's header; `get_tensor` maps that tensor's bytes when asked."""

    def __init__(self, path: Union[str, Path]):
        self.path = Path(path)
        with open(self.path, "rb") as f:
            head = f.read(8)
            if len(head) != 8:
                raise ValueError(f"{self.path}: shorter than a safetensors header")
            (n,) = struct.unpack("<Q", head)
            if n > HEADER_LIMIT:
                raise ValueError(f"{self.path}: header of {n} bytes exceeds {HEADER_LIMIT}")
            raw = f.read(n)
        if len(raw) != n:
            raise ValueError(f"{self.path}: header truncated ({len(raw)} of {n} bytes)")
        header = json.loads(raw.decode("utf-8"))
        self.metadata: Optional[Dict[str, str]] = header.pop("__metadata__", None)
        self.data_start = 8 + n
        size = os.path.getsize(self.path) - self.data_start
        self.entries: Dict[str, Tuple[str, Tuple[int, ...], int, int]] = {}
        for name, info in header.items():
            dtype, shape, (begin, end) = info["dtype"], tuple(int(s) for s in info["shape"]), info["data_offsets"]
            if dtype not in DTYPES:
                raise ValueError(f"{self.path}: {name}: dtype {dtype!r} is not one of {sorted(DTYPES)}")
            want = int(np.prod(shape, dtype=np.int64)) * DTYPES[dtype][1].itemsize
            if end - begin != want or begin < 0 or end > size:
                raise ValueError(f"{self.path}: {name}: offsets [{begin}, {end}) do not hold {dtype} {list(shape)} "
                                 f"in {size} data bytes")
            self.entries[name] = (dtype, shape, begin, end)

    def keys(self) -> List[str]:
        return list(self.entries)

    def dtype_shape(self, name: str) -> Tuple[torch.dtype, Tuple[int, ...]]:
        dtype, shape, _, _ = self.entries[name]
        return DTYPES[dtype][0], shape

    def get_tensor(self, name: str) -> torch.Tensor:
        """The stored tensor, a copy-on-write map of its bytes (nothing is
        read before this call; the pages go when the tensor does)."""
        dtype, shape, begin, end = self.entries[name]
        torch_dtype, np_dtype = DTYPES[dtype]
        if begin == end:
            return torch.empty(shape, dtype=torch_dtype)
        mapped = np.memmap(self.path, dtype=np_dtype, mode="c", offset=self.data_start + begin,
                           shape=(int(np.prod(shape, dtype=np.int64)),))
        t = torch.from_numpy(mapped)
        if dtype == "BF16":
            t = t.view(torch.bfloat16)
        return t.reshape(shape)


def checkpoint_files(path: Union[str, Path]) -> List[Path]:
    """A file, or the sorted `*.safetensors` of a directory (its shards)."""
    path = Path(path)
    if path.is_file():
        return [path]
    files = sorted(path.glob("*.safetensors"))
    if not files:
        raise FileNotFoundError(f"No *.safetensors under {path}")
    return files


def iter_tensors(path: Union[str, Path]) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, tensor) over a file or a directory of shards, one tensor at a
    time, in each file's data order."""
    for f in checkpoint_files(path):
        sf = SafetensorsFile(f)
        for name in sorted(sf.keys(), key=lambda k: sf.entries[k][2]):
            yield name, sf.get_tensor(name)


def load_file(path: Union[str, Path]) -> Dict[str, torch.Tensor]:
    """Every tensor of a file or directory, copied out of the maps."""
    return {name: t.clone() for name, t in iter_tensors(path)}


def _spec(t: TensorLike) -> Tuple[str, Tuple[int, ...]]:
    if t.dtype not in _NAMES:
        raise ValueError(f"dtype {t.dtype} has no safetensors name here; supported: {sorted(DTYPES)}")
    return _NAMES[t.dtype], tuple(int(s) for s in t.shape)


def _header(tensors: Mapping[str, TensorLike], metadata: Optional[Mapping[str, str]]) -> Tuple[bytes, List[str]]:
    specs = {name: _spec(t) for name, t in tensors.items()}
    order = sorted(specs, key=lambda k: (_RANK[specs[k][0]], k))
    header: Dict[str, object] = {}
    if metadata is not None:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    for name in order:
        dtype, shape = specs[name]
        size = int(np.prod(shape, dtype=np.int64)) * DTYPES[dtype][1].itemsize
        header[name] = {"dtype": dtype, "shape": list(shape), "data_offsets": [offset, offset + size]}
        offset += size
    raw = json.dumps(header, separators=(",", ":"), ensure_ascii=False).encode("utf-8")
    return raw + b" " * (-len(raw) % 8), order


def _tensor_bytes(t: torch.Tensor) -> memoryview:
    t = t.detach().to("cpu").contiguous().reshape(-1)
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return memoryview(t.numpy()).cast("B")


def save_file(tensors: Mapping[str, TensorLike], path: Union[str, Path],
              metadata: Optional[Mapping[str, str]] = None) -> None:
    """Write `tensors` (tensors, or `Lazy` entries made one at a time in
    file order) as one safetensors file."""
    header, order = _header(tensors, metadata)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(header)))
        f.write(header)
        for name in order:
            entry = tensors[name]
            t = entry.make() if isinstance(entry, Lazy) else entry
            if _spec(t) != _spec(entry):
                raise ValueError(f"{name}: produced {t.dtype} {list(t.shape)}, announced {entry.dtype} "
                                 f"{list(entry.shape)}")
            f.write(_tensor_bytes(t))
            del t


def tensor_nbytes(t: TensorLike) -> int:
    return int(np.prod(t.shape, dtype=np.int64)) * DTYPES[_spec(t)[0]][1].itemsize


def save_sharded(tensors: Mapping[str, TensorLike], out_dir: Union[str, Path], n_shards: int,
                 metadata: Optional[Mapping[str, str]] = None) -> List[Path]:
    """The HF sharded layout: `model-0000i-of-0000n.safetensors`, split in
    key order at about equal bytes, and `model.safetensors.index.json`
    ({"metadata": {"total_size"}, "weight_map": {name: file}})."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    total = sum(tensor_nbytes(t) for t in tensors.values())
    shards: List[Dict[str, TensorLike]] = [{} for _ in range(n_shards)]
    done = 0
    for name, t in tensors.items():
        shards[min(n_shards - 1, done * n_shards // max(total, 1))][name] = t
        done += tensor_nbytes(t)
    files, weight_map = [], {}
    for i, shard in enumerate(shards):
        fname = f"model-{i + 1:05d}-of-{n_shards:05d}.safetensors"
        save_file(shard, out_dir / fname, metadata)
        files.append(out_dir / fname)
        weight_map.update(dict.fromkeys(shard, fname))
    with open(out_dir / "model.safetensors.index.json", "w") as f:
        json.dump({"metadata": {"total_size": total}, "weight_map": weight_map}, f, indent=2)
    return files
