"""TFDS datasets read without TensorFlow or tensorflow_datasets.

The port's counterpart of what the JAX package's `_get_builder` returns
(`tfds.builder(name, data_dir)`, then `.as_dataset(split=...)` and
`.info.splits`), for datasets prepared by TFDS in its TFRecord layout:

    <data_dir>/<name>/<version>/dataset_info.json
                               /features.json
                               /<name>-<split>.tfrecord-00000-of-00016 ...

`TfdsBuilder(data_dir, name)` reads the highest semantic version present.
`dataset_info.json` gives the splits, each split's shard lengths and its
file name template; `features.json` (TFDS's proto JSON) gives each
feature's type and shape: FeaturesDict, Sequence / Dataset (an RLDS
episode's `steps`), Tensor, Scalar, Image and Text. Records are
read through the native TFRecord reader (CRC32C-checked) and each
`tf.train.Example` is parsed by the wire-format decoder below.

`builder(split, start=0)` yields one trajectory per episode, the dict that
`make_dataset_from_rlds` restructures (the JAX package builds the same from
TFDS's episodes): every `steps/...` feature as an array over the episode's
T steps, nested as in features.json (`observation`, `action` flat or a
dict), and the episode-level features under `traj_metadata`, repeated T
times (dlimp's layout). Image features stay encoded (object arrays of JPEG
or PNG bytes): `obs_transforms.decode_and_resize` decodes them where the
frames are resized, so the shuffle buffer holds encoded frames. Text and
string tensors are object arrays of bytes; bool is int64 on disk.

Splits: "train", "val", ..., and slices "train[:5%]", "train[5%:]",
"train[10:20]" in TFDS's rule: a percent boundary is
round(percent * num_examples / 100) with Python's round (half to even);
a negative boundary counts from the end. Files are read in shard order,
records in file order: TFDS's `shuffle_files` is left to the frame
stream's shuffle buffer. `start=k` begins at the split's k-th episode,
seeking to its record.

Anything else (another file format such as array_record, another feature
type or tensor encoding, a dataset_info.json without shard lengths) raises,
naming it.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
from pathlib import Path
from types import SimpleNamespace
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

from bridgelang_tpu_torch import native

DEFAULT_TEMPLATE = "{DATASET}-{SPLIT}.{FILEFORMAT}-{SHARD_X_OF_Y}"
_VERSION = re.compile(r"^(\d+)\.(\d+)\.(\d+)$")
_SPLIT = re.compile(r"^(\w+)(?:\[(-?\d*)(%?):(-?\d*)(%?)\])?$")
_NUMERIC = {"float16", "float32", "float64", "bfloat16", "int8", "int16", "int32", "int64", "uint8", "uint16",
            "uint32", "uint64", "bool"}


# --- tf.train.Example, wire format ----------------------------------------------------


def _varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if b < 0x80:
            return result, pos
        shift += 7


def _fields(buf: bytes):
    """(field number, wire type, value) of each field of one message; a
    length-delimited value is a memoryview."""
    view = memoryview(buf)
    pos, end = 0, len(buf)
    while pos < end:
        key, pos = _varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _varint(buf, pos)
        elif wire == 2:
            n, pos = _varint(buf, pos)
            value, pos = view[pos:pos + n], pos + n
        elif wire == 5:
            value, pos = view[pos:pos + 4], pos + 4
        elif wire == 1:
            value, pos = view[pos:pos + 8], pos + 8
        else:
            raise ValueError(f"tf.train.Example: unsupported wire type {wire}")
        if pos > end:
            raise ValueError("tf.train.Example: a field runs past the end of its message")
        yield field, wire, value


def _int64s(wire: int, value) -> List[int]:
    if wire == 0:
        return [value]
    data, out, pos = bytes(value), [], 0
    while pos < len(data):
        v, pos = _varint(data, pos)
        out.append(v)
    return out


def parse_example(record: bytes) -> Dict[str, Tuple[str, Any]]:
    """A serialized tf.train.Example -> {key: (kind, values)}: kind "bytes"
    (list of bytes), "float" (float32 array) or "int64" (int64 array)."""
    out: Dict[str, Tuple[str, Any]] = {}
    for field, _, features in _fields(record):
        if field != 1:
            continue
        for f2, _, entry in _fields(bytes(features)):
            if f2 != 1:
                continue
            key, feature = None, b""
            for f3, _, v in _fields(bytes(entry)):
                if f3 == 1:
                    key = bytes(v).decode()
                elif f3 == 2:
                    feature = bytes(v)
            kind, values = "bytes", []
            for f4, _, lst in _fields(feature):
                items = list(_fields(bytes(lst)))
                if f4 == 1:
                    kind, values = "bytes", [bytes(v) for f, _, v in items if f == 1]
                elif f4 == 2:
                    chunks = [bytes(v) for f, _, v in items if f == 1]
                    kind, values = "float", np.frombuffer(b"".join(chunks), "<f4").copy()
                elif f4 == 3:
                    ints = [x for f, w, v in items if f == 1 for x in _int64s(w, v)]
                    kind, values = "int64", np.array(ints, np.uint64).view(np.int64)
            out[key] = (kind, values)
    return out


def _varint_bytes(v: int) -> bytes:
    v &= (1 << 64) - 1
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _len_field(field: int, payload: bytes) -> bytes:
    return _varint_bytes((field << 3) | 2) + _varint_bytes(len(payload)) + payload


def serialize_example(features: Dict[str, Any]) -> bytes:
    """{key: list of bytes | float array | int array} -> a serialized
    tf.train.Example (packed float and int64 lists, as TensorFlow writes
    them); the kind follows the values' type."""
    entries = []
    for key in sorted(features):
        values = features[key]
        if isinstance(values, (list, tuple)) and (not values or isinstance(values[0], (bytes, bytearray))):
            lst = _len_field(1, b"".join(_len_field(1, bytes(v)) for v in values))
        else:
            arr = np.asarray(values)
            if arr.dtype.kind == "f":
                lst = _len_field(2, _len_field(1, arr.astype("<f4").tobytes()) if arr.size else b"")
            elif arr.dtype.kind in "iub":
                ints = b"".join(_varint_bytes(int(x)) for x in arr.ravel().tolist())
                lst = _len_field(3, _len_field(1, ints) if arr.size else b"")
            else:
                raise TypeError(f"serialize_example: {key}: unsupported values {arr.dtype}")
        entry = _len_field(1, key.encode()) + _len_field(2, lst)
        entries.append(_len_field(1, entry))
    return _len_field(1, b"".join(entries))


# --- features.json ------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Leaf:
    """One stored feature: kind "tensor", "image" or "text"; dtype; the
    shape of one item (-1 where unknown); whether it lies under a sequence."""

    kind: str
    dtype: str
    shape: Tuple[int, ...]
    sequence: bool


def _shape(node: Dict[str, Any]) -> Tuple[int, ...]:
    return tuple(int(d) for d in node.get("shape", {}).get("dimensions", []))


def parse_features(node: Dict[str, Any], sequence: bool = False):
    """features.json (proto JSON) -> a nested dict of `Leaf`s."""
    cls = node.get("pythonClassName", "").rsplit(".", 1)[-1]
    if cls == "FeaturesDict":
        return {k: parse_features(v, sequence) for k, v in node["featuresDict"]["features"].items()}
    if cls in ("Sequence", "Dataset"):
        if sequence:
            raise ValueError(f"features.json: a {cls} inside a sequence is not supported")
        return parse_features(node["sequence"]["feature"], True)
    if cls in ("Tensor", "Scalar"):
        t = node["tensor"]
        encoding = t.get("encoding", "none")
        if encoding not in ("none", "NONE", ""):
            raise ValueError(f"features.json: tensor encoding {encoding!r} is not supported")
        dtype = t["dtype"]
        if dtype != "string" and dtype not in _NUMERIC:
            raise ValueError(f"features.json: tensor dtype {dtype!r} is not supported")
        return Leaf("text" if dtype == "string" else "tensor", dtype, _shape(t), sequence)
    if cls == "Image":
        im = node["image"]
        fmt = im.get("encodingFormat", "png")
        if fmt not in ("png", "jpeg"):
            raise ValueError(f"features.json: image encoding {fmt!r} is not supported")
        return Leaf("image", im.get("dtype", "uint8"), _shape(im), sequence)
    if cls == "Text":
        return Leaf("text", "string", (), sequence)
    raise ValueError(f"features.json: feature type {node.get('pythonClassName')!r} is not supported (FeaturesDict, "
                     "Sequence, Dataset, Tensor, Scalar, Image and Text are)")


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Leaf):
            yield prefix + (k,), v
        else:
            yield from _leaves(v, prefix + (k,))


def _to_array(key: str, leaf: Leaf, kind: str, values, n_steps: Optional[int]):
    if leaf.kind in ("image", "text"):
        if kind != "bytes":
            raise ValueError(f"{key}: stored as {kind}, features.json says {leaf.kind}")
        if not leaf.sequence:
            return values[0] if values else b""
        arr = np.empty(len(values), dtype=object)
        arr[:] = values
        return arr
    want = "float" if leaf.dtype.startswith(("float", "bfloat")) else "int64"
    if kind != want and len(values):
        raise ValueError(f"{key}: stored as {kind}, features.json says {leaf.dtype}")
    arr = np.asarray(values, np.float32 if want == "float" else np.int64)
    shape = tuple(-1 if d < 0 else d for d in leaf.shape)
    if leaf.sequence:
        shape = (n_steps if n_steps is not None else -1,) + shape
    if shape.count(-1) > 1:
        raise ValueError(f"{key}: shape {leaf.shape} has more than one unknown dimension")
    dtype = np.dtype("float32" if leaf.dtype == "bfloat16" else leaf.dtype)
    return arr.reshape(shape).astype(dtype, copy=False)


def _nest(flat: Dict[Tuple[str, ...], Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for path, v in flat.items():
        d = out
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = v
    return out


def example_to_trajectory(example: Dict[str, Tuple[str, Any]], features: Dict[str, Any]) -> Dict[str, Any]:
    """One parsed episode -> the trajectory dict (steps' features over T,
    episode features under traj_metadata, repeated T times)."""
    leaves = list(_leaves(features))
    n_steps = None
    for path, leaf in leaves:  # T from a step feature whose items have a known size
        key = "/".join(path)
        if not leaf.sequence or key not in example:
            continue
        if leaf.kind in ("image", "text"):  # one string per step
            n_steps = len(example[key][1])
            break
        if all(d >= 0 for d in leaf.shape):
            n_steps = len(example[key][1]) // max(1, math.prod(leaf.shape))
            break
    steps, meta = {}, {}
    for path, leaf in leaves:
        key = "/".join(path)
        if key not in example:
            raise KeyError(f"tf.train.Example has no feature {key!r} (features.json lists it)")
        kind, values = example[key]
        arr = _to_array(key, leaf, kind, values, n_steps)
        if leaf.sequence:
            steps[path[1:]] = arr
        else:
            meta[path] = arr
    traj = _nest(steps)
    if meta:
        t = n_steps if n_steps is not None else len(traj.get("action", ()))
        repeated = {}
        for path, v in meta.items():
            if isinstance(v, bytes):
                a = np.empty(t, dtype=object)
                a[:] = [v] * t
            else:
                a = np.repeat(np.asarray(v)[None], t, axis=0)
            repeated[path] = a
        traj["traj_metadata"] = _nest(repeated)
    return traj


# --- splits and shards --------------------------------------------------------------


def split_bounds(split: str, num_examples: int) -> Tuple[str, int, int]:
    """("train[:5%]", 40) -> ("train", 0, 2): the split's name and the
    [from, to) episode range of TFDS's slicing (percent boundaries rounded to
    the closest integer, half to even; negative ones from the end)."""
    m = _SPLIT.match(split.replace(" ", ""))
    if not m:
        raise ValueError(f"split {split!r}: expected NAME or NAME[from:to] (percent or absolute)")
    name, a, a_pct, b, b_pct = m.groups()

    def bound(text: str, pct: str) -> Optional[int]:
        if text in (None, "", "-"):
            return None
        v = int(text)
        if pct:
            v = int(round(v * num_examples / 100.0))
        if v < 0:
            v = max(num_examples + v, 0)
        return v

    lo, hi = bound(a, a_pct), bound(b, b_pct)
    lo = 0 if lo is None else min(lo, num_examples)
    hi = num_examples if hi is None else min(hi, num_examples)
    return name, lo, max(lo, hi)


@dataclasses.dataclass
class SplitInfo:
    name: str
    shard_lengths: List[int]
    template: str

    @property
    def num_examples(self) -> int:
        return sum(self.shard_lengths)


def latest_version_dir(root: Path) -> Optional[Path]:
    """The highest x.y.z subdirectory of `root` holding dataset_info.json."""
    found = [(tuple(int(g) for g in m.groups()), d) for d in root.iterdir() if d.is_dir()
             for m in [_VERSION.match(d.name)] if m and (d / "dataset_info.json").exists()] if root.is_dir() else []
    return max(found)[1] if found else None


class TfdsBuilder:
    """`builder(split, start=0)` over a TFDS directory: the trajectories of
    the split's episodes in shard order. `info.splits[name].num_examples`
    as TFDS gives it. Picklable (paths and parsed JSON only), so worker
    processes can take it."""

    def __init__(self, data_dir, name: str):
        root = Path(data_dir) / name
        self.dir = latest_version_dir(root)
        if self.dir is None or not (self.dir / "dataset_info.json").exists():
            raise FileNotFoundError(f"no TFDS dataset under {root} (expected <version>/dataset_info.json)")
        self.name = name
        info = json.loads((self.dir / "dataset_info.json").read_text())
        self.file_format = info.get("fileFormat", "tfrecord")
        if self.file_format != "tfrecord":
            raise ValueError(f"{self.dir}: file format {self.file_format!r} is not supported (tfrecord is)")
        self.splits: Dict[str, SplitInfo] = {}
        for s in info.get("splits", []):
            if "shardLengths" not in s:
                raise ValueError(f"{self.dir}/dataset_info.json: split {s.get('name')!r} has no shardLengths")
            self.splits[s["name"]] = SplitInfo(s["name"], [int(x) for x in s["shardLengths"]],
                                               s.get("filepathTemplate") or DEFAULT_TEMPLATE)
        self.features = parse_features(json.loads((self.dir / "features.json").read_text()))
        self.info = SimpleNamespace(splits=self.splits, name=name, version=self.dir.name)
        self._offsets: Dict[Path, List[int]] = {}

    def shard_paths(self, split: str) -> List[Path]:
        s = self.splits[split]
        n = len(s.shard_lengths)
        return [self.dir / s.template.format(DATASET=self.name, SPLIT=split, FILEFORMAT=self.file_format,
                                             SHARD_INDEX=f"{i:05d}", NUM_SHARDS=f"{n:05d}",
                                             SHARD_X_OF_Y=f"{i:05d}-of-{n:05d}") for i in range(n)]

    def num_examples(self, split: str) -> int:
        name = _SPLIT.match(split.replace(" ", ""))
        if not name or name.group(1) not in self.splits:
            raise ValueError(f"{self.name}: no split {split!r} (splits: {sorted(self.splits)})")
        s = self.splits[name.group(1)]
        _, lo, hi = split_bounds(split, s.num_examples)
        return hi - lo

    def offsets(self, path: Path) -> List[int]:
        if path not in self._offsets:
            self._offsets[path] = native.record_offsets(path)
        return self._offsets[path]

    def __call__(self, split: str, start: int = 0) -> Iterator[Dict[str, Any]]:
        m = _SPLIT.match(split.replace(" ", ""))
        if not m or m.group(1) not in self.splits:
            raise ValueError(f"{self.name}: no split {split!r} (splits: {sorted(self.splits)})")
        info = self.splits[m.group(1)]
        _, lo, hi = split_bounds(split, info.num_examples)
        return self._read(info, lo + start, hi)

    def _read(self, info: SplitInfo, first: int, stop: int) -> Iterator[Dict[str, Any]]:
        i = 0
        for path, n in zip(self.shard_paths(info.name), info.shard_lengths):
            if i + n <= first:
                i += n
                continue
            if i >= stop:
                return
            if not path.exists():
                raise FileNotFoundError(f"{path}: a shard dataset_info.json lists is missing")
            offset = 0
            if first > i:
                offset, i = self.offsets(path)[first - i], first
            for record in native.read_tfrecords(str(path), offset=offset):
                if i >= stop:
                    return
                yield example_to_trajectory(parse_example(record), self.features)
                i += 1


def open_builder(data_dir, name: str):
    """The builder of `<data_dir>/<name>` by its layout: a TFDS version
    directory (`<version>/dataset_info.json`) -> TfdsBuilder; native episode
    files (`*.tfrecord`) -> native_loader.NativeEpisodeBuilder."""
    from bridgelang_tpu_torch.vla.datasets.native_loader import NativeEpisodeBuilder

    if data_dir is None:
        raise ValueError(f"{name}: no data_dir to read the dataset from (a TFDS directory or a native store)")
    root = Path(data_dir) / name
    if latest_version_dir(root) is not None:
        return TfdsBuilder(data_dir, name)
    if root.is_dir() and any(root.glob("*.tfrecord")):
        return NativeEpisodeBuilder(root)
    raise FileNotFoundError(f"{root}: neither a TFDS dataset (<version>/dataset_info.json) nor a native episode "
                            "store (*.tfrecord)")

