"""Native episode store: npz episodes framed as TFRecords, read without
TensorFlow.

Counterpart of bridgelang_tpu/vla/datasets/native_loader.py, with the same
files: each record is one episode, an `np.savez_compressed` blob of
`images` [T, H, W, 3] uint8, `actions` [T, D] float32, `language`, and
optionally `states` [T, S] float32 and `wrist_images`, written and read by
the port's native library (bridgelang_tpu_torch.native, CRC32C-checked).
A store written by either package reads in the other.

`NativeEpisodeBuilder(dir)(split)` is the `builder` of the port's
`make_dataset_from_rlds`: an iterator of numpy trajectory dicts in file
order (the JAX builder returns a `tf.data.Dataset` of the same dicts).
"""

from __future__ import annotations

import functools
import io
import re
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, Optional, Sequence

import numpy as np

from bridgelang_tpu_torch import native


def write_episode(writer, *, images: np.ndarray, actions: np.ndarray, states: Optional[np.ndarray] = None,
                  language: str = "", wrist_images: Optional[np.ndarray] = None) -> None:
    """Append one episode (arrays over time) to a `native.TFRecordWriter`."""
    buf = io.BytesIO()
    payload = {
        "images": np.ascontiguousarray(images),
        "actions": np.ascontiguousarray(actions.astype(np.float32)),
        "language": np.array(language),
    }
    if states is not None:
        payload["states"] = np.ascontiguousarray(states.astype(np.float32))
    if wrist_images is not None:
        payload["wrist_images"] = np.ascontiguousarray(wrist_images)
    np.savez_compressed(buf, **payload)
    writer.write(buf.getvalue())


def read_episodes(paths: Sequence[Path]) -> Iterator[Dict[str, Any]]:
    """Raw episode dicts from native TFRecord files, in order."""
    for path in paths:
        for record in native.read_tfrecords(str(path)):
            yield decode_episode(record)


def decode_episode(record: bytes) -> Dict[str, Any]:
    with np.load(io.BytesIO(record), allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def split_fraction(split: str) -> Optional[float]:
    """None for "train" (every episode), N/100 for "train[:N%]"."""
    if split == "train":
        return None
    m = re.fullmatch(r"train\[:(\d+)%\]", split)
    if not m:
        raise ValueError(f"NativeEpisodeBuilder supports 'train' and 'train[:N%]' splits, got {split!r}")
    return int(m.group(1)) / 100.0


class NativeEpisodeBuilder:
    """`builder` for make_dataset_from_rlds over a directory of native
    TFRecord episode files: `builder(split)` yields RLDS-style trajectories
    {observation: {image, wrist_image, state}, action, language_instruction}.
    "train[:N%]" takes the first max(1, int(N% of the episodes)), as the JAX
    builder does. `builder(split, start=k)` begins at the split's k-th
    episode, seeking to its record (what a resumed data stream reads)."""

    def __init__(self, data_dir, image_key: str = "image", wrist_key: str = "wrist_image"):
        self.paths = sorted(Path(data_dir).glob("*.tfrecord"))
        if not self.paths:
            raise FileNotFoundError(f"no *.tfrecord under {data_dir}")
        self.image_key = image_key
        self.wrist_key = wrist_key
        self._offsets: Dict[Path, list] = {}

    def offsets(self, path: Path) -> list:
        if path not in self._offsets:
            self._offsets[path] = native.record_offsets(path)
        return self._offsets[path]

    def to_traj(self, ep: Dict[str, Any]) -> Dict[str, Any]:
        t = len(ep["actions"])
        obs: Dict[str, Any] = {self.image_key: ep["images"]}
        if "wrist_images" in ep:
            obs[self.wrist_key] = ep["wrist_images"]
        if "states" in ep:
            obs["state"] = ep["states"]
        return {
            "observation": obs,
            "action": ep["actions"],
            "language_instruction": np.repeat(str(ep["language"]).encode(), t),
        }

    def __call__(self, split: str, start: int = 0) -> Iterator[Dict[str, Any]]:
        frac = split_fraction(split)
        n_take = None
        if frac is not None:
            n_total = sum(native.count_records(p) for p in self.paths)
            n_take = max(1, int(n_total * frac))
        i = 0
        for path in self.paths:
            offset = 0
            if start > i:
                offsets = self.offsets(path)
                if start >= i + len(offsets):
                    i += len(offsets)
                    continue
                offset, i = offsets[start - i], start
            for record in native.read_tfrecords(str(path), offset=offset):
                if n_take is not None and i >= n_take:
                    return
                yield self.to_traj(decode_episode(record))
                i += 1


def native_builder_factory(root_dir) -> Callable[[str], NativeEpisodeBuilder]:
    """`builder_factory` for RLDSDataset: dataset name -> NativeEpisodeBuilder
    over `<root_dir>/<name>/` (the TFDS directory convention); picklable, so
    the dataset's worker processes can take it."""
    return functools.partial(_native_builder, Path(root_dir))


def _native_builder(root_dir: Path, name: str) -> NativeEpisodeBuilder:
    return NativeEpisodeBuilder(root_dir / name)
