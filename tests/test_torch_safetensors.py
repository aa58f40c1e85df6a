"""The port's safetensors reader and writer against the `safetensors` library.

Bit-exact in both directions for every dtype the port reads (F32, F16, BF16,
I8, U8, I32, I64, BOOL), empty and 0-d tensors and `__metadata__`; the
writer's bytes equal the library's; a sharded directory with an index reads
as one; the reader maps a tensor's bytes only when asked for it.
"""

import json

import numpy as np
import pytest
import torch

from bridgelang_tpu_torch.util import safetensors_io as sio

safetensors_torch = pytest.importorskip("safetensors.torch")


def _tensors(seed=0):
    rng = np.random.default_rng(seed)
    f32 = torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32))
    return {
        "f32": f32,
        "f16": torch.from_numpy(rng.standard_normal((4, 2)).astype(np.float16)),
        "bf16": torch.from_numpy(rng.standard_normal((2, 3, 4)).astype(np.float32)).to(torch.bfloat16),
        "i8": torch.from_numpy(rng.integers(-128, 128, (7,), dtype=np.int8)),
        "u8": torch.from_numpy(rng.integers(0, 256, (2, 2), dtype=np.uint8)),
        "i32": torch.from_numpy(rng.integers(-2**31, 2**31 - 1, (3,), dtype=np.int32)),
        "i64": torch.from_numpy(rng.integers(-2**62, 2**62, (2,), dtype=np.int64)),
        "bool": torch.from_numpy(rng.integers(0, 2, (5,)).astype(bool)),
        "empty": torch.zeros((0, 4), dtype=torch.float32),
        "scalar": torch.tensor(3.5, dtype=torch.float32),
        "nan_inf": torch.tensor([float("nan"), float("inf"), -0.0], dtype=torch.bfloat16),
    }


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _assert_same(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert torch.equal(_bits(got[k]), _bits(want[k])), k


def test_reads_library_files_bit_equal(tmp_path):
    want = _tensors()
    path = tmp_path / "lib.safetensors"
    safetensors_torch.save_file(want, str(path), metadata={"format": "pt", "note": "é"})
    sf = sio.SafetensorsFile(path)
    assert sf.metadata == {"format": "pt", "note": "é"}
    _assert_same(sio.load_file(path), want)


def test_library_reads_port_files_and_bytes_equal(tmp_path):
    want = _tensors(1)
    ours, theirs = tmp_path / "ours.safetensors", tmp_path / "theirs.safetensors"
    sio.save_file(want, ours, metadata={"format": "pt"})
    safetensors_torch.save_file(want, str(theirs), metadata={"format": "pt"})
    assert ours.read_bytes() == theirs.read_bytes()
    _assert_same(safetensors_torch.load_file(str(ours)), want)
    sio.save_file(want, ours)  # no metadata
    safetensors_torch.save_file(want, str(theirs))
    assert ours.read_bytes() == theirs.read_bytes()


def test_lazy_entries_are_made_in_file_order_one_at_a_time(tmp_path):
    want = _tensors(2)
    made = []

    def lazy(name):
        def make():
            made.append(name)
            return want[name]
        return sio.Lazy(want[name].dtype, tuple(want[name].shape), make)

    sio.save_file({k: lazy(k) for k in want}, tmp_path / "lazy.safetensors")
    _assert_same(safetensors_torch.load_file(str(tmp_path / "lazy.safetensors")), want)
    header_order = list(sio.SafetensorsFile(tmp_path / "lazy.safetensors").entries)
    assert made == header_order
    bad = {"x": sio.Lazy(torch.float32, (2,), lambda: torch.zeros(3))}
    with pytest.raises(ValueError, match="announced"):
        sio.save_file(bad, tmp_path / "bad.safetensors")


def test_sharded_directory_reads_as_one(tmp_path):
    want = {f"layer.{i}.w": torch.full((64, 8), float(i)) for i in range(7)}
    want["bf16"] = torch.arange(10, dtype=torch.bfloat16)
    files = sio.save_sharded(want, tmp_path / "ckpt", n_shards=3)
    assert [f.name for f in files] == [f"model-0000{i}-of-00003.safetensors" for i in (1, 2, 3)]
    index = json.loads((tmp_path / "ckpt" / "model.safetensors.index.json").read_text())
    assert set(index["weight_map"]) == set(want)
    assert len(set(index["weight_map"].values())) == 3
    assert index["metadata"]["total_size"] == sum(t.numel() * t.element_size() for t in want.values())
    _assert_same(sio.load_file(tmp_path / "ckpt"), want)
    merged = {}
    for f in files:
        merged.update(safetensors_torch.load_file(str(f)))
    _assert_same(merged, want)
    headers = {}
    for f in sio.checkpoint_files(tmp_path / "ckpt"):
        sf = sio.SafetensorsFile(f)
        headers.update({k: sf.dtype_shape(k) for k in sf.keys()})
    assert headers == {k: (t.dtype, tuple(t.shape)) for k, t in want.items()}


def test_reader_maps_bytes_only_when_asked(tmp_path):
    path = tmp_path / "late.safetensors"
    sio.save_file({"a": torch.zeros(4), "b": torch.zeros(4)}, path)
    sf = sio.SafetensorsFile(path)  # header only
    _, _, begin, _ = sf.entries["b"]
    with open(path, "r+b") as f:  # rewrite b's bytes after the header was read
        f.seek(sf.data_start + begin)
        f.write(np.arange(4, dtype=np.float32).tobytes())
    assert sf.get_tensor("b").tolist() == [0.0, 1.0, 2.0, 3.0]
    names = [name for name, _ in sio.iter_tensors(path)]
    assert names == ["a", "b"]


def test_rejects_malformed_headers(tmp_path):
    path = tmp_path / "bad.safetensors"
    header = json.dumps({"x": {"dtype": "F32", "shape": [4], "data_offsets": [0, 8]}}).encode()
    path.write_bytes(len(header).to_bytes(8, "little") + header + bytes(8))
    with pytest.raises(ValueError, match="do not hold"):
        sio.SafetensorsFile(path)
    header = json.dumps({"x": {"dtype": "C64", "shape": [1], "data_offsets": [0, 8]}}).encode()
    path.write_bytes(len(header).to_bytes(8, "little") + header + bytes(8))
    with pytest.raises(ValueError, match="dtype"):
        sio.SafetensorsFile(path)
