"""The port's TFDS reader (vla/datasets/rlds/tfds_reader.py) against
TensorFlow's parsing and the JAX package's pipeline, on the CPU.

TFDS directories are written here with TensorFlow (tf.train.Example,
tf.io.TFRecordWriter, dataset_info.json and features.json as TFDS writes
them) in LIBERO's layout and in RT-1's (fractal20220817_data: a nested action
dict). The JAX package reads them through `TfBuilder`, a builder with
`.as_dataset` / `.info.splits` over TensorFlow's own parsing that decodes the
frames with tf.io.decode_image, as TFDS's Image feature does (the JAX package
passes no SkipDecoding); the port reads them with no builder.

* tf.train.Example wire format: the port's parser and serializer against
  protobuf's (tf.train.Example), packed and unpacked lists, negative ints.
* The smoke run's TFDS writer (chip_smoke.write_tfds_dataset), at a tiny
  size: every record parses with tf.io.parse_single_example to the arrays it
  was given.
* TfdsBuilder against TfBuilder: every split form (train, train[:5%],
  train[5%:], train[10:20], train[-3:]) gives the same episodes, steps and
  metadata; frames bit-equal after decoding; `start=` seeks.
* get_vla_dataset_and_collator of both packages over one directory (the rule
  of test_torch_data_pipeline.py's native-store test): statistics equal,
  input_ids and labels equal, frames within one code on at most 0.5 % of the
  pixels (the lanczos3 rule), true_length (train[:5%]) equal; for LIBERO and
  for fractal20220817_data.
* A resumed stream over a TFDS directory gives the uninterrupted batches,
  in process and through the reader and worker processes.
* EpisodicRLDSDataset over a TFDS directory equals the JAX one.
* Layout and refusals: `open_builder` picks TFDS or the native store by the
  directory, the highest version, and refuses array_record, an unknown
  feature type or a dataset_info.json without shard lengths, naming them.
"""

import json
import math
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import tensorflow as tf
import torch

import chip_smoke as cs
from bridgelang_tpu.models.llm.tokenizer import ByteFallbackTokenizer as JTokenizer
from bridgelang_tpu.vla import materialize as jmat
from bridgelang_tpu.vla.datasets.datasets import EpisodicRLDSDataset as JEpisodic
from bridgelang_tpu.vla.datasets.datasets import RLDSBatchTransform as JBatchTransform
from bridgelang_tpu.vla.action_tokenizer import ActionTokenizer as JActionTokenizer
from bridgelang_tpu_torch.models.llm.tokenizer import ByteFallbackTokenizer
from bridgelang_tpu_torch.native.image import decode_image
from bridgelang_tpu_torch.vla import materialize as tmat
from bridgelang_tpu_torch.vla.action_tokenizer import ActionTokenizer
from bridgelang_tpu_torch.vla.datasets.datasets import EpisodicRLDSDataset, RLDSBatchTransform
from bridgelang_tpu_torch.vla.datasets.native_loader import NativeEpisodeBuilder
from bridgelang_tpu_torch.vla.datasets.rlds import tfds_reader as tr

LIBERO, FRACTAL = "libero_spatial_no_noops", cs.TFDS_FRACTAL


def _jpeg_frames(n, hw, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:hw, 0:hw]
    out = []
    for i in range(n):
        base = np.stack([128 + 90 * np.sin(xx / (9 + i % 5) + c) * np.cos(yy / (13 + c)) for c in range(3)], -1)
        frame = np.clip(base + rng.normal(0, 6, (hw, hw, 3)), 0, 255).astype(np.uint8)
        out.append(tf.io.encode_jpeg(frame, quality=95).numpy())
    return out


def _feature(values):
    if isinstance(values, list):
        return tf.train.Feature(bytes_list=tf.train.BytesList(value=values))
    arr = np.asarray(values)
    if arr.dtype.kind == "f":
        return tf.train.Feature(float_list=tf.train.FloatList(value=arr.ravel().tolist()))
    return tf.train.Feature(int64_list=tf.train.Int64List(value=arr.ravel().astype(np.int64).tolist()))


def write_with_tf(root, name, episodes, features, n_shards, template=None):
    """A TFDS directory written by TensorFlow: shards of consecutive episodes
    as tf.train.Example records, dataset_info.json and features.json."""
    out = Path(root) / name / "1.0.0"
    out.mkdir(parents=True)
    bounds = [len(episodes) * i // n_shards for i in range(n_shards + 1)]
    fmt = template or tr.DEFAULT_TEMPLATE
    for i in range(n_shards):
        path = out / fmt.format(DATASET=name, SPLIT="train", FILEFORMAT="tfrecord", SHARD_INDEX=f"{i:05d}",
                                NUM_SHARDS=f"{n_shards:05d}", SHARD_X_OF_Y=f"{i:05d}-of-{n_shards:05d}")
        with tf.io.TFRecordWriter(str(path)) as w:
            for ep in episodes[bounds[i]:bounds[i + 1]]:
                ex = tf.train.Example(features=tf.train.Features(feature={k: _feature(v) for k, v in ep.items()}))
                w.write(ex.SerializeToString())
    split = {"name": "train", "shardLengths": [str(bounds[i + 1] - bounds[i]) for i in range(n_shards)]}
    if template:
        split["filepathTemplate"] = template
    (out / "dataset_info.json").write_text(json.dumps({"name": name, "version": "1.0.0", "splits": [split]}))
    (out / "features.json").write_text(json.dumps(features))
    return out


class TfBuilder:
    """What tfds.builder(name, data_dir) gives the JAX package, over
    TensorFlow's parsing: `.info.splits[...].num_examples` and
    `.as_dataset(split)`, episodes of {"steps": Dataset, "episode_metadata"}
    with images decoded by tf.io.decode_image (channels from features.json)."""

    def __init__(self, root, name):
        self.dir = Path(root) / name / "1.0.0"
        info = json.loads((self.dir / "dataset_info.json").read_text())["splits"][0]
        self.lengths = [int(x) for x in info["shardLengths"]]
        self.template = info.get("filepathTemplate", tr.DEFAULT_TEMPLATE)
        self.name = name
        self.leaves = dict(tr._leaves(tr.parse_features(json.loads((self.dir / "features.json").read_text()))))
        self.info = SimpleNamespace(splits={"train": SimpleNamespace(num_examples=sum(self.lengths))})

    def _spec(self):
        spec = {}
        for path, leaf in self.leaves.items():
            dtype = tf.string if leaf.kind in ("image", "text") else (
                tf.float32 if leaf.dtype.startswith("float") else tf.int64)
            shape = () if leaf.kind in ("image", "text") else leaf.shape
            spec["/".join(path)] = (tf.io.FixedLenSequenceFeature(shape, dtype, allow_missing=True) if leaf.sequence
                                    else tf.io.FixedLenFeature(shape, dtype))
        return spec

    def as_dataset(self, split, shuffle_files=False, **_):
        n = sum(self.lengths)
        m = tr._SPLIT.match(split)
        name, a, a_pct, b, b_pct = m.groups()

        def bound(text, pct):  # TFDS: round(pct * n / 100), negative from the end
            if not text:
                return None
            v = int(round(int(text) * n / 100.0)) if pct else int(text)
            return max(n + v, 0) if v < 0 else v

        lo, hi = bound(a, a_pct) or 0, bound(b, b_pct)
        hi = n if hi is None else min(hi, n)
        files = [str(self.dir / self.template.format(
            DATASET=self.name, SPLIT=name, FILEFORMAT="tfrecord", SHARD_INDEX=f"{i:05d}",
            NUM_SHARDS=f"{len(self.lengths):05d}", SHARD_X_OF_Y=f"{i:05d}-of-{len(self.lengths):05d}"))
            for i in range(len(self.lengths))]
        spec, leaves = self._spec(), self.leaves

        def episode(record):
            ex = tf.io.parse_single_example(record, spec)
            steps, meta = {}, {}
            for path, leaf in leaves.items():
                v = ex["/".join(path)]
                if leaf.kind == "image":
                    v = tf.map_fn(lambda s: tf.io.decode_image(s, channels=leaf.shape[-1], expand_animations=False),
                                  v, fn_output_signature=tf.TensorSpec(leaf.shape, tf.uint8))
                elif leaf.kind == "tensor" and leaf.dtype != "int64":
                    v = tf.cast(v, leaf.dtype)
                target = steps if leaf.sequence else meta
                d = target
                for k in (path[1:] if leaf.sequence else path)[:-1]:
                    d = d.setdefault(k, {})
                d[path[-1]] = v
            return {"steps": tf.data.Dataset.from_tensor_slices(steps), **meta}

        return tf.data.TFRecordDataset(files).skip(lo).take(max(hi - lo, 0)).map(episode)


def _libero_eps(n, t, hw, seed):
    frames = _jpeg_frames(12, hw, seed)
    return [cs.libero_episode(e, t, frames) for e in range(n)]


def _fractal_eps(n, t, hw, seed):
    frames = _jpeg_frames(8, hw, seed)
    return [cs.fractal_episode(e, t, frames) for e in range(n)]


def _np(x):
    return np.asarray(x.numpy() if hasattr(x, "numpy") else x)


# --- wire format ------------------------------------------------------------------


def test_example_wire_format_equals_protobuf():
    rng = np.random.default_rng(0)
    features = {"a/bytes": [b"", b"\x00\xff" * 40, rng.bytes(300)], "b/float": rng.normal(size=11).astype(np.float32),
                "c/int": np.array([0, 1, -1, 2 ** 40, -(2 ** 62), 127, 128]), "d/empty_float": np.zeros(0, np.float32),
                "e/bool": np.array([True, False, True])}
    ours = tr.serialize_example(features)
    ex = tf.train.Example.FromString(ours)
    want = tf.train.Example(features=tf.train.Features(feature={k: _feature(v) for k, v in features.items()}))
    assert ex == want
    for record in (ours, want.SerializeToString()):
        parsed = tr.parse_example(record)
        assert parsed["a/bytes"] == ("bytes", features["a/bytes"])
        np.testing.assert_array_equal(parsed["b/float"][1], features["b/float"])
        np.testing.assert_array_equal(parsed["c/int"][1], features["c/int"])
        np.testing.assert_array_equal(parsed["e/bool"][1], [1, 0, 1])
    # unpacked repeated fields (wire types 0 and 5) parse too
    unpacked = tr._len_field(1, tr._len_field(1, tr._len_field(1, b"k") + tr._len_field(2, tr._len_field(
        3, b"\x08\x05\x08\x7f"))) + tr._len_field(1, tr._len_field(1, b"f") + tr._len_field(2, tr._len_field(
            2, b"\x0d" + np.float32(1.5).tobytes() + b"\x0d" + np.float32(-2).tobytes()))))
    parsed = tr.parse_example(unpacked)
    np.testing.assert_array_equal(parsed["k"][1], [5, 127])
    np.testing.assert_array_equal(parsed["f"][1], [1.5, -2.0])


def test_smoke_writer_parses_in_tf_to_its_arrays(tmp_path):
    eps = _libero_eps(5, 4, 16, seed=1)
    out = Path(cs.write_tfds_dataset(str(tmp_path), LIBERO, eps, cs.libero_features(16), n_shards=2))
    builder = TfBuilder(tmp_path, LIBERO)
    spec = builder._spec()
    records = [r for f in sorted(out.glob("*.tfrecord-*")) for r in tf.data.TFRecordDataset(str(f)).as_numpy_iterator()]
    assert len(records) == 5
    for ep, record in zip(eps, records):
        parsed = tf.io.parse_single_example(record, spec)
        for key, values in ep.items():
            got = _np(parsed[key])
            if isinstance(values, list):
                assert np.atleast_1d(got).tolist() == values, key
            else:
                np.testing.assert_array_equal(got.reshape(np.shape(values)), values, err_msg=key)
    info = json.loads((out / "dataset_info.json").read_text())
    assert info["splits"][0]["shardLengths"] == ["2", "3"]


# --- the reader against TensorFlow's parsing ----------------------------------------


def _assert_traj_equal_tf(got, want_episode):
    """A TfdsBuilder trajectory against a TfBuilder episode (frames decoded
    by TensorFlow; the port's stay encoded until decode_image)."""
    steps = next(iter(want_episode["steps"].batch(10 ** 6)))

    def walk(g, w, path):
        for k, wv in w.items():
            if isinstance(wv, dict):
                walk(g[k], wv, path + (k,))
                continue
            gv, wv = g[k], _np(wv)
            if gv.dtype == object and wv.dtype == np.uint8:  # an image: decode ours
                gv = np.stack([decode_image(b) for b in gv])
                np.testing.assert_array_equal(gv, wv, err_msg=str(path + (k,)))
            elif gv.dtype == object:
                assert gv.tolist() == wv.tolist(), path + (k,)
            else:
                assert gv.dtype == wv.dtype or (wv.dtype == np.int64 and gv.dtype == bool), (path + (k,), gv.dtype)
                np.testing.assert_array_equal(gv, wv, err_msg=str(path + (k,)))

    walk(got, {k: v for k, v in steps.items()}, ())
    meta = got["traj_metadata"]["episode_metadata"]
    for k, v in want_episode["episode_metadata"].items():
        assert meta[k].tolist() == [_np(v).item()] * len(got["action"] if not isinstance(got["action"], dict)
                                                          else next(iter(got["action"].values())))


@pytest.mark.parametrize("name", [LIBERO, FRACTAL])
def test_tfds_builder_equals_tf_parsing(tmp_path, name):
    eps = _libero_eps(23, 3, 24, 2) if name == LIBERO else _fractal_eps(23, 3, 24, 3)
    features = cs.libero_features(24) if name == LIBERO else cs.fractal_features(24)
    write_with_tf(tmp_path, name, eps, features, n_shards=4,
                  template=None if name == LIBERO else "{DATASET}-{SPLIT}.{FILEFORMAT}-{SHARD_INDEX}-of-{NUM_SHARDS}")
    ours, theirs = tr.open_builder(str(tmp_path), name), TfBuilder(tmp_path, name)
    assert isinstance(ours, tr.TfdsBuilder) and ours.info.splits["train"].num_examples == 23
    for split in ("train", "train[:5%]", "train[5%:]", "train[10:20]", "train[-3:]", "train[:50%]"):
        got, want = list(ours(split)), list(theirs.as_dataset(split=split))
        assert len(got) == len(want) == ours.num_examples(split), split
        for g, w in zip(got, want):
            _assert_traj_equal_tf(g, w)
    assert ours.num_examples("train[:5%]") == 1  # round(1.15) (TFDS's rule)
    def ids(trajs):
        return [next(iter(t["traj_metadata"]["episode_metadata"].values()))[0] for t in trajs]

    everything = ids(ours("train"))
    assert len(set(everything)) == 23
    for start in (0, 1, 5, 6, 22, 23):
        assert ids(ours("train", start=start)) == everything[start:]
    assert ids(ours("train[5%:]", start=3)) == everything[1 + 3:]


def test_split_boundaries_follow_tfds_rounding():
    assert tr.split_bounds("train[:5%]", 40) == ("train", 0, 2)
    assert tr.split_bounds("train[:5%]", 10) == ("train", 0, 0)  # round(0.5) is 0: half to even
    assert tr.split_bounds("train[:5%]", 30) == ("train", 0, 2)  # round(1.5) is 2
    assert tr.split_bounds("train[5%:]", 40) == ("train", 2, 40)
    assert tr.split_bounds("train[-10%:]", 40) == ("train", 36, 40)
    assert tr.split_bounds("train[10:200]", 40) == ("train", 10, 40)
    assert tr.split_bounds("val", 7) == ("val", 0, 7)
    with pytest.raises(ValueError):
        tr.split_bounds("train+val", 7)


# --- both packages' pipelines over one TFDS directory --------------------------------


def _jax_deterministic(ds):
    opts = tf.data.Options()
    opts.deterministic = True
    weights = ds.dataset.sample_weights
    ds.dataset = ds.dataset.with_options(opts)
    ds.dataset.sample_weights = weights
    return ds


@pytest.mark.parametrize("name", [LIBERO, FRACTAL])
def test_rlds_dataset_equals_jax_over_a_tfds_directory(tmp_path, monkeypatch, name):
    monkeypatch.setenv("HOME", str(tmp_path / "home"))  # a fresh statistics cache for both packages
    if name == LIBERO:
        write_with_tf(tmp_path / "tfds", name, _libero_eps(40, 6, 64, 4), cs.libero_features(64), n_shards=3)
    else:
        write_with_tf(tmp_path / "tfds", name, _fractal_eps(40, 6, 64, 5), cs.fractal_features(64), n_shards=3)
    kw = dict(batch_size=4, shuffle_buffer_size=1, train=False, image_aug=False, resize_resolution=(48, 48),
              predict_stop_token=True)
    jds, _, _ = jmat.get_vla_dataset_and_collator(str(tmp_path / "tfds"), name, JTokenizer(), prompt_bucket=96,
                                                  builder_factory=lambda n: TfBuilder(tmp_path / "tfds", n), **kw)
    tds, _, _ = tmat.get_vla_dataset_and_collator(str(tmp_path / "tfds"), name, ByteFallbackTokenizer(),
                                                  prompt_bucket=96, seed=0, num_workers=0, **kw)
    assert tds.sample_weights == [1.0] == list(_jax_deterministic(jds).dataset.sample_weights)
    assert tds.true_length == jds.true_length == len(tds) == 12  # train[:5%]: 2 episodes of 6 steps
    want_stats = {k: (tf.nest.map_structure(_np, v) if isinstance(v, dict) else v)
                  for k, v in jds.dataset_statistics.items()}
    _assert_stats_equal(tds.dataset_statistics, want_stats)
    j_it, t_it = iter(jds), iter(tds)
    for _ in range(5):  # 20 frames: the split, then again
        jb, tb = next(j_it), next(t_it)
        for key in ("input_ids", "attention_mask", "labels"):
            np.testing.assert_array_equal(tb[key], jb[key], err_msg=key)
        assert tb["dataset_names"] == jb["dataset_names"]
        diff = np.abs(tb["frames"].astype(int) - jb["frames"].astype(int))
        assert tb["frames"].shape == jb["frames"].shape == (4, 48, 48, 3)
        assert diff.max() <= 1 and (diff > 0).mean() <= 0.005
    t_it.close()


def _assert_stats_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], dict):
            _assert_stats_equal(got[k], want[k])
        else:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


def _batches_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        for k in ("input_ids", "labels", "frames"):
            np.testing.assert_array_equal(x[k], y[k])


def test_resume_over_a_tfds_directory(tmp_path, monkeypatch):
    """Training mode (shuffled, augmented) over a two-dataset mixture of TFDS
    directories: a stream restored from state(k) gives batch k on, in this
    process and through the reader and worker processes (the builders travel
    to them pickled)."""
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    root = tmp_path / "tfds"
    write_with_tf(root, LIBERO, _libero_eps(5, 5, 32, 6), cs.libero_features(32), n_shards=2)
    write_with_tf(root, FRACTAL, _fractal_eps(4, 4, 32, 7), cs.fractal_features(32), n_shards=2)
    monkeypatch.setitem(tmat_mixtures(), "test_mix", [(LIBERO, 1.0), (FRACTAL, 1.0)])

    def make(num_workers=0):
        ds, _, _ = tmat.get_vla_dataset_and_collator(
            str(root), "test_mix", ByteFallbackTokenizer(), prompt_bucket=96, batch_size=3, shuffle_buffer_size=8,
            train=True, image_aug=True, resize_resolution=(24, 24), seed=3, num_workers=num_workers)
        return ds

    it = make().batches()
    first = [next(it) for _ in range(10)]
    assert {n for b in first for n in b["dataset_names"]} == {LIBERO, FRACTAL}
    saved = it.state(7)
    resumed = make().batches(saved)
    _batches_equal([next(resumed) for _ in range(3)], first[7:])
    workers = make(num_workers=1).batches(saved)
    _batches_equal([next(workers) for _ in range(3)], first[7:])
    workers.close()


def tmat_mixtures():
    from bridgelang_tpu_torch.vla.datasets.rlds.oxe.mixtures import OXE_NAMED_MIXTURES

    return OXE_NAMED_MIXTURES


def test_episodic_dataset_equals_jax_over_a_tfds_directory(tmp_path, monkeypatch):
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    write_with_tf(tmp_path, LIBERO, _libero_eps(4, 3, 16, 8), cs.libero_features(16), n_shards=2)
    tok, jtok = ByteFallbackTokenizer(), JTokenizer()
    ours = EpisodicRLDSDataset(str(tmp_path), LIBERO, RLDSBatchTransform(ActionTokenizer(tok), tok), train=True)
    theirs = JEpisodic(str(tmp_path), LIBERO, JBatchTransform(JActionTokenizer(jtok), jtok), train=True,
                       builder=TfBuilder(tmp_path, LIBERO))
    got, want = list(ours), list(theirs)
    assert len(got) == len(want) == 4
    for g_ep, w_ep in zip(got, want):
        assert len(g_ep) == len(w_ep) == 3
        for g, w in zip(g_ep, w_ep):
            np.testing.assert_array_equal(np.asarray(g["input_ids"]), np.asarray(w["input_ids"]))
            np.testing.assert_array_equal(np.asarray(g["frames"]), np.asarray(w["pixel_values"] if "pixel_values" in w
                                                                              else w["frames"]))


# --- layout and refusals -----------------------------------------------------------


def test_open_builder_picks_the_layout_and_refuses_what_it_cannot_read(tmp_path):
    eps = _libero_eps(3, 2, 8, 9)
    cs.write_tfds_dataset(str(tmp_path), LIBERO, eps, cs.libero_features(8), n_shards=1)
    older = tmp_path / LIBERO / "0.9.0"
    older.mkdir()
    (older / "dataset_info.json").write_text("{}")
    assert tr.open_builder(str(tmp_path), LIBERO).dir.name == "1.0.0"
    native = tmp_path / "native_store"
    native.mkdir()
    (native / "a.tfrecord").write_bytes(b"")
    assert isinstance(tr.open_builder(str(tmp_path), "native_store"), NativeEpisodeBuilder)
    with pytest.raises(FileNotFoundError, match="neither"):
        tr.open_builder(str(tmp_path), "missing")
    with pytest.raises(ValueError, match="data_dir"):
        tr.open_builder(None, LIBERO)
    d = tmp_path / LIBERO / "1.0.0"
    info = json.loads((d / "dataset_info.json").read_text())
    (d / "dataset_info.json").write_text(json.dumps(dict(info, fileFormat="array_record")))
    with pytest.raises(ValueError, match="array_record"):
        tr.TfdsBuilder(str(tmp_path), LIBERO)
    del info["splits"][0]["shardLengths"]
    (d / "dataset_info.json").write_text(json.dumps(info))
    with pytest.raises(ValueError, match="shardLengths"):
        tr.TfdsBuilder(str(tmp_path), LIBERO)
    with pytest.raises(ValueError, match="Video"):
        tr.parse_features({"pythonClassName": "tensorflow_datasets.core.features.video_feature.Video"})
    with pytest.raises(ValueError, match="zlib"):
        tr.parse_features({"pythonClassName": "x.Tensor", "tensor": {"dtype": "float32", "encoding": "zlib"}})
