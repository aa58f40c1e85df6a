"""The port's TensorFlow-free data pipeline against the JAX package's tf.data
pipeline, on the CPU, over inputs made from seeds with numpy.

* Native episode stores: a file written by either package's writer reads
  back byte-equal through the other's reader (the CRC32C framing is the
  same bytes); episodes written by either package's `write_episode` read
  back equal through the other's `read_episodes`.
* Trajectory transforms (`chunk_act_obs` at window 1 and 2, future 0 and 7,
  episodes shorter than the window, a goal step, absolute dims), the gripper
  scans, `relabel_bridge_actions`, the `libero` and `bridge_orig`
  standardizations: exactly equal.
* `get_dataset_statistics` and the q99 / bounds / normal normalizations:
  rtol 1e-6 (both are float32 numpy or float32 TF ops in the same order;
  they agree bit for bit here).
* The lanczos3 resize against the JAX `decode_and_resize` (TF's
  scale_and_translate, then round and cast): at most one uint8 code apart, on
  at most 0.5 % of the pixels. Measured on these frames: one pixel value in
  150,528 (0.0007 %) at 256 -> 224 and at 200 -> 224, none at 224 -> 224. Where TF's float
  result overshoots [0, 255], its cast wraps modulo 256 and the port
  saturates: a separate case holds the port to the clipped TF value there.
* Each colour op at fixed factors against `tf.image.adjust_*`, and the
  random crop's bilinear resize against `tf.image.resize`: atol 1/255
  (measured: below 5e-7).
* Encoded frames: a JPEG camera frame and a 16-bit PNG depth map through
  both packages' `decode_and_resize` (224 -> 224, where the resizes agree):
  equal.
* RT-1's nested-action standardization (fractal20220817_data): equal.
* The whole `RLDSDataset` over one native store (train=False, shuffle
  buffer 1, no augmentation, the JAX tf.data set deterministic, so both read
  the file order): input_ids, attention_mask and labels equal, frames within
  the resize rule, dataset_statistics, sample_weights and true_length equal.
"""

import numpy as np
import pytest
import tensorflow as tf
import torch

from bridgelang_tpu import native as jnative
from bridgelang_tpu.models.llm.tokenizer import ByteFallbackTokenizer as JTokenizer
from bridgelang_tpu.vla import materialize as jmat
from bridgelang_tpu.vla.datasets import native_loader as jnl
from bridgelang_tpu.vla.datasets.rlds import obs_transforms as jobs
from bridgelang_tpu.vla.datasets.rlds import traj_transforms as jtraj
from bridgelang_tpu.vla.datasets.rlds.oxe import transforms as joxe
from bridgelang_tpu.vla.datasets.rlds.utils import data_utils as jdu
from bridgelang_tpu_torch import native as tnative
from bridgelang_tpu_torch.models.llm.tokenizer import ByteFallbackTokenizer
from bridgelang_tpu_torch.vla import materialize as tmat
from bridgelang_tpu_torch.vla.datasets import native_loader as tnl
from bridgelang_tpu_torch.vla.datasets.rlds import dataset as tdataset
from bridgelang_tpu_torch.vla.datasets.rlds import obs_transforms as tobs
from bridgelang_tpu_torch.vla.datasets.rlds import traj_transforms as ttraj
from bridgelang_tpu_torch.vla.datasets.rlds.oxe import transforms as toxe
from bridgelang_tpu_torch.vla.datasets.rlds.utils import data_utils as tdu

INSTRUCTIONS = ["pick up the red block", "open the drawer", "put the spoon on the towel", "push the bowl"]


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.asarray(tree.numpy() if hasattr(tree, "numpy") else tree)


def _assert_tree_equal(got, want):
    assert set(got) == set(want), (sorted(got), sorted(want))
    for k in want:
        if isinstance(want[k], dict):
            _assert_tree_equal(got[k], want[k])
        else:
            g, w = np.asarray(got[k]), np.asarray(want[k])
            if w.dtype.kind in "SO":  # TF hands strings back as object arrays of bytes
                assert g.dtype.kind in "SO" and g.shape == w.shape and g.tolist() == w.tolist(), k
                continue
            assert g.shape == w.shape and g.dtype == w.dtype, (k, g.shape, w.shape, g.dtype, w.dtype)
            np.testing.assert_array_equal(g, w, err_msg=k)


def smooth_frames(n, h, w, seed):
    """Gradients plus noise, clipped to [0, 255]: frames that compress and
    that a 3-lobe resize does not push past the uint8 range."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for i in range(n):
        base = np.stack([128 + 90 * np.sin(xx / (13 + i) + c) * np.cos(yy / (19 + c) + i) for c in range(3)], -1)
        out.append(np.clip(base + rng.normal(0, 8, (h, w, 3)), 0, 255).astype(np.uint8))
    return np.stack(out)


def random_walk_actions(t, seed):
    """7-D actions: a smooth random walk in [-1, 1], the gripper +-1."""
    rng = np.random.default_rng(seed)
    move = np.clip(np.cumsum(rng.normal(0, 0.15, (t, 6)), axis=0), -1, 1)
    grip = np.where(np.sin(np.arange(t) / 3.0 + seed) > 0, 1.0, -1.0)[:, None]
    return np.concatenate([move, grip], axis=1).astype(np.float32)


def write_store(root, name, n_episodes, t, hw, seed):
    d = root / name
    d.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    with tnative.TFRecordWriter(d / "episodes-00000.tfrecord") as w:
        for ep in range(n_episodes):
            tnl.write_episode(w, images=smooth_frames(t, hw, hw, seed + ep),
                              wrist_images=smooth_frames(t, hw, hw, seed + 100 + ep),
                              actions=random_walk_actions(t, seed + ep),
                              states=rng.normal(size=(t, 8)).astype(np.float32),
                              language=INSTRUCTIONS[ep % len(INSTRUCTIONS)])
    return d


# --- native files ----------------------------------------------------------------


def test_native_files_read_byte_equal_across_packages(tmp_path):
    rng = np.random.default_rng(0)
    records = [rng.bytes(int(n)) for n in rng.integers(0, 5000, 12)] + [b""]
    for i, (writer, reader) in enumerate(((tnative, jnative), (jnative, tnative))):
        path = tmp_path / f"r{i}.tfrecord"
        with writer.TFRecordWriter(str(path)) as w:
            for r in records:
                w.write(r)
        assert list(reader.read_tfrecords(str(path))) == records
        assert reader.count_records(str(path)) == len(records)
    assert (tmp_path / "r0.tfrecord").read_bytes() == (tmp_path / "r1.tfrecord").read_bytes()
    for r in records[:4]:
        assert tnative.crc32c(r) == jnative.crc32c(r)
    # a flipped byte fails the CRC in both readers
    data = bytearray((tmp_path / "r0.tfrecord").read_bytes())
    data[40] ^= 0xFF
    (tmp_path / "bad.tfrecord").write_bytes(bytes(data))
    for reader in (tnative, jnative):
        with pytest.raises(OSError):
            list(reader.read_tfrecords(str(tmp_path / "bad.tfrecord")))
    acts = rng.uniform(-1.2, 1.2, (64, 7)).astype(np.float32)
    np.testing.assert_array_equal(tnative.actions_to_tokens(acts), jnative.actions_to_tokens(acts))
    toks = tnative.actions_to_tokens(acts)
    np.testing.assert_array_equal(tnative.tokens_to_actions(toks), jnative.tokens_to_actions(toks))


def test_episodes_cross_read_and_builder_splits(tmp_path):
    for i, (writer_mod, nl) in enumerate(((tnative, tnl), (jnative, jnl))):
        d = tmp_path / f"store{i}" / "libero_spatial_no_noops"
        d.mkdir(parents=True)
        with writer_mod.TFRecordWriter(str(d / "a.tfrecord")) as w:
            for ep in range(5):
                nl.write_episode(w, images=smooth_frames(3, 8, 8, ep), actions=random_walk_actions(3, ep),
                                 states=np.ones((3, 8), np.float32), language=INSTRUCTIONS[ep % 4],
                                 wrist_images=smooth_frames(3, 8, 8, ep + 9))
    for i in range(2):
        paths = sorted((tmp_path / f"store{i}" / "libero_spatial_no_noops").glob("*.tfrecord"))
        t_eps, j_eps = list(tnl.read_episodes(paths)), list(jnl.read_episodes(paths))
        assert len(t_eps) == 5
        for a, b in zip(t_eps, j_eps):
            _assert_tree_equal(a, b)
        builder_t = tnl.native_builder_factory(tmp_path / f"store{i}")("libero_spatial_no_noops")
        builder_j = jnl.native_builder_factory(tmp_path / f"store{i}")("libero_spatial_no_noops")
        for split, n in (("train", 5), ("train[:40%]", 2), ("train[:5%]", 1)):
            got = list(builder_t(split))
            want = [_np_tree(x) for x in builder_j(split).as_numpy_iterator()]
            assert len(got) == len(want) == n
            for a, b in zip(got, want):
                _assert_tree_equal(a, b)
        with pytest.raises(ValueError):
            next(builder_t("val"))


# --- trajectory transforms --------------------------------------------------------


def _trajectory(t, seed, timestep=False, absolute=True):
    rng = np.random.default_rng(seed)
    traj = {
        "observation": {"image_primary": rng.integers(0, 255, (t, 4, 4, 3), dtype=np.uint8),
                        "proprio": rng.normal(size=(t, 8)).astype(np.float32)},
        "task": {"language_instruction": np.array([b"do it"] * t)},
        "action": rng.normal(size=(t, 7)).astype(np.float32),
        "dataset_name": np.array([b"x"] * t),
    }
    if absolute:
        traj["absolute_action_mask"] = np.tile(np.array([False] * 6 + [True])[None], (t, 1))
    if timestep:
        traj["task"]["timestep"] = np.minimum(np.arange(t) + rng.integers(0, 3, t), t - 1).astype(np.int32)
    return traj


@pytest.mark.parametrize("window,future,t,timestep", [(1, 0, 9, False), (1, 7, 9, False), (1, 7, 4, True),
                                                      (2, 7, 1, False), (3, 2, 2, True)])
def test_chunk_act_obs_equals_jax(window, future, t, timestep):
    raw = _trajectory(t, seed=t + window, timestep=timestep)
    traj = jtraj.add_pad_mask_dict(tf.nest.map_structure(tf.constant, raw))
    want = _np_tree(jtraj.chunk_act_obs(traj, window_size=window, future_action_window_size=future))
    got = ttraj.chunk_act_obs(ttraj.add_pad_mask_dict(raw), window_size=window, future_action_window_size=future)
    _assert_tree_equal(got, want)
    assert got["action"].shape == (t, window + future, 7)


def test_gripper_scans_and_bridge_relabel_equal_jax():
    rng = np.random.default_rng(3)
    for t in (1, 2, 9, 30):
        g = rng.choice([0.0, 0.02, 0.5, 0.97, 1.0, 0.3], t).astype(np.float32)
        np.testing.assert_array_equal(tdu.binarize_gripper_actions(g), jdu.binarize_gripper_actions(tf.constant(g)).numpy())
        r = rng.choice([-1.0, -0.05, 0.0, 0.05, 1.0], t).astype(np.float32)
        np.testing.assert_array_equal(tdu.rel2abs_gripper_actions(r), jdu.rel2abs_gripper_actions(tf.constant(r)).numpy())
        np.testing.assert_array_equal(tdu.invert_gripper_actions(g), jdu.invert_gripper_actions(tf.constant(g)).numpy())
    np.testing.assert_array_equal(tdu.rel2abs_gripper_actions(np.zeros(5, np.float32)),
                                  jdu.rel2abs_gripper_actions(tf.zeros(5)).numpy())
    traj = {"observation": {"state": rng.normal(size=(8, 7)).astype(np.float32)},
            "action": rng.normal(size=(8, 7)).astype(np.float32)}
    _assert_tree_equal(tdu.relabel_bridge_actions(traj),
                       _np_tree(jdu.relabel_bridge_actions(tf.nest.map_structure(tf.constant, traj))))


def _raw_traj(t, seed, grip):
    rng = np.random.default_rng(seed)
    return {
        "observation": {"image_0": rng.integers(0, 255, (t, 4, 4, 3), dtype=np.uint8),
                        "state": rng.normal(size=(t, 8)).astype(np.float32)},
        "action": np.concatenate([rng.normal(size=(t, 6)), grip(rng, t)[:, None]], 1).astype(np.float32),
        "language_instruction": np.array([b"stack the cups"] * t),
    }


@pytest.mark.parametrize("name", ["libero", "bridge_orig"])
def test_standardize_transforms_equal_jax(name):
    grip = {"libero": lambda rng, t: rng.choice([-1.0, 1.0, 0.4], t),
            "bridge_orig": lambda rng, t: rng.choice([0.0, 1.0, 0.5, 0.99], t)}[name]
    traj = _raw_traj(12, seed=5, grip=grip)
    want = _np_tree(getattr(joxe, name)(tf.nest.map_structure(tf.constant, traj)))
    got = getattr(toxe, name)({k: (dict(v) if isinstance(v, dict) else v) for k, v in traj.items()})
    _assert_tree_equal(got, want)
    assert toxe.OXE_STANDARDIZATION_TRANSFORMS.keys() == joxe.OXE_STANDARDIZATION_TRANSFORMS.keys()
    # RT-1's nested action dict (fractal20220817_data), which the TFDS reader yields
    rng = np.random.default_rng(6)
    rt1 = {"observation": {"image_0": traj["observation"]["image_0"],
                           "natural_language_instruction": np.array([b"pick up the can"] * 12)},
           "action": {"world_vector": rng.normal(size=(12, 3)).astype(np.float32),
                      "rotation_delta": rng.normal(size=(12, 3)).astype(np.float32),
                      "gripper_closedness_action": rng.choice([-1.0, 0.0, 1.0], (12, 1)).astype(np.float32)}}
    want = _np_tree(joxe.OXE_STANDARDIZATION_TRANSFORMS["fractal20220817_data"](tf.nest.map_structure(tf.constant, rt1)))
    _assert_tree_equal(toxe.OXE_STANDARDIZATION_TRANSFORMS["fractal20220817_data"](rt1), want)


def test_statistics_and_normalization_equal_jax(tmp_path):
    trajs = []
    for i in range(5):
        rng = np.random.default_rng(10 + i)
        act = rng.normal(size=(7 + i, 7)).astype(np.float32)
        act[:, 3] = 0.25  # a degenerate dim (min == max): zeroed under the bounds modes
        trajs.append({"action": act, "observation": {"proprio": rng.normal(size=(7 + i, 8)).astype(np.float32)}})
    deps = ["test", "train", "src"]
    want = jdu.get_dataset_statistics(tf.data.Dataset.from_generator(
        lambda: iter(trajs), output_signature={"action": tf.TensorSpec([None, 7], tf.float32),
                                               "observation": {"proprio": tf.TensorSpec([None, 8], tf.float32)}}),
        deps, save_dir=str(tmp_path / "j"), force_recompute=True)
    got = tdu.get_dataset_statistics(iter(trajs), deps, save_dir=str(tmp_path / "t"), force_recompute=True)
    assert got.keys() == want.keys() and got["num_transitions"] == want["num_transitions"] == sum(len(t["action"]) for t in trajs)
    for key in ("action", "proprio"):
        for stat in want[key]:
            np.testing.assert_allclose(got[key][stat], want[key][stat], rtol=1e-6, err_msg=f"{key}.{stat}")
    # the cache: a second call reads the file, whatever the data
    assert tdu.get_dataset_statistics(iter([]), deps, save_dir=str(tmp_path / "t")) == got
    stats = {k: ({s: np.asarray(v) for s, v in want[k].items()} if isinstance(want[k], dict) else want[k]) for k in want}
    stats["action"]["mask"] = np.array([True] * 6 + [False])
    for kind in jdu.NormalizationType:
        for traj in trajs[:2]:
            j = _np_tree(jdu.normalize_action_and_proprio(tf.nest.map_structure(tf.constant, traj), stats, kind))
            t = tdu.normalize_action_and_proprio(traj, stats, tdu.NormalizationType(kind.value))
            for a, b in ((t["action"], j["action"]), (t["observation"]["proprio"], j["observation"]["proprio"])):
                np.testing.assert_allclose(a, b, rtol=1e-6, atol=0)
    # the q99 normalizer of the action tokenizer is the pipeline's arithmetic
    from bridgelang_tpu_torch.vla.action_tokenizer import normalize_actions_q99

    q01, q99 = np.asarray(want["action"]["q01"], np.float32), np.asarray(want["action"]["q99"], np.float32)
    degenerate = np.asarray(want["action"]["min"]) == np.asarray(want["action"]["max"])
    got_q = normalize_actions_q99(torch.from_numpy(trajs[0]["action"]), torch.from_numpy(q01), torch.from_numpy(q99),
                                  mask=torch.tensor([True] * 6 + [False]), degenerate_mask=torch.from_numpy(degenerate))
    want_q = tdu.normalize_action_and_proprio(trajs[0], stats, tdu.NormalizationType.BOUNDS_Q99)["action"]
    np.testing.assert_allclose(got_q.numpy(), want_q, rtol=1e-6, atol=1e-7)
    assert tdu.allocate_threads(8, np.array([0.7, 0.2, 0.1])).tolist() == jdu.allocate_threads(8, np.array([0.7, 0.2, 0.1])).tolist()


# --- frame transforms -------------------------------------------------------------


@pytest.mark.parametrize("size_in", [256, 224, 200])
def test_lanczos3_resize_within_one_code_of_jax(size_in):
    frame = smooth_frames(1, size_in, size_in, seed=size_in)[0]
    want = jobs.decode_and_resize({"image_primary": tf.constant(frame)}, (224, 224))["image_primary"].numpy()
    got = tobs.decode_and_resize({"image_primary": frame}, (224, 224))["image_primary"]
    assert got.shape == want.shape == (224, 224, 3) and got.dtype == np.uint8
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() <= 0.005, ((diff > 0).mean(), diff.max())


def test_lanczos3_overshoot_saturates_where_tf_wraps():
    frame = np.zeros((64, 64, 3), np.uint8)
    frame[:, 32:] = 255  # a hard edge: the 3-lobe kernel overshoots both ways
    tf_float = tf.image.resize(tf.cast(frame, tf.float32), (56, 56), method="lanczos3").numpy()
    got = tobs.decode_and_resize({"image_primary": frame}, (56, 56))["image_primary"]
    assert (np.round(tf_float) > 255).any() and (np.round(tf_float) < 0).any()
    np.testing.assert_array_equal(got, np.clip(np.round(tf_float), 0, 255).astype(np.uint8))


def test_colour_ops_equal_tf_at_fixed_factors():
    x = smooth_frames(1, 40, 48, seed=2)[0].astype(np.float32) / 255.0
    for op, tf_op, factors in (("adjust_brightness", tf.image.adjust_brightness, (-0.2, 0.13)),
                               ("adjust_contrast", tf.image.adjust_contrast, (0.8, 1.17)),
                               ("adjust_saturation", tf.image.adjust_saturation, (0.8, 1.2)),
                               ("adjust_hue", tf.image.adjust_hue, (-0.05, 0.04))):
        for f in factors:
            for img in (x, np.clip(x + 0.15, 0, 1.2).astype(np.float32)):
                np.testing.assert_allclose(getattr(tobs, op)(img, f), tf_op(img, f).numpy(), atol=1 / 255, rtol=0,
                                           err_msg=f"{op}({f})")
    crop = x[3:37, 5:45]
    np.testing.assert_allclose(tobs.resize_bilinear(crop, (40, 48)),
                               tf.image.resize(crop, (40, 48), method="bilinear").numpy(), atol=1 / 255, rtol=0)


def test_augmentation_draws_stay_in_range_and_repeat():
    kw = {"random_resized_crop": {"scale": [0.9, 0.9], "ratio": [1.0, 1.0]}, "random_brightness": [0.2],
          "random_contrast": [0.8, 1.2], "random_saturation": [0.8, 1.2], "random_hue": [0.05],
          "augment_order": list(tobs.AUGMENT_OPS)}
    g = torch.Generator().manual_seed(0)
    for _ in range(50):
        f = tobs.draw_augment_factors(g, (224, 224), **kw)
        top, left, ch, cw = f["random_resized_crop"]
        assert ch == cw == 213 and 0 <= top <= 11 and 0 <= left <= 11
        assert abs(f["random_brightness"]) <= 0.2 and abs(f["random_hue"]) <= 0.05
        assert 0.8 <= f["random_contrast"] <= 1.2 and 0.8 <= f["random_saturation"] <= 1.2
    frame = smooth_frames(1, 224, 224, seed=4)[0]
    a = tobs.augment({"image_primary": frame}, torch.Generator().manual_seed(5), kw)["image_primary"]
    b = tobs.augment({"image_primary": frame}, torch.Generator().manual_seed(5), kw)["image_primary"]
    np.testing.assert_array_equal(a, b)
    assert a.dtype == np.uint8 and a.shape == frame.shape and not np.array_equal(a, frame)
    # encoded frames decode as TF decodes them: a JPEG camera frame (resized 224 -> 224, where the port's
    # lanczos3 equals TF's) and a 16-bit PNG depth map as float32
    jpeg = tf.io.encode_jpeg(frame, quality=95).numpy()
    want = jobs.decode_and_resize({"image_primary": tf.constant(jpeg)}, (224, 224))["image_primary"].numpy()
    encoded = np.empty((), dtype=object)
    encoded[()] = jpeg
    np.testing.assert_array_equal(tobs.decode_and_resize({"image_primary": encoded}, (224, 224))["image_primary"], want)
    depth = tf.io.encode_png(np.random.default_rng(7).integers(0, 65535, (20, 24, 1), dtype=np.uint16)).numpy()
    want = jobs.decode_and_resize({"depth_primary": tf.constant(depth)}, None)["depth_primary"].numpy()
    got = tobs.decode_and_resize({"depth_primary": np.array(depth)}, None)["depth_primary"]
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape == (20, 24)
    np.testing.assert_array_equal(got, want)


# --- the whole pipeline -----------------------------------------------------------


def _jax_deterministic(ds):
    """The JAX RLDSDataset with its tf.data pipeline made deterministic (it
    sets deterministic=False for speed), so it yields the file order."""
    opts = tf.data.Options()
    opts.deterministic = True
    weights = ds.dataset.sample_weights
    ds.dataset = ds.dataset.with_options(opts)
    ds.dataset.sample_weights = weights
    return ds


def test_rlds_dataset_equals_jax_over_a_native_store(tmp_path, monkeypatch):
    monkeypatch.setenv("HOME", str(tmp_path / "home"))  # a fresh statistics cache for both packages
    write_store(tmp_path / "store", "libero_spatial_no_noops", n_episodes=40, t=6, hw=64, seed=0)
    kw = dict(batch_size=4, shuffle_buffer_size=1, train=False, image_aug=False, resize_resolution=(48, 48),
              predict_stop_token=True)
    jds, _, _ = jmat.get_vla_dataset_and_collator(
        str(tmp_path / "store"), "libero_spatial_no_noops", JTokenizer(), prompt_bucket=96,
        builder_factory=jnl.native_builder_factory(tmp_path / "store"), **kw)
    tds, _, _ = tmat.get_vla_dataset_and_collator(
        str(tmp_path / "store"), "libero_spatial_no_noops", ByteFallbackTokenizer(), prompt_bucket=96,
        builder_factory=tnl.native_builder_factory(tmp_path / "store"), seed=0, num_workers=0, **kw)
    assert tds.sample_weights == [1.0] == list(_jax_deterministic(jds).dataset.sample_weights)
    assert tds.true_length == jds.true_length == len(tds) == 12  # train[:5%] of 40 episodes: 2 x 6 frames
    _assert_tree_equal(tds.dataset_statistics, {k: _np_tree(v) for k, v in jds.dataset_statistics.items()})

    j_it, t_it = iter(jds), iter(tds)
    for _ in range(5):  # 20 frames: the 12-frame split, then again
        jb, tb = next(j_it), next(t_it)
        for key in ("input_ids", "attention_mask", "labels"):
            np.testing.assert_array_equal(tb[key], jb[key], err_msg=key)
        assert tb["dataset_names"] == jb["dataset_names"]
        diff = np.abs(tb["frames"].astype(int) - jb["frames"].astype(int))
        assert tb["frames"].shape == jb["frames"].shape == (4, 48, 48, 3)
        assert diff.max() <= 1 and (diff > 0).mean() <= 0.005
    t_it.close()


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for k in ("input_ids", "labels", "frames"):
            np.testing.assert_array_equal(a[k], b[k])


def _assert_states_equal(got, want):
    assert set(got) == set(want)
    assert torch.equal(got["refs"], want["refs"])
    assert {k: v for k, v in got.items() if k != "refs"} == {k: v for k, v in want.items() if k != "refs"}


def test_rlds_dataset_train_mode_repeats_with_a_seed_and_resumes(tmp_path, monkeypatch):
    """Training mode: shuffled, augmented frames; the same seed gives the
    same batches. A stream restored from `state(k)` (saved and read back
    with weights_only) gives batch k on, reading only the trajectories its
    shuffle buffer and cursor refer to, not the stream before them. The
    reader and worker processes give the batches and states the in-process
    stream gives, and a resume there too."""
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    write_store(tmp_path / "store", "libero_spatial_no_noops", n_episodes=4, t=5, hw=32, seed=1)

    def make(seed, num_workers=0):
        ds, _, _ = tmat.get_vla_dataset_and_collator(
            str(tmp_path / "store"), "libero_spatial_no_noops", ByteFallbackTokenizer(), prompt_bucket=96,
            batch_size=3, shuffle_buffer_size=8, train=True, image_aug=True, resize_resolution=(24, 24),
            builder_factory=tnl.native_builder_factory(tmp_path / "store"), seed=seed, num_workers=num_workers)
        return ds

    reads = []
    to_traj = tnl.NativeEpisodeBuilder.to_traj
    monkeypatch.setattr(tnl.NativeEpisodeBuilder, "to_traj", lambda self, ep: reads.append(1) or to_traj(self, ep))
    it = make(3).batches()
    first = [next(it) for _ in range(24)]
    again = [b for _, b in zip(range(24), make(3))]
    _assert_batches_equal(again, first)
    state20 = it.state(20)
    assert state20["refs"].shape == (8, 4) and state20["refs"].dtype == torch.int64
    torch.save(state20, tmp_path / "state.pt")
    saved = torch.load(tmp_path / "state.pt", weights_only=True)
    reads.clear()
    resumed_it = make(3).batches(saved)
    resumed = [next(resumed_it)]
    buffered = {tuple(r[:3]) for r in saved["refs"].tolist()}
    assert len(reads) <= len(buffered) + 2  # the buffer's trajectories and the cursor's (68 frames read before)
    resumed += [next(resumed_it) for _ in range(3)]
    _assert_batches_equal(resumed, first[20:])
    _assert_states_equal(resumed_it.state(), it.state(24))

    workers = make(3, num_workers=2).batches()  # a reader and two batch workers, batches in order
    _assert_batches_equal([next(workers) for _ in range(6)], first[:6])
    _assert_states_equal(workers.state(5), make_state(make(3), 5))
    procs = list(workers._procs)
    workers.close()
    assert len(procs) == 3 and not any(p.is_alive() for p in procs)
    resumed_workers = make(3, num_workers=2).batches(saved)
    _assert_batches_equal([next(resumed_workers) for _ in range(4)], first[20:])
    resumed_workers.close()

    other = next(iter(make(4)))
    assert not np.array_equal(other["frames"], first[0]["frames"])
    with pytest.raises(ValueError, match="saved for"):
        make(4).batches(saved)
    # without a builder the directory's layout picks the reader: here the native store
    by_layout, stats = tdataset.make_dataset_from_rlds("libero_spatial_no_noops", str(tmp_path / "store"), train=True,
                                                       **_libero_kwargs())
    given, given_stats = tdataset.make_dataset_from_rlds(
        "libero_spatial_no_noops", train=True, builder=tnl.NativeEpisodeBuilder(tmp_path / "store" /
                                                                                "libero_spatial_no_noops"),
        **_libero_kwargs())
    _assert_tree_equal(stats, given_stats)
    for a, b in zip(by_layout, given):
        _assert_tree_equal(a, b)


def _libero_kwargs():
    kw = tmat_kwargs("libero_spatial_no_noops")
    return {k: v for k, v in kw.items() if k not in ("name", "data_dir", "chunk_filter_fn")}


def tmat_kwargs(name):
    from bridgelang_tpu_torch.vla.datasets.rlds.oxe.materialize import make_oxe_dataset_kwargs

    return make_oxe_dataset_kwargs(name, "unused")


def make_state(dataset, n):
    """The state of a fresh in-process pass after n batches."""
    it = dataset.batches()
    for _ in range(n):
        next(it)
    return it.state()


def test_builder_start_seeks_to_the_episode(tmp_path):
    """`builder(split, start=k)` reads from the split's k-th episode on,
    across files and under a "train[:N%]" split."""
    d = tmp_path / "store" / "ds"
    d.mkdir(parents=True)
    for f, eps in enumerate([range(0, 3), range(3, 7)]):
        with tnative.TFRecordWriter(d / f"episodes-{f:05d}.tfrecord") as w:
            for ep in eps:
                tnl.write_episode(w, images=np.full((2, 4, 4, 3), ep, np.uint8),
                                  actions=np.full((2, 7), ep, np.float32), language=f"episode {ep}")
    builder = tnl.NativeEpisodeBuilder(d)
    for split, n in (("train", 7), ("train[:50%]", 3)):
        everything = [int(t["action"][0, 0]) for t in builder(split)]
        assert everything == list(range(n))
        for start in range(n + 1):
            assert [int(t["action"][0, 0]) for t in builder(split, start=start)] == everything[start:]
    offsets = tnative.record_offsets(d / "episodes-00001.tfrecord")
    assert len(offsets) == 4 and offsets[0] == 0
    with pytest.raises(OSError):
        (d / "cut.tfrecord").write_bytes((d / "episodes-00000.tfrecord").read_bytes()[:-3])
        tnative.record_offsets(d / "cut.tfrecord")


def test_rlds_dataset_reader_failure_reaches_the_training_process(tmp_path, monkeypatch):
    """A store that breaks after the statistics pass: the reader process's
    error reaches the caller of `next`, in-process and through the workers."""
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    store = write_store(tmp_path / "store", "libero_spatial_no_noops", n_episodes=2, t=4, hw=16, seed=2)
    for workers, error, match in ((0, OSError, "corrupt"), (1, RuntimeError, "frame-reader")):
        ds, _, _ = tmat.get_vla_dataset_and_collator(
            str(tmp_path / "store"), "libero_spatial_no_noops", ByteFallbackTokenizer(), prompt_bucket=96,
            batch_size=2, shuffle_buffer_size=4, builder_factory=tnl.native_builder_factory(tmp_path / "store"),
            seed=0, num_workers=workers)
        record = store / "episodes-00000.tfrecord"
        intact = record.read_bytes()
        record.write_bytes(intact[:-5])
        it = ds.batches()
        with pytest.raises(error, match=match):
            next(it)
        it.close()
        record.write_bytes(intact)
