"""Every OXE standardization transform of the port against the JAX package's,
and the port's DROID rotation helpers against the JAX ones and scipy, on the
CPU.

Each key of the JAX OXE_STANDARDIZATION_TRANSFORMS runs on a synthetic
trajectory holding the keys its transform reads (seeded numpy: flat or
nested actions, wide states, depth maps, encoded frames, ZLIB-compressed
kuka states, language_table's code points with non-ASCII and invalid ones):
outputs equal exactly, except the quaternion-to-Euler dims (float32 atan2 /
asin: rtol 1e-6, atol 1e-7). DROID's camera swap is checked by branch: the
port's output under a draw above and below 1/2 against the JAX output that
took the same branch. The droid_utils functions: float64 within 1e-12 of the
JAX functions, Euler matrices against scipy's extrinsic xyz.
"""

import zlib

import numpy as np
import pytest
import tensorflow as tf
from scipy.spatial.transform import Rotation

from bridgelang_tpu.vla.datasets.rlds.oxe import droid_utils as jdu
from bridgelang_tpu.vla.datasets.rlds.oxe import transforms as joxe
from bridgelang_tpu_torch.vla.datasets.rlds.oxe import droid_utils as tdu
from bridgelang_tpu_torch.vla.datasets.rlds.oxe import transforms as toxe

T = 9
# transforms whose action is a dict (the gripper command [T, 1], or [T] for these three)
DICT_ACTION = {"rt1", "kuka", "taco_play", "jaco_play", "berkeley_cable_routing", "roboturk", "nyu_door_opening",
               "viola", "berkeley_autolab_ur5", "toto", "bc_z", "bridge_oxe", "pusht", "rh20t"}
GRIP_1D = {"viola", "berkeley_autolab_ur5", "pusht"}
QUATERNION = {"furniture_bench", "iamlab_pick_insert", "cmu_playing_with_food"}  # Euler dims 3:6


def _strings(values):
    out = np.empty(len(values), dtype=object)
    out[:] = values
    return out


def _f(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def synthetic_trajectory(fn_name: str, seed: int) -> dict:
    """The raw keys every transform reads, one recipe for the flat-action
    datasets and one for the nested-action ones."""
    rng = np.random.default_rng(seed)
    frames = _strings([bytes(rng.integers(0, 256, 40, dtype=np.uint8)) + b"\xff\xd9" for _ in range(T)])
    lang = _strings([b"put the cup on the plate"] * T)
    grip = rng.choice(np.array([-1.0, 0.0, 0.3, 1.0], np.float32), (T, 1))
    obs = {"image": frames, "state": _f(rng, T, 40), "depth": rng.integers(0, 999, (T, 4, 4, 1)).astype(np.int32),
           "depth_additional_view": rng.integers(0, 999, (T, 4, 4, 1)).astype(np.int32),
           "depth_image": _f(rng, T, 4, 4, 1), "cartesian_position": _f(rng, T, 6), "gripper_position": grip.copy(),
           "eef_pose": _f(rng, T, 7), "state_gripper_pose": _f(rng, T), "end_effector_pose": _f(rng, T, 5),
           "position": _f(rng, T, 2), "yaw": _f(rng, T, 1), "exterior_image_1_left": frames,
           "exterior_image_2_left": frames[::-1].copy(), "natural_language_instruction": lang}
    code_points = np.zeros((T, 24), np.int32)
    for i in range(T):
        text = [ord(c) for c in f"push the {'ré' if i % 2 else 'blue'} block {i}"]
        code_points[i, :len(text)] = text
    code_points[2, 5] = 0xD800  # a surrogate: TF's encoder writes U+FFFD
    obs["instruction"] = code_points
    traj = {"observation": obs, "language_instruction": lang,
            "traj_metadata": {"episode_metadata": {"file_path": _strings([b"ep.hdf5"] * T)}},
            "ground_truth_states": {"EE": _f(rng, T, 6)},
            "action_dict": {"cartesian_velocity": _f(rng, T, 6), "gripper_position": grip.copy()}}
    if fn_name in DICT_ACTION:
        g = rng.choice(np.array([-1.0, 0.0, 0.5, 1.0], np.float32), T)
        traj["action"] = {
            "world_vector": _f(rng, T, 3), "rotation_delta": _f(rng, T, 3),
            "gripper_closedness_action": g if fn_name in GRIP_1D else g[:, None],
            "open_gripper": rng.integers(0, 2, T).astype(bool), "rel_actions_world": _f(rng, T, 7),
            "future/xyz_residual": _f(rng, T, 30), "future/axis_angle_residual": _f(rng, T, 30),
            "future/target_close": rng.integers(0, 2, (T, 10)).astype(np.int64),
            "tcp_base": _f(rng, T, 7), "gripper": rng.integers(0, 2, T).astype(bool)}
        obs.update(robot_obs=_f(rng, T, 15), end_effector_cartesian_pos=_f(rng, T, 7), robot_state=_f(rng, T, 15),
                   image_with_depth=_f(rng, T, 4, 4, 1), tcp_base=_f(rng, T, 7), gripper_width=_f(rng, T),
                   state=_f(rng, T, 7))
        for key, width in (("clip_function_input/base_pose_tool_reached", 7), ("gripper_closed", 1)):
            obs[key] = _strings([zlib.compress(_f(rng, width).tobytes()) for _ in range(T)])
    else:
        action = _f(rng, T, 20)
        action[:, -1] = rng.choice(np.array([0.0, 0.02, 0.5, 0.98, 1.0], np.float32), T)
        if fn_name in QUATERNION:
            q = Rotation.random(T, random_state=seed).as_quat().astype(np.float32)  # [x, y, z, w]
            action[:, 3:7] = q
        traj["action"] = action
    return traj


def _copy(tree):
    return {k: _copy(v) if isinstance(v, dict) else v for k, v in tree.items()}


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.asarray(tree.numpy() if hasattr(tree, "numpy") else tree)


def _assert_tree_equal(got, want, loose=(), path=()):
    assert set(got) == set(want), (path, sorted(got), sorted(want))
    for k in want:
        if isinstance(want[k], dict):
            _assert_tree_equal(got[k], want[k], loose, path + (k,))
            continue
        g, w = np.asarray(got[k]), np.asarray(want[k])
        if w.dtype.kind in "SO":
            assert g.dtype.kind in "SO" and g.shape == w.shape and g.tolist() == w.tolist(), path + (k,)
            continue
        assert g.shape == w.shape and g.dtype == w.dtype, (path + (k,), g.shape, w.shape, g.dtype, w.dtype)
        if path + (k,) in loose:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7, err_msg=str(path + (k,)))
        else:
            np.testing.assert_array_equal(g, w, err_msg=str(path + (k,)))


class _Draw:
    """A generator stand-in whose uniform() gives `value`."""

    def __init__(self, value):
        self.value = value

    def uniform(self):
        return self.value


@pytest.mark.parametrize("name", list(joxe.OXE_STANDARDIZATION_TRANSFORMS))
def test_transform_equals_jax(name):
    jfn = joxe.OXE_STANDARDIZATION_TRANSFORMS[name]
    tfn = toxe.OXE_STANDARDIZATION_TRANSFORMS[name]
    assert tfn.__name__ == jfn.__name__
    traj = synthetic_trajectory(jfn.__name__, seed=sum(map(ord, name)))
    before = _np_tree(_copy(traj))
    want = _np_tree(jfn(tf.nest.map_structure(tf.constant, _copy(traj))))
    loose = {("action",)} if jfn.__name__ in QUATERNION else ()
    if jfn.__name__ == "droid_baseact":  # the JAX draw took one branch; the port's same branch must equal it
        swapped = not np.array_equal(want["observation"]["exterior_image_1_left"], traj["observation"]["exterior_image_1_left"])
        got = tfn(_copy(traj), rng=_Draw(0.3 if swapped else 0.7))
        _assert_tree_equal(got, want)
        other = tfn(_copy(traj), rng=_Draw(0.7 if swapped else 0.3))
        assert other["observation"]["exterior_image_1_left"].tolist() == \
            want["observation"]["exterior_image_2_left"].tolist()
        assert other["observation"]["exterior_image_2_left"].tolist() == \
            want["observation"]["exterior_image_1_left"].tolist()
    else:
        got = tfn(_copy(traj))
        _assert_tree_equal(got, want, loose)
    _assert_tree_equal(_np_tree(traj), before)  # the input is not modified
    if name.startswith(("libero", "bridge", "fractal", "kuka", "taco", "jaco")):
        assert got["action"].shape[-1] == 7


def test_registries_hold_the_same_datasets_and_language_table_cuts_at_nul():
    assert list(toxe.OXE_STANDARDIZATION_TRANSFORMS) == list(joxe.OXE_STANDARDIZATION_TRANSFORMS)
    out = toxe.language_table(synthetic_trajectory("language_table", 0))["language_instruction"]
    assert out[0] == b"push the blue block 0" and out[1] == "push the ré block 1".encode()
    assert out[2] == "push �he blue block 2".encode()


def test_droid_utils_equal_jax_and_scipy():
    rng = np.random.default_rng(0)
    euler = np.stack([rng.uniform(-np.pi, np.pi, 64), rng.uniform(-1.4, 1.4, 64), rng.uniform(-np.pi, np.pi, 64)], -1)
    euler[:4, 1] = [np.pi / 2, -np.pi / 2, np.pi / 2 - 1e-7, 0.0]  # gimbal lock and its edge
    rmat = tdu.euler_to_rmat(euler)
    np.testing.assert_allclose(rmat, jdu.euler_to_rmat(tf.constant(euler)).numpy(), atol=1e-12)
    np.testing.assert_allclose(rmat, Rotation.from_euler("xyz", euler).as_matrix(), atol=1e-12)
    np.testing.assert_allclose(tdu.rmat_to_euler(rmat), jdu.rmat_to_euler(tf.constant(rmat)).numpy(), atol=1e-12)
    np.testing.assert_allclose(tdu.euler_to_rmat(tdu.rmat_to_euler(rmat)), rmat, atol=1e-7)
    np.testing.assert_allclose(tdu.rmat_to_euler(rmat[8:]), euler[8:], atol=1e-9)
    np.testing.assert_array_equal(tdu.mat_to_rot6d(rmat), np.concatenate([rmat[:, 0], rmat[:, 1]], -1))
    np.testing.assert_allclose(tdu.euler_to_r6(euler), jdu.euler_to_r6(tf.constant(euler)).numpy(), atol=1e-12)
    vel = np.concatenate([rng.uniform(-1, 1, (64, 3)), rng.uniform(-0.5, 0.5, (64, 3))], -1)
    pose = np.concatenate([rng.uniform(-1, 1, (64, 3)), euler], -1)
    got = tdu.velocity_act_to_wrist_frame(vel, pose)
    np.testing.assert_allclose(got, jdu.velocity_act_to_wrist_frame(tf.constant(vel), tf.constant(pose)).numpy(),
                               atol=1e-12)
    r = Rotation.from_euler("xyz", pose[:, 3:6]).as_matrix()
    want_t = np.einsum("bji,bj->bi", r, vel[:, :3])
    want_r = np.swapaxes(r, 1, 2) @ Rotation.from_euler("xyz", vel[:, 3:6]).as_matrix() @ r
    np.testing.assert_allclose(got, np.concatenate([want_t, want_r[:, 0], want_r[:, 1]], -1), atol=1e-12)
    for acts in (np.zeros((3, 7), np.float32), rng.normal(size=(3, 7)).astype(np.float32)):
        norm_zero = 2 * (0 - tdu._DROID_Q01) / (tdu._DROID_Q99 - tdu._DROID_Q01 + 1e-8) - 1
        frame = {"action": np.concatenate([np.tile(norm_zero, (3, 1)), acts[:, 6:]], 1) if not acts.any() else acts}
        assert tdu.zero_action_filter(frame) == bool(jdu.zero_action_filter(tf.nest.map_structure(tf.constant, frame)))
