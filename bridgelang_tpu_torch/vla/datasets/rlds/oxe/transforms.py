"""Per-dataset standardization transforms for Open X-Embodiment datasets, in
numpy.

Counterpart of bridgelang_tpu/vla/datasets/rlds/oxe/transforms.py, every
function and registry entry of it. Each transform maps a raw trajectory (a
dict of numpy arrays over time, nested as the TFDS reader yields it) to the
canonical layout:

    action [T, 7] = EEF delta xyz (3) + delta rpy (3) + ABSOLUTE gripper
                    with +1 = open / 0 = close
    observation gains the state keys named by the dataset's config
    language_instruction hoisted to the trajectory top level when needed

A transform returns a new trajectory dict with a new observation dict; the
arrays and the nested action dicts it was given are not modified. DROID's
random swap of its two exterior cameras draws from the `rng` it is passed
(a fresh generator when none is, as the JAX package draws from TF's
unseeded random op).
"""

from __future__ import annotations

import zlib
from typing import Any, Callable, Dict, Optional

import numpy as np

from bridgelang_tpu_torch.vla.datasets.rlds.utils.data_utils import (
    binarize_gripper_actions,
    invert_gripper_actions,
    rel2abs_gripper_actions,
    relabel_bridge_actions,
)

Traj = Dict[str, Any]


# --- combinators --------------------------------------------------------------


def _own(traj: Traj) -> Traj:
    """A shallow copy with its own observation dict, for in-place edits."""
    traj = dict(traj)
    traj["observation"] = dict(traj["observation"])
    return traj


def _cat(*xs) -> np.ndarray:
    return np.concatenate(xs, axis=-1)


def _f32(x) -> np.ndarray:
    return np.asarray(x).astype(np.float32)


def _grip(mode: str, g: np.ndarray) -> np.ndarray:
    """Normalize a gripper channel to absolute +1=open/0=close."""
    if mode == "clip":
        return np.clip(g, 0, 1)
    if mode == "invert_clip":
        return invert_gripper_actions(np.clip(g, 0, 1))
    if mode == "invert":
        return invert_gripper_actions(g)
    if mode == "rel2abs":
        return rel2abs_gripper_actions(g[..., 0] if g.ndim == 2 else g)[..., None]
    if mode == "binarize":
        return binarize_gripper_actions(g[..., 0] if g.ndim == 2 else g)[..., None]
    if mode == "pass":
        return g
    raise ValueError(mode)


def _rt1_style(traj: Traj, grip_mode: str = "rel2abs", hoist_language: bool = True) -> Traj:
    """Structured action dict {world_vector, rotation_delta, gripper_closedness_action}."""
    traj = _own(traj)
    a = traj["action"]
    traj["action"] = _cat(a["world_vector"], a["rotation_delta"], _grip(grip_mode, a["gripper_closedness_action"]))
    if hoist_language:
        traj["language_instruction"] = traj["observation"]["natural_language_instruction"]
    return traj


def _flat_action(traj: Traj, grip_mode: str) -> Traj:
    """Flat [.., >=7] action: first 6 dims kept, last dim is gripper."""
    traj = _own(traj)
    a = traj["action"]
    traj["action"] = _cat(a[:, :6], _grip(grip_mode, a[:, -1:]))
    return traj


def _split_state(traj: Traj, eef_key: str = "EEF_state", grip_key: str = "gripper_state",
                 src: str = "state", eef_slice=(0, 6), grip_slice=(-1, None)) -> Traj:
    traj = _own(traj)
    state = traj["observation"][src]
    g0, g1 = grip_slice
    traj["observation"][eef_key] = state[:, eef_slice[0]:eef_slice[1]]
    traj["observation"][grip_key] = state[:, g0:g1]
    return traj


def _drop_first_step(traj: Traj) -> Traj:
    out = {}
    for key, val in traj.items():
        if key == "traj_metadata":
            out[key] = val
        elif isinstance(val, dict):
            out[key] = {k: v[1:] for k, v in val.items()}
        else:
            out[key] = val[1:]
    return out


def _quat_action_to_euler(q: np.ndarray) -> np.ndarray:
    """Quaternion [x,y,z,w] -> euler xyz (the JAX package's formula, as it
    runs without tensorflow_graphics), in the quaternion's dtype."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    roll = np.arctan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    pitch = np.arcsin(np.clip(2 * (w * y - z * x), -1.0, 1.0).astype(q.dtype))
    yaw = np.arctan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    return np.stack([roll, pitch, yaw], axis=-1)


# --- per-dataset transforms ---------------------------------------------------


def bridge_oxe(traj: Traj) -> Traj:
    """Bridge V2 as packaged in OXE: drop the all-zero first step, structured
    action with boolean open_gripper, then state-delta relabeling."""
    traj = _drop_first_step(traj)
    a = traj["action"]
    traj["action"] = _cat(a["world_vector"], a["rotation_delta"], _f32(a["open_gripper"][:, None]))
    traj["language_instruction"] = traj["observation"]["natural_language_instruction"]
    traj = relabel_bridge_actions(traj)
    return _split_state(traj)


def bridge_orig(traj: Traj) -> Traj:
    """Bridge V2 from the project website: drop the zero first step, binarize
    the continuous gripper, relabel actions from state deltas."""
    traj = _drop_first_step(traj)
    traj["action"] = np.concatenate(
        (traj["action"][:, :6], binarize_gripper_actions(traj["action"][:, -1])[:, None]), axis=1)
    traj = relabel_bridge_actions(traj)
    return _split_state(traj)


def rt1(traj: Traj) -> Traj:
    return _rt1_style(traj, "rel2abs")


def kuka(traj: Traj) -> Traj:
    traj = _rt1_style(traj, "rel2abs", hoist_language=False)
    obs = traj["observation"]

    def unzip(key, width):  # tf.io.decode_compressed(ZLIB), then decode_raw(float32)
        raw = [np.frombuffer(zlib.decompress(bytes(b)), "<f4") for b in obs[key]]
        return np.concatenate(raw).astype(np.float32).reshape(-1, width)

    obs["clip_function_input/base_pose_tool_reached"] = unzip("clip_function_input/base_pose_tool_reached", 7)
    obs["gripper_closed"] = unzip("gripper_closed", 1)
    traj["language_instruction"] = obs["natural_language_instruction"]
    return traj


def taco_play(traj: Traj) -> Traj:
    traj = _own(traj)
    obs = traj["observation"]
    obs["state_eef"] = obs["robot_obs"][:, :6]
    obs["state_gripper"] = obs["robot_obs"][:, 7:8]
    a = traj["action"]["rel_actions_world"]
    traj["action"] = _cat(a[:, :6], np.clip(a[:, -1:], 0, 1))
    traj["language_instruction"] = obs["natural_language_instruction"]
    return traj


def jaco_play(traj: Traj) -> Traj:
    traj = _own(traj)
    obs = traj["observation"]
    obs["state_eef"] = obs["end_effector_cartesian_pos"][:, :6]
    obs["state_gripper"] = obs["end_effector_cartesian_pos"][:, -1:]
    a = traj["action"]
    grip = rel2abs_gripper_actions(a["gripper_closedness_action"][:, 0])
    traj["action"] = _cat(a["world_vector"], np.zeros_like(a["world_vector"]), grip[:, None])
    traj["language_instruction"] = obs["natural_language_instruction"]
    return traj


def berkeley_cable_routing(traj: Traj) -> Traj:
    traj = _own(traj)
    a = traj["action"]
    traj["action"] = _cat(a["world_vector"], a["rotation_delta"], np.zeros_like(a["world_vector"][:, :1]))
    traj["language_instruction"] = traj["observation"]["natural_language_instruction"]
    return traj


def roboturk(traj: Traj) -> Traj:
    return _rt1_style(traj, "invert_clip")


def nyu_door_opening(traj: Traj) -> Traj:
    return _rt1_style(traj, "rel2abs")


def viola(traj: Traj) -> Traj:
    traj = _own(traj)
    a = traj["action"]
    grip = invert_gripper_actions(np.clip(a["gripper_closedness_action"][:, None], 0, 1))
    traj["action"] = _cat(a["world_vector"], a["rotation_delta"], grip)
    traj["language_instruction"] = traj["observation"]["natural_language_instruction"]
    return traj


def berkeley_autolab_ur5(traj: Traj) -> Traj:
    traj = _own(traj)
    obs = traj["observation"]
    obs["state"] = obs["robot_state"][:, 6:14]
    obs["depth"] = obs.pop("image_with_depth")
    a = traj["action"]
    grip = rel2abs_gripper_actions(a["gripper_closedness_action"])
    traj["action"] = _cat(a["world_vector"], a["rotation_delta"], grip[:, None])
    traj["language_instruction"] = obs["natural_language_instruction"]
    return traj


def toto(traj: Traj) -> Traj:
    traj = _own(traj)
    a = traj["action"]
    traj["action"] = _cat(a["world_vector"], a["rotation_delta"], _f32(a["open_gripper"][:, None]))
    traj["language_instruction"] = traj["observation"]["natural_language_instruction"]
    return traj


def _instruction_from_code_points(row: np.ndarray) -> bytes:
    """tf.strings.unicode_encode(row, "UTF-8") (an invalid code point becomes
    U+FFFD), cut at the first NUL."""
    chars = "".join(chr(c) if 0 <= c <= 0x10FFFF and not 0xD800 <= c <= 0xDFFF else "�" for c in row.tolist())
    return chars.encode("utf-8").split(b"\x00", 1)[0]


def language_table(traj: Traj) -> Traj:
    traj = _own(traj)
    a = traj["action"]  # 2D push action
    traj["action"] = _cat(a, np.zeros_like(a), np.zeros_like(a), np.ones_like(a[:, :1]))
    rows = np.asarray(traj["observation"]["instruction"])
    lang = np.empty(len(rows), dtype=object)
    lang[:] = [_instruction_from_code_points(r) for r in rows]
    traj["language_instruction"] = lang
    return traj


def stanford_hydra(traj: Traj) -> Traj:
    traj = _flat_action(traj, "invert")
    obs = traj["observation"]
    obs["eef_state"] = _cat(obs["state"][:, :3], obs["state"][:, 7:10])
    obs["gripper_state"] = obs["state"][:, -3:-2]
    return traj


def austin_buds(traj: Traj) -> Traj:
    traj = _flat_action(traj, "invert_clip")
    traj["observation"]["state"] = traj["observation"]["state"][:, :8]
    return traj


def nyu_franka_play(traj: Traj) -> Traj:
    traj = _own(traj)
    obs = traj["observation"]
    obs["depth"] = _f32(obs["depth"][..., 0])
    obs["depth_additional_view"] = _f32(obs["depth_additional_view"][..., 0])
    obs["eef_state"] = obs["state"][:, -6:]
    a = traj["action"]
    traj["action"] = _cat(a[:, -8:-2], np.clip(a[:, -2:-1], 0, 1))
    return traj


def furniture_bench(traj: Traj) -> Traj:
    traj = _own(traj)
    obs = traj["observation"]
    obs["state"] = _cat(obs["state"][:, :7], obs["state"][:, -1:])
    a = traj["action"]
    traj["action"] = _cat(a[:, :3], _quat_action_to_euler(a[:, 3:7]), invert_gripper_actions(np.clip(a[:, -1:], 0, 1)))
    return traj


def ucsd_kitchen(traj: Traj) -> Traj:
    traj = _own(traj)
    traj["observation"]["joint_state"] = traj["observation"]["state"][:, :7]
    traj["action"] = traj["action"][..., :-1]
    return traj


def austin_sailor(traj: Traj) -> Traj:
    return _flat_action(traj, "invert_clip")


def austin_sirius(traj: Traj) -> Traj:
    return _flat_action(traj, "invert_clip")


def bc_z(traj: Traj) -> Traj:
    traj = _own(traj)
    a = traj["action"]
    traj["action"] = _cat(a["future/xyz_residual"][:, :3], a["future/axis_angle_residual"][:, :3],
                          invert_gripper_actions(_f32(a["future/target_close"][:, :1])))
    traj["language_instruction"] = traj["observation"]["natural_language_instruction"]
    return traj


def dlr_edan_shared_control(traj: Traj) -> Traj:
    return _flat_action(traj, "invert")


def iamlab_pick_insert(traj: Traj) -> Traj:
    traj = _own(traj)
    obs = traj["observation"]
    obs["joint_state"] = obs["state"][:, :7]
    obs["gripper_state"] = obs["state"][:, 7:8]
    a = traj["action"]
    traj["action"] = _cat(a[:, :3], _quat_action_to_euler(a[:, 3:7]), a[:, 7:8])
    return traj


def utaustin_mutex(traj: Traj) -> Traj:
    traj = _own(traj)
    traj["observation"]["state"] = traj["observation"]["state"][:, :8]
    return _flat_action(traj, "invert_clip")


def berkeley_fanuc(traj: Traj) -> Traj:
    traj = _own(traj)
    obs = traj["observation"]
    obs["joint_state"] = obs["state"][:, :6]
    obs["gripper_state"] = obs["state"][:, 6:7]
    traj["action"] = _cat(traj["action"], invert_gripper_actions(obs["gripper_state"]))
    return traj


def cmu_stretch(traj: Traj) -> Traj:
    traj = _own(traj)
    obs = traj["observation"]
    obs["eef_state"] = _cat(obs["state"][:, :3], np.zeros_like(obs["state"][:, :3]))
    obs["gripper_state"] = obs["state"][:, -1:]
    traj["action"] = traj["action"][..., :-1]
    return traj


def fmb(traj: Traj) -> Traj:
    traj = _own(traj)
    obs = traj["observation"]
    obs["proprio"] = _cat(obs["eef_pose"], obs["state_gripper_pose"][..., None])
    return traj


def dobbe(traj: Traj) -> Traj:
    traj = _own(traj)
    traj["observation"]["proprio"] = traj["observation"]["state"]
    return traj


def _rand_swap_exterior_images(img1, img2, rng: np.random.Generator):
    """Swap the two exterior cameras with probability 1/2 per trajectory, so
    single-camera training sees both viewpoints (JAX transforms.py:341-344)."""
    return (img1, img2) if rng.uniform() > 0.5 else (img2, img1)


def droid_baseact(traj: Traj, rng: Optional[np.random.Generator] = None) -> Traj:
    """DROID: cartesian velocity in base frame; gripper position inverted;
    exterior cameras randomly swapped (draws from `rng`)."""
    traj = _own(traj)
    a = traj["action_dict"]
    traj["action"] = _cat(a["cartesian_velocity"][:, :3], a["cartesian_velocity"][:, 3:6], 1 - a["gripper_position"])
    obs = traj["observation"]
    obs["exterior_image_1_left"], obs["exterior_image_2_left"] = _rand_swap_exterior_images(
        obs["exterior_image_1_left"], obs["exterior_image_2_left"], rng if rng is not None else np.random.default_rng())
    obs["proprio"] = _cat(obs["cartesian_position"], obs["gripper_position"])
    return traj


def tdroid(traj: Traj) -> Traj:
    traj = _own(traj)
    traj["action"] = np.concatenate(
        (traj["action"][:, :6], binarize_gripper_actions(traj["action"][:, -1])[:, None]), axis=1)
    obs = traj["observation"]
    obs["EEF_state"] = obs["cartesian_position"][:, :6]
    obs["gripper_state"] = obs["gripper_position"][:, -1:]
    return traj


def libero(traj: Traj) -> Traj:
    """LIBERO regenerated datasets: gripper in -1(open)..1(close) -> clip+flip."""
    traj = _own(traj)
    grip = invert_gripper_actions(np.clip(traj["action"][:, -1:], 0, 1))
    traj["action"] = np.concatenate((traj["action"][:, :6], grip), axis=1)
    obs = traj["observation"]
    obs["EEF_state"] = obs["state"][:, :6]
    obs["gripper_state"] = obs["state"][:, -2:]  # 2D gripper state
    return traj


def identity(traj: Traj) -> Traj:
    return traj


OXE_STANDARDIZATION_TRANSFORMS: Dict[str, Callable[[Traj], Traj]] = {
    "bridge_oxe": bridge_oxe,
    "bridge_orig": bridge_orig,
    "bridge_dataset": bridge_orig,
    "fractal20220817_data": rt1,
    "kuka": kuka,
    "taco_play": taco_play,
    "jaco_play": jaco_play,
    "berkeley_cable_routing": berkeley_cable_routing,
    "roboturk": roboturk,
    "nyu_door_opening_surprising_effectiveness": nyu_door_opening,
    "viola": viola,
    "berkeley_autolab_ur5": berkeley_autolab_ur5,
    "toto": toto,
    "language_table": language_table,
    "stanford_hydra_dataset_converted_externally_to_rlds": stanford_hydra,
    "austin_buds_dataset_converted_externally_to_rlds": austin_buds,
    "nyu_franka_play_dataset_converted_externally_to_rlds": nyu_franka_play,
    "furniture_bench_dataset_converted_externally_to_rlds": furniture_bench,
    "ucsd_kitchen_dataset_converted_externally_to_rlds": ucsd_kitchen,
    "austin_sailor_dataset_converted_externally_to_rlds": austin_sailor,
    "austin_sirius_dataset_converted_externally_to_rlds": austin_sirius,
    "bc_z": bc_z,
    "dlr_edan_shared_control_converted_externally_to_rlds": dlr_edan_shared_control,
    "iamlab_cmu_pickup_insert_converted_externally_to_rlds": iamlab_pick_insert,
    "utaustin_mutex": utaustin_mutex,
    "berkeley_fanuc_manipulation": berkeley_fanuc,
    "cmu_stretch": cmu_stretch,
    "fmb_dataset": fmb,
    "dobbe": dobbe,
    "droid": droid_baseact,
    "tdroid_carrot_in_bowl": tdroid,
    "tdroid_pour_corn_in_pot": tdroid,
    "libero_spatial_no_noops": libero,
    "libero_object_no_noops": libero,
    "libero_goal_no_noops": libero,
    "libero_10_no_noops": libero,
    "libero_combined": libero,
}


# --- Long-tail transforms (registry completion) ---


# PPGM shares T-DROID's standardization contract exactly (action gripper
# binarize + cartesian EEF/gripper state split).
ppgm = tdroid


def pusht(traj: Traj) -> Traj:
    traj = _own(traj)
    a = traj["action"]
    traj["action"] = _cat(a["world_vector"], a["rotation_delta"], a["gripper_closedness_action"][:, None])
    traj["language_instruction"] = traj["observation"]["natural_language_instruction"]
    return traj


def stanford_kuka_multimodal(traj: Traj) -> Traj:
    traj = _own(traj)
    obs = traj["observation"]
    obs["depth_image"] = obs["depth_image"][..., 0]
    a = traj["action"]
    traj["action"] = _cat(a[:, :3], np.zeros_like(a[:, :3]), a[:, -1:])
    return traj


def nyu_rot(traj: Traj) -> Traj:
    traj = _own(traj)
    obs = traj["observation"]
    obs["eef_state"] = obs["state"][..., :6]
    obs["gripper_state"] = obs["state"][..., -1:]
    traj["action"] = traj["action"][..., :7]
    return traj


def maniskill(traj: Traj) -> Traj:
    traj = _own(traj)
    traj["observation"]["gripper_state"] = traj["observation"]["state"][..., 7:8]
    return traj


def cmu_franka_exploration(traj: Traj) -> Traj:
    traj = dict(traj)
    traj["action"] = traj["action"][..., :-1]
    return traj


def ucsd_pick_place(traj: Traj) -> Traj:
    traj = _own(traj)
    obs = traj["observation"]
    obs["eef_state"] = obs["state"][:, :6]
    obs["gripper_state"] = obs["state"][:, -1:]
    a = traj["action"]
    traj["action"] = _cat(a[:, :3], np.zeros_like(a[:, :3]), a[:, -1:])
    return traj


def utokyo_pr2(traj: Traj) -> Traj:
    traj = _own(traj)
    obs = traj["observation"]
    obs["eef_state"] = obs["state"][:, :6]
    obs["gripper_state"] = obs["state"][:, -1:]
    traj["action"] = traj["action"][..., :-1]
    return traj


def utokyo_xarm_bimanual(traj: Traj) -> Traj:
    traj = dict(traj)
    traj["action"] = traj["action"][..., -7:]
    return traj


def robo_net(traj: Traj) -> Traj:
    traj = _own(traj)
    obs = traj["observation"]
    obs["eef_state"] = _cat(obs["state"][:, :4], np.zeros_like(obs["state"][:, :2]))
    obs["gripper_state"] = obs["state"][:, -1:]
    a = traj["action"]
    traj["action"] = _cat(a[:, :4], np.zeros_like(a[:, :2]), a[:, -1:])
    return traj


def kaist_nonprehensile(traj: Traj) -> Traj:
    traj = _own(traj)
    traj["observation"]["state"] = traj["observation"]["state"][:, -7:]
    a = traj["action"]
    traj["action"] = _cat(a[:, :6], np.zeros_like(a[:, :1]))
    return traj


def stanford_mask_vit(traj: Traj) -> Traj:
    traj = _own(traj)
    obs = traj["observation"]
    obs["eef_state"] = _cat(obs["end_effector_pose"][:, :4], np.zeros_like(obs["end_effector_pose"][:, :2]))
    obs["gripper_state"] = obs["end_effector_pose"][:, -1:]
    a = traj["action"]
    traj["action"] = _cat(a[:, :4], np.zeros_like(a[:, :2]), a[:, -1:])
    return traj


def tokyo_lsmo(traj: Traj) -> Traj:
    traj = _own(traj)
    obs = traj["observation"]
    obs["eef_state"] = obs["state"][:, :6]
    obs["gripper_state"] = obs["state"][:, -1:]
    return traj


def dlr_sara_grid_clamp(traj: Traj) -> Traj:
    traj = _own(traj)
    traj["observation"]["state"] = traj["observation"]["state"][:, :6]
    return traj


def asu_table_top(traj: Traj) -> Traj:
    traj = _own(traj)
    traj["observation"]["eef_state"] = traj["ground_truth_states"]["EE"]
    traj["observation"]["gripper_state"] = traj["observation"]["state"][:, -1:]
    return traj


def robocook(traj: Traj) -> Traj:
    traj = _own(traj)
    obs = traj["observation"]
    obs["eef_state"] = obs["state"][:, :6]
    obs["gripper_state"] = obs["state"][:, -1:]
    return traj


def imperial_wristcam(traj: Traj) -> Traj:
    traj = dict(traj)
    traj["action"] = traj["action"][..., :-1]
    return traj


def uiuc_d3field(traj: Traj) -> Traj:
    traj = dict(traj)
    a = traj["action"]
    traj["action"] = _cat(a, np.zeros_like(a), np.zeros_like(a[:, :1]))
    return traj


def cmu_playing_with_food(traj: Traj) -> Traj:
    traj = dict(traj)
    a = traj["action"]
    traj["action"] = _cat(a[:, :3], _quat_action_to_euler(a[:, 3:7]), a[:, -1:])
    return traj


def playfusion(traj: Traj) -> Traj:
    traj = dict(traj)
    a = traj["action"]
    traj["action"] = _cat(a[:, :3], a[:, -4:])
    return traj


def roboset(traj: Traj) -> Traj:
    traj = _own(traj)
    traj["observation"]["proprio"] = traj["observation"]["state"]
    grip = invert_gripper_actions(np.clip(traj["action"][:, -1:], 0, 1))
    traj["action"] = _cat(traj["action"][:, :7], grip)
    return traj


def rh20t(traj: Traj) -> Traj:
    traj = _own(traj)
    a = traj["action"]
    traj["action"] = _cat(a["tcp_base"], _f32(a["gripper"][:, None]))
    obs = traj["observation"]
    obs["proprio"] = _cat(obs["tcp_base"], obs["gripper_width"][..., None])
    return traj


OXE_STANDARDIZATION_TRANSFORMS.update({
    "ppgm": ppgm,
    "ppgm_static": ppgm,
    "ppgm_wrist": ppgm,
    "columbia_cairlab_pusht_real": pusht,
    "stanford_kuka_multimodal_dataset_converted_externally_to_rlds": stanford_kuka_multimodal,
    "nyu_rot_dataset_converted_externally_to_rlds": nyu_rot,
    "maniskill_dataset_converted_externally_to_rlds": maniskill,
    "cmu_franka_exploration_dataset_converted_externally_to_rlds": cmu_franka_exploration,
    "ucsd_pick_and_place_dataset_converted_externally_to_rlds": ucsd_pick_place,
    "utokyo_pr2_opening_fridge_converted_externally_to_rlds": utokyo_pr2,
    "utokyo_pr2_tabletop_manipulation_converted_externally_to_rlds": utokyo_pr2,
    "utokyo_xarm_pick_and_place_converted_externally_to_rlds": identity,
    "utokyo_xarm_bimanual_converted_externally_to_rlds": utokyo_xarm_bimanual,
    "robo_net": robo_net,
    "berkeley_mvp_converted_externally_to_rlds": identity,
    "berkeley_rpt_converted_externally_to_rlds": identity,
    "kaist_nonprehensile_converted_externally_to_rlds": kaist_nonprehensile,
    "stanford_mask_vit_converted_externally_to_rlds": stanford_mask_vit,
    "tokyo_u_lsmo_converted_externally_to_rlds": tokyo_lsmo,
    "dlr_sara_pour_converted_externally_to_rlds": identity,
    "dlr_sara_grid_clamp_converted_externally_to_rlds": dlr_sara_grid_clamp,
    "asu_table_top_converted_externally_to_rlds": asu_table_top,
    "stanford_robocook_converted_externally_to_rlds": robocook,
    "imperialcollege_sawyer_wrist_cam": imperial_wristcam,
    "uiuc_d3field": uiuc_d3field,
    "cmu_playing_with_food": cmu_playing_with_food,
    "cmu_play_fusion": playfusion,
    "roboset": roboset,
    "rh20t": rh20t,
    "droid_wipe": droid_baseact,
})


def gnm(traj: Traj) -> Traj:
    """Navigation datasets: 2D waypoint actions padded to the 7-dof layout."""
    traj = _own(traj)
    obs = traj["observation"]
    obs["state"] = _cat(obs["position"], np.zeros_like(obs["state"][:, :3]), obs["yaw"])
    a = traj["action"]
    traj["action"] = _cat(a, np.zeros_like(a), np.zeros_like(a), np.zeros_like(a[:, :1]))
    return traj


for _gnm_name in ("berkeley_gnm_recon", "berkeley_gnm_cory_hall", "berkeley_gnm_sac_son"):
    OXE_STANDARDIZATION_TRANSFORMS[_gnm_name] = gnm
for _td_name in ("tdroid_cover_object_with_towel", "tdroid_flip_pot_upright",
                 "tdroid_knock_object_over", "tdroid_move_object_onto_plate"):
    OXE_STANDARDIZATION_TRANSFORMS[_td_name] = tdroid
