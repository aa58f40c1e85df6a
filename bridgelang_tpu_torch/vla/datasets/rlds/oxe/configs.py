"""Open X-Embodiment per-dataset configurations (host only).

The port's copy of bridgelang_tpu/vla/datasets/rlds/oxe/configs.py (the
public OXE/Octo registry of observation-key maps and encodings, reference
prismatic/vla/datasets/rlds/oxe/configs.py), as frozen dataclasses; the
same 74 datasets.
"""

from __future__ import annotations

import dataclasses
from enum import IntEnum
from typing import Dict, Optional, Tuple


class StateEncoding(IntEnum):
    """Proprioceptive state layout (8-dim canonical)."""

    NONE = -1
    POS_EULER = 1      # xyz + rpy + pad + gripper
    POS_QUAT = 2       # xyz + quat + gripper
    JOINT = 3          # 7 joints + gripper
    JOINT_BIMANUAL = 4


class ActionEncoding(IntEnum):
    EEF_POS = 1            # delta xyz + delta rpy + gripper (7)
    JOINT_POS = 2          # 7 joint deltas + gripper (8)
    JOINT_POS_BIMANUAL = 3
    EEF_R6 = 4             # xyz + R6 rotation + gripper (10)


@dataclasses.dataclass(frozen=True)
class OXEDatasetConfig:
    # observation-key name in the raw dataset for each canonical camera slot
    image_primary: Optional[str] = None
    image_secondary: Optional[str] = None
    image_wrist: Optional[str] = None
    depth_primary: Optional[str] = None
    depth_secondary: Optional[str] = None
    depth_wrist: Optional[str] = None
    # raw state keys composing the 8-dim proprio vector (None = zero pad)
    state_obs_keys: Tuple[Optional[str], ...] = ()
    state_encoding: StateEncoding = StateEncoding.NONE
    action_encoding: ActionEncoding = ActionEncoding.EEF_POS
    # name of a registered per-dataset frame filter (reference aux_kwargs
    # chunk_filter_fn, configs.py:543-547: droid drops all-zero-action chunks)
    chunk_filter: Optional[str] = None

    @property
    def image_obs_keys(self) -> Dict[str, Optional[str]]:
        return {"primary": self.image_primary, "secondary": self.image_secondary, "wrist": self.image_wrist}

    @property
    def depth_obs_keys(self) -> Dict[str, Optional[str]]:
        return {"primary": self.depth_primary, "secondary": self.depth_secondary, "wrist": self.depth_wrist}


C = OXEDatasetConfig
PE, PQ, J, NONE = StateEncoding.POS_EULER, StateEncoding.POS_QUAT, StateEncoding.JOINT, StateEncoding.NONE

OXE_DATASET_CONFIGS: Dict[str, OXEDatasetConfig] = {
    "fractal20220817_data": C("image", None, None,
                              state_obs_keys=("base_pose_tool_reached", "gripper_closed"), state_encoding=PQ),
    "kuka": C("image", None, None,
              state_obs_keys=("clip_function_input/base_pose_tool_reached", "gripper_closed"), state_encoding=PQ),
    "bridge_oxe": C("image", "image_1", None,
                    state_obs_keys=("EEF_state", None, "gripper_state"), state_encoding=PE),
    "bridge_orig": C("image_0", "image_1", None,
                     state_obs_keys=("EEF_state", None, "gripper_state"), state_encoding=PE),
    "bridge_dataset": C("image_0", "image_1", None,
                        state_obs_keys=("EEF_state", None, "gripper_state"), state_encoding=PE),
    "taco_play": C("rgb_static", None, "rgb_gripper", "depth_static", None, "depth_gripper",
                   state_obs_keys=("state_eef", None, "state_gripper"), state_encoding=PE),
    "jaco_play": C("image", None, "image_wrist",
                   state_obs_keys=("state_eef", None, "state_gripper"), state_encoding=PE),
    "berkeley_cable_routing": C("image", "top_image", "wrist45_image",
                                state_obs_keys=("robot_state", None), state_encoding=J),
    "roboturk": C("front_rgb", None, None,
                  state_obs_keys=(None,) * 8, state_encoding=NONE),
    "nyu_door_opening_surprising_effectiveness": C(None, None, "image",
                                                   state_obs_keys=(None,) * 8, state_encoding=NONE),
    "viola": C("agentview_rgb", None, "eye_in_hand_rgb",
               state_obs_keys=("joint_states", "gripper_states"), state_encoding=J),
    "berkeley_autolab_ur5": C("image", None, "hand_image", "depth", None, None,
                              state_obs_keys=("state",), state_encoding=PQ),
    "toto": C("image", None, None, state_obs_keys=("state", None), state_encoding=J),
    "language_table": C("rgb", None, None,
                        state_obs_keys=("effector_translation", None, None, None, None, None, None),
                        state_encoding=PE),
    "stanford_hydra_dataset_converted_externally_to_rlds": C(
        "image", None, "wrist_image", state_obs_keys=("eef_state", None, "gripper_state"), state_encoding=PE),
    "austin_buds_dataset_converted_externally_to_rlds": C(
        "image", None, "wrist_image", state_obs_keys=("state",), state_encoding=J),
    "nyu_franka_play_dataset_converted_externally_to_rlds": C(
        "image", "image_additional_view", None, "depth", "depth_additional_view", None,
        state_obs_keys=("eef_state", None, None), state_encoding=PE),
    "furniture_bench_dataset_converted_externally_to_rlds": C(
        "image", None, "wrist_image", state_obs_keys=("state",), state_encoding=PQ),
    "ucsd_kitchen_dataset_converted_externally_to_rlds": C(
        "image", None, None, state_obs_keys=("joint_state", None), state_encoding=J),
    "austin_sailor_dataset_converted_externally_to_rlds": C(
        "image", None, "wrist_image", state_obs_keys=("state",), state_encoding=PQ),
    "austin_sirius_dataset_converted_externally_to_rlds": C(
        "image", None, "wrist_image", state_obs_keys=("state",), state_encoding=PQ),
    "bc_z": C("image", None, None,
              state_obs_keys=("present/xyz", "present/axis_angle", None, "present/sensed_close"),
              state_encoding=PE),
    "dlr_edan_shared_control_converted_externally_to_rlds": C(
        "image", None, None, state_obs_keys=("state", None), state_encoding=PE),
    "iamlab_cmu_pickup_insert_converted_externally_to_rlds": C(
        "image", None, "wrist_image", state_obs_keys=("joint_state", "gripper_state"), state_encoding=J),
    "utaustin_mutex": C("image", None, "wrist_image", state_obs_keys=("state",), state_encoding=J),
    "berkeley_fanuc_manipulation": C("image", None, "wrist_image",
                                     state_obs_keys=("joint_state", None, "gripper_state"), state_encoding=J),
    "cmu_stretch": C("image", None, None,
                     state_obs_keys=("eef_state", None, "gripper_state"), state_encoding=PE),
    "fmb_dataset": C("image_side_1", "image_side_2", "image_wrist_1",
                     "image_side_1_depth", "image_side_2_depth", "image_wrist_1_depth",
                     state_obs_keys=("proprio",), state_encoding=PE),
    "dobbe": C("wrist_image", None, None, state_obs_keys=("proprio",), state_encoding=PE),
    "droid": C("exterior_image_1_left", "exterior_image_2_left", "wrist_image_left",
               state_obs_keys=("proprio",), state_encoding=PQ, chunk_filter="zero_action"),
    "tdroid_carrot_in_bowl": C("static_image", None, None, "static_depth_image", None, None,
                               state_obs_keys=("EEF_state", None, "gripper_state"), state_encoding=PE),
    "tdroid_pour_corn_in_pot": C("static_image", None, None, "static_depth_image", None, None,
                                 state_obs_keys=("EEF_state", None, "gripper_state"), state_encoding=PE),
    "libero_spatial_no_noops": C("image", None, "wrist_image",
                                 state_obs_keys=("EEF_state", None, "gripper_state"), state_encoding=PE),
    "libero_object_no_noops": C("image", None, "wrist_image",
                                state_obs_keys=("EEF_state", None, "gripper_state"), state_encoding=PE),
    "libero_goal_no_noops": C("image", None, "wrist_image",
                              state_obs_keys=("EEF_state", None, "gripper_state"), state_encoding=PE),
    "libero_10_no_noops": C("image", None, "wrist_image",
                            state_obs_keys=("EEF_state", None, "gripper_state"), state_encoding=PE),
    "libero_combined": C("image", None, "wrist_image",
                         state_obs_keys=("EEF_state", None, "gripper_state"), state_encoding=PE),
}

# --- Long-tail OXE datasets (registry completion) ---
OXE_DATASET_CONFIGS.update({
    "ppgm": C("image", None, "wrist_image",
              state_obs_keys=("cartesian_position", "gripper_position"), state_encoding=PE),
    "ppgm_static": C("image", None, None,
                     state_obs_keys=("cartesian_position", "gripper_position"), state_encoding=PE),
    "ppgm_wrist": C("wrist_image", None, None,
                    state_obs_keys=("cartesian_position", "gripper_position"), state_encoding=PE),
    "columbia_cairlab_pusht_real": C("image", None, "wrist_image",
                                     state_obs_keys=("robot_state", None, None, None, None, None, None),
                                     state_encoding=PE),
    "stanford_kuka_multimodal_dataset_converted_externally_to_rlds": C(
        "image", None, None, "depth_image", None, None,
        state_obs_keys=("ee_position", "ee_orientation", None), state_encoding=PQ),
    "nyu_rot_dataset_converted_externally_to_rlds": C(
        "image", None, None, state_obs_keys=("eef_state", None, "gripper_state"), state_encoding=PE),
    "maniskill_dataset_converted_externally_to_rlds": C(
        "image", None, "wrist_image", "depth", None, "wrist_depth",
        state_obs_keys=("tcp_pose", "gripper_state"), state_encoding=PQ),
    "cmu_franka_exploration_dataset_converted_externally_to_rlds": C(
        "highres_image", None, None, state_obs_keys=(None,) * 8, state_encoding=NONE),
    "ucsd_pick_and_place_dataset_converted_externally_to_rlds": C(
        "image", None, None, state_obs_keys=("eef_state", None, "gripper_state"), state_encoding=PE),
    "utokyo_pr2_opening_fridge_converted_externally_to_rlds": C(
        "image", None, None, state_obs_keys=("eef_state", None, "gripper_state"), state_encoding=PE),
    "utokyo_pr2_tabletop_manipulation_converted_externally_to_rlds": C(
        "image", None, None, state_obs_keys=("eef_state", None, "gripper_state"), state_encoding=PE),
    "utokyo_xarm_pick_and_place_converted_externally_to_rlds": C(
        "image", "image2", "hand_image", state_obs_keys=("end_effector_pose", None, None), state_encoding=PE),
    "utokyo_xarm_bimanual_converted_externally_to_rlds": C(
        "image", None, None, state_obs_keys=("pose_r", None, None), state_encoding=PE),
    "robo_net": C("image", "image1", None,
                  state_obs_keys=("eef_state", None, "gripper_state"), state_encoding=PE),
    "berkeley_mvp_converted_externally_to_rlds": C(
        None, None, "hand_image", state_obs_keys=("pose", "gripper"), state_encoding=PQ,
        action_encoding=ActionEncoding.JOINT_POS),
    "berkeley_rpt_converted_externally_to_rlds": C(
        None, None, "hand_image", state_obs_keys=("joint_pos", "gripper"), state_encoding=J,
        action_encoding=ActionEncoding.JOINT_POS),
    "kaist_nonprehensile_converted_externally_to_rlds": C(
        "image", None, None, state_obs_keys=("state", None), state_encoding=PQ),
    "stanford_mask_vit_converted_externally_to_rlds": C(
        "image", None, None, state_obs_keys=("eef_state", None, "gripper_state"), state_encoding=PE),
    "tokyo_u_lsmo_converted_externally_to_rlds": C(
        "image", None, None, state_obs_keys=("eef_state", None, "gripper_state"), state_encoding=PE),
    "dlr_sara_pour_converted_externally_to_rlds": C(
        "image", None, None, state_obs_keys=("state", None, None), state_encoding=PE),
    "dlr_sara_grid_clamp_converted_externally_to_rlds": C(
        "image", None, None, state_obs_keys=("state", None, None), state_encoding=PE),
    "asu_table_top_converted_externally_to_rlds": C(
        "image", None, None, state_obs_keys=("eef_state", None, "gripper_state"), state_encoding=PE),
    "stanford_robocook_converted_externally_to_rlds": C(
        "image_1", "image_2", None, "depth_1", "depth_2", None,
        state_obs_keys=("eef_state", None, "gripper_state"), state_encoding=PE),
    "imperialcollege_sawyer_wrist_cam": C(
        "image", None, "wrist_image", state_obs_keys=(None, None, None, None, None, None, None, "state"),
        state_encoding=NONE),
    "uiuc_d3field": C("image_1", "image_2", None, "depth_1", "depth_2", None,
                      state_obs_keys=(None,) * 8, state_encoding=NONE),
    "cmu_playing_with_food": C("image", None, "finger_vision_1",
                               state_obs_keys=("state", None, None), state_encoding=PE),
    "cmu_play_fusion": C("image", None, None, state_obs_keys=("state",), state_encoding=J),
    "roboset": C("image_left", "image_right", "image_wrist",
                 state_obs_keys=("proprio",), state_encoding=J, action_encoding=ActionEncoding.JOINT_POS),
    "rh20t": C("image_front", "image_side_right", "image_wrist",
               state_obs_keys=("proprio",), state_encoding=PE),
    "droid_wipe": C("exterior_image_2_left", None, "wrist_image_left",
                    state_obs_keys=("proprio",), state_encoding=PE),
})

# Navigation (GNM) + remaining T-DROID task datasets — completes the
# reference's registry 1:1 (plus our ppgm/libero_combined extras).
for _gnm in ("berkeley_gnm_recon", "berkeley_gnm_cory_hall", "berkeley_gnm_sac_son"):
    OXE_DATASET_CONFIGS[_gnm] = C(None, None, "image",
                                  state_obs_keys=("state", None, None), state_encoding=PE)
for _td in ("tdroid_cover_object_with_towel", "tdroid_flip_pot_upright",
            "tdroid_knock_object_over", "tdroid_move_object_onto_plate"):
    OXE_DATASET_CONFIGS[_td] = C("static_image", None, None, "static_depth_image", None, None,
                                 state_obs_keys=("EEF_state", None, "gripper_state"), state_encoding=PE)
