"""Named training mixtures: dataset -> sampling weight (host only).

The port's copy of bridgelang_tpu/vla/datasets/rlds/oxe/mixtures.py: the
published OpenVLA/Octo mixture ratios (`oxe_magic_soup_plus` trained
openvla-7b). Members without a registered config are skipped with a warning
when a mixture is materialized.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

Mixture = List[Tuple[str, float]]

_MAGIC_SOUP_CORE: Mixture = [
    ("fractal20220817_data", 0.54087122203),
    ("kuka", 0.8341046294),
    ("bridge_orig", 1.0),
    ("taco_play", 2.0),
    ("jaco_play", 1.0),
    ("berkeley_cable_routing", 1.0),
    ("roboturk", 2.0),
    ("viola", 2.0),
    ("berkeley_autolab_ur5", 2.0),
    ("toto", 1.0),
    ("language_table", 0.1),
    ("stanford_hydra_dataset_converted_externally_to_rlds", 2.0),
    ("austin_buds_dataset_converted_externally_to_rlds", 1.0),
    ("nyu_franka_play_dataset_converted_externally_to_rlds", 3.0),
    ("furniture_bench_dataset_converted_externally_to_rlds", 0.1),
    ("ucsd_kitchen_dataset_converted_externally_to_rlds", 2.0),
    ("austin_sailor_dataset_converted_externally_to_rlds", 1.0),
    ("austin_sirius_dataset_converted_externally_to_rlds", 1.0),
    ("dlr_edan_shared_control_converted_externally_to_rlds", 1.0),
    ("iamlab_cmu_pickup_insert_converted_externally_to_rlds", 1.0),
    ("utaustin_mutex", 1.0),
    ("berkeley_fanuc_manipulation", 2.0),
    ("cmu_stretch", 1.0),
]

_MAGIC_SOUP_PLUS_EXTRAS: Mixture = [
    ("bc_z", 0.2),
    ("fmb_dataset", 1.0),
    ("dobbe", 0.2),
]

OXE_NAMED_MIXTURES: Dict[str, Mixture] = {
    # --- dev / single-dataset ---
    "bridge": [("bridge_orig", 1.0)],
    "bridge_rt_1": [("bridge_orig", 1.0), ("fractal20220817_data", 1.0)],
    "droid": [("droid", 1.0)],
    "droid_wipe": [("droid_wipe", 1.0)],
    # --- RT-X core mixture ---
    "rtx": [
        ("fractal20220817_data", 0.54087122203),
        ("kuka", 0.8341046294),
        ("bridge_orig", 1.0),
        ("taco_play", 2.0),
        ("jaco_play", 2.0),
        ("berkeley_cable_routing", 3.0),
        ("roboturk", 1.0),
        ("viola", 2.0),
        ("berkeley_autolab_ur5", 1.0),
        ("toto", 1.0),
    ],
    # --- RT-X + Franka datasets (reference mixtures.py:43-76; repeats the
    # shared RT-X entries with Franka-mix weights — duplicates are dropped
    # first-occurrence-wins at materialize time, as in the reference) ---
    "rtx_franka": [
        ("fractal20220817_data", 0.54087122203),
        ("kuka", 0.8341046294),
        ("bridge_orig", 1.0),
        ("taco_play", 2.0),
        ("jaco_play", 2.0),
        ("berkeley_cable_routing", 3.0),
        ("roboturk", 1.0),
        ("viola", 2.0),
        ("berkeley_autolab_ur5", 1.0),
        ("toto", 1.0),
        ("taco_play", 1.0),
        ("berkeley_cable_routing", 1.0),
        ("viola", 1.0),
        ("toto", 1.0),
        ("stanford_hydra_dataset_converted_externally_to_rlds", 1.0),
        ("austin_buds_dataset_converted_externally_to_rlds", 3.0),
        ("nyu_franka_play_dataset_converted_externally_to_rlds", 3.0),
        ("maniskill_dataset_converted_externally_to_rlds", 0.1),
        ("furniture_bench_dataset_converted_externally_to_rlds", 0.1),
        ("cmu_franka_exploration_dataset_converted_externally_to_rlds", 5.0),
        ("austin_sailor_dataset_converted_externally_to_rlds", 1.0),
        ("austin_sirius_dataset_converted_externally_to_rlds", 1.0),
        ("berkeley_rpt_converted_externally_to_rlds", 1.0),
        ("kaist_nonprehensile_converted_externally_to_rlds", 3.0),
        ("stanford_robocook_converted_externally_to_rlds", 1.0),
        ("iamlab_cmu_pickup_insert_converted_externally_to_rlds", 1.0),
        ("utaustin_mutex", 1.0),
        ("cmu_play_fusion", 1.0),
    ],
    # --- Octo-style magic soup (v0.1 model) ---
    "oxe_magic_soup": _MAGIC_SOUP_CORE.copy(),
    # --- openvla-7b mixtures ---
    "oxe_magic_soup_plus": _MAGIC_SOUP_CORE + _MAGIC_SOUP_PLUS_EXTRAS + [("droid", 0.06)],
    "oxe_magic_soup_plus_minus": (
        [("fractal20220817_data", 1.0)] + _MAGIC_SOUP_CORE[1:] + _MAGIC_SOUP_PLUS_EXTRAS
    ),
    # --- fine-tuning mixes ---
    "tdroid_carrot_in_bowl": [("tdroid_carrot_in_bowl", 1.0)],
    "tdroid_pour_corn_in_pot": [("tdroid_pour_corn_in_pot", 1.0)],
    "tdroid_flip_pot_upright": [("tdroid_flip_pot_upright", 1.0)],
    "tdroid_move_object_onto_plate": [("tdroid_move_object_onto_plate", 1.0)],
    "tdroid_knock_object_over": [("tdroid_knock_object_over", 1.0)],
    "tdroid_cover_object_with_towel": [("tdroid_cover_object_with_towel", 1.0)],
    "libero_spatial_no_noops": [("libero_spatial_no_noops", 1.0)],
    "libero_object_no_noops": [("libero_object_no_noops", 1.0)],
    "libero_goal_no_noops": [("libero_goal_no_noops", 1.0)],
    "libero_10_no_noops": [("libero_10_no_noops", 1.0)],
    "libero_combined": [("libero_combined", 1.0)],
}

# minus variant also drops language_table (reference mixtures.py:141-170):
OXE_NAMED_MIXTURES["oxe_magic_soup_plus_minus"] = [
    (n, w) for n, w in OXE_NAMED_MIXTURES["oxe_magic_soup_plus_minus"] if n != "language_table"
]
