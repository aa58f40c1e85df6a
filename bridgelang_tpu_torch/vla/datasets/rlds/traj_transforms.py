"""Trajectory-level transforms in numpy: windowing, subsampling, pad masks.

Counterpart of bridgelang_tpu/vla/datasets/rlds/traj_transforms.py (there on
tf.data). A trajectory is a dict of numpy arrays over time (nested dicts
under "observation" and "task").
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def is_string_array(x) -> bool:
    return np.asarray(x).dtype.kind in "SUO"


def string_lengths(x) -> np.ndarray:
    return np.vectorize(len, otypes=[np.int64])(np.asarray(x)) if np.size(x) else np.zeros(np.shape(x), np.int64)


def chunk_act_obs(traj: Dict[str, Any], window_size: int = 1, future_action_window_size: int = 0) -> Dict[str, Any]:
    """Each frame gets a history window of observations and a history+future
    window of actions, with pad masks (JAX traj_transforms.py:14-71):

        observation[t] -> [window_size, ...]   (frames t-w+1 .. t, clamped at 0)
        action[t]      -> [window_size + future, action_dim]

    Action indices clamp at the goal step (`task.timestep`, else the last
    step); actions strictly past it become neutral: 0 on relative dims, the
    clamped value on the dims `absolute_action_mask` marks."""
    traj = dict(traj)
    traj_len = len(traj["action"])
    action_dim = traj["action"].shape[-1]
    steps = np.arange(traj_len)
    history_indices = steps[:, None] + np.arange(-window_size + 1, 1)[None, :]
    timestep_pad_mask = history_indices >= 0
    action_indices = steps[:, None] + np.arange(-window_size + 1, 1 + future_action_window_size)[None, :]
    if "timestep" in traj.get("task", {}):
        goal_timestep = np.asarray(traj["task"]["timestep"])
    else:
        goal_timestep = np.full(traj_len, traj_len - 1)
    history_indices = np.maximum(history_indices, 0)
    floored_action_indices = np.minimum(np.maximum(action_indices, 0), goal_timestep[:, None])

    obs = tree_map(lambda x: np.asarray(x)[history_indices], traj["observation"])
    obs["timestep_pad_mask"] = timestep_pad_mask
    traj["observation"] = obs
    action = traj["action"][floored_action_indices]
    absolute_action_mask = traj.get("absolute_action_mask", np.zeros((traj_len, action_dim), dtype=bool))
    neutral_actions = np.where(absolute_action_mask[:, None, :], action, np.zeros_like(action))
    action_past_goal = action_indices > goal_timestep[:, None]
    traj["action"] = np.where(action_past_goal[:, :, None], neutral_actions, action)
    return traj


def subsample(traj: Dict[str, Any], subsample_length: int,
              rng: Optional[np.random.Generator] = None) -> Dict[str, Any]:
    """A uniform random subset of `subsample_length` steps of a longer
    trajectory (JAX traj_transforms.py:74-84), drawn from `rng`."""
    traj_len = len(traj["action"])
    if traj_len <= subsample_length:
        return traj
    rng = rng if rng is not None else np.random.default_rng()
    indices = rng.permutation(traj_len)[:subsample_length]
    return tree_map(lambda x: np.asarray(x)[indices], traj)


def add_pad_mask_dict(traj: Dict[str, Any]) -> Dict[str, Any]:
    """Per-key masks under observation and task: False where a string entry
    is empty (padding), True everywhere for other arrays."""
    traj = dict(traj)
    traj_len = len(traj["action"])
    for key in ("observation", "task"):
        if key not in traj:
            continue
        pad_masks = {}
        for subkey, x in traj[key].items():
            if is_string_array(x):
                pad_masks[subkey] = string_lengths(x) != 0
            else:
                pad_masks[subkey] = np.ones(traj_len, dtype=bool)
        traj[key] = dict(traj[key], pad_mask_dict=pad_masks)
    return traj
