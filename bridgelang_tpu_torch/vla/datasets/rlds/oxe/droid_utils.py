"""DROID helpers in numpy: rotation representations and the degenerate-action
chunk filter.

Counterpart of bridgelang_tpu/vla/datasets/rlds/oxe/droid_utils.py (there in
TF ops), function by function, in the input's float dtype.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np


def rmat_to_euler(rmat: np.ndarray) -> np.ndarray:
    """Rotation matrix [..., 3, 3] -> extrinsic xyz Euler angles [..., 3]."""
    sy = np.sqrt(rmat[..., 0, 0] ** 2 + rmat[..., 1, 0] ** 2)
    singular = sy < 1e-6
    x = np.where(singular, np.arctan2(-rmat[..., 1, 2], rmat[..., 1, 1]), np.arctan2(rmat[..., 2, 1], rmat[..., 2, 2]))
    y = np.arctan2(-rmat[..., 2, 0], sy)
    z = np.where(singular, np.zeros_like(x), np.arctan2(rmat[..., 1, 0], rmat[..., 0, 0]))
    return np.stack([x, y, z], axis=-1)


def euler_to_rmat(euler: np.ndarray) -> np.ndarray:
    """Extrinsic xyz Euler [..., 3] -> rotation matrix [..., 3, 3]."""
    x, y, z = euler[..., 0], euler[..., 1], euler[..., 2]
    cx, sx = np.cos(x), np.sin(x)
    cy, sy = np.cos(y), np.sin(y)
    cz, sz = np.cos(z), np.sin(z)
    rows = [np.stack([cy * cz, sx * sy * cz - cx * sz, cx * sy * cz + sx * sz], -1),
            np.stack([cy * sz, sx * sy * sz + cx * cz, cx * sy * sz - sx * cz], -1),
            np.stack([-sy, sx * cy, cx * cy], -1)]
    return np.stack(rows, axis=-2)


def mat_to_rot6d(rmat: np.ndarray) -> np.ndarray:
    """Rotation matrix -> R6 representation (first two rows, row-major)."""
    return np.concatenate([rmat[..., 0, :], rmat[..., 1, :]], axis=-1)


def euler_to_r6(euler: np.ndarray) -> np.ndarray:
    return mat_to_rot6d(euler_to_rmat(euler))


def velocity_act_to_wrist_frame(vel: np.ndarray, wrist_in_robot_frame: np.ndarray) -> np.ndarray:
    """Base-frame cartesian velocity [B, 6] (3 translation + 3 euler) in the
    wrist frame, [B, 9] (3 translation + 6 R6): dt_wrist = R^-1 dt,
    dR_wrist = R^-1 dR R as R6."""
    r_frame = euler_to_rmat(wrist_in_robot_frame[:, 3:6])
    r_frame_inv = np.swapaxes(r_frame, -1, -2)
    vel_t = np.einsum("bij,bj->bi", r_frame_inv, vel[:, :3])
    dr_rel = r_frame_inv @ euler_to_rmat(vel[:, 3:6]) @ r_frame
    return np.concatenate([vel_t, mat_to_rot6d(dr_rel)], axis=-1)


_DROID_Q01 = np.array([-0.7776297926902771, -0.5803514122962952, -0.5795090794563293,
                       -0.6464047729969025, -0.7041108310222626, -0.8895104378461838], np.float32)
_DROID_Q99 = np.array([0.7597932070493698, 0.5726242214441299, 0.7351000607013702,
                       0.6705610305070877, 0.6464948207139969, 0.8897542208433151], np.float32)


def zero_action_filter(frame: Dict[str, Any]) -> bool:
    """Keep a frame unless its action chunk is all ~zero (DROID's idle
    stretches). It runs after q99 normalization, so "zero" is the normalized
    zero action."""
    acts = np.asarray(frame["action"])[..., :6]
    norm_zero = 2 * (np.zeros_like(acts) - _DROID_Q01) / (_DROID_Q99 - _DROID_Q01 + 1e-8) - 1
    return bool(np.any(np.abs(acts - norm_zero) > 1e-5))
