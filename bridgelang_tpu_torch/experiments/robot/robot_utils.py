"""Shared robot-eval utilities: model dispatch, gripper conventions, seeding,
replay videos.

Counterpart of experiments/robot/robot_utils.py (the reference's
experiments/robot/robot_utils.py:29-102), over the port's policy
(`openvla_utils`).
"""

from __future__ import annotations

import os
import random
from typing import Any, Dict, Optional

import numpy as np

DATE_FORMAT = "%Y_%m_%d-%H_%M_%S"


def set_seed_everywhere(seed: int) -> None:
    """Seed Python, numpy and torch (every device)."""
    import torch

    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def get_model(cfg) -> Any:
    """The policy named by cfg.model_family (only "openvla", as the
    reference's robot_utils.py:40-50)."""
    if cfg.model_family != "openvla":
        raise ValueError(f"Unsupported model family {cfg.model_family!r}")
    from bridgelang_tpu_torch.experiments.robot.openvla_utils import get_vla

    return get_vla(cfg)


def get_action(cfg, model, obs: Dict[str, Any], task_label: str) -> np.ndarray:
    if cfg.model_family != "openvla":
        raise ValueError(f"Unsupported model family {cfg.model_family!r}")
    from bridgelang_tpu_torch.experiments.robot.openvla_utils import get_vla_action

    return get_vla_action(model, obs, task_label, unnorm_key=cfg.unnorm_key,
                          center_crop=getattr(cfg, "center_crop", False))


def normalize_gripper_action(action: np.ndarray, binarize: bool = True) -> np.ndarray:
    """[0, 1] gripper -> [-1, +1] (then its sign with `binarize`), the
    training convention (reference robot_utils.py:75-92)."""
    out = action.copy()
    out[..., -1] = 2 * (out[..., -1] - 0.0) / (1.0 - 0.0) - 1
    if binarize:
        out[..., -1] = np.sign(out[..., -1])
    return out


def invert_gripper_action(action: np.ndarray) -> np.ndarray:
    """Flip the gripper's sign for robots where -1 = open (reference
    robot_utils.py:95-102; LIBERO needs it)."""
    out = action.copy()
    out[..., -1] = -out[..., -1]
    return out


def save_video(frames, path, fps: int = 30) -> Optional[str]:
    """Write an episode's replay video (MP4, or a GIF when imageio has no
    ffmpeg plugin). Returns the written path, or None without frames or
    without `imageio`, which stays optional."""
    if not frames:
        return None
    try:
        import imageio
    except ImportError:
        print("imageio not installed; skipping rollout video")
        return None

    path = str(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    frames = [np.asarray(f) for f in frames]
    try:
        imageio.mimwrite(path, frames, fps=fps)
        return path
    except Exception:  # no MP4 writer: fall back to a GIF
        gif = os.path.splitext(path)[0] + ".gif"
        imageio.mimwrite(gif, frames, duration=int(1000 / fps), loop=0)
        return gif
