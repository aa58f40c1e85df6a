"""BridgeV2 evaluation utilities: env construction, task prompts, episode
recording. Counterpart of experiments/robot/bridge/bridgev2_utils.py (the
reference's experiments/robot/bridge/bridgev2_utils.py).
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, List, Optional

import numpy as np

DATE_TIME = time.strftime("%Y_%m_%d-%H_%M_%S")


def get_widowx_env_params(cfg) -> Dict[str, Any]:
    """(Mostly default) widowx env params (reference bridgev2_utils.py:24-31)."""
    from widowx_envs.widowx_env_service import WidowXConfigs

    env_params = WidowXConfigs.DefaultEnvParams.copy()
    env_params["override_workspace_boundaries"] = [list(b) for b in cfg.bounds]
    env_params["camera_topics"] = list(cfg.camera_topics)
    env_params["return_full_image"] = True
    return env_params


def get_widowx_env(cfg):
    """Connect to the WidowX action server and wrap it
    (reference bridgev2_utils.py:33-48)."""
    from widowx_envs.widowx_env_service import WidowXClient

    from bridgelang_tpu_torch.experiments.robot.bridge.widowx_env import WidowXGym

    env_params = get_widowx_env_params(cfg)
    env_params["start_state"] = list(np.concatenate([cfg.init_ee_pos, cfg.init_ee_quat]))
    client = WidowXClient(host=cfg.host_ip, port=cfg.port)
    client.init(env_params)
    return WidowXGym(client, cfg=cfg, im_size=cfg.resize_hw, blocking=cfg.blocking)


def get_next_task_label(task_label: str) -> str:
    """Prompt for the next task; empty input repeats the previous one."""
    if task_label == "":
        user_input = ""
        while user_input == "":
            user_input = input("Enter the task name: ").strip()
        return user_input
    user_input = input("Enter the task name (or leave blank to repeat the previous task): ").strip()
    return user_input if user_input else task_label


def save_rollout_video(rollout_images: List[np.ndarray], idx: int, out_dir: str = "./rollouts") -> Optional[str]:
    """Replay video of an episode (reference bridgev2_utils.py:67-76); returns
    the path, or None when no frames / no imageio."""
    from bridgelang_tpu_torch.experiments.robot.robot_utils import save_video

    path = save_video(rollout_images, os.path.join(out_dir, f"rollout-{DATE_TIME}-{idx + 1}.mp4"), fps=5)
    if path:
        print(f"Saved rollout video at path {path}")
    return path


def save_rollout_data(
    rollout_orig_images, rollout_images, rollout_states, rollout_actions, idx: int, out_dir: str = "./rollouts"
) -> str:
    """One .npz per episode: original + preprocessed images, proprio, actions
    (reference bridgev2_utils.py:78-99)."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"rollout-{DATE_TIME}-{idx + 1}.npz")
    np.savez(
        path,
        orig_images=np.asarray(rollout_orig_images),
        images=np.asarray(rollout_images),
        states=np.asarray(rollout_states),
        actions=np.asarray(rollout_actions),
    )
    print(f"Saved rollout data at path {path}")
    return path


def refresh_obs(obs: Dict[str, Any], env) -> Dict[str, Any]:
    """Re-poll the camera/proprio without stepping (reference :127-133)."""
    new_obs = env.get_observation()
    obs.update(
        {k: new_obs[k] for k in ("image_primary", "full_image", "proprio") if k in new_obs}
    )
    return obs
