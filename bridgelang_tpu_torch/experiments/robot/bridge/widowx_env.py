"""WidowX control-environment wrapper for BridgeData V2 evaluations.

Counterpart of experiments/robot/bridge/widowx_env.py (the reference's
experiments/robot/bridge/widowx_env.py:1-160, itself derived from the public
Octo eval code). Host Python: the policy runs on the card, in process or
behind the REST server; this wraps the `widowx_envs` robot stack with the
BridgeV2 evaluation conventions:

  * observations: [3,S,S] float image -> uint8 [S,S,3]; proprio padded to the
    8-dim RLDS layout (xyz+rpy, one zero pad, gripper);
  * a lost connection (get_observation() -> None) truncates the episode with
    a null observation instead of crashing;
  * reset moves to a user-confirmed start pose with blocking=True (a
    non-blocking move would corrupt the controller's reset qpos).

gym is optional: when installed the wrapper is a real gym.Env with
observation/action spaces; otherwise it exposes the same step/reset API.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Tuple

import numpy as np

try:  # pragma: no cover - robot workstation dependency
    import gym

    _ENV_BASE = gym.Env
except ImportError:  # evaluation drivers only need step/reset duck-typing
    gym = None
    _ENV_BASE = object

# Gripper points ~15 degrees off the standard orientation; the z-column tilt
# makes the start pose look natural (reference widowx_env.py:141-150).
_START_ROT = np.array(
    [
        [0.267, 0.000, 0.963],
        [0.000, 1.000, 0.000],
        [-0.963, 0.000, 0.267],
    ]
)
_DEFAULT_ROTATION = np.array([[0, 0, 1.0], [0, 1.0, 0], [-1.0, 0, 0]])


def _quat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return np.array(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ]
    )


def _quat_to_matrix(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q / np.linalg.norm(q)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ]
    )


def _matrix_to_quat(m: np.ndarray) -> np.ndarray:
    w = np.sqrt(max(0.0, 1.0 + m[0, 0] + m[1, 1] + m[2, 2])) / 2.0
    if w > 1e-8:
        return np.array(
            [w, (m[2, 1] - m[1, 2]) / (4 * w), (m[0, 2] - m[2, 0]) / (4 * w), (m[1, 0] - m[0, 1]) / (4 * w)]
        )
    # fall back to the largest diagonal element branch
    i = int(np.argmax(np.diag(m)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(0.0, 1.0 + m[i, i] - m[j, j] - m[k, k])) * 2.0
    q = np.zeros(4)
    q[1 + i] = s / 4
    q[0] = (m[k, j] - m[j, k]) / s
    q[1 + j] = (m[j, i] + m[i, j]) / s
    q[1 + k] = (m[k, i] + m[i, k]) / s
    return q


def state_to_eep(xyz_coor, zangle: float) -> np.ndarray:
    """Start state -> 4x4 end-effector pose (reference widowx_env.py:17-28;
    matches `widowx_controller`'s convention). Pure numpy — no pyquaternion."""
    assert len(xyz_coor) == 3
    rot_z = np.array([np.cos(zangle / 2.0), 0.0, 0.0, np.sin(zangle / 2.0)])  # wxyz about z
    quat = _quat_mul(rot_z, _matrix_to_quat(_DEFAULT_ROTATION))
    pose = np.eye(4)
    pose[:3, -1] = xyz_coor
    pose[:3, :3] = _quat_to_matrix(quat)
    return pose


def wait_for_obs(widowx_client) -> Dict[str, Any]:
    obs = widowx_client.get_observation()
    while obs is None:
        print("Waiting for observations...")
        time.sleep(1)
        obs = widowx_client.get_observation()
    return obs


def convert_obs(obs: Dict[str, Any], im_size: int) -> Dict[str, Any]:
    """Raw widowx obs -> BridgeV2 eval obs: uint8 image + RLDS 8-dim proprio
    (xyz+rpy, zero pad slot, gripper) (reference widowx_env.py:41-52)."""
    image_obs = (obs["image"].reshape(3, im_size, im_size).transpose(1, 2, 0) * 255).astype(np.uint8)
    proprio = np.concatenate([obs["state"][:6], [0], obs["state"][-1:]])
    out = {"image_primary": image_obs, "proprio": proprio}
    if "full_image" in obs:
        out["full_image"] = obs["full_image"]
    return out


def null_obs(img_size: int) -> Dict[str, Any]:
    return {
        "image_primary": np.zeros((img_size, img_size, 3), dtype=np.uint8),
        "proprio": np.zeros((8,), dtype=np.float64),
    }


class WidowXGym(_ENV_BASE):
    """Gym-style environment over a `WidowXClient`
    (reference widowx_env.py:63-160)."""

    def __init__(self, widowx_client, cfg, im_size: int = 256, blocking: bool = True):
        self.widowx_client = widowx_client
        self.im_size = im_size
        self.blocking = blocking
        self.cfg = cfg
        if gym is not None:
            self.observation_space = gym.spaces.Dict(
                {
                    "image_primary": gym.spaces.Box(
                        low=np.zeros((im_size, im_size, 3)),
                        high=255 * np.ones((im_size, im_size, 3)),
                        dtype=np.uint8,
                    ),
                    "full_image": gym.spaces.Box(
                        low=np.zeros((480, 640, 3)),
                        high=255 * np.ones((480, 640, 3)),
                        dtype=np.uint8,
                    ),
                    "proprio": gym.spaces.Box(low=-np.ones((8,)), high=np.ones((8,)), dtype=np.float64),
                }
            )
            self.action_space = gym.spaces.Box(low=np.zeros((7,)), high=np.ones((7,)), dtype=np.float64)

    def step(self, action) -> Tuple[Dict[str, Any], float, bool, bool, Dict]:
        self.widowx_client.step_action(action, blocking=self.blocking)
        raw_obs = self.widowx_client.get_observation()
        if raw_obs is None:
            # lost connection to the action server: truncate the episode
            return null_obs(self.im_size), 0.0, False, True, {}
        return convert_obs(raw_obs, self.im_size), 0.0, False, False, {}

    def reset(self, seed=None, options=None) -> Tuple[Dict[str, Any], Dict]:
        if gym is not None:
            super().reset(seed=seed)
        self.widowx_client.reset()
        self.move_to_start_state()
        return convert_obs(wait_for_obs(self.widowx_client), self.im_size), {}

    def get_observation(self) -> Dict[str, Any]:
        return convert_obs(wait_for_obs(self.widowx_client), self.im_size)

    def move_to_start_state(self) -> None:
        """Interactive start pose: user confirms/overrides xyz, then a
        BLOCKING move (non-blocking would race `_reset_previous_qpos`)."""
        while True:
            try:
                init = list(getattr(self.cfg, "init_ee_pos", (0.3, -0.09, 0.26)))
                vals = []
                for name, default in zip("xyz", init):
                    raw = input(f"Enter {name} of gripper start (empty for default == {default}): ").strip()
                    vals.append(float(raw) if raw else float(default))
                transform = np.eye(4)
                transform[:3, :3] = _START_ROT
                transform[:3, -1] = vals
                self.widowx_client.move(transform, duration=0.8, blocking=True)
                return
            except Exception as e:  # noqa: BLE001 — retry on bad input / transient robot errors
                print(e)
