"""Goal relabeling in numpy: a future observation as the goal.

Counterpart of bridgelang_tpu/vla/datasets/rlds/utils/goal_relabeling.py.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np


def uniform(traj: Dict[str, Any], rng: Optional[np.random.Generator] = None) -> Dict[str, Any]:
    """For each step t, a goal index g ~ Uniform[t+1, T) (clamped to the last
    step) drawn from `rng`: task.image_* / depth_* from the goal frame and
    task.timestep = g."""
    rng = rng if rng is not None else np.random.default_rng()
    traj_len = len(traj["action"])
    rand = rng.random(traj_len, dtype=np.float32)
    low = np.arange(traj_len, dtype=np.float32) + 1
    high = np.float32(traj_len)
    goal_idxs = np.minimum((rand * (high - low) + low).astype(np.int32), traj_len - 1)
    task = dict(traj.get("task", {}))
    for k, v in traj["observation"].items():
        if k.startswith("image_") or k.startswith("depth_"):
            task[k] = np.asarray(v)[goal_idxs]
    task["timestep"] = goal_idxs
    return dict(traj, task=task)


GOAL_RELABELING_FUNCTIONS = {"uniform": uniform}
