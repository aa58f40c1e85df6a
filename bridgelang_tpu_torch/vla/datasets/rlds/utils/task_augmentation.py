"""Task-conditioning augmentation in numpy: drop the language or the goal image.

Counterpart of bridgelang_tpu/vla/datasets/rlds/utils/task_augmentation.py.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from bridgelang_tpu_torch.vla.datasets.rlds.utils.data_utils import to_padding


def delete_task_conditioning(traj: Dict[str, Any], keep_image_prob: float,
                             rng: Optional[np.random.Generator] = None) -> Dict[str, Any]:
    """Per step, with probability `keep_image_prob` (drawn from `rng`) keep
    the goal images and blank the language, else the reverse; a step without
    language keeps its images."""
    if "language_instruction" not in traj.get("task", {}):
        return traj
    task = dict(traj["task"])
    image_keys = {k for k in task if k.startswith("image_") or k.startswith("depth_")}
    if not image_keys:
        return traj
    rng = rng if rng is not None else np.random.default_rng()
    traj_len = len(traj["action"])
    should_keep_images = rng.random(traj_len) < keep_image_prob
    should_keep_images |= ~task["pad_mask_dict"]["language_instruction"]
    pad_mask_dict = dict(task["pad_mask_dict"])
    for k in image_keys | {"language_instruction"}:
        keep = should_keep_images if k in image_keys else ~should_keep_images
        x = np.asarray(task[k])
        task[k] = np.where(keep.reshape((-1,) + (1,) * (x.ndim - 1)), x, to_padding(x))
        pad_mask_dict[k] = pad_mask_dict[k] & keep
    task["pad_mask_dict"] = pad_mask_dict
    return dict(traj, task=task)


TASK_AUGMENT_FUNCTIONS = {"delete_task_conditioning": delete_task_conditioning}
