"""RLDS data utilities in numpy: normalization, gripper relabeling, dataset
statistics, thread allocation.

Counterpart of bridgelang_tpu/vla/datasets/rlds/utils/data_utils.py (there
on tf.data). A trajectory is a dict of numpy arrays over time. The contract
is the JAX package's: the statistics schema and its sha256-keyed JSON cache
(here under `~/.cache/bridgelang_tpu_torch/`), q01/q99 bounds normalization
with masked dims passing through, and the gripper scans.
"""

from __future__ import annotations

import hashlib
import json
import os
from enum import Enum
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional

import numpy as np

AUTOTUNE = -1  # a thread count the pipeline chooses itself (tf.data.AUTOTUNE's value)


class NormalizationType(str, Enum):
    NORMAL = "normal"            # mean 0, std 1
    BOUNDS = "bounds"            # min/max -> [-1, 1]
    BOUNDS_Q99 = "bounds_q99"    # q01/q99 -> [-1, 1] (the VLA default)


def to_padding(x: np.ndarray) -> np.ndarray:
    """Zeros of a numeric array, empty strings of a string array."""
    x = np.asarray(x)
    if x.dtype.kind in "SUO":
        return np.full(x.shape, b"" if x.dtype.kind in "SO" else "", dtype=x.dtype)
    if x.dtype.kind in "biuf":
        return np.zeros_like(x)
    raise ValueError(f"Cannot pad an array of dtype {x.dtype}")


# --- gripper action relabeling ------------------------------------------------


def binarize_gripper_actions(actions: np.ndarray) -> np.ndarray:
    """Continuous gripper [0, 1] -> {0, 1}: values in between take the next
    definitive (open > 0.95 / closed < 0.05) value ahead, by a reverse scan
    seeded with the trajectory's last action (JAX data_utils.py:36-54)."""
    actions = np.asarray(actions, np.float32)
    open_mask = actions > 0.95
    closed_mask = actions < 0.05
    in_between = ~(open_mask | closed_mask)
    out = np.empty_like(actions)
    carry = actions[-1]
    for i in range(len(actions) - 1, -1, -1):
        if not in_between[i]:
            carry = np.float32(open_mask[i])
        out[i] = carry
    return out


def invert_gripper_actions(actions: np.ndarray) -> np.ndarray:
    return 1.0 - actions


def rel2abs_gripper_actions(actions: np.ndarray) -> np.ndarray:
    """Relative gripper commands (+1 closing / -1 opening / ~0 hold) ->
    absolute open state in [0, 1]: a forward scan holding the last command,
    starting from the inverse of the first one (open when none is given)."""
    actions = np.asarray(actions)
    thresholded = np.where(actions < -0.1, 1, np.where(actions > 0.1, -1, 0)).astype(np.int32)
    nonzero = np.flatnonzero(thresholded != 0)
    start = -thresholded[nonzero[0]] if len(nonzero) else 0
    carry = 1 if start == 0 else start
    out = np.empty(len(actions), np.int32)
    for i, t in enumerate(thresholded):
        if t != 0:
            carry = t
        out[i] = carry
    return out.astype(np.float32) / 2 + 0.5


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def relabel_bridge_actions(traj: Dict[str, Any]) -> Dict[str, Any]:
    """Bridge-style relabeling: the movement dims of action[t] become
    state[t+1] - state[t]; the last step is dropped."""
    state = traj["observation"]["state"]
    movement = state[1:, :6] - state[:-1, :6]
    truncated = _tree_map(lambda x: x[:-1], traj)
    truncated["action"] = np.concatenate([movement, traj["action"][:-1, -1:]], axis=1)
    return truncated


# --- normalization ------------------------------------------------------------


def normalize_action_and_proprio(traj: Dict[str, Any], metadata: Dict[str, Dict[str, np.ndarray]],
                                 normalization_type: NormalizationType) -> Dict[str, Any]:
    """Apply per-dataset statistics in float32; dims whose `mask` is False
    pass through, and under the bounds modes a dim with min == max becomes 0
    whatever its mask (JAX data_utils.py:75-123)."""
    keys = {"action": "action"}
    if "proprio" in traj.get("observation", {}):
        keys["proprio"] = "proprio"
    out = dict(traj)
    for traj_key, stats_key in keys.items():
        stats = {k: np.asarray(v, dtype=np.float32) for k, v in metadata[stats_key].items() if k != "mask"}
        mask = np.asarray(metadata[stats_key].get(
            "mask", np.ones_like(stats["q01"] if "q01" in stats else stats["mean"], dtype=bool)), dtype=bool)
        x = out["observation"][traj_key] if traj_key == "proprio" else out[traj_key]
        if normalization_type == NormalizationType.NORMAL:
            y = (x - stats["mean"]) / (stats["std"] + 1e-8)
        elif normalization_type == NormalizationType.BOUNDS:
            y = np.clip(2.0 * (x - stats["min"]) / (stats["max"] - stats["min"] + 1e-8) - 1.0, -1.0, 1.0)
        elif normalization_type == NormalizationType.BOUNDS_Q99:
            y = np.clip(2.0 * (x - stats["q01"]) / (stats["q99"] - stats["q01"] + 1e-8) - 1.0, -1.0, 1.0)
        else:
            raise ValueError(f"Unknown normalization {normalization_type}")
        normalized = np.where(mask, y, x).astype(np.float32)
        if normalization_type in (NormalizationType.BOUNDS, NormalizationType.BOUNDS_Q99):
            normalized = np.where(stats["min"] == stats["max"], np.float32(0), normalized)
        if traj_key == "proprio":
            out["observation"] = dict(out["observation"], proprio=normalized)
        else:
            out[traj_key] = normalized
    return out


# --- statistics ---------------------------------------------------------------


def statistics_cache_dir() -> Path:
    return Path.home() / ".cache" / "bridgelang_tpu_torch"


def get_dataset_statistics(trajectories: Iterable[Dict[str, Any]], hash_dependencies: List[str],
                           save_dir: Optional[str] = None, force_recompute: bool = False) -> Dict[str, Any]:
    """mean/std/min/max/q01/q99 of action (and observation/proprio) over every
    step, with num_transitions and num_trajectories, cached as JSON under a
    sha256 of `hash_dependencies` (in `save_dir`, else the home cache).
    `trajectories` is iterated only on a cache miss."""
    unique_hash = hashlib.sha256("".join(hash_dependencies).encode("utf-8")).hexdigest()
    cache_paths = []
    if save_dir:
        cache_paths.append(Path(save_dir) / f"dataset_statistics_{unique_hash}.json")
    cache_paths.append(statistics_cache_dir() / f"dataset_statistics_{unique_hash}.json")

    if not force_recompute:
        for p in cache_paths:
            if p.exists():
                with open(p) as f:
                    return json.load(f)

    actions, proprios = [], []
    num_transitions, num_trajectories = 0, 0
    for traj in trajectories:
        actions.append(np.asarray(traj["action"]))
        if isinstance(traj.get("observation"), dict) and "proprio" in traj["observation"]:
            proprios.append(np.asarray(traj["observation"]["proprio"]))
        num_transitions += len(traj["action"])
        num_trajectories += 1
    actions = np.concatenate(actions, axis=0)

    def stats_of(x):
        return {
            "mean": x.mean(0).tolist(),
            "std": x.std(0).tolist(),
            "max": x.max(0).tolist(),
            "min": x.min(0).tolist(),
            "q01": np.quantile(x, 0.01, axis=0).tolist(),
            "q99": np.quantile(x, 0.99, axis=0).tolist(),
        }

    metadata = {"action": stats_of(actions), "num_transitions": num_transitions,
                "num_trajectories": num_trajectories}
    if proprios:
        metadata["proprio"] = stats_of(np.concatenate(proprios, axis=0))

    for p in cache_paths:
        try:
            p.parent.mkdir(parents=True, exist_ok=True)
            tmp = p.with_suffix(f".{os.getpid()}.tmp")
            with open(tmp, "w") as f:
                json.dump(metadata, f)
            os.replace(tmp, p)
            break
        except OSError:
            continue
    return metadata


def save_dataset_statistics(run_dir, statistics: Dict[str, Any]) -> None:
    """The inference-time sidecar `<run_dir>/dataset_statistics.json`."""
    out = Path(run_dir) / "dataset_statistics.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out, "w") as f:
        json.dump(statistics, f, indent=2, default=lambda x: np.asarray(x).tolist())


# --- mixture utilities --------------------------------------------------------


def allocate_threads(n: Optional[int], weights: np.ndarray) -> np.ndarray:
    """Distribute n threads over datasets in proportion to their weights,
    each getting at least one; None gives each dataset AUTOTUNE."""
    if n is None:
        return np.full(len(weights), AUTOTUNE, dtype=np.int64)
    assert n >= len(weights), "more datasets than threads"
    weights = np.asarray(weights, dtype=np.float32)
    weights = weights / weights.sum()
    allocation = np.zeros_like(weights, dtype=np.int64)
    while True:
        mask = (weights * n < 1) & (weights > 0)
        if not mask.any():
            break
        n -= mask.sum()
        allocation += mask
        weights[mask] = 0.0
        if weights.sum() > 0:
            weights = weights / weights.sum()
    fractional, integral = np.modf(weights * n)
    allocation += integral.astype(np.int64)
    n -= int(integral.sum())
    for i in np.argsort(fractional)[::-1][:n]:
        allocation[i] += 1
    return allocation


def pprint_data_mixture(dataset_kwargs_list: List[Dict[str, Any]], dataset_weights: List[float]) -> str:
    lines = ["", "#" * 80, "# Loading the following dataset mixture (name: weight):", "#" * 80]
    total = sum(dataset_weights) or 1.0
    for kw, w in zip(dataset_kwargs_list, dataset_weights):
        lines.append(f"#  {kw['name']}: {w / total:.5f}")
    lines.append("#" * 80)
    return "\n".join(lines)
