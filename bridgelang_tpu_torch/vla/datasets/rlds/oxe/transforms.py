"""Per-dataset standardization transforms for Open X-Embodiment datasets, in
numpy.

Counterpart of bridgelang_tpu/vla/datasets/rlds/oxe/transforms.py. Every
transform maps a raw trajectory (a dict of numpy arrays over time) to the
canonical layout:

    action [T, 7] = EEF delta xyz (3) + delta rpy (3) + ABSOLUTE gripper
                    with +1 = open / 0 = close
    observation gains the state keys named by the dataset's config

Ported: `libero` (the LIBERO native stores), `bridge_orig` (Bridge V2 from
the project website) and `identity`, with the helpers they use. The other
datasets' transforms act on TFDS's nested action dicts and wait for the
TFDS reader: their registry entries raise `NotImplementedError`.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np

from bridgelang_tpu_torch.vla.datasets.rlds.oxe.configs import OXE_DATASET_CONFIGS
from bridgelang_tpu_torch.vla.datasets.rlds.utils.data_utils import (
    binarize_gripper_actions,
    invert_gripper_actions,
    rel2abs_gripper_actions,
    relabel_bridge_actions,
)

Traj = Dict[str, Any]


def _grip(mode: str, g: np.ndarray) -> np.ndarray:
    """Normalize a gripper channel to absolute +1=open/0=close."""
    if mode == "clip":
        return np.clip(g, 0, 1)
    if mode == "invert_clip":
        return invert_gripper_actions(np.clip(g, 0, 1))
    if mode == "invert":
        return invert_gripper_actions(g)
    if mode == "rel2abs":
        return rel2abs_gripper_actions(g[..., 0] if g.ndim == 2 else g)[..., None]
    if mode == "binarize":
        return binarize_gripper_actions(g[..., 0] if g.ndim == 2 else g)[..., None]
    if mode == "pass":
        return g
    raise ValueError(mode)


def _split_state(traj: Traj, eef_key: str = "EEF_state", grip_key: str = "gripper_state",
                 src: str = "state", eef_slice=(0, 6), grip_slice=(-1, None)) -> Traj:
    state = traj["observation"][src]
    g0, g1 = grip_slice
    traj["observation"] = dict(traj["observation"], **{eef_key: state[:, eef_slice[0]:eef_slice[1]],
                                                        grip_key: state[:, g0:g1]})
    return traj


def _drop_first_step(traj: Traj) -> Traj:
    out = {}
    for key, val in traj.items():
        if key == "traj_metadata":
            out[key] = val
        elif isinstance(val, dict):
            out[key] = {k: v[1:] for k, v in val.items()}
        else:
            out[key] = val[1:]
    return out


def bridge_orig(traj: Traj) -> Traj:
    """Bridge V2 from the project website: drop the zero first step, binarize
    the continuous gripper, relabel actions from state deltas."""
    traj = _drop_first_step(traj)
    traj["action"] = np.concatenate(
        (traj["action"][:, :6], binarize_gripper_actions(traj["action"][:, -1])[:, None]), axis=1)
    traj = relabel_bridge_actions(traj)
    return _split_state(traj)


def libero(traj: Traj) -> Traj:
    """LIBERO regenerated datasets: gripper in -1(open)..1(close) -> clip+flip."""
    grip = invert_gripper_actions(np.clip(traj["action"][:, -1:], 0, 1))
    traj = dict(traj, action=np.concatenate((traj["action"][:, :6], grip), axis=1))
    obs = traj["observation"]
    traj["observation"] = dict(obs, EEF_state=obs["state"][:, :6], gripper_state=obs["state"][:, -2:])
    return traj


def identity(traj: Traj) -> Traj:
    return traj


def _unported(name: str) -> Callable[[Traj], Traj]:
    def unported(traj: Traj) -> Traj:
        raise NotImplementedError(
            f"the standardization transform of {name!r} acts on TFDS's nested action dicts and is not yet "
            "ported: it waits for the TFDS reader (ROADMAP.md: TFDS/RLDS reading without TF); the port "
            "reads libero_*, bridge_orig/bridge_dataset and the identity-transform datasets")

    return unported


_PORTED: Dict[str, Callable[[Traj], Traj]] = {
    "bridge_orig": bridge_orig,
    "bridge_dataset": bridge_orig,
    "libero_spatial_no_noops": libero,
    "libero_object_no_noops": libero,
    "libero_goal_no_noops": libero,
    "libero_10_no_noops": libero,
    "libero_combined": libero,
    "utokyo_xarm_pick_and_place_converted_externally_to_rlds": identity,
    "berkeley_mvp_converted_externally_to_rlds": identity,
    "berkeley_rpt_converted_externally_to_rlds": identity,
    "dlr_sara_pour_converted_externally_to_rlds": identity,
}

OXE_STANDARDIZATION_TRANSFORMS: Dict[str, Callable[[Traj], Traj]] = {
    name: _PORTED.get(name) or _unported(name) for name in OXE_DATASET_CONFIGS
}
