"""Per-dataset loader kwargs from the OXE configs and mixtures (host only).

The port's copy of bridgelang_tpu/vla/datasets/rlds/oxe/materialize.py
(reference prismatic/vla/datasets/rlds/oxe/materialize.py), with DROID's
zero-action chunk filter in numpy.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from bridgelang_tpu_torch.vla.datasets.rlds.oxe.configs import ActionEncoding, OXE_DATASET_CONFIGS
from bridgelang_tpu_torch.vla.datasets.rlds.oxe.mixtures import OXE_NAMED_MIXTURES
from bridgelang_tpu_torch.vla.datasets.rlds.oxe.transforms import OXE_STANDARDIZATION_TRANSFORMS
from bridgelang_tpu_torch.vla.datasets.rlds.utils.data_utils import NormalizationType

logger = logging.getLogger(__name__)

_DROID_Q01 = np.array([-0.7776297926902771, -0.5803514122962952, -0.5795090794563293,
                       -0.6464047729969025, -0.7041108310222626, -0.8895104378461838], np.float32)
_DROID_Q99 = np.array([0.7597932070493698, 0.5726242214441299, 0.7351000607013702,
                       0.6705610305070877, 0.6464948207139969, 0.8897542208433151], np.float32)


def zero_action_filter(frame: Dict[str, Any]) -> bool:
    """Keep a frame unless its action chunk is all ~zero (DROID's idle
    stretches). It runs after q99 normalization, so "zero" is the normalized
    zero action (JAX oxe/droid_utils.py:66-76)."""
    acts = np.asarray(frame["action"])[..., :6]
    norm_zero = 2 * (np.zeros_like(acts) - _DROID_Q01) / (_DROID_Q99 - _DROID_Q01 + 1e-8) - 1
    return bool(np.any(np.abs(acts - norm_zero) > 1e-5))


CHUNK_FILTERS = {"zero_action": zero_action_filter}


def make_oxe_dataset_kwargs(
    dataset_name: str,
    data_root_dir: str,
    load_camera_views: Tuple[str, ...] = ("primary",),
    load_depth: bool = False,
    load_proprio: bool = False,
    load_language: bool = True,
    action_proprio_normalization_type: NormalizationType = NormalizationType.BOUNDS_Q99,
) -> Dict[str, Any]:
    """kwargs for `make_dataset_from_rlds` (reference materialize.py:21-89).
    The normalization mask excludes the gripper dim (trained on absolute
    open/close, never normalized); absolute_action_mask marks non-delta dims.
    """
    cfg = OXE_DATASET_CONFIGS[dataset_name]
    if cfg.action_encoding == ActionEncoding.EEF_POS:
        # 6 relative EEF dims + absolute gripper
        absolute_action_mask = [False] * 6 + [True]
        action_normalization_mask = [True] * 6 + [False]
    elif cfg.action_encoding == ActionEncoding.JOINT_POS:
        absolute_action_mask = [False] * 7 + [True]
        action_normalization_mask = [True] * 7 + [False]
    elif cfg.action_encoding == ActionEncoding.JOINT_POS_BIMANUAL:
        absolute_action_mask = ([False] * 6 + [True]) * 2
        action_normalization_mask = ([True] * 6 + [False]) * 2
    elif cfg.action_encoding == ActionEncoding.EEF_R6:
        absolute_action_mask = [False] * 9 + [True]
        action_normalization_mask = [True] * 9 + [False]
    else:
        raise ValueError(f"Unsupported action encoding {cfg.action_encoding}")

    missing = [v for v in load_camera_views if cfg.image_obs_keys.get(v) is None and v != "secondary"]
    if missing and all(cfg.image_obs_keys.get(v) is None for v in load_camera_views):
        raise ValueError(f"{dataset_name}: no requested camera view available ({load_camera_views})")

    image_obs_keys = {k: v for k, v in cfg.image_obs_keys.items() if k in load_camera_views}
    depth_obs_keys = {k: v for k, v in cfg.depth_obs_keys.items() if load_depth and k in load_camera_views}

    kwargs: Dict[str, Any] = {
        "name": dataset_name,
        "data_dir": str(data_root_dir),
        "image_obs_keys": image_obs_keys,
        "depth_obs_keys": depth_obs_keys,
        "standardize_fn": OXE_STANDARDIZATION_TRANSFORMS[dataset_name],
        "language_key": "language_instruction" if load_language else None,
        "action_proprio_normalization_type": action_proprio_normalization_type,
        "absolute_action_mask": absolute_action_mask,
        "action_normalization_mask": action_normalization_mask,
    }
    if cfg.chunk_filter is not None:
        kwargs["chunk_filter_fn"] = CHUNK_FILTERS[cfg.chunk_filter]
    if load_proprio:
        # Assemble proprio by concatenating the config's raw state keys with
        # one zero-pad dim per None slot (reference materialize.py:49-63 +
        # dataset.py:157-167); fall back to a pre-merged "proprio" key for
        # configs that don't declare state_obs_keys.
        if cfg.state_obs_keys:
            kwargs["state_obs_keys"] = list(cfg.state_obs_keys)
        else:
            kwargs["proprio_obs_key"] = "proprio"
    return kwargs


def get_oxe_dataset_kwargs_and_weights(
    data_root_dir: str,
    mixture_spec: List[Tuple[str, float]],
    load_camera_views: Tuple[str, ...] = ("primary",),
    load_depth: bool = False,
    load_proprio: bool = False,
    load_language: bool = True,
    action_proprio_normalization_type: NormalizationType = NormalizationType.BOUNDS_Q99,
) -> Tuple[List[Dict[str, Any]], List[float]]:
    """Resolve a mixture into loader kwargs, skipping unregistered/broken
    datasets with a warning (reference materialize.py:92-131)."""
    included, filtered_weights = [], []
    seen = set()
    for name, weight in mixture_spec:
        if name in seen:
            # First occurrence wins (reference materialize.py:102-109 — the
            # rtx_franka mixture repeats shared RT-X entries on purpose).
            logger.warning("Skipping duplicate dataset %r", name)
            continue
        seen.add(name)
        if name not in OXE_DATASET_CONFIGS or name not in OXE_STANDARDIZATION_TRANSFORMS:
            logger.warning("Skipping unregistered dataset %r", name)
            continue
        try:
            kwargs = make_oxe_dataset_kwargs(
                name, data_root_dir, load_camera_views, load_depth, load_proprio, load_language,
                action_proprio_normalization_type,
            )
        except ValueError as e:
            logger.warning("Skipping %r: %s", name, e)
            continue
        included.append(kwargs)
        filtered_weights.append(weight)
    return included, filtered_weights


def resolve_mixture(data_mix: str) -> List[Tuple[str, float]]:
    if data_mix in OXE_NAMED_MIXTURES:
        return OXE_NAMED_MIXTURES[data_mix]
    # Single-dataset fallback: any registered dataset name is a valid mix.
    return [(data_mix, 1.0)]
