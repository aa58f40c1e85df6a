"""OpenVLA eval helpers: model loading and action queries.

Counterpart of experiments/robot/openvla_utils.py (the reference's
experiments/robot/openvla_utils.py:31-170). Two backends: in process
(`load_vla` and the port's predicts, on the card unless `device="cpu"`) or a
REST server (`serving.server`), so that a simulator host needs no card.

The center crop saturates its uint8 cast: the bicubic resize overshoots
[0, 1], and values past it clip to 0 and 255 (the reference clips before
`convert_image_dtype(..., saturate=True)`), where the JAX harness's numpy
cast wraps them around.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np


class _ChunkQueue:
    """Open-loop chunk execution (the OFT eval protocol): fetch an
    [H, action_dim] chunk once, pop one action per control tick, fetch again
    when drained or when the task or unnorm_key changes. Needs a model
    fine-tuned with `finetune --parallel_decode --action_chunk H`."""

    def __init__(self, horizon: int):
        self.horizon = int(horizon)
        self._pending: list = []
        self._key = None

    def next(self, key, fetch) -> np.ndarray:
        if key != self._key:
            self._pending, self._key = [], key
        if not self._pending:
            chunk = np.asarray(fetch(self.horizon))
            self._pending = [chunk[i] for i in range(chunk.shape[0])]
        return self._pending.pop(0)

    def reset(self) -> None:
        """Drop pending actions. Call at each episode's start: a leftover
        chunk was planned from the previous episode's last frame."""
        self._pending = []


class InProcessVLA:
    """The policy in this process. With `speculative` the previous tick's
    action ids are the next tick's draft (greedy-equivalent by the margin
    gate, see `models.vlm.generate_speculative`); with `action_chunk` > 1 it
    executes chunks open loop instead (one parallel forward per H ticks, see
    `_ChunkQueue`). `device`: CUDA by default (raises without a card)."""

    def __init__(self, checkpoint: str, tokenizer_path: Optional[str] = None, quantize_int8: bool = True,
                 speculative: bool = False, action_chunk: int = 1, device=None):
        from bridgelang_tpu_torch.models.llm.tokenizer import get_tokenizer
        from bridgelang_tpu_torch.models.load import load_vla

        self.model, self.params = load_vla(checkpoint, quantize_int8=quantize_int8, device=device)
        self.model.tokenizer = get_tokenizer(tokenizer_path)
        self.device = self.model.device
        self.speculative = speculative
        self._last_tokens: Optional[np.ndarray] = None
        self._chunks = _ChunkQueue(action_chunk) if action_chunk > 1 else None

    def reset_episode(self) -> None:
        """Drop per-episode state (pending chunk actions, the draft)."""
        if self._chunks is not None:
            self._chunks.reset()
        self._last_tokens = None

    def predict(self, image: np.ndarray, instruction: str, unnorm_key: Optional[str]) -> np.ndarray:
        if self._chunks is not None:
            return self._chunks.next(
                (instruction, unnorm_key),
                lambda h: self.model.predict_action_chunk(self.params, image, instruction, horizon=h,
                                                          unnorm_key=unnorm_key),
            )
        if self.speculative:
            draft = self._last_tokens
            if draft is None:
                draft = np.zeros(self.model.get_action_dim(unnorm_key), np.int32)
            action, tokens = self.model.predict_action_speculative(self.params, image, instruction,
                                                                   draft_tokens=draft, unnorm_key=unnorm_key)
            self._last_tokens = tokens
            return action
        return self.model.predict_action(self.params, image, instruction, unnorm_key=unnorm_key)


class RemoteVLA:
    """The policy behind a REST server (`deploy`); the frames' crop runs on
    this host's CPU."""

    device = "cpu"

    def __init__(self, host: str, port: int, speculative: bool = False, action_dim: int = 7,
                 action_chunk: int = 1):
        self.host, self.port = host, port
        self.speculative = speculative
        self.action_dim = action_dim
        self._last_tokens: Optional[np.ndarray] = None
        self._chunks = _ChunkQueue(action_chunk) if action_chunk > 1 else None

    def reset_episode(self) -> None:
        if self._chunks is not None:
            self._chunks.reset()
        self._last_tokens = None

    def predict(self, image: np.ndarray, instruction: str, unnorm_key: Optional[str]) -> np.ndarray:
        from bridgelang_tpu_torch.serving.server import client_act

        if self._chunks is not None:
            return self._chunks.next(
                (instruction, unnorm_key),
                lambda h: client_act(self.host, self.port, image, instruction, unnorm_key, horizon=h),
            )
        if self.speculative:
            draft = self._last_tokens if self._last_tokens is not None else np.zeros(self.action_dim, np.int32)
            action, tokens = client_act(self.host, self.port, image, instruction, unnorm_key,
                                        draft_tokens=draft, return_tokens=True)
            if tokens is not None:
                self._last_tokens = tokens
            return action
        return client_act(self.host, self.port, image, instruction, unnorm_key)


def get_vla(cfg) -> Any:
    """`RemoteVLA` when cfg.remote_host is set, else `InProcessVLA` on
    cfg.device (CUDA when it is None)."""
    speculative = bool(getattr(cfg, "speculative", False))
    action_chunk = int(getattr(cfg, "action_chunk", 1))
    if getattr(cfg, "remote_host", None):
        return RemoteVLA(cfg.remote_host, cfg.remote_port, speculative=speculative, action_chunk=action_chunk)
    return InProcessVLA(cfg.pretrained_checkpoint, getattr(cfg, "tokenizer_path", None), speculative=speculative,
                        action_chunk=action_chunk, device=getattr(cfg, "device", None))


def crop_and_resize(image01: np.ndarray, crop_scale: float = 0.9, device="cpu") -> np.ndarray:
    """Center crop of sqrt(crop_scale) per side, resized back
    (`ops.image_ops.crop_and_resize_eval`, on `device`) -> float32 [H, W, 3].
    It must match training's random-crop statistics: the reference's
    openvla_utils.py:81-124 warns that LIBERO-trained models degrade
    without it."""
    import torch

    from bridgelang_tpu_torch.ops.image_ops import crop_and_resize_eval

    image = torch.as_tensor(np.asarray(image01, np.float32), device=device)
    return crop_and_resize_eval(image, crop_scale).cpu().numpy()


def crop_frame_u8(frame: np.ndarray, device="cpu") -> np.ndarray:
    """A uint8 frame through `crop_and_resize`, back to uint8: rounded half
    to even, then saturated to [0, 255]."""
    image01 = np.asarray(frame).astype(np.float32) / 255.0
    return np.clip((crop_and_resize(image01, device=device) * 255.0).round(), 0, 255).astype(np.uint8)


def get_vla_action(vla, obs: Dict[str, Any], task_label: str, unnorm_key: Optional[str] = None,
                   center_crop: bool = False) -> np.ndarray:
    """The action for obs["full_image"] (uint8 [H, W, 3]) and the task; with
    `center_crop`, the frame goes through `crop_frame_u8` on the policy's
    device first."""
    image = np.asarray(obs["full_image"])
    if center_crop:
        image = crop_frame_u8(image, device=getattr(vla, "device", "cpu"))
    return vla.predict(image, task_label, unnorm_key)
