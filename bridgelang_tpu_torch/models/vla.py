"""OpenVLA in torch: action prediction on top of PrismaticVLM.

Counterpart of bridgelang_tpu/models/vla.py (greedy decoding). After
tokenization the whole path runs on the model's device: frame preprocessing,
vision encode, prefill, greedy decode of `action_dim` tokens, bin
de-tokenization and q01/q99 unnormalization; one host copy returns the
actions. Speculative, parallel and chunked decoding are not yet ported.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Union

import numpy as np
import torch

from bridgelang_tpu_torch.models.llm.prompting import build_vla_prompt
from bridgelang_tpu_torch.models.vlm import LLAMA_EMPTY_TOKEN, Params, PrismaticVLM, VLMConfig
from bridgelang_tpu_torch.ops.image_ops import frames_to_tensor, preprocess_batch
from bridgelang_tpu_torch.vla.action_tokenizer import make_bins, token_ids_to_actions, unnormalize_actions

DEFAULT_PROMPT_BUCKET = 48


def check_unnorm_key(norm_stats: Dict[str, Any], unnorm_key: Optional[str]) -> str:
    if unnorm_key is None:
        if len(norm_stats) != 1:
            raise ValueError(f"Model trained on multiple datasets; pass `unnorm_key` from: {list(norm_stats.keys())}")
        unnorm_key = next(iter(norm_stats.keys()))
    if unnorm_key not in norm_stats:
        raise ValueError(f"`unnorm_key` {unnorm_key!r} not in available statistics: {list(norm_stats.keys())}")
    return unnorm_key


class OpenVLA(PrismaticVLM):
    def __init__(
        self,
        cfg: VLMConfig,
        norm_stats: Dict[str, Any],
        tokenizer=None,
        dtype: torch.dtype = torch.bfloat16,
        n_action_bins: int = 256,
        prompt_bucket: int = DEFAULT_PROMPT_BUCKET,
        device=None,
    ):
        super().__init__(cfg, dtype=dtype, device=device)
        self.norm_stats = norm_stats
        self.tokenizer = tokenizer
        self.n_action_bins = n_action_bins
        self.prompt_bucket = prompt_bucket
        _, bin_centers = make_bins(n_action_bins)
        self.bin_centers = torch.as_tensor(bin_centers, dtype=torch.float32, device=self.device)

    def get_action_dim(self, unnorm_key: Optional[str] = None) -> int:
        key = check_unnorm_key(self.norm_stats, unnorm_key)
        return len(self.norm_stats[key]["action"]["q01"])

    # --- device path ---

    def predict_action_device(
        self,
        params: Params,
        input_ids: torch.Tensor,
        attention_mask: torch.Tensor,
        pixel_values: torch.Tensor,
        q01: torch.Tensor,
        q99: torch.Tensor,
        stat_mask: torch.Tensor,
        action_dim: int,
    ) -> torch.Tensor:
        """[B, T] prompts + [B, C, H, W] images -> [B, action_dim] actions."""
        token_ids = self.generate_greedy(params, input_ids, attention_mask, pixel_values, max_new_tokens=action_dim)
        normalized = token_ids_to_actions(token_ids, self.bin_centers, self.cfg.llm.vocab_size)
        return unnormalize_actions(normalized, q01, q99, stat_mask)

    # --- host-side API ---

    def prepare_prompt_ids(self, instruction: str) -> np.ndarray:
        """Tokenize the VLA prompt; append the '▁' token the Llama tokenizer drops."""
        if self.tokenizer is None:
            raise ValueError("predict_action from strings requires a tokenizer")
        prompt = build_vla_prompt(instruction, llm_family=self.cfg.llm_family)
        ids = np.asarray(self.tokenizer(prompt).input_ids)
        if ids.ndim > 1:
            ids = ids[0]
        if self.cfg.llm_family in ("llama2-pure", "llama2-chat", "vicuna") and ids[-1] != LLAMA_EMPTY_TOKEN:
            ids = np.concatenate([ids, [LLAMA_EMPTY_TOKEN]])
        return ids.astype(np.int32)

    def pad_prompt(self, ids_list: Sequence[np.ndarray]):
        """Right-pad id arrays to the bucket (doubled until the longest fits)."""
        bucket = self.prompt_bucket
        longest = max(len(i) for i in ids_list)
        while bucket < longest:
            bucket *= 2
        batch = np.full((len(ids_list), bucket), self.cfg.llm.pad_token_id, dtype=np.int32)
        mask = np.zeros((len(ids_list), bucket), dtype=np.int32)
        for r, ids in enumerate(ids_list):
            batch[r, : len(ids)] = ids
            mask[r, : len(ids)] = 1
        return batch, mask

    def predict_action(
        self,
        params: Params,
        image: Union[np.ndarray, Any],
        instruction: str,
        unnorm_key: Optional[str] = None,
    ) -> np.ndarray:
        """Single image (PIL or uint8 [H, W, 3]) + instruction -> action (numpy)."""
        return self.predict_action_batch(params, [image], [instruction], unnorm_key)[0]

    @torch.inference_mode()
    def predict_action_batch(
        self,
        params: Params,
        images: Sequence[Union[np.ndarray, Any]],
        instructions: Sequence[str],
        unnorm_key: Optional[str] = None,
    ) -> np.ndarray:
        key = check_unnorm_key(self.norm_stats, unnorm_key)
        stats = self.norm_stats[key]["action"]
        action_dim = len(stats["q01"])
        dev = self.device
        q01 = torch.as_tensor(np.asarray(stats["q01"], np.float32), device=dev)
        q99 = torch.as_tensor(np.asarray(stats["q99"], np.float32), device=dev)
        stat_mask = torch.as_tensor(np.asarray(stats.get("mask", [True] * action_dim), bool), device=dev)

        frames = np.stack([np.asarray(im.convert("RGB") if hasattr(im, "convert") else im) for im in images])
        ids, mask = self.pad_prompt([self.prepare_prompt_ids(t) for t in instructions])
        pixel_values = preprocess_batch(frames_to_tensor(frames, dev), self.image_transform, dtype=self.dtype)
        out = self.predict_action_device(
            params, torch.as_tensor(ids, device=dev), torch.as_tensor(mask, device=dev), pixel_values,
            q01, q99, stat_mask, action_dim=action_dim,
        )
        return out.cpu().numpy()


def norm_stats_from_json(obj: Dict[str, Any]) -> Dict[str, Any]:
    """Accept a `dataset_statistics.json`-style payload."""
    return {k: {"action": dict(v["action"])} for k, v in obj.items()}
