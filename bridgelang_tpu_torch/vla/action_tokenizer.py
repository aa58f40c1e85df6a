"""Discrete action tokenization: continuous actions <-> LLM token ids.

Counterpart of bridgelang_tpu/vla/action_tokenizer.py: the device half
(`token_ids_to_actions`, `unnormalize_actions`, `bin_actions` on tensors) and
the host `ActionTokenizer` the data pipeline uses. Same bit-fidelity
contract:
  bins        = linspace(min, max, n_bins)                    # 256 edges
  bin_centers = midpoints                                     # 255 centers
  token_id    = vocab_size - digitize(clip(action), bins)     # digitize in [1, 256]
  decode      = bin_centers[clip(vocab_size - id - 1, 0, 254)]
where `vocab_size` is the ORIGINAL LLM vocab (32000 for Llama-2), not the
padded embedding table.
"""

from __future__ import annotations

from typing import List, Optional, Union

import numpy as np
import torch

LLAMA2_VOCAB_SIZE = 32000
DEFAULT_N_BINS = 256


def make_bins(n_bins: int = DEFAULT_N_BINS, min_action: float = -1.0, max_action: float = 1.0):
    bins = np.linspace(min_action, max_action, n_bins)
    bin_centers = (bins[:-1] + bins[1:]) / 2.0
    return bins, bin_centers


def bin_actions(
    actions: torch.Tensor,
    bins: torch.Tensor,
    vocab_size: int = LLAMA2_VOCAB_SIZE,
    min_action: float = -1.0,
    max_action: float = 1.0,
) -> torch.Tensor:
    """Continuous actions -> token ids. `bucketize(right=True)` is
    np.digitize(right=False): the count of edges <= the value."""
    clipped = torch.clamp(actions, min_action, max_action)
    discretized = torch.bucketize(clipped, bins.to(clipped.dtype), right=True)  # in [1, n_bins]
    return (vocab_size - discretized).to(torch.int32)


def token_ids_to_actions(
    token_ids: torch.Tensor,
    bin_centers: torch.Tensor,
    vocab_size: int = LLAMA2_VOCAB_SIZE,
) -> torch.Tensor:
    """Token ids -> normalized actions in [-1, 1], with the reference's
    off-by-one clip."""
    discretized = vocab_size - token_ids.long()
    idx = torch.clamp(discretized - 1, 0, bin_centers.shape[0] - 1)
    return bin_centers[idx]


def unnormalize_actions(
    normalized: torch.Tensor,
    q01: torch.Tensor,
    q99: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """action = 0.5 * (a + 1) * (q99 - q01) + q01 where mask, else a (gripper)."""
    unnormed = 0.5 * (normalized + 1.0) * (q99 - q01) + q01
    if mask is None:
        return unnormed
    return torch.where(mask, unnormed, normalized)


class ActionTokenizer:
    """Host-side action tokenizer with the reference's interface. `tokenizer`
    is any object with `.vocab_size`, `.decode` and `.batch_decode`; only
    `vocab_size` enters the id math."""

    def __init__(self, tokenizer, bins: int = DEFAULT_N_BINS, min_action: float = -1.0, max_action: float = 1.0):
        self.tokenizer, self.n_bins = tokenizer, bins
        self.min_action, self.max_action = min_action, max_action
        self.bins, self.bin_centers = make_bins(bins, min_action, max_action)
        # Contract: action tokens overwrite the final n_bins ids of the vocab.
        self.action_token_begin_idx: int = int(self.tokenizer.vocab_size - (self.n_bins + 1))

    def encode_to_ids(self, action: np.ndarray) -> np.ndarray:
        action = np.clip(action, float(self.min_action), float(self.max_action))
        discretized = np.digitize(action, self.bins)
        return (self.tokenizer.vocab_size - discretized).astype(np.int64)

    def __call__(self, action: np.ndarray) -> Union[str, List[str]]:
        ids = self.encode_to_ids(action)
        if ids.ndim == 1:
            return self.tokenizer.decode(list(ids))
        return self.tokenizer.batch_decode(ids.tolist())

    def decode_token_ids_to_actions(self, action_token_ids: np.ndarray) -> np.ndarray:
        discretized = self.tokenizer.vocab_size - action_token_ids
        discretized = np.clip(discretized - 1, a_min=0, a_max=self.bin_centers.shape[0] - 1)
        return self.bin_centers[discretized]

    @property
    def vocab_size(self) -> int:
        return self.n_bins
