"""Action de-tokenization on the device: LLM token ids -> continuous actions.

Counterpart of the device half of bridgelang_tpu/vla/action_tokenizer.py,
with the same bit-fidelity contract:
  bins        = linspace(min, max, n_bins)                    # 256 edges
  bin_centers = midpoints                                     # 255 centers
  decode      = bin_centers[clip(vocab_size - id - 1, 0, 254)]
where `vocab_size` is the ORIGINAL LLM vocab (32000 for Llama-2), not the
padded embedding table.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

LLAMA2_VOCAB_SIZE = 32000
DEFAULT_N_BINS = 256


def make_bins(n_bins: int = DEFAULT_N_BINS, min_action: float = -1.0, max_action: float = 1.0):
    bins = np.linspace(min_action, max_action, n_bins)
    bin_centers = (bins[:-1] + bins[1:]) / 2.0
    return bins, bin_centers


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
