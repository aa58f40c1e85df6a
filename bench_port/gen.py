"""The one traffic generator: every input of every cell, drawn from the seed.

* /act requests: robot r's request number `tick` carries a fresh uint8 frame
  and an instruction from the mix's list, both drawn from (seed, r, tick).
  Warm-up requests use negative ticks, so no warm frame repeats a timed one.
* Training rows: step s's batch holds every instruction of the mix's list
  equally often, in an order drawn from (seed, s), with uniform actions in
  [-1, 1]; its frames are drawn on the device from (seed, s). So every seed
  gives every step the same sizes (the same real tokens), with other values.

Imports numpy only (torch inside `train_frames`): the robot client, the
harness and the reference all use it.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def _rng(*key: int) -> np.random.Generator:
    return np.random.default_rng([int(k) & 0xFFFFFFFFFFFFFFFF for k in key])


def act_frame(seed: int, robot: int, tick: int, hw: Sequence[int]) -> np.ndarray:
    """[H, W, 3] uint8 frame of one request."""
    return _rng(seed, 1, robot, tick + (1 << 32)).integers(0, 256, size=(hw[0], hw[1], 3), dtype=np.uint8)


def act_instruction(seed: int, robot: int, tick: int, instructions: Sequence[str]) -> str:
    return instructions[int(_rng(seed, 2, robot, tick + (1 << 32)).integers(len(instructions)))]


def train_rows(seed: int, step: int, batch: int, instructions: Sequence[str]) -> Tuple[List[str], np.ndarray]:
    """(instructions [B], actions [B, 7] float32) of step `step`."""
    if batch % len(instructions):
        raise ValueError(f"batch {batch} is no multiple of the mix's {len(instructions)} instructions")
    rng = _rng(seed, 3, step)
    order = rng.permutation(np.repeat(np.arange(len(instructions)), batch // len(instructions)))
    actions = rng.uniform(-1.0, 1.0, size=(batch, 7)).astype(np.float32)
    return [instructions[i] for i in order], actions


def train_frames(seed: int, step: int, batch: int, hw: Sequence[int], device):
    """[B, H, W, 3] uint8 frames of step `step`, drawn on `device`."""
    import torch

    state = int(np.random.SeedSequence([int(seed) & 0xFFFFFFFFFFFFFFFF, 4, step]).generate_state(1, np.uint64)[0] >> 1)
    gen = torch.Generator(device=device).manual_seed(state)
    return torch.randint(0, 256, (batch, hw[0], hw[1], 3), generator=gen, dtype=torch.uint8, device=device)


def sample(seed: int, n_items: int, k: int, must: Sequence[int] = ()) -> List[int]:
    """k indices of n_items drawn from the seed, `must` among them."""
    rng = _rng(seed, 5)
    rest = [i for i in rng.permutation(n_items).tolist() if i not in set(must)]
    return sorted(set(must) | set(rest[:max(0, k - len(set(must)))]))
