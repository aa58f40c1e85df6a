"""Deterministic seeding (counterpart of bridgelang_tpu/util/seeding.py).

`set_global_seed` seeds the host libraries (Python, numpy, torch) as the
JAX package does, and returns the same per-worker init function (a numpy
SeedSequence over seed, process and worker). Where the JAX package derives
one root `jax.random.key` per run, the port hands out a `torch.Generator` on
an explicit device: the port's random draws (`init_params`, LoRA adapters)
take a generator, never the global state.
"""

from __future__ import annotations

import os
import random
from typing import Callable, Optional

import numpy as np
import torch


def _process_index() -> int:
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_rank()
    return 0


def set_global_seed(seed: int, get_worker_init_fn: bool = False) -> Optional[Callable[[int], None]]:
    """Seed Python, numpy and torch (CPU and every card); return a
    worker-init function if asked."""
    if not 0 <= seed < np.iinfo(np.uint32).max:
        raise ValueError(f"Seed {seed} out of range")
    os.environ["PYTHONHASHSEED"] = str(seed)
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return (lambda worker_id: _worker_init_fn(seed, worker_id)) if get_worker_init_fn else None


def _worker_init_fn(seed: int, worker_id: int) -> None:
    ss = np.random.SeedSequence([seed, _process_index(), worker_id])
    np.random.seed(ss.generate_state(4))
    random.seed(int(ss.generate_state(1)[0]))
    torch.manual_seed(int(ss.generate_state(1, dtype=np.uint64)[0]))


def root_key(seed: int, device, process_unique: bool = False) -> torch.Generator:
    """The run's root generator on `device`; with `process_unique` each
    process of a torch.distributed run draws its own stream."""
    gen = torch.Generator(device=device)
    if process_unique:
        seed = int(np.random.SeedSequence([seed, _process_index()]).generate_state(1, dtype=np.uint64)[0])
    return gen.manual_seed(seed)
