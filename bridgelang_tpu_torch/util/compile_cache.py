"""Serving warm-up: capture every predict graph before the server listens.

Counterpart of bridgelang_tpu/util/compile_cache.py. `warmup_predict` runs
one predict per batch bucket the server can hit
(`serving.server.batch_buckets`) and, with `speculative`, the batch-1
speculative predict, so that a CUDA model captures each of their graphs
(models/graphs.py) before the first request instead of during it. On the
CPU it runs the same predicts eagerly.

The JAX module's `enable_persistent_cache` points XLA at an on-disk cache of
compiled programs. A CUDA graph lives in one process and there is nothing to
keep on disk (the kernels' libraries are cached by ops/_build.py), so it has
no counterpart here.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np


def warmup_predict(model, params, max_batch: int = 1, unnorm_key: Optional[str] = None,
                   speculative: bool = False, margin_threshold: float = 0.25,
                   instruction: str = "warmup") -> float:
    """Run (and so capture) the predict of every batch bucket up to
    `max_batch` on a black frame of the first tower's size, and with
    `speculative` the batch-1 speculative predict. The
    prompt bucket is the one `instruction` pads to: pass an instruction as
    long as the served ones to warm their bucket. The margin is a device
    operand of the one speculative graph, so any `margin_threshold` warms
    every margin. Returns seconds."""
    from bridgelang_tpu_torch.serving.server import batch_buckets

    if unnorm_key is None:
        unnorm_key = next(iter(model.norm_stats))
    size = model.image_transform.towers[0].size
    frame = np.zeros((size, size, 3), np.uint8)
    t0 = time.time()
    for n in batch_buckets(max_batch):
        model.predict_action_batch(params, [frame] * n, [instruction] * n, unnorm_key=unnorm_key)
    if speculative:
        draft = np.zeros(model.get_action_dim(unnorm_key), np.int32)
        model.predict_action_speculative(params, frame, instruction, draft, unnorm_key=unnorm_key,
                                         margin_threshold=margin_threshold)
    return time.time() - t0
