"""Wire up VLA datasets: tokenizers, batch transform, collator and loader.

Counterpart of bridgelang_tpu/vla/materialize.py.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

from bridgelang_tpu_torch.vla.action_tokenizer import ActionTokenizer
from bridgelang_tpu_torch.vla.datasets.datasets import (
    PaddedCollatorForActionPrediction,
    RLDSBatchTransform,
    RLDSDataset,
)


def get_vla_dataset_and_collator(
    data_root_dir: str,
    data_mix: str,
    base_tokenizer: Any,
    llm_family: str = "llama2-pure",
    batch_size: int = 32,
    prompt_bucket: int = 64,
    pad_token_id: int = 32000,
    shuffle_buffer_size: int = 256_000,
    image_aug: bool = False,
    resize_resolution: Tuple[int, int] = (224, 224),
    train: bool = True,
    predict_stop_token: bool = True,
    builder_factory=None,
    traj_transform_threads: Optional[int] = None,
    traj_read_threads: Optional[int] = None,
    action_chunk: int = 1,
    action_dim: int = 7,
    seed: Optional[int] = None,
    num_workers: Optional[int] = None,
) -> Tuple[RLDSDataset, ActionTokenizer, PaddedCollatorForActionPrediction]:
    """(dataset, action tokenizer, collator). With `action_chunk` > 1 the
    supervised span holds action_dim * action_chunk tokens, so the collator's
    bucket widens to 64 + action_dim * (action_chunk - 1) (JAX
    materialize.py:42-47). `seed` makes the data repeatable; `num_workers`:
    the dataset's batch worker processes (0: none, the batches are made in
    this process)."""
    action_tokenizer = ActionTokenizer(base_tokenizer)
    batch_transform = RLDSBatchTransform(
        action_tokenizer, base_tokenizer, llm_family=llm_family, predict_stop_token=predict_stop_token,
        action_chunk=action_chunk,
    )
    if action_chunk > 1:
        prompt_bucket = max(prompt_bucket, 64 + action_dim * (action_chunk - 1))
    collator = PaddedCollatorForActionPrediction(max_length=prompt_bucket, pad_token_id=pad_token_id)
    dataset = RLDSDataset(
        data_root_dir,
        data_mix,
        batch_transform,
        collator,
        batch_size,
        shuffle_buffer_size=shuffle_buffer_size,
        train=train,
        image_aug=image_aug,
        resize_resolution=resize_resolution,
        builder_factory=builder_factory,
        traj_transform_threads=traj_transform_threads,
        traj_read_threads=traj_read_threads,
        future_action_window_size=action_chunk - 1,
        seed=seed,
        num_workers=num_workers,
    )
    return dataset, action_tokenizer, collator
