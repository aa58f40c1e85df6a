"""Stage -> dataset/collator wiring for VLM pretraining.

Counterpart of bridgelang_tpu/preprocessing/materialize.py (the reference's
prismatic/preprocessing/materialize.py:23-69).
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Tuple

from bridgelang_tpu_torch.conf.datasets import DatasetConfig
from bridgelang_tpu_torch.preprocessing.datasets import (
    AlignDataset,
    FinetuneDataset,
    PaddedCollatorForLanguageModeling,
)


def get_dataset_and_collator(
    stage: str,
    dataset_cfg: DatasetConfig,
    tokenizer: Any,
    llm_family: str,
    max_length: int = 2048,
    pad_token_id: int = 32000,
    image_size: int = 224,
) -> Tuple[Any, PaddedCollatorForLanguageModeling]:
    root = Path(dataset_cfg.dataset_root_dir)
    collator = PaddedCollatorForLanguageModeling(max_length, pad_token_id, image_hw=(image_size, image_size))
    if stage == "align":
        ann, imgs = dataset_cfg.align_stage_components
        return AlignDataset(root / ann, root / imgs, tokenizer, image_size=image_size), collator
    if stage in ("finetune", "full-finetune", "last-layer-finetune"):
        ann, imgs = dataset_cfg.finetune_stage_components
        return (FinetuneDataset(root / ann, root / imgs, tokenizer, llm_family=llm_family, image_size=image_size),
                collator)
    raise ValueError(f"Unknown stage {stage!r}")
