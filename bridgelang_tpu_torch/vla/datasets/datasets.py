"""VLA dataset wrappers: RLDS frame -> training example -> fixed-shape batch.

Counterpart of bridgelang_tpu/vla/datasets/datasets.py (`RLDSBatchTransform`,
`PaddedCollatorForActionPrediction`, `DummyDataset`), kept as the port's own
host-only copy. The transform emits raw uint8 frames and token ids; image
normalization runs on the device inside the train step. Action tokens are
appended numerically (prompt ids + [29871] + action ids + EOS), as in the
JAX package. `RLDSDataset` and `EpisodicRLDSDataset` wait for the RLDS
pipeline.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Dict, List, Tuple

import numpy as np

from bridgelang_tpu_torch.models.llm.prompting import get_prompt_builder
from bridgelang_tpu_torch.models.vlm import IGNORE_INDEX, LLAMA_EMPTY_TOKEN
from bridgelang_tpu_torch.vla.action_tokenizer import ActionTokenizer

EOS_TOKEN_ID = 2  # Llama </s>


@dataclasses.dataclass
class RLDSBatchTransform:
    action_tokenizer: ActionTokenizer
    base_tokenizer: Any  # callable(str) -> ids (HF tokenizer or stand-in)
    llm_family: str = "llama2-pure"
    predict_stop_token: bool = True
    image_key: str = "image_primary"
    # Tokenize the current action plus the next chunk-1 as one flat span.
    action_chunk: int = 1

    def __call__(self, rlds_batch: Dict[str, Any]) -> Dict[str, Any]:
        """One RLDS frame -> {frames, input_ids, labels, dataset_name}."""
        dataset_name = _to_str(rlds_batch["dataset_name"])
        action = np.asarray(rlds_batch["action"])  # [window+future, dim]
        action = action[: self.action_chunk] if self.action_chunk > 1 else action[0]
        img = np.asarray(rlds_batch["observation"][self.image_key][0])
        lang = _to_str(rlds_batch["task"]["language_instruction"])

        builder = get_prompt_builder(self.llm_family)
        builder.add_turn("human", f"What action should the robot take to {lang.lower()}?")
        prompt_text = builder.get_prompt()

        prompt_ids = _encode(self.base_tokenizer, prompt_text)
        if prompt_ids[-1] != LLAMA_EMPTY_TOKEN:
            prompt_ids = np.concatenate([prompt_ids, [LLAMA_EMPTY_TOKEN]])
        action_ids = self.action_tokenizer.encode_to_ids(action).reshape(-1)
        input_ids = np.concatenate([prompt_ids, action_ids, [EOS_TOKEN_ID]]).astype(np.int32)

        # Loss only on the action tokens (+ EOS unless predict_stop_token is off).
        labels = np.full_like(input_ids, IGNORE_INDEX)
        labels[-(len(action_ids) + 1):] = input_ids[-(len(action_ids) + 1):]
        if not self.predict_stop_token:
            labels[-1] = IGNORE_INDEX

        return {"frames": img, "input_ids": input_ids, "labels": labels, "dataset_name": dataset_name}


def _to_str(x: Any) -> str:
    if isinstance(x, bytes):
        return x.decode("utf-8")
    if isinstance(x, np.ndarray):
        return _to_str(x.item() if x.ndim == 0 else x.flat[0])
    return str(x)


def _encode(tokenizer: Any, text: str) -> np.ndarray:
    if hasattr(tokenizer, "encode"):
        ids = tokenizer.encode(text)
    else:
        out = tokenizer(text)
        ids = out.input_ids if hasattr(out, "input_ids") else out["input_ids"]
    ids = np.asarray(ids)
    return ids[0] if ids.ndim > 1 else ids


@dataclasses.dataclass
class PaddedCollatorForActionPrediction:
    """Fixed-shape batch assembly: right-pad token ids and labels to
    `max_length`, stack uint8 frames, carry dataset names. Examples longer
    than `max_length` are dropped with a warning and their slots refilled
    from kept ones, so supervision stays complete and shapes static."""

    max_length: int = 64
    pad_token_id: int = 32000
    padding_side: str = "right"  # the fused-BOS layout requires right padding

    def __post_init__(self):
        assert self.padding_side == "right", "PrismaticVLM requires right padding"
        self._n_dropped = 0

    def __call__(self, examples: List[Dict[str, Any]]) -> Dict[str, Any]:
        kept = [ex for ex in examples if len(ex["input_ids"]) <= self.max_length]
        n_over = len(examples) - len(kept)
        if n_over:
            self._n_dropped += n_over
            if self._n_dropped <= 10 or self._n_dropped % 1000 == 0:
                logging.getLogger(__name__).warning(
                    "Dropped %d example(s) longer than max_length=%d (total dropped: %d) "
                    "— raise the collator max_length if this is common",
                    n_over, self.max_length, self._n_dropped,
                )
        if not kept:
            longest = max(len(ex["input_ids"]) for ex in examples)
            raise ValueError(
                f"every example in the batch exceeds max_length={self.max_length} "
                f"(longest: {longest}); raise the collator max_length"
            )
        examples = kept + [kept[i % len(kept)] for i in range(n_over)]

        b = len(examples)
        ids = np.full((b, self.max_length), self.pad_token_id, np.int32)
        labels = np.full((b, self.max_length), IGNORE_INDEX, np.int32)
        mask = np.zeros((b, self.max_length), np.int32)
        for i, ex in enumerate(examples):
            seq = ex["input_ids"]
            ids[i, : len(seq)] = seq
            labels[i, : len(seq)] = ex["labels"]
            mask[i, : len(seq)] = 1
        return {
            "input_ids": ids,
            "labels": labels,
            "attention_mask": mask,
            "frames": np.stack([ex["frames"] for ex in examples]),
            "dataset_names": [ex["dataset_name"] for ex in examples],
        }


class DummyDataset:
    """Synthetic VLA dataset: random 7-DoF actions and uint8 frames from
    `seed`, one fixed instruction. The fixture for end-to-end training runs."""

    def __init__(self, batch_transform: RLDSBatchTransform, n: int = 64, seed: int = 0,
                 image_hw: Tuple[int, int] = (224, 224)):
        self.batch_transform = batch_transform
        self.n = n
        self.rng = np.random.default_rng(seed)
        self.image_hw = image_hw

    def __len__(self) -> int:
        return self.n

    def __iter__(self):
        for _ in range(self.n):
            frame = {
                "dataset_name": "dummy_dataset",
                "action": self.rng.uniform(-1, 1, size=(1, 7)).astype(np.float32),
                "observation": {
                    "image_primary": self.rng.integers(0, 255, size=(1, *self.image_hw, 3), dtype=np.uint8)
                },
                "task": {"language_instruction": b"do something spectacular"},
            }
            yield self.batch_transform(frame)
