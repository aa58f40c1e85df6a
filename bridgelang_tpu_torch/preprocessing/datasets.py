"""VLM pretraining datasets: LLaVA-style chat JSON + image directories.

Counterpart of bridgelang_tpu/preprocessing/datasets.py (the reference's
prismatic/preprocessing/datasets/datasets.py): the same examples, ids,
labels, frames and batch index lists. The align stage supervises the
caption only, the finetune stage the assistant turns of multi-turn chats;
unimodal examples carry no image.

Examples yield raw uint8 frames on the host, as in the JAX package; the
train step normalizes them on the device. Images are read as PIL reads them
(`native.image.load_image`: Image.open(p).convert("RGB").resize((s, s)),
bit for bit) without PIL.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, List, Tuple

import numpy as np

from bridgelang_tpu_torch.models.llm.prompting import get_prompt_builder
from bridgelang_tpu_torch.models.vlm import IGNORE_INDEX
from bridgelang_tpu_torch.native.image import load_image

EOS_TOKEN_ID = 2


class AlignDataset:
    """Caption-only projector alignment stage (reference datasets.py:29-98):
    example = "<image> {caption}" where ONLY the caption tokens train."""

    def __init__(self, chat_json: Path, image_dir: Path, tokenizer, image_size: int = 224):
        self.image_dir = Path(image_dir)
        self.tokenizer = tokenizer
        self.image_size = image_size
        with open(chat_json) as f:
            self.examples = json.load(f)
        self.dataset_type = "align"

    def __len__(self) -> int:
        return len(self.examples)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        ex = self.examples[idx]
        caption = ex["conversations"][-1]["value"].replace("<image>", "").strip()
        ids = np.asarray(self.tokenizer.encode(caption), dtype=np.int32)
        ids = np.concatenate([ids, [EOS_TOKEN_ID]]).astype(np.int32)
        labels = ids.copy()
        labels[0] = IGNORE_INDEX  # BOS unsupervised (reference datasets.py:79)
        frame = load_image(self.image_dir / ex["image"], self.image_size)
        return {"input_ids": ids, "labels": labels, "frames": frame, "multimodal": True}

    def get_modality_lengths(self) -> List[Tuple[bool, int]]:
        return [(True, len(e["conversations"][-1]["value"].split())) for e in self.examples]


def _takes_add_bos(tokenizer) -> bool:
    """The JAX package's probe: does `tokenizer.encode` name an `add_bos`
    argument?"""
    return hasattr(tokenizer, "encode") and "add_bos" in tokenizer.encode.__code__.co_varnames


class FinetuneDataset:
    """Multi-turn instruct tuning (reference datasets.py:101-200): loss on
    assistant ("gpt") turns only; text-only examples have no image."""

    def __init__(self, chat_json: Path, image_dir: Path, tokenizer, llm_family: str = "vicuna",
                 image_size: int = 224):
        self.image_dir = Path(image_dir)
        self.tokenizer = tokenizer
        self.llm_family = llm_family
        self.image_size = image_size
        with open(chat_json) as f:
            self.examples = json.load(f)
        self.dataset_type = "finetune"

    def __len__(self) -> int:
        return len(self.examples)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        ex = self.examples[idx]
        builder = get_prompt_builder(self.llm_family)
        ids_parts: List[np.ndarray] = [np.asarray([1], dtype=np.int32)]  # BOS
        label_parts: List[np.ndarray] = [np.asarray([IGNORE_INDEX], dtype=np.int32)]
        add_bos = _takes_add_bos(self.tokenizer)
        for turn in ex["conversations"]:
            role = "human" if turn["from"] == "human" else "gpt"
            wrapped = builder.add_turn(role, turn["value"])
            seg = self.tokenizer.encode(wrapped, add_bos=False) if add_bos else self.tokenizer.encode(wrapped)
            seg = np.asarray(seg, dtype=np.int32)
            seg = seg[seg != 1]  # drop stray BOS from tokenizers that force it
            ids_parts.append(seg)
            label_parts.append(seg.copy() if role == "gpt" else np.full_like(seg, IGNORE_INDEX))
        ids = np.concatenate(ids_parts)
        labels = np.concatenate(label_parts)

        if "image" in ex:
            frame = load_image(self.image_dir / ex["image"], self.image_size)
            return {"input_ids": ids, "labels": labels, "frames": frame, "multimodal": True}
        return {"input_ids": ids, "labels": labels, "frames": None, "multimodal": False}

    def get_modality_lengths(self) -> List[Tuple[bool, int]]:
        out = []
        for ex in self.examples:
            n = sum(len(t["value"].split()) for t in ex["conversations"])
            out.append(("image" in ex, n))
        return out


class PaddedCollatorForLanguageModeling:
    """Counterpart of reference util/data_utils.py:29-92: pad/truncate ids and
    labels to `max_length`, zero frames + multimodal_indices for unimodal
    examples."""

    def __init__(self, max_length: int, pad_token_id: int, image_hw: Tuple[int, int] = (224, 224)):
        self.max_length = max_length
        self.pad_token_id = pad_token_id
        self.image_hw = image_hw

    def __call__(self, examples: List[Dict[str, Any]]) -> Dict[str, Any]:
        b = len(examples)
        ids = np.full((b, self.max_length), self.pad_token_id, np.int32)
        labels = np.full((b, self.max_length), IGNORE_INDEX, np.int32)
        mask = np.zeros((b, self.max_length), np.int32)
        frames = np.zeros((b, *self.image_hw, 3), np.uint8)
        multimodal_indices = []
        for i, ex in enumerate(examples):
            seq = ex["input_ids"][: self.max_length]
            ids[i, : len(seq)] = seq
            labels[i, : len(seq)] = ex["labels"][: len(seq)]
            mask[i, : len(seq)] = 1
            if ex["multimodal"] and ex["frames"] is not None:
                frames[i] = ex["frames"]
                multimodal_indices.append(i)
        return {
            "input_ids": ids,
            "labels": labels,
            "attention_mask": mask,
            "frames": frames,
            "multimodal_indices": np.asarray(multimodal_indices, dtype=np.int32),
        }


class SplitModalityBatcher:
    """LLaVA-style batching (reference util/batching_utils.py:23-212
    SplitModalitySampler): batches are all-multimodal or all-unimodal,
    length-sorted inside shuffled chunks of 64 batches, the longest batch
    first (an out-of-memory shows at once), the rest shuffled. Host-side
    index scheduler; each process takes every `process_count`-th batch."""

    def __init__(self, modality_lengths: List[Tuple[bool, int]], batch_size: int, seed: int = 0,
                 process_index: int = 0, process_count: int = 1):
        self.modality_lengths = modality_lengths
        self.batch_size = batch_size
        self.seed = seed
        self.process_index, self.process_count = process_index, process_count

    def batches(self, epoch: int = 0) -> List[List[int]]:
        rng = np.random.default_rng([self.seed, epoch])
        mm = [i for i, (is_mm, _) in enumerate(self.modality_lengths) if is_mm]
        uni = [i for i, (is_mm, _) in enumerate(self.modality_lengths) if not is_mm]
        out: List[List[int]] = []
        for group in (mm, uni):
            if not group:
                continue
            order = rng.permutation(group)
            chunk = self.batch_size * 64
            for start in range(0, len(order), chunk):
                block = sorted(order[start : start + chunk], key=lambda i: -self.modality_lengths[i][1])
                for bstart in range(0, len(block) - self.batch_size + 1, self.batch_size):
                    out.append([int(x) for x in block[bstart : bstart + self.batch_size]])
        out.sort(key=lambda batch: -max(self.modality_lengths[i][1] for i in batch))
        reordered = [out[0]] if out else []
        rest = out[1:]
        rng.shuffle(rest)
        reordered += rest
        return reordered[self.process_index :: self.process_count]
