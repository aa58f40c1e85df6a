"""Prompt ids, training examples and action de-tokenization, from scratch.

The byte-fallback tokenizer the configurations assume: BOS 1, then one id
3 + b per UTF-8 byte b. The VLA inference prompt is
"In: What action should the robot take to <instruction>?\\nOut:"; the Llama-2
families append the SentencePiece '▁' id 29871. Training prompts follow the
family's chat format ("pure": the same text with "Out: " stripped to
"Out:"; "phi": "<|endoftext|>Input: ...\\nOutput:"), then 29871, the seven
action ids and EOS 2; the labels are the last eight ids.

Actions: 256 bin edges over [-1, 1]; an action's id is 32000 minus its
bin (np.digitize); an id decodes to the center of bin clip(32000 - id - 1,
0, 254) when the decoder's vocab is 32000, of vocab_size - id - 1 otherwise,
then q01/q99 unnormalization where the statistics' mask is set.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

BOS, EOS, EMPTY = 1, 2, 29871
IGNORE = -100
BYTE_TOKENIZER_VOCAB = 32000
LLAMA2_FAMILIES = ("llama2-pure", "llama2-chat", "vicuna")


def byte_ids(text: str) -> List[int]:
    return [BOS] + [3 + b for b in text.encode("utf-8")]


def inference_prompt_ids(instruction: str, llm_family: str) -> np.ndarray:
    ids = byte_ids(f"In: What action should the robot take to {instruction.lower()}?\nOut:")
    if llm_family in LLAMA2_FAMILIES and ids[-1] != EMPTY:
        ids.append(EMPTY)
    return np.asarray(ids, np.int64)


def training_prompt_text(instruction: str, llm_family: str) -> str:
    msg = f"What action should the robot take to {instruction.lower()}?".strip()
    if llm_family == "phi":
        return f"<|endoftext|>Input: {msg}\nOutput: ".rstrip()
    if llm_family in ("llama2-pure", "mistral-pure"):
        return f"In: {msg}\nOut: ".rstrip()
    raise ValueError(f"no training prompt format for the family {llm_family!r}")


def action_bins(n_bins: int = 256) -> Tuple[np.ndarray, np.ndarray]:
    bins = np.linspace(-1.0, 1.0, n_bins)
    return bins, (bins[:-1] + bins[1:]) / 2.0


def action_ids(action: np.ndarray) -> np.ndarray:
    bins, _ = action_bins()
    return (BYTE_TOKENIZER_VOCAB - np.digitize(np.clip(action, -1.0, 1.0), bins)).astype(np.int64)


def training_example(instruction: str, action: np.ndarray, llm_family: str) -> Tuple[np.ndarray, np.ndarray]:
    """(input_ids, labels) of one example."""
    ids = byte_ids(training_prompt_text(instruction, llm_family))
    if ids[-1] != EMPTY:
        ids.append(EMPTY)
    acts = action_ids(np.asarray(action).reshape(-1))
    input_ids = np.asarray(ids + acts.tolist() + [EOS], np.int64)
    labels = np.full_like(input_ids, IGNORE)
    labels[-(len(acts) + 1):] = input_ids[-(len(acts) + 1):]
    return input_ids, labels


def training_batch(instructions: Sequence[str], actions: np.ndarray, llm_family: str, max_length: int,
                   pad_id: int) -> Dict[str, np.ndarray]:
    """Right-padded ids, labels and the validity mask [B, max_length]."""
    b = len(instructions)
    ids = np.full((b, max_length), pad_id, np.int64)
    labels = np.full((b, max_length), IGNORE, np.int64)
    mask = np.zeros((b, max_length), np.int64)
    for r, (text, act) in enumerate(zip(instructions, actions)):
        x, y = training_example(text, act, llm_family)
        if len(x) > max_length:
            raise ValueError(f"example of {len(x)} ids exceeds max_length {max_length}")
        ids[r, :len(x)], labels[r, :len(x)], mask[r, :len(x)] = x, y, 1
    return {"input_ids": ids, "labels": labels, "attention_mask": mask}


def ids_to_actions(token_ids: np.ndarray, vocab_size: int, stats: Dict) -> np.ndarray:
    """[..., n] ids -> float32 actions, in float32 arithmetic."""
    _, centers = action_bins()
    centers = centers.astype(np.float32)
    idx = np.clip(vocab_size - np.asarray(token_ids, np.int64) - 1, 0, centers.shape[0] - 1)
    norm = centers[idx]
    q01 = np.asarray(stats["q01"], np.float32)
    q99 = np.asarray(stats["q99"], np.float32)
    mask = np.asarray(stats.get("mask", [True] * len(q01)), bool)
    one, half = np.float32(1.0), np.float32(0.5)
    unnorm = half * (norm + one) * (q99 - q01) + q01
    return np.where(mask, unnorm, norm).astype(np.float32)
