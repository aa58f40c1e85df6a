"""Faults planted under a run's timed path, to show that its check fails.

Each fault is a hook the driver applies: an act hook takes (model, params)
and changes the model's decode; a lora hook takes the train step and
returns a broken one. Used by the CPU tests and by `control.py` on the chip.
"""

from __future__ import annotations

from typing import Callable, Dict


def act_token_altered(model, params) -> None:
    """The fourth served id of every row moved to its neighbour."""
    inner = model.generate_greedy
    vocab = model.cfg.llm.padded_vocab_size

    def altered(*args, **kwargs):
        out = inner(*args, **kwargs)
        out[:, 3] = (out[:, 3] + 1) % vocab
        return out

    model.generate_greedy = altered


def act_half_batch(model, params) -> None:
    """Only the first half of a batch decoded (none of a batch of one); the
    rows left out answer id 0."""
    inner = model.generate_greedy

    def half(p, input_ids, attention_mask, pixel_values, *args, **kwargs):
        k = input_ids.shape[0] // 2
        out = inner(p, input_ids, attention_mask, pixel_values, *args, **kwargs)
        out[k:] = 0
        return out

    model.generate_greedy = half


def lora_state_unchanged(step_fn: Callable) -> Callable:
    """The step runs, then its adapters and moments are put back."""
    import torch

    def unchanged(state, batch):
        saved = [t.detach().clone() for t in _trainable(state)]
        moments = {k: [t.clone() for t in state.opt_state[k]] for k in ("mu", "nu")}
        count = state.opt_state["count"]
        state, metrics = step_fn(state, batch)
        with torch.no_grad():
            for t, s in zip(_trainable(state), saved):
                t.copy_(s)
            for k, ts in moments.items():
                for t, s in zip(state.opt_state[k], ts):
                    t.copy_(s)
        state.opt_state["count"] = count
        return state, metrics

    return unchanged


def lora_half_batch(step_fn: Callable) -> Callable:
    """The step sees the first half of the batch's rows (its mean is over them)."""
    def half(state, batch):
        k = batch["input_ids"].shape[0] // 2
        return step_fn(state, {name: t[:k] for name, t in batch.items()})

    return half


def lora_token_altered(step_fn: Callable) -> Callable:
    """One action id of every example moved to its neighbour, in the ids and labels."""
    def altered(state, batch):
        ids, labels = batch["input_ids"].clone(), batch["labels"].clone()
        col = (labels != -100).int().argmax(dim=1)  # the first labelled position
        rows = range(ids.shape[0])
        ids[rows, col] += 1
        labels[rows, col] += 1
        return step_fn(state, dict(batch, input_ids=ids, labels=labels))

    return altered


def _trainable(state):
    return [v for lp in state.params["llm"]["layers"] for k, v in lp.items() if "_lora_" in k]


FAULTS: Dict[str, Dict[str, Callable]] = {
    "act": {"token_altered": act_token_altered, "half_batch": act_half_batch},
    "lora": {"state_unchanged": lora_state_unchanged, "half_batch": lora_half_batch,
             "token_altered": lora_token_altered},
}
