"""The plain reference against the port, at tiny sizes on the CPU: prompt
ids, training batches, de-tokenization, the weights' layout, served logits
(float and int8 w8a8) and the LoRA step."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import tiny  # noqa: F401  (puts bench_port and the repository on sys.path)
import gen
import portside
import weights
from reference import model as ref
from reference import tokens as rtok

FAMILIES = [("mistral7b-vla", "mistral-pure"), ("phi2-vla", "phi")]


def build(name: str, quantize_int8: bool, seed: int = 3):
    from bridgelang_tpu_torch.deploy import quantize_for_serving

    cfg = tiny.config(name, quantize_int8=quantize_int8)
    model = portside.build_model(cfg, torch.float32, "cpu")
    params = weights.make_weights(cfg, seed, torch.float32, "cpu")
    portside.check_layout(model, params)
    model, served = quantize_for_serving(model, params, quantize_int8, False, 128)
    return cfg, model, params, served


def port_teacher_forced(model, params, frames: np.ndarray, instructions, tokens: np.ndarray) -> torch.Tensor:
    """The port's logits [B, n, V]: the prefill's last real row, then one
    decode step per served id fed back through an fp32 KV cache (the
    served cache is bf16, which a tiny fp32 comparison would see)."""
    from bridgelang_tpu_torch.models.llm.llama import lm_logits

    ids, mask = model.pad_prompt([model.prepare_prompt_ids(s) for s in instructions])
    ids_t, mask_t = torch.as_tensor(ids), torch.as_tensor(mask)
    toks = torch.as_tensor(tokens, dtype=torch.long)
    with torch.inference_mode():
        pix = model.preprocess_frames(torch.as_tensor(frames))
        last, cache, true_len = model._prefill(params, ids_t, mask_t, pix, toks.shape[1], torch.float32)
        out = [lm_logits(params["llm"], last, model.cfg.llm)]
        for i in range(toks.shape[1] - 1):
            out.append(model._decode_logits(params, model.cfg.llm, toks[:, i:i + 1], (true_len + i)[:, None], cache))
    return torch.cat(out, dim=1).float()


@pytest.mark.parametrize("name,family", FAMILIES)
def test_prompt_ids_match_the_port(name, family):
    cfg, model, _, _ = build(name, False)
    for text in tiny.traffic("act-1robot")["instructions"] + ["Warmup", "open the drawer!"]:
        np.testing.assert_array_equal(rtok.inference_prompt_ids(text, family), model.prepare_prompt_ids(text))


@pytest.mark.parametrize("name,family", FAMILIES)
def test_training_batch_matches_the_port(name, family):
    from bridgelang_tpu_torch.vla.action_tokenizer import ActionTokenizer
    from bridgelang_tpu_torch.vla.datasets.datasets import PaddedCollatorForActionPrediction, RLDSBatchTransform

    cfg, model, _, _ = build(name, False)
    mix = tiny.traffic("lora-b32")
    instructions, actions = gen.train_rows(11, 0, 16, mix["instructions"])
    tok = model.tokenizer
    transform = RLDSBatchTransform(ActionTokenizer(tok), tok, llm_family=model.cfg.llm_family)
    collate = PaddedCollatorForActionPrediction(max_length=mix["max_length"], pad_token_id=model.cfg.llm.pad_token_id)
    frame = np.zeros((1, 1, 1, 3), np.uint8)
    port = collate([transform({"dataset_name": "t", "action": a[None], "observation": {"image_primary": frame},
                               "task": {"language_instruction": s}}) for s, a in zip(instructions, actions)])
    mine = rtok.training_batch(instructions, actions, family, mix["max_length"], cfg["port"]["llm"]["pad_token_id"])
    for key in ("input_ids", "labels", "attention_mask"):
        np.testing.assert_array_equal(mine[key], port[key])


@pytest.mark.parametrize("name,family", FAMILIES)
def test_detokenization_matches_the_port(name, family):
    cfg, model, _, _ = build(name, False)
    vocab = cfg["port"]["llm"]["vocab_size"]
    ids = np.array([[vocab - 1, vocab - 2, vocab - 128, vocab - 256, vocab - 300, 5, 31999]], np.int64)
    stats = cfg["norm_stats"]["bridge_orig"]["action"]
    port = model.tokens_to_actions(torch.as_tensor(ids), torch.tensor(stats["q01"]), torch.tensor(stats["q99"]),
                                   torch.tensor(stats["mask"]))
    np.testing.assert_array_equal(rtok.ids_to_actions(ids, vocab, stats), port.numpy())


@pytest.mark.parametrize("quantize_int8", [False, True], ids=["float", "int8-w8a8"])
@pytest.mark.parametrize("name,family", FAMILIES)
def test_served_logits_match_the_port(name, family, quantize_int8):
    """Teacher-forced over a prompt and seven ids: prefill rows (w8a8 for
    int8) and decode rows (the dequantized weight) against the port's
    prefill and cached decode."""
    cfg, model, params, served = build(name, quantize_int8)
    hw = [40, 40]
    frames = np.stack([gen.act_frame(9, 0, t, hw) for t in range(3)])
    instructions = ["put the bowl on the plate", "turn on the stove", "stack the green block on the red one"]
    tokens = np.random.default_rng(0).integers(3, 31000, size=(3, 7))
    port = port_teacher_forced(model, served, frames, instructions, tokens)
    with torch.no_grad():
        mine = ref.served_logits(params, cfg, torch.as_tensor(frames), instructions, tokens,
                                 "int8" if quantize_int8 else None)
    scale = float(port.abs().max())
    err = max(float((port[i] - mine[i]).abs().max()) for i in range(3))
    assert err <= (2e-3 if quantize_int8 else 2e-4) * scale, (err, scale)


@pytest.mark.parametrize("name", ["mistral7b-vla", "phi2-vla"])
def test_weights_are_seeded_and_in_the_port_layout(name):
    cfg, model, params, _ = build(name, False, seed=21)
    again = weights.make_weights(cfg, 21, torch.float32, "cpu")
    other = weights.make_weights(cfg, 22, torch.float32, "cpu")
    assert torch.equal(params["llm"]["layers"][1]["wq"], again["llm"]["layers"][1]["wq"])
    assert not torch.equal(params["llm"]["layers"][1]["wq"], other["llm"]["layers"][1]["wq"])


def test_lora_step_matches_the_port():
    """Three LoRA steps of the port (fp32) against the reference's."""
    out = tiny.run("phi2-lora-b32", tiny.config("phi2-vla"), tiny.traffic("lora-b32"), seconds=0.5,
                   limits={"loss_rel_gap": 1e-5, "grad1_norm_gap": 1e-5, "change_norm_gap": 1e-5})
    assert out["correct"], out["checks"]
