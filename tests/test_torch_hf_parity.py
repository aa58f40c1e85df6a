"""The port's Llama decoder against transformers' LlamaForCausalLM, on the CPU.

The JAX package holds its decoder against the same HF model in
tests/test_hf_parity.py; this file does it for the port. A tiny random HF
Llama (GQA, 2 layers) is converted by the port's own HF key map
(`models.load.convert_hf_state_dict`, the path a published checkpoint
takes) in fp32, and both run the same ids. No port module imports
transformers; the test skips where it is not installed.

Tolerances: logits atol 2e-4, rtol 2e-3, as the JAX package's test (fp32
sums in another order, HF's attention and RMSNorm kernels); greedy ids
exactly equal.
"""

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from bridgelang_tpu_torch.models.llm.llama import (  # noqa: E402
    LLMConfig,
    embed_tokens,
    init_kv_cache,
    llm_forward,
    lm_logits,
)
from bridgelang_tpu_torch.models.load import convert_hf_state_dict  # noqa: E402

TINY = LLMConfig(vocab_size=128, padded_vocab_size=128, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
                 intermediate_size=96, max_seq_len=128, pad_token_id=0)


@pytest.fixture(scope="module")
def hf_model():
    cfg = transformers.LlamaConfig(
        vocab_size=TINY.padded_vocab_size, hidden_size=TINY.dim, intermediate_size=TINY.intermediate_size,
        num_hidden_layers=TINY.n_layers, num_attention_heads=TINY.n_heads, num_key_value_heads=TINY.n_kv_heads,
        max_position_embeddings=TINY.max_seq_len, rms_norm_eps=TINY.norm_eps, rope_theta=TINY.rope_theta,
        attention_bias=False, tie_word_embeddings=False)
    torch.manual_seed(0)
    return transformers.LlamaForCausalLM(cfg).eval()


@pytest.fixture(scope="module")
def port_params(hf_model):
    sd = {f"language_model.{k}": v.detach().clone() for k, v in hf_model.state_dict().items()}
    params = convert_hf_state_dict(sd, TINY.n_layers, vit_depths={}, target_dtype=torch.float32)["llm"]
    assert len(params["layers"]) == TINY.n_layers and set(params["layers"][0]) == {
        "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "attn_norm", "mlp_norm"}
    return params


def _causal(b, t):
    return (torch.arange(t)[None, :] <= torch.arange(t)[:, None]).expand(b, 1, t, t)


def test_logits_match_hf(hf_model, port_params):
    ids = torch.from_numpy(np.random.default_rng(0).integers(1, 127, size=(2, 9)))
    with torch.no_grad():
        want = hf_model(ids).logits.numpy()
        pos = torch.arange(9).expand(2, 9)
        h, _ = llm_forward(port_params, TINY, embed_tokens(port_params, ids), pos, _causal(2, 9))
        got = lm_logits(port_params, h, TINY).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-3)


def test_greedy_decode_matches_hf(hf_model, port_params):
    """HF's greedy `generate` against the port's prefill into an fp32 KV
    cache and single-token decode steps over it (the serving path)."""
    ids = torch.from_numpy(np.random.default_rng(1).integers(1, 127, size=(1, 6)))
    n_new = 5
    with torch.no_grad():
        want = hf_model.generate(ids, max_new_tokens=n_new, do_sample=False, pad_token_id=0,
                                 use_cache=True).numpy()[0, 6:]
        t = ids.shape[1]
        cache = init_kv_cache(TINY, 1, t + n_new, dtype=torch.float32)
        pos = torch.arange(t)[None]
        h, cache = llm_forward(port_params, TINY, embed_tokens(port_params, ids), pos, _causal(1, t), cache=cache,
                               cache_positions=pos, cache_write="contiguous")
        token = lm_logits(port_params, h[:, -1:], TINY).argmax(dim=-1)
        got = [int(token)]
        for i in range(n_new - 1):
            p = torch.tensor([[t + i]])
            mask = (torch.arange(t + n_new) <= t + i)[None, None, None, :]
            h, cache = llm_forward(port_params, TINY, embed_tokens(port_params, token), p, mask, cache=cache,
                                   cache_positions=p)
            token = lm_logits(port_params, h, TINY).argmax(dim=-1)
            got.append(int(token))
    np.testing.assert_array_equal(np.asarray(got), want)
