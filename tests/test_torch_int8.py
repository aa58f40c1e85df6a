"""The port's int8 weights (ops/quant.py int8 half, llama.proj's int8 routes) vs the JAX package, on the CPU.

Geometry: the 2-layer, 256-wide decoder of tests/test_torch_int4.py and the
tiny dual-tower OpenVLA of tests/test_torch_vla.py, both initialised by the
JAX package and converted. Inputs are numpy draws from a seed.

Tolerances, and why:
* quantization (codes, bf16 scales, int4 packs from an int8 source) and
  dequantization: exactly equal. Both packages divide in fp32 and round half
  to even; the dequant is one fp32 product.
* decoder logits over int8 weights: fp32 through two layers, atol 1e-4 *
  max|logit|. Below W8A8_MIN_CHUNK, or with w8a8 off, both cast the codes to
  fp32 and scale per column. Above it with w8a8 on, the codes of the
  activations are equal (the integer product is exact on both sides) unless
  one sits on a rounding tie ~1e-6 apart, which moves a logit by far less.
* greedy ids over int8 with w8a8 off: exactly equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bridgelang_tpu.models.llm import llama as jllama
from bridgelang_tpu.models.llm.llama import LLMConfig as JLLMConfig
from bridgelang_tpu.ops import quant as jq
from bridgelang_tpu_torch.convert import llm_params_from_jax, params_from_jax
from bridgelang_tpu_torch.models.llm import llama as tllama
from bridgelang_tpu_torch.ops import quant as tq
from tests.test_torch_int4 import SMALL_VOCAB, _f32, _np
from tests.test_torch_vla import INSTRUCTIONS, _frames, pair  # noqa: F401 (pair is a fixture)


def _float_tree(seed=5):
    jcfg = JLLMConfig(**SMALL_VOCAB)
    return jcfg, jllama.init_llm_params(jax.random.key(seed), jcfg)


def _assert_tree_equal(t, j):
    """A port llm tree against a converted JAX one, leaf by leaf, exactly."""
    assert set(t) == set(j) and len(t["layers"]) == len(j["layers"])
    for tl, jl in zip(t["layers"], j["layers"]):
        assert set(tl) == set(jl)
        for k in tl:
            assert tl[k].dtype == jl[k].dtype and tl[k].shape == jl[k].shape, k
            assert torch.equal(tl[k], jl[k]), k
    for k in t:
        if k != "layers":
            assert t[k].dtype == j[k].dtype and torch.equal(t[k], j[k]), k


def test_quantize_llm_int8_bit_equal_jax():
    _, jtree = _float_tree()
    want = llm_params_from_jax(_np(jq.quantize_llm_int8(jtree)))
    got = tq.quantize_llm_int8(llm_params_from_jax(_np(jtree)))
    _assert_tree_equal(got, want)
    lp = got["layers"][0]
    assert lp["wq"].dtype == torch.int8 and lp["wq_scale"].shape == (lp["wq"].shape[0], 1)
    assert got["lm_head"].shape == (SMALL_VOCAB["padded_vocab_size"], SMALL_VOCAB["dim"])


def test_dequantize_llm_int8_bit_equal_jax():
    _, jtree = _float_tree(seed=6)
    j8 = jq.quantize_llm_int8(jtree)
    want = llm_params_from_jax(_np(jq.dequantize_llm_int8(j8, jnp.float32)))
    got = tq.dequantize_llm_int8(llm_params_from_jax(_np(j8)), torch.float32)
    _assert_tree_equal(got, want)
    assert tq.dequantize_llm_int4 is tq.dequantize_llm_int8  # one function, the JAX package's alias


@pytest.mark.parametrize("n_shards", [1, 2])
def test_int4_from_an_int8_source_bit_equal_jax(n_shards):
    _, jtree = _float_tree(seed=7)
    j8 = jq.quantize_llm_int8(jtree)
    want = llm_params_from_jax(_np(jq.quantize_llm_int4(j8, group=128, n_shards=n_shards)))
    got = tq.quantize_llm_int4(llm_params_from_jax(_np(j8)), group=128, n_shards=n_shards)
    _assert_tree_equal(got, want)
    assert not any(k.endswith("_scale") for k in got["layers"][0])  # the int8 scales are consumed
    with pytest.raises(ValueError, match="already packed"):
        tq.quantize_llm_int4(got)


def test_quantized_bytes_and_int8_init():
    jcfg, jtree = _float_tree(seed=8)
    j8 = jq.quantize_llm_int8(jtree)
    assert tq.quantized_bytes(llm_params_from_jax(_np(j8))) == jq.quantized_bytes(j8)
    cfg = tllama.LLMConfig(**SMALL_VOCAB)
    p = tq.init_llm_params_int8(torch.Generator().manual_seed(0), cfg)
    ref = llm_params_from_jax(_np(jq.init_llm_params_int8(jax.random.key(0), jcfg)))
    for k in ("embed", "embed_scale", "lm_head", "lm_head_scale", "final_norm"):
        assert p[k].shape == ref[k].shape and p[k].dtype == ref[k].dtype, k
    for k, v in ref["layers"][0].items():
        assert p["layers"][0][k].shape == v.shape and p["layers"][0][k].dtype == v.dtype, k
    codes = p["layers"][0]["w_gate"]
    assert int(codes.abs().max()) == 127  # each column's absmax maps to +-127
    emb = tllama.embed_tokens(p, torch.arange(5)[None], torch.bfloat16)
    h, _ = tllama.llm_forward(p, cfg, emb, torch.arange(5)[None], torch.ones((1, 1, 5, 5), dtype=torch.bool).tril())
    assert torch.isfinite(tllama.lm_logits(p, h, cfg)).all()


@pytest.mark.parametrize("w8a8", [False, True])
@pytest.mark.parametrize("t", [5, tllama.W8A8_MIN_CHUNK, 12])
def test_proj_on_int8_weights_below_and_above_the_w8a8_gate(w8a8, t):
    jcfg, jtree = _float_tree(seed=9)
    jcfg = dataclasses.replace(jcfg, w8a8=w8a8)
    cfg = tllama.LLMConfig(**SMALL_VOCAB, w8a8=w8a8)
    j8 = jq.quantize_llm_int8(jtree)
    t8 = llm_params_from_jax(_np(j8))
    ids = np.random.default_rng(t).integers(3, 500, size=(2, t)).astype(np.int32)
    mask = np.broadcast_to(np.tril(np.ones((t, t), bool)), (2, 1, t, t))
    pos = np.broadcast_to(np.arange(t), (2, t))
    jemb = jllama.embed_tokens(j8, jnp.asarray(ids), dtype=jnp.float32)
    jh, _ = jllama.llm_forward(j8, jcfg, jemb, jnp.asarray(pos), jnp.asarray(mask))
    want = np.asarray(jllama.lm_logits(j8, jh, jcfg))
    calls = {"n": 0}
    real = tllama.quantize_activations_per_token

    def counting(x):
        calls["n"] += 1
        return real(x)

    tllama.quantize_activations_per_token = counting
    try:
        temb = tllama.embed_tokens(t8, torch.from_numpy(ids), torch.float32)
        th, _ = tllama.llm_forward(t8, cfg, temb, torch.from_numpy(pos.copy()), torch.from_numpy(mask.copy()))
        got = tllama.lm_logits(t8, th, cfg).numpy()
    finally:
        tllama.quantize_activations_per_token = real
    assert calls["n"] == (7 * 2 if w8a8 and t >= tllama.W8A8_MIN_CHUNK else 0)  # the w8a8 route, per projection
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max(), rtol=0)


def test_int8_product_is_exact_and_pads_short_rows():
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.integers(-127, 128, size=(3, 64)).astype(np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, size=(40, 64)).astype(np.int8))
    got = tllama._int8_product(q, w)
    assert got.dtype == torch.int32 and torch.equal(got, (q.long() @ w.long().t()).int())


def test_kv_cache_dtypes():
    cfg = tllama.LLMConfig(**SMALL_VOCAB)
    for dtype in (torch.bfloat16, torch.float32):
        c = tllama.init_kv_cache(cfg, 2, 9, dtype=dtype)
        assert c["k"].dtype == dtype and c["k"].shape == (2, 2, 9, 4, 64) and not c["v"].any()
    c = tllama.init_kv_cache(cfg, 2, 9, dtype=torch.int8)  # codes and bf16 per-(token, head) scales, as JAX
    want = jllama.init_kv_cache(jllama.LLMConfig(**SMALL_VOCAB), 2, 9, dtype=jnp.int8)
    assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", "")) for k, v in c.items()} == {
        k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}
    assert c["k"].dtype == torch.int8 and c["k_scale"].dtype == torch.bfloat16 and not any(v.any() for v in c.values())


def test_full_attention_equals_jax_under_a_general_mask():
    rng = np.random.default_rng(4)
    q = rng.normal(size=(2, 9, 4, 64)).astype(np.float32)
    k = rng.normal(size=(2, 9, 2, 64)).astype(np.float32)
    v = rng.normal(size=(2, 9, 2, 64)).astype(np.float32)
    mask = rng.random((2, 1, 9, 9)) < 0.6
    mask[..., 0] = True  # every row sees a key
    want = np.asarray(jllama.full_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask)))
    got = tllama.full_attention(*(torch.from_numpy(x) for x in (q, k, v)), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-5)
    with pytest.raises(ValueError, match="attention="):
        tllama.llm_forward(llm_params_from_jax(_np(_float_tree()[1])), tllama.LLMConfig(**SMALL_VOCAB),
                           torch.zeros((1, 2, 256)), torch.zeros((1, 2), dtype=torch.long),
                           torch.ones((1, 1, 2, 2), dtype=torch.bool), attention="bogus")


def _int8_vla(pair_, w8a8):
    """The pair's models with the decoder quantized to int8 by the JAX package."""
    from bridgelang_tpu.models.vla import OpenVLA as JOpenVLA
    from bridgelang_tpu_torch.models.vla import OpenVLA

    jmodel, jparams, tmodel, _ = pair_
    jm = JOpenVLA(dataclasses.replace(jmodel.cfg, llm=dataclasses.replace(jmodel.cfg.llm, w8a8=w8a8)),
                  jmodel.norm_stats, tokenizer=jmodel.tokenizer, dtype=jnp.float32)
    jm.image_transform = jmodel.image_transform
    tm = OpenVLA(dataclasses.replace(tmodel.cfg, llm=dataclasses.replace(tmodel.cfg.llm, w8a8=w8a8)),
                 tmodel.norm_stats, tokenizer=tmodel.tokenizer, dtype=torch.float32, device="cpu")
    tm.image_transform = tmodel.image_transform
    jp = dict(jparams, llm=jq.quantize_llm_int8(jparams["llm"]))
    return jm, jp, tm, params_from_jax(jax.tree.map(np.asarray, jp))


def test_int8_greedy_ids_equal_jax_with_w8a8_off(pair):
    from bridgelang_tpu.ops import image_ops as jimg

    jm, jp, tm, tp = _int8_vla(pair, w8a8=False)
    ids, mask = jm.pad_prompt([jm.prepare_prompt_ids(t) for t in INSTRUCTIONS])
    pixels = np.array(jimg.preprocess_batch(jnp.asarray(_frames(2, seed=21)), jm.image_transform))
    want = np.asarray(jm.generate_greedy(jp, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(pixels),
                                         max_new_tokens=7))
    got = tm.generate_greedy(tp, torch.from_numpy(ids), torch.from_numpy(mask), torch.from_numpy(pixels),
                             max_new_tokens=7).numpy()
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got[0], got[1])


def test_speculative_verify_chunk_stays_greedy_equivalent_past_w8a8_gate(pair):
    """An int8 + w8a8 model's verify chunk of n >= W8A8_MIN_CHUNK tokens must
    cast its weights as decode (T=1) does: speculative equals greedy at
    margin 0 for a zero and a perfect draft, and quantizes activations
    exactly as often as greedy (the prefill's projections only)."""
    from bridgelang_tpu.ops import image_ops as jimg

    n = tllama.W8A8_MIN_CHUNK
    _, _, tm, tp = _int8_vla(pair, w8a8=True)
    ids, mask = tm.pad_prompt([tm.prepare_prompt_ids(t) for t in INSTRUCTIONS])
    pixels = np.array(jimg.preprocess_batch(jnp.asarray(_frames(2, seed=22)), pair[0].image_transform))
    args = [torch.from_numpy(x) for x in (ids, mask, pixels)]
    calls = {"n": 0}
    real = tllama.quantize_activations_per_token

    def counting(x):
        calls["n"] += 1
        return real(x)

    tllama.quantize_activations_per_token = counting
    try:
        greedy = tm.generate_greedy(tp, *args, max_new_tokens=n, cache_dtype=torch.float32)
        greedy_calls, calls["n"] = calls["n"], 0
        for draft in (torch.zeros_like(greedy), greedy):
            spec = tm.generate_speculative(tp, *args, draft, cache_dtype=torch.float32, margin_threshold=0.0)
            torch.testing.assert_close(spec, greedy, rtol=0, atol=0)
            assert calls["n"] == greedy_calls > 0, "the verify chunk crossed the W8A8_MIN_CHUNK gate"
            calls["n"] = 0
    finally:
        tllama.quantize_activations_per_token = real
