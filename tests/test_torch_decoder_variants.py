"""The decoder variants of the port vs the JAX package, on the CPU: the Phi-2
block, the int8 KV cache and Mistral's sliding window.

Parameters are drawn by the JAX package (the Phi biases and norms moved off
their zero and one inits with numpy draws, so that every bias path shows),
converted with `bridgelang_tpu_torch.convert`, and both packages run the
same numpy inputs. Geometries: the Phi block at the JAX test's size (dim 80,
4 heads of 20, rotary_dim 8 = 0.4 x 20); the Phi VLA at that width with the
real 51200/51264 vocabulary (so the byte tokenizer and the action tail fit);
its int4 tree at dim 256 (8 heads of 32, rotary_dim 12), where the JAX
package runs its Pallas kernels and not its fallback; Mistral as a 2-layer
GQA Llama (4 query and 2 KV heads) with `sliding_window` 8, below every
prompt.

Tolerances, and why:
* fp32 hidden states and logits: atol 1e-5 (fp32 sums in another order
  through two layers).
* `_quantize_kv`: codes bit-equal, scales equal (both divide in fp32 by the
  same fp32 scale and round half to even).
* token ids: exactly equal, with fp32 weights; under the int8 cache too
  (its codes are compared directly as well).
* int8 and int4 Phi trees with w8a8 on: the teacher-forced logits rule of
  tests/test_torch_int4.py (an activation code on a rounding tie may flip
  by host: 0.05 max|logit|, the argmax where the top-2 margin clears twice
  that).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bridgelang_tpu.models.llm import llama as jllama
from bridgelang_tpu.models.llm.tokenizer import ByteFallbackTokenizer as JTokenizer
from bridgelang_tpu.models.vision.vit import ViTConfig as JViTConfig
from bridgelang_tpu.models.vla import OpenVLA as JOpenVLA
from bridgelang_tpu.models.vlm import VLMConfig as JVLMConfig
from bridgelang_tpu.ops import image_ops as jimg
from bridgelang_tpu.ops import int4_matmul as jm
from bridgelang_tpu.ops import quant as jq
from bridgelang_tpu.training import lora as jlora
from bridgelang_tpu_torch.convert import llm_params_from_jax, params_from_jax
from bridgelang_tpu_torch.models.llm import llama as tllama
from bridgelang_tpu_torch.models.llm.tokenizer import ByteFallbackTokenizer
from bridgelang_tpu_torch.models.vision.vit import ViTConfig
from bridgelang_tpu_torch.models.vla import OpenVLA, norm_stats_from_json
from bridgelang_tpu_torch.models.vlm import VLMConfig
from bridgelang_tpu_torch.ops import image_ops as timg
from bridgelang_tpu_torch.training import lora as tlora
from tests.helpers import TINY_NORM_STATS
from tests.test_torch_int4 import W4A8_LOGIT_BAND
from tests.test_torch_vla import DINO, INSTRUCTIONS, SIG, TOWERS, _frames

TOL = dict(atol=1e-5, rtol=1e-5)
N = 7  # action dims
PHI_TINY = dict(vocab_size=128, padded_vocab_size=192, dim=80, n_layers=2, n_heads=4, n_kv_heads=4,
                intermediate_size=64, pad_token_id=128)
PHI_VLA = dict(PHI_TINY, vocab_size=51200, padded_vocab_size=51264, pad_token_id=51200)
PHI_INT4 = dict(PHI_VLA, dim=256, n_heads=8, n_kv_heads=8, intermediate_size=512)  # rotary_dim 12
MISTRAL_VLA = dict(vocab_size=32000, padded_vocab_size=32064, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
                   intermediate_size=128, sliding_window=8)
PHI_BIASES = ("attn_norm_bias", "bq", "bk", "bv", "bo", "b_up", "b_down")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _jphi(**over):
    return dataclasses.replace(jllama.LLM_CONFIGS["phi-2-3b"], **over)


def _tcfg(jcfg):
    return tllama.LLMConfig(**dataclasses.asdict(jcfg))


def _visible_phi(llm, seed):
    """A JAX Phi tree with its biases, norm biases and norm weights drawn
    away from 0 and 1, so that a dropped or misplaced one shows."""
    rng = np.random.default_rng(seed)

    def moved(x, center=0.0):
        return jnp.asarray(center + 0.1 * rng.normal(size=x.shape), x.dtype)

    layers = dict(llm["layers"])
    for name in PHI_BIASES:
        layers[name] = moved(layers[name])
    layers["attn_norm"] = moved(layers["attn_norm"], 1.0)
    return dict(llm, layers=layers, final_norm=moved(llm["final_norm"], 1.0),
                final_norm_bias=moved(llm["final_norm_bias"]), lm_head_bias=moved(llm["lm_head_bias"]))


def _causal(lengths, t, s):
    q = np.arange(t)[:, None]
    k = np.arange(s)[None, :]
    return ((k <= q)[None] & (k[None] < np.asarray(lengths)[:, None, None]))[:, None]  # [B, 1, T, S]


@pytest.fixture(scope="module")
def phi_llm():
    jcfg = _jphi(**PHI_TINY)
    jp = _visible_phi(jllama.init_llm_params(jax.random.key(21), jcfg), seed=22)
    return jcfg, jp, _tcfg(jcfg), llm_params_from_jax(_np(jp))


# --- the Phi block ----------------------------------------------------------------


def test_phi_init_has_the_jax_leaves():
    """The port's seeded init gives the JAX init's leaves (names, shapes,
    dtypes) in the port's layout; biases start at zero, norms at one."""
    jcfg = _jphi(**PHI_TINY)
    want = llm_params_from_jax(_np(jllama.init_llm_params(jax.random.key(0), jcfg)))
    got = tllama.init_llm_params(torch.Generator().manual_seed(0), _tcfg(jcfg))
    assert set(got) == set(want) == {"embed", "layers", "final_norm", "final_norm_bias", "lm_head", "lm_head_bias"}
    assert "w_gate" not in got["layers"][0] and "mlp_norm" not in got["layers"][0]
    for g, w in zip(got["layers"], want["layers"]):
        assert {k: (tuple(v.shape), v.dtype) for k, v in g.items()} == {k: (tuple(v.shape), v.dtype) for k, v in w.items()}
        for name in PHI_BIASES:
            assert not g[name].any()
    for name in ("embed", "final_norm", "final_norm_bias", "lm_head", "lm_head_bias"):
        assert got[name].shape == want[name].shape
    assert not got["lm_head_bias"].any() and bool((got["final_norm"] == 1).all())


def test_layer_norm_matches_jax():
    rng = np.random.default_rng(23)
    x = (3.0 + rng.normal(size=(2, 5, 80))).astype(np.float32)
    w, b = (rng.normal(size=(80,)).astype(np.float32) for _ in range(2))
    want = np.asarray(jllama.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 1e-5))
    np.testing.assert_allclose(tllama.layer_norm(*_t(x, w, b), 1e-5).numpy(), want, **TOL)
    xb = torch.from_numpy(x).to(torch.bfloat16)  # computes in fp32, rounds once to the input dtype
    got = tllama.layer_norm(xb, *_t(w, b), 1e-5)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), tllama.layer_norm(xb.float(), *_t(w, b), 1e-5).to(
        torch.bfloat16).float().numpy())


@pytest.mark.parametrize("cache_write", [None, "contiguous", "scatter"])
def test_phi_llm_forward_and_decode_match_jax(phi_llm, cache_write):
    """Phi forward without a cache, or a prefill into a cache then one
    decode step over it: hidden states and logits within 1e-5."""
    jcfg, jp, tcfg, tp = phi_llm
    rng = np.random.default_rng(24)
    b, t, s = 2, 10, 14
    lengths = [10, 6]
    emb = rng.normal(size=(b, t, jcfg.dim)).astype(np.float32)
    pos = np.broadcast_to(np.arange(t), (b, t)).copy()
    mask = _causal(lengths, t, s if cache_write == "scatter" else t)
    kw_j, kw_t = {}, {}
    if cache_write is not None:
        kw_j = dict(cache=jllama.init_kv_cache(jcfg, b, s, dtype=jnp.float32), cache_positions=jnp.asarray(pos),
                    cache_write=cache_write)
        kw_t = dict(cache=tllama.init_kv_cache(tcfg, b, s, dtype=torch.float32), cache_positions=torch.from_numpy(pos),
                    cache_write=cache_write)
    jh, jc = jllama.llm_forward(jp, jcfg, jnp.asarray(emb), jnp.asarray(pos), jnp.asarray(mask), **kw_j)
    th, tc = tllama.llm_forward(tp, tcfg, *_t(emb, pos, mask), lengths=torch.tensor(lengths, dtype=torch.int32),
                                **kw_t)
    for i, n in enumerate(lengths):  # rows past an example's length are don't-care
        np.testing.assert_allclose(th[i, :n].numpy(), np.asarray(jh)[i, :n], **TOL)
        np.testing.assert_allclose(tllama.lm_logits(tp, th, tcfg)[i, :n].numpy(),
                                   np.asarray(jllama.lm_logits(jp, jh, jcfg))[i, :n], **TOL)
    if cache_write is None:
        return
    for key in ("k", "v"):
        for i, n in enumerate(lengths):
            np.testing.assert_allclose(tc[key][:, i, :n].numpy(), np.asarray(jc[key])[:, i, :n], **TOL)
    tok = rng.normal(size=(b, 1, jcfg.dim)).astype(np.float32)
    dpos = np.asarray(lengths)[:, None]
    dmask = np.arange(s)[None, None, None, :] <= dpos[:, :, None, None]
    jh2, _ = jllama.llm_forward(jp, jcfg, jnp.asarray(tok), jnp.asarray(dpos), jnp.asarray(dmask), cache=jc,
                                cache_positions=jnp.asarray(dpos))
    th2, _ = tllama.llm_forward(tp, tcfg, *_t(tok, dpos, dmask), cache=tc, cache_positions=torch.from_numpy(dpos))
    np.testing.assert_allclose(th2.numpy(), np.asarray(jh2), **TOL)
    np.testing.assert_allclose(tllama.lm_logits(tp, th2, tcfg).numpy(),
                               np.asarray(jllama.lm_logits(jp, jh2, jcfg)), **TOL)


# --- the int8 KV cache ------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_bit_equal_to_jax(dtype):
    """Codes bit-equal and scales equal to the JAX `_quantize_kv` as the
    package runs it (inside the jitted decoder), on rows of every scale, a
    zero row and rows of one value."""
    rng = np.random.default_rng(25)
    x = rng.normal(size=(3000, 4, 20)) * rng.uniform(1e-3, 30.0, size=(3000, 4, 1))
    x[0, 0] = 0.0
    x[1, 1] = 2.5
    x[2, 2] = -1e-3
    jx = jnp.asarray(x, getattr(jnp, dtype))
    want_q, want_s = jax.jit(jllama._quantize_kv)(jx)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    got_q, got_s = tllama._quantize_kv(tx)
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.bfloat16 and got_s.shape == (3000, 4)
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.float().numpy(), np.asarray(want_s.astype(jnp.float32)))
    assert int(got_q.abs().max()) == 127 and not got_q[0, 0].any() and float(got_s[0, 0]) == 1.0
    deq = tllama._dequantize_kv(got_q, got_s, torch.float32)
    np.testing.assert_array_equal(deq.numpy(), np.asarray(jllama._dequantize_kv(want_q, want_s, jnp.float32)))


@pytest.mark.parametrize("arch", ["llama_gqa", "phi"])
def test_int8_cache_prefill_and_decode_match_jax(phi_llm, arch):
    """The int8 cache through the contiguous prefill (attention over the
    unquantized chunk, the cache written quantized) and two scatter decode
    steps (quantize, scatter, attend over the dequantized cache): codes and
    scales equal to the JAX package's, hidden states within 1e-5."""
    if arch == "phi":
        jcfg, jp, tcfg, tp = phi_llm
    else:
        jcfg = jllama.LLMConfig(vocab_size=128, padded_vocab_size=192, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
                                intermediate_size=96, pad_token_id=128)
        jp = jllama.init_llm_params(jax.random.key(26), jcfg)
        tcfg, tp = _tcfg(jcfg), llm_params_from_jax(_np(jp))
    rng = np.random.default_rng(27)
    b, t, s = 2, 9, 12
    lengths = [9, 5]
    emb = rng.normal(size=(b, t, jcfg.dim)).astype(np.float32)
    pos = np.broadcast_to(np.arange(t), (b, t)).copy()
    mask = _causal(lengths, t, t)
    jc = jllama.init_kv_cache(jcfg, b, s, dtype=jnp.int8)
    tc = tllama.init_kv_cache(tcfg, b, s, dtype=torch.int8)
    assert set(tc) == set(jc) == {"k", "v", "k_scale", "v_scale"}
    assert tc["k_scale"].dtype == torch.bfloat16 and tc["k_scale"].shape == tuple(jc["k_scale"].shape)
    jh, jc = jllama.llm_forward(jp, jcfg, jnp.asarray(emb), jnp.asarray(pos), jnp.asarray(mask), cache=jc,
                                cache_positions=jnp.asarray(pos), cache_write="contiguous")
    th, tc = tllama.llm_forward(tp, tcfg, *_t(emb, pos, mask), cache=tc, cache_positions=torch.from_numpy(pos),
                                cache_write="contiguous", lengths=torch.tensor(lengths, dtype=torch.int32))
    for i, n in enumerate(lengths):
        np.testing.assert_allclose(th[i, :n].numpy(), np.asarray(jh)[i, :n], **TOL)
    for step in range(2):
        tok = rng.normal(size=(b, 1, jcfg.dim)).astype(np.float32)
        dpos = np.asarray(lengths)[:, None] + step
        dmask = np.arange(s)[None, None, None, :] <= dpos[:, :, None, None]
        jh, jc = jllama.llm_forward(jp, jcfg, jnp.asarray(tok), jnp.asarray(dpos), jnp.asarray(dmask), cache=jc,
                                    cache_positions=jnp.asarray(dpos))
        th, tc = tllama.llm_forward(tp, tcfg, *_t(tok, dpos, dmask), cache=tc, cache_positions=torch.from_numpy(dpos))
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    for i, n in enumerate(lengths):  # every written slot: the prefill's valid rows and both decode tokens
        slots = list(range(n)) + [n, n + 1]
        for key in ("k", "v"):
            np.testing.assert_array_equal(tc[key][:, i, slots].numpy(), np.asarray(jc[key])[:, i, slots])
            np.testing.assert_array_equal(tc[key + "_scale"][:, i, slots].float().numpy(),
                                          np.asarray(jc[key + "_scale"].astype(jnp.float32))[:, i, slots])


# --- the VLAs: Phi, Mistral's window, the int8 cache ------------------------------------------


def _vla_pair(jllm_cfg, seed: int, quantize=None):
    """The tiny dual-tower OpenVLA over the decoder `jllm_cfg`, initialised
    by the JAX package (a Phi tree with visible biases), the LM head's action
    columns scaled up so that decoding lands in the action range, quantized
    by the JAX package when `quantize` ("int8" or "int4") says so; and its
    conversion into the port."""
    backbone = {"phi": "phi-2-3b"}.get(jllm_cfg.arch, "mistral-v0.1-7b-pure" if jllm_cfg.sliding_window
                                       else "llama2-7b-pure")  # the prompt family follows the backbone id
    jcfg = dataclasses.replace(JVLMConfig(), llm_backbone_id=backbone, llm=jllm_cfg,
                               vision_override=(JViTConfig(**DINO), JViTConfig(**SIG)))
    jmodel = JOpenVLA(jcfg, TINY_NORM_STATS, tokenizer=JTokenizer(), dtype=jnp.float32)
    jmodel.image_transform = jimg.ImageTransformConfig("resize-naive", tuple(jimg.ImageTowerSpec(*t) for t in TOWERS))
    jparams = jmodel.init_params(jax.random.key(seed))
    v = jllm_cfg.vocab_size
    llm_p = dict(jparams["llm"], lm_head=jparams["llm"]["lm_head"].at[:, v - 256:v].multiply(8.0))
    if jllm_cfg.arch == "phi":
        llm_p = _visible_phi(llm_p, seed + 1)
    if quantize == "int4":
        llm_p = jq.quantize_llm_int4(llm_p, group=128)
    elif quantize == "int8":
        llm_p = jq.quantize_llm_int8(llm_p)
    jparams = dict(jparams, llm=llm_p)
    tcfg = dataclasses.replace(VLMConfig(), llm_backbone_id=backbone, llm=_tcfg(jllm_cfg),
                               vision_override=(ViTConfig(**DINO), ViTConfig(**SIG)))
    tmodel = OpenVLA(tcfg, norm_stats_from_json(TINY_NORM_STATS), tokenizer=ByteFallbackTokenizer(),
                     dtype=torch.float32, device="cpu")
    tmodel.image_transform = timg.ImageTransformConfig("resize-naive", tuple(timg.ImageTowerSpec(*t) for t in TOWERS))
    return jmodel, jparams, tmodel, params_from_jax(_np(jparams))


@pytest.fixture(scope="module")
def phi_vla():
    return _vla_pair(_jphi(**PHI_VLA), seed=30)


@pytest.fixture(scope="module")
def mistral_vla():
    return _vla_pair(jllama.LLMConfig(**MISTRAL_VLA), seed=31)


def _inputs(jmodel, n_rows, seed):
    ids, mask = jmodel.pad_prompt([jmodel.prepare_prompt_ids(INSTRUCTIONS[r % 2]) for r in range(n_rows)])
    pixels = np.array(jimg.preprocess_batch(jnp.asarray(_frames(n_rows, seed)), jmodel.image_transform))
    return ids, mask, pixels


def _greedy_pair(pair, ids, mask, pixels, jdtype, tdtype, n=N):
    jmodel, jparams, tmodel, tparams = pair
    j = np.asarray(jmodel.generate_greedy(jparams, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(pixels),
                                          max_new_tokens=n, cache_dtype=jdtype))
    t = tmodel.generate_greedy(tparams, *_t(ids, mask, pixels), max_new_tokens=n, cache_dtype=tdtype).numpy()
    return j, t


def test_phi_vla_greedy_ids_and_actions_equal_jax(phi_vla):
    """The Phi VLA end to end: the same prompt ids (no '▁' appended for the
    phi family), greedy ids equal to the JAX package's, landing on the
    action ids the JAX package gives a Phi backbone (51200 - bin), and the
    same actions."""
    jmodel, jparams, tmodel, tparams = phi_vla
    ids, mask, pixels = _inputs(jmodel, 2, seed=32)
    t_ids, t_mask = tmodel.pad_prompt([tmodel.prepare_prompt_ids(INSTRUCTIONS[r]) for r in range(2)])
    np.testing.assert_array_equal(t_ids, ids)
    np.testing.assert_array_equal(t_mask, mask)
    assert ids[0, mask[0].sum() - 1] != 29871 and (ids[mask == 0] == 51200).all()  # phi pad id
    j, t = _greedy_pair(phi_vla, ids, mask, pixels, jnp.float32, torch.float32)
    np.testing.assert_array_equal(t, j)
    assert ((j >= 51200 - 256) & (j < 51200)).mean() > 0.5, "decoding should land in the action range"
    assert not np.array_equal(j[0], j[1])
    frames = list(_frames(2, seed=33))
    np.testing.assert_allclose(tmodel.predict_action_batch(tparams, frames, INSTRUCTIONS),
                               np.asarray(jmodel.predict_action_batch(jparams, frames, INSTRUCTIONS)), atol=1e-6, rtol=0)


def test_phi_prompt_bucket_and_prefill_length():
    """Under the byte-fallback tokenizer a Phi predict of the smoke's
    instruction pads its prompt to the 96 bucket (the prompt is 64 ids) and
    its prefill is 96 + 256 patches = 352 tokens, as the 7B's; pad and action
    ids are Phi's (the pad at 51200, action bin i at 51200 - i)."""
    cfg = VLMConfig.from_ids("prism-phi-dinosiglip+3b", "dinosiglip-vit-so-224px", "phi-2-3b",
                             "no-align+fused-gelu-mlp")
    model = OpenVLA(cfg, norm_stats_from_json(TINY_NORM_STATS), tokenizer=ByteFallbackTokenizer(), device="cpu")
    assert cfg.llm_family == "phi" and cfg.llm.head_dim == 80 and cfg.llm.rotary_dim == 32
    ids, mask = model.pad_prompt([model.prepare_prompt_ids("pick up the red block")])
    assert 48 < mask.sum() <= 96 and ids.shape[1] == 96 and ids.shape[1] + model.num_patches == 352
    assert ids[0, 0] == 1 and (ids[mask == 0] == 51200).all()  # the byte tokenizer's BOS, Phi's pad
    centers = model.bin_centers.numpy()
    tokens = torch.tensor([[51199, 51000, 50000]])  # bins 1, 200 and (clipped) 255 of the Phi vocabulary
    acts = model.tokens_to_actions(tokens, torch.full((3,), -1.0), torch.ones(3), torch.ones(3, dtype=torch.bool))
    np.testing.assert_allclose(acts.numpy()[0], [centers[0], centers[199], centers[-1]], rtol=0, atol=1e-6)


def test_mistral_window_binds_and_ids_equal_jax(mistral_vla):
    """Mistral's GQA with the window cut to 8, below the ~350-token prefill:
    the flash kernel's `window` (the port's prefill) and the masks of decode
    give the JAX package's ids, and the window changes the result."""
    jmodel, jparams, tmodel, tparams = mistral_vla
    ids, mask, pixels = _inputs(jmodel, 2, seed=34)
    assert mask.sum(axis=1).min() > 8
    j, t = _greedy_pair(mistral_vla, ids, mask, pixels, jnp.float32, torch.float32)
    np.testing.assert_array_equal(t, j)
    wide = OpenVLA(dataclasses.replace(tmodel.cfg, llm=dataclasses.replace(tmodel.cfg.llm, sliding_window=None)),
                   tmodel.norm_stats, tokenizer=tmodel.tokenizer, dtype=torch.float32, device="cpu")
    wide.image_transform = tmodel.image_transform
    h_win = tmodel.forward_hidden(tparams, *_t(ids, mask, pixels, ids), remat=False)[0]
    h_wide = wide.forward_hidden(tparams, *_t(ids, mask, pixels, ids), remat=False)[0]
    assert float((h_win - h_wide).abs().max()) > 1e-2, "the window of 8 should bind"


@pytest.mark.parametrize("which", ["llama_gqa", "phi", "mistral_window"])
def test_greedy_with_int8_cache_equals_jax(phi_vla, mistral_vla, which):
    """Greedy decode over the int8 KV cache: ids equal to the JAX package's
    under its int8 cache. Token 0 also equals the fp32 cache's: the prefill
    attends over its own unquantized K/V and only writes the cache
    quantized. Later tokens read the quantized cache and may leave a near
    tie of the fp32 run (they do on the windowed pair)."""
    if which == "llama_gqa":
        pair = _vla_pair(jllama.LLMConfig(**dict(MISTRAL_VLA, sliding_window=None)), seed=35)
    else:
        pair = {"phi": phi_vla, "mistral_window": mistral_vla}[which]
    ids, mask, pixels = _inputs(pair[0], 2, seed=36)
    j8, t8 = _greedy_pair(pair, ids, mask, pixels, jnp.int8, torch.int8)
    np.testing.assert_array_equal(t8, j8)
    _, t32 = _greedy_pair(pair, ids, mask, pixels, jnp.float32, torch.float32)
    np.testing.assert_array_equal(t8[:, 0], t32[:, 0])


@pytest.mark.parametrize("draft_kind", ["zeros", "greedy", "partial"])
def test_speculative_with_int8_cache_equals_greedy(phi_vla, draft_kind):
    """generate_speculative over the int8 cache (the verify chunk quantizes
    its K/V into the 4-leaf cache, the fix-up steps decode over it): equal
    to generate_greedy under the same cache at the serving margin, and to
    the JAX package's speculative ids."""
    jmodel, jparams, tmodel, tparams = phi_vla
    ids, mask, pixels = _inputs(jmodel, 2, seed=37)
    greedy = tmodel.generate_greedy(tparams, *_t(ids, mask, pixels), max_new_tokens=5, cache_dtype=torch.int8).numpy()
    draft = {"zeros": np.zeros_like(greedy), "greedy": greedy.copy(),
             "partial": np.concatenate([greedy[:, :3], np.full_like(greedy[:, 3:], 7)], axis=1)}[draft_kind]
    t = tmodel.generate_speculative(tparams, *_t(ids, mask, pixels, draft), cache_dtype=torch.int8).numpy()
    np.testing.assert_array_equal(t, greedy)
    j = jmodel.generate_speculative(jparams, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(pixels),
                                    jnp.asarray(draft, jnp.int32), cache_dtype=jnp.int8)
    np.testing.assert_array_equal(t, np.asarray(j))


# --- quantized and LoRA Phi trees ---------------------------------------------------------------


@pytest.fixture(scope="module")
def phi_int8_vla():
    return _vla_pair(_jphi(**PHI_VLA), seed=40, quantize="int8")


@pytest.fixture(scope="module")
def phi_int4_vla():
    for k, n in ((256, 256), (256, 512), (512, 256)):  # wq/wk/wv/wo, w_up, w_down: the Pallas kernels run
        assert jm.int4_kernel_eligible(k, n, k // 128)
    return _vla_pair(_jphi(**PHI_INT4), seed=41, quantize="int4")


def _with_w8a8(pair, w8a8):
    jmodel, jparams, tmodel, tparams = pair
    jm2 = JOpenVLA(dataclasses.replace(jmodel.cfg, llm=dataclasses.replace(jmodel.cfg.llm, w8a8=w8a8)),
                   TINY_NORM_STATS, tokenizer=JTokenizer(), dtype=jnp.float32)
    tm2 = OpenVLA(dataclasses.replace(tmodel.cfg, llm=dataclasses.replace(tmodel.cfg.llm, w8a8=w8a8)),
                  norm_stats_from_json(TINY_NORM_STATS), tokenizer=ByteFallbackTokenizer(), dtype=torch.float32,
                  device="cpu")
    jm2.image_transform, tm2.image_transform = jmodel.image_transform, tmodel.image_transform
    return jm2, jparams, tm2, tparams


@pytest.mark.parametrize("w8a8", [False, True])
@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_quantized_phi_ids_equal_jax(phi_int8_vla, phi_int4_vla, kind, w8a8):
    """int8 and int4 Phi trees quantized by the JAX package and converted:
    the biases and norm biases stay float; with w8a8 off the greedy ids are
    equal; with it on the teacher-forced logits follow the rule of
    tests/test_torch_int4.py."""
    jmodel, jparams, tmodel, tparams = _with_w8a8(phi_int8_vla if kind == "int8" else phi_int4_vla, w8a8)
    lp = tparams["llm"]["layers"][0]
    assert "w_gate" not in lp and all(lp[b].dtype == torch.float32 for b in PHI_BIASES)
    assert (lp["wq"].dtype, lp.get("wq_scale4") is not None) == (torch.int8, kind == "int4")
    assert tparams["llm"]["lm_head_bias"].dtype == torch.float32 and tparams["llm"]["lm_head"].dtype == torch.int8
    ids, mask, pixels = _inputs(jmodel, 2, seed=42)
    j_tok = np.asarray(jmodel.generate_greedy(jparams, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(pixels),
                                              max_new_tokens=N))
    assert not np.array_equal(j_tok[0], j_tok[1])
    if not w8a8:
        t_tok = tmodel.generate_greedy(tparams, *_t(ids, mask, pixels), max_new_tokens=N).numpy()
        np.testing.assert_array_equal(t_tok, j_tok)
        return
    cleared = 0
    for i, text in enumerate(INSTRUCTIONS):  # one example at a time: no padding inside the sequence
        seq = np.concatenate([jmodel.prepare_prompt_ids(text), j_tok[i, :-1]]).astype(np.int32)[None]
        ones = np.ones_like(seq)
        jl, _ = jmodel.forward_train(jparams, jnp.asarray(seq), jnp.asarray(ones), jnp.asarray(pixels[i:i + 1]),
                                     jnp.asarray(seq), remat=False)
        with torch.no_grad():
            tl, _ = tmodel.forward_train(tparams, *_t(seq, ones, pixels[i:i + 1], seq), remat=False)
        want, got = np.asarray(jl)[0, -N:], tl.numpy()[0, -N:]
        for step in range(N):
            band = W4A8_LOGIT_BAND * float(np.abs(want[step]).max())
            assert float(np.abs(got[step] - want[step]).max()) <= band, f"example {i} step {step}"
            top2 = np.sort(want[step])[-2:]
            if top2[1] - top2[0] > 2 * band:
                cleared += 1
                assert int(np.argmax(got[step])) == int(j_tok[i, step]), f"example {i} step {step}"
    assert cleared >= 4, f"only {cleared} of 14 steps clear the 2b margin: the id check is near empty"


def test_phi_lora_leaves_and_merge(phi_llm):
    """Adapters over a Phi tree: the leaves the JAX `add_lora_params` adds
    (six projections, no w_gate), in the port's layout; the port's merge
    equals W + B A in fp32 and the JAX merge, and leaves the biases alone."""
    jcfg, jp, tcfg, tp = phi_llm
    jl = jlora.add_lora_params(jax.random.key(43), jp, rank=4, alpha=8.0)
    rng = np.random.default_rng(44)
    layers = dict(jl["layers"])
    for name in [k for k in layers if k.endswith("_lora_b")]:  # B starts at zero: give it values
        layers[name] = jnp.asarray(0.05 * rng.normal(size=layers[name].shape), jnp.float32)
    jl = dict(jl, layers=layers)
    want_leaves = llm_params_from_jax(_np(jl))
    got = tlora.add_lora_params(torch.Generator().manual_seed(43), tp, rank=4, alpha=8.0)
    for g, w in zip(got["layers"], want_leaves["layers"]):
        assert {k: tuple(v.shape) for k, v in g.items()} == {k: tuple(v.shape) for k, v in w.items()}
    assert sorted(k for k in got["layers"][0] if k.endswith("_lora_a")) == sorted(
        f"{t}_lora_a" for t in ("wq", "wk", "wv", "wo", "w_up", "w_down"))
    merged = tlora.merge_lora(want_leaves)
    jmerged = llm_params_from_jax(_np(jlora.merge_lora(jl)))
    for i, lp in enumerate(want_leaves["layers"]):
        for name in ("wq", "wk", "wv", "wo", "w_up", "w_down"):
            plain = lp[name] + lp[name + "_lora_b"] @ lp[name + "_lora_a"]
            np.testing.assert_allclose(merged["layers"][i][name].numpy(), plain.numpy(), rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(merged["layers"][i][name].numpy(), jmerged["layers"][i][name].numpy(),
                                       rtol=1e-6, atol=1e-6)
        for name in PHI_BIASES:
            assert merged["layers"][i][name] is lp[name]
        assert not any("_lora_" in k for k in merged["layers"][i])


def test_phi_lora_train_steps_match_jax(phi_vla):
    """Two LoRA train steps of the Phi VLA (adapters drawn in numpy on the
    six projections it has, B too so that every adapter has a gradient;
    the phi prompt format, 100 byte tokens, in a 112 bucket): loss, grad
    norm and L1 within 1e-5 of the jitted JAX step's, as
    tests/test_torch_training.py holds the Llama step."""
    from bridgelang_tpu.training import trainer as jtrainer
    from bridgelang_tpu.vla import action_tokenizer as jat
    from bridgelang_tpu.vla.datasets import datasets as jds
    from bridgelang_tpu_torch.training import trainer as ttrainer
    from bridgelang_tpu_torch.vla import action_tokenizer as tat
    from bridgelang_tpu_torch.vla.datasets import datasets as tds

    jmodel, jparams, tmodel, _ = phi_vla
    rng = np.random.default_rng(45)
    layers = dict(jparams["llm"]["layers"])
    for name in ("wq", "wk", "wv", "wo", "w_up", "w_down"):
        n_layers, d_in, d_out = layers[name].shape
        layers[name + "_lora_a"] = jnp.asarray(rng.normal(size=(n_layers, d_in, 4)) * 0.5, jnp.float32)
        layers[name + "_lora_b"] = jnp.asarray(rng.normal(size=(n_layers, 4, d_out)) * 0.02, jnp.float32)
    jp = dict(jparams, llm=dict(jparams["llm"], layers=layers))
    tp = params_from_jax(_np(jp))

    jt = jds.RLDSBatchTransform(jat.ActionTokenizer(JTokenizer()), JTokenizer(), llm_family="phi")
    tt = tds.RLDSBatchTransform(tat.ActionTokenizer(ByteFallbackTokenizer()), ByteFallbackTokenizer(), llm_family="phi")
    jb = jds.PaddedCollatorForActionPrediction(max_length=112, pad_token_id=51200)(
        list(jds.DummyDataset(jt, n=2, seed=46, image_hw=(32, 32))))
    tb = tds.PaddedCollatorForActionPrediction(max_length=112, pad_token_id=51200)(
        list(tds.DummyDataset(tt, n=2, seed=46, image_hw=(32, 32))))
    np.testing.assert_array_equal(tb["input_ids"], jb["input_ids"])
    assert (tb["attention_mask"].sum(axis=1) == 100).all()

    cfg = dict(learning_rate=2e-5, lr_scheduler_type="constant", max_grad_norm=1.0)
    j_mask = jlora.lora_trainable_mask(jp)
    jtx = jtrainer.make_optimizer(jtrainer.OptimConfig(**cfg), jp, trainable_mask=j_mask)
    jstep = jax.jit(jtrainer.make_vla_train_step(jmodel, jtx, trainable_mask=j_mask, compute_dtype=jnp.float32,
                                                 image_transform=jmodel.image_transform))
    jstate = jtrainer.init_train_state(jp, jtx, trainable_mask=j_mask)
    t_mask = tlora.lora_trainable_mask(tp)
    ttx = ttrainer.make_optimizer(ttrainer.OptimConfig(**cfg), tp, trainable_mask=t_mask)
    tstep = ttrainer.make_vla_train_step(tmodel, ttx, trainable_mask=t_mask, compute_dtype=torch.float32,
                                         image_transform=tmodel.image_transform)
    tstate = ttrainer.init_train_state(tp, ttx, trainable_mask=t_mask)
    jbatch = {k: jnp.asarray(v) for k, v in jb.items() if k != "dataset_names"}
    tbatch = {k: torch.from_numpy(v) for k, v in tb.items() if k != "dataset_names"}
    for _ in range(2):
        jstate, jmet = jstep(jstate, jbatch)
        tstate, tmet = tstep(tstate, tbatch)
        for key in ("loss", "grad_norm", "l1_loss"):
            np.testing.assert_allclose(float(tmet[key]), float(jmet[key]), rtol=1e-5, err_msg=key)
