"""The port's packed-int4 path vs the JAX package, on the CPU.

Geometry: kernel-eligible shapes (dim 256, 4 heads, 4 KV heads, intermediate
512, 2 layers, group 128; one K=512 group-256 case), so that the JAX side runs
its Pallas kernels in interpret mode and not its XLA fallback; each test
asserts `int4_kernel_eligible` for the shapes it claims. The port runs the
kernels' plain versions (a CPU tensor). Inputs are numpy draws from a seed.

Tolerances, and why:
* quantization (activation codes and scales, packed bytes, bf16 group scales,
  the int8 embedding and head): exactly equal. Both packages divide in fp32
  and round half to even.
* w4a8 matmul with fp32 x: the codes are equal and each group's integer sum
  is exact on both sides; only the fp32 order in which the groups' scaled sums
  add differs (the TPU kernel adds in blocks of groups): rtol 1e-6,
  atol 1e-6 * rms. With bf16 x the result rounds once to bf16: one bf16 ulp
  (rtol 2^-7).
* float-activation matmul: the JAX kernel recovers the high nibble as
  (x.bytes - x.low_bytes) / 16 and the port sums x * code directly, so fp32
  rounding differs by ~16 ulp of the byte sum: fp32 x rtol 1e-5 + 1e-5 rms;
  bf16 x one bf16 ulp + 1e-3 rms (as chip_smoke.py's GRAD_TOL).
* dx through the custom VJPs: the same dequantized weights and one fp32
  product: atol 1e-5 * max|dx|.
* decoder logits over int4: atol 1e-4 * max|logit| (fp32 through two layers;
  with w8a8 an activation code may round the other way on a near-half tie,
  which moves a logit by far less).
* greedy token ids over int4: exactly equal with w8a8 off; with w8a8 on,
  teacher-forced logits within 0.05 max|logit| and equal argmax wherever
  the top-2 margin clears twice that (near-half activation ties, see
  `test_int4_w4a8_greedy_token_ids_equal_jax`).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bridgelang_tpu.models.llm import llama as jllama
from bridgelang_tpu.models.llm.llama import LLMConfig as JLLMConfig
from bridgelang_tpu.models.llm.tokenizer import ByteFallbackTokenizer as JTokenizer
from bridgelang_tpu.models.vision.vit import ViTConfig as JViTConfig
from bridgelang_tpu.models.vla import OpenVLA as JOpenVLA
from bridgelang_tpu.models.vlm import VLMConfig as JVLMConfig
from bridgelang_tpu.ops import image_ops as jimg
from bridgelang_tpu.ops import int4_matmul as jm
from bridgelang_tpu.ops import quant as jq
from bridgelang_tpu_torch.convert import llm_params_from_jax, params_from_jax
from bridgelang_tpu_torch.models.llm import llama as tllama
from bridgelang_tpu_torch.models import vla as tvla
from bridgelang_tpu_torch.models.llm.tokenizer import ByteFallbackTokenizer
from bridgelang_tpu_torch.models.vision.vit import ViTConfig
from bridgelang_tpu_torch.models.vla import OpenVLA, norm_stats_from_json
from bridgelang_tpu_torch.models.vlm import VLMConfig
from bridgelang_tpu_torch.ops import image_ops as timg
from bridgelang_tpu_torch.ops import int4_matmul as tm
from bridgelang_tpu_torch.ops import quant as tq
from tests.helpers import TINY_NORM_STATS

LLM = dict(vocab_size=32000, padded_vocab_size=32064, dim=256, n_layers=2, n_heads=4, n_kv_heads=4,
           intermediate_size=512)
SMALL_VOCAB = dict(LLM, vocab_size=512, padded_vocab_size=576, pad_token_id=512)
DINO = dict(image_size=32, patch_size=8, width=32, depth=2, num_heads=4, mlp_dim=64,
            use_cls_token=True, num_reg_tokens=4, no_embed_class=True, layerscale_init=1e-5)
SIG = dict(image_size=32, patch_size=8, width=48, depth=2, num_heads=4, mlp_dim=96,
           use_cls_token=False, act="gelu_tanh")
TOWERS = ((32, jimg.IMAGENET_DEFAULT_MEAN, jimg.IMAGENET_DEFAULT_STD), (32, jimg.INCEPTION_MEAN, jimg.INCEPTION_STD))
INSTRUCTIONS = ["pick up the red block", "put the small spoon on the towel next to the blue cup"]
# (K, N, group): the decoder's three shapes at this geometry, and K=512 at group 256
MATMUL_SHAPES = [(256, 512, 128), (512, 256, 128), (512, 512, 256)]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _jax_int4_llm(cfg_kwargs, seed, **cfg_extra):
    jcfg = JLLMConfig(**cfg_kwargs, **cfg_extra)
    return jcfg, jq.quantize_llm_int4(jllama.init_llm_params(jax.random.key(seed), jcfg), group=128)


def _check_eligible(llm_cfg, group):
    d, i, hd = llm_cfg["dim"], llm_cfg["intermediate_size"], llm_cfg["dim"] // llm_cfg["n_heads"]
    for k, n in ((d, llm_cfg["n_heads"] * hd), (d, llm_cfg["n_kv_heads"] * hd), (d, i), (i, d)):
        assert tm.int4_kernel_eligible(k, n, k // group) and jm.int4_kernel_eligible(k, n, k // group)


# --- quantization ---------------------------------------------------------------------


def test_activation_quantization_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(5, 7, 256)).astype(np.float32)
    x[0, 0] = 0.0  # an all-zero token takes scale 1
    x[1, 1, :4] = [127.0, 0.5, 1.5, -2.5]  # absmax 127 -> scale 1: exact half ties round to even
    jqx, jsx = jq.quantize_activations_per_token(jnp.asarray(x))
    tqx, tsx = tq.quantize_activations_per_token(torch.from_numpy(x))
    assert tqx.dtype == torch.int8
    np.testing.assert_array_equal(tqx.numpy(), np.asarray(jqx))
    np.testing.assert_array_equal(tsx.numpy(), np.asarray(jsx))
    np.testing.assert_array_equal(tqx[1, 1, :4].numpy(), [127, 0, 2, -2])


@pytest.mark.parametrize("n_shards", [1, 2])
def test_quantize_llm_int4_bytes_equal_jax(n_shards):
    _check_eligible(SMALL_VOCAB, 128)
    jcfg = JLLMConfig(**SMALL_VOCAB)
    jp = jllama.init_llm_params(jax.random.key(1), jcfg)
    jq4 = _np(jq.quantize_llm_int4(jp, group=128, n_shards=n_shards))
    tq4 = tq.quantize_llm_int4(llm_params_from_jax(_np(jp)), group=128, n_shards=n_shards)
    for i, lp in enumerate(tq4["layers"]):
        for name in tq.QUANT_TARGETS:
            assert lp[name].dtype == torch.int8 and lp[name + "_scale4"].dtype == torch.bfloat16
            assert lp[name].is_contiguous() and lp[name + "_scale4"].is_contiguous()  # as the kernels read them
            np.testing.assert_array_equal(lp[name].numpy(), jq4["layers"][name][i], err_msg=name)
            np.testing.assert_array_equal(lp[name + "_scale4"].float().numpy(), _f32(jq4["layers"][name + "_scale4"][i]))
    np.testing.assert_array_equal(tq4["embed"].numpy(), jq4["embed"])
    np.testing.assert_array_equal(tq4["embed_scale"].float().numpy(), _f32(jq4["embed_scale"]))
    np.testing.assert_array_equal(tq4["lm_head"].numpy(), jq4["lm_head"].T)  # the port's [V, D]
    np.testing.assert_array_equal(tq4["lm_head_scale"].float().numpy(), _f32(jq4["lm_head_scale"]).T)
    # one matrix on its own, through the 2-d helper
    w = np.random.default_rng(2).normal(size=(512, 256)).astype(np.float32)
    jpk, jsc = jq._quantize4_2d(jnp.asarray(w), 256, n_shards=n_shards)
    tpk, tsc = tq._quantize4_2d(torch.from_numpy(w), 256, n_shards=n_shards)
    np.testing.assert_array_equal(tpk.numpy(), np.asarray(jpk))
    np.testing.assert_array_equal(tsc.float().numpy(), _f32(jsc))
    assert tq.pack_layout_tag(n_shards) == jq.pack_layout_tag(n_shards)


@pytest.mark.parametrize("n_shards", [1, 2])
def test_pack_unpack_dequant_round_trip(n_shards):
    rng = np.random.default_rng(3)
    codes = rng.integers(-8, 8, size=(256, 512)).astype(np.int8)
    packed = tq.pack_int4(torch.from_numpy(codes), n_shards=n_shards)
    assert packed.shape == (256, 256) and packed.dtype == torch.int8
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jq.pack_int4(jnp.asarray(codes), n_shards=n_shards)))
    np.testing.assert_array_equal(tq.unpack_int4(packed, n_shards=n_shards).numpy(), codes)
    scales = (rng.uniform(0.01, 0.1, size=(2, 512))).astype(np.float32)
    s_bf = torch.from_numpy(scales).to(torch.bfloat16)
    for tdt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = tq.dequant_int4(packed, s_bf, tdt, n_shards=n_shards).float().numpy()
        want = _f32(jq.dequant_int4(jnp.asarray(packed.numpy()), jnp.asarray(scales, jnp.bfloat16), jdt,
                                    n_shards=n_shards))
        np.testing.assert_array_equal(got, want)
    # dequantize_llm_int4 returns the port's dense [out, in] layout
    q4 = tq.quantize_llm_int4(llm_params_from_jax(_np(jllama.init_llm_params(jax.random.key(4), JLLMConfig(**SMALL_VOCAB)))),
                              n_shards=n_shards)
    deq = tq.dequantize_llm_int4(q4, torch.float32, int4_shards=n_shards)
    assert deq["layers"][0]["w_gate"].shape == (512, 256) and "w_gate_scale4" not in deq["layers"][0]
    want = tq.dequant_int4(q4["layers"][0]["w_gate"], q4["layers"][0]["w_gate_scale4"], torch.float32,
                           n_shards=n_shards).t()
    np.testing.assert_array_equal(deq["layers"][0]["w_gate"].numpy(), want.numpy())
    assert deq["embed"].dtype == deq["lm_head"].dtype == torch.float32 and "embed_scale" not in deq


def test_init_llm_params_int4_draws_a_packed_decoder():
    """The random int4 decoder has the JAX package's leaves, shapes and
    dtypes (the port's [V, D] head), and its forward runs (its numbers come
    from another generator, so they are not compared)."""
    jcfg = JLLMConfig(**SMALL_VOCAB)
    jtree = _np(jq.init_llm_params_int4(jax.random.key(0), jcfg, group=128))
    tcfg = tllama.LLMConfig(**SMALL_VOCAB)
    t = tq.init_llm_params_int4(torch.Generator().manual_seed(0), tcfg, group=128)
    assert set(t["layers"][0]) == set(jtree["layers"]) and len(t["layers"]) == jcfg.n_layers
    for k, v in t["layers"][0].items():
        assert v.shape == jtree["layers"][k].shape[1:] and str(v.dtype)[6:] == str(jtree["layers"][k].dtype), k
    assert t["lm_head"].shape == jtree["lm_head"].shape[::-1] and t["embed_scale"].shape == jtree["embed_scale"].shape
    emb = tllama.embed_tokens(t, torch.arange(6)[None], torch.float32)
    h, _ = tllama.llm_forward(t, tcfg, emb, torch.arange(6)[None], torch.ones((1, 1, 6, 6), dtype=torch.bool).tril())
    assert torch.isfinite(tllama.lm_logits(t, h, tcfg)).all()


def test_convert_carries_a_jax_int4_tree_byte_for_byte():
    jcfg, jq4 = _jax_int4_llm(SMALL_VOCAB, seed=5)
    jnp4 = _np(jq4)
    t = llm_params_from_jax(jnp4, dtype=torch.float32)
    for i, lp in enumerate(t["layers"]):
        for name in tq.QUANT_TARGETS:
            assert lp[name].shape == jnp4["layers"][name][i].shape  # [in, out/2], not transposed
            np.testing.assert_array_equal(lp[name].numpy(), jnp4["layers"][name][i])
            assert lp[name + "_scale4"].dtype == torch.bfloat16  # quantized leaves keep their dtype
            np.testing.assert_array_equal(lp[name + "_scale4"].float().numpy(), _f32(jnp4["layers"][name + "_scale4"][i]))
        assert lp["attn_norm"].dtype == torch.float32
    np.testing.assert_array_equal(t["embed"].numpy(), jnp4["embed"])
    np.testing.assert_array_equal(t["lm_head"].numpy(), jnp4["lm_head"].T)
    assert t["lm_head_scale"].shape == (SMALL_VOCAB["padded_vocab_size"], 1)
    with pytest.raises(NotImplementedError):  # int8 decoder layers are not yet ported
        llm_params_from_jax(_np(jq.quantize_llm_int8(jllama.init_llm_params(jax.random.key(5), jcfg))))


# --- the matmuls ------------------------------------------------------------------------


def _weights(k, n, group, seed):
    w = np.random.default_rng(seed).normal(size=(k, n)).astype(np.float32)
    jp, js = jq._quantize4_2d(jnp.asarray(w), group)
    return jp, js, torch.from_numpy(np.asarray(jp)), torch.from_numpy(_f32(js)).to(torch.bfloat16)


def _assert_close(got, want, rtol, atol_rms):
    rms = float(np.sqrt(np.mean(want.astype(np.float64) ** 2)))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_rms * rms)


TOLS = {("a8", "float32"): (1e-6, 1e-6), ("a8", "bfloat16"): (2.0 ** -7, 0.0),
        ("float", "float32"): (1e-5, 1e-5), ("float", "bfloat16"): (2.0 ** -7, 1e-3)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["a8", "float"])
@pytest.mark.parametrize("shape", MATMUL_SHAPES)
def test_int4_matmul_matches_jax(shape, mode, dtype):
    k, n, group = shape
    assert tm.int4_kernel_eligible(k, n, k // group) and jm.int4_kernel_eligible(k, n, k // group)
    jp, js, tp, ts = _weights(k, n, group, seed=k + n)
    jfn, tfn = (jm.matmul_int4_a8, tm.matmul_int4_a8) if mode == "a8" else (jm.matmul_int4, tm.matmul_int4)
    rng = np.random.default_rng(6)
    for lead in ((1,), (7,), (37,), (2, 3)):
        xj = jnp.asarray(rng.normal(size=(*lead, k)).astype(np.float32), dtype=dtype)
        xt = torch.from_numpy(_f32(xj)).to(getattr(torch, dtype))
        got = tfn(xt, tp, ts)
        assert got.shape == (*lead, n) and got.dtype == xt.dtype
        _assert_close(got.float().numpy(), _f32(jfn(xj, jp, js)), *TOLS[(mode, dtype)])
    # the plain versions are the CPU path: no kernel launched
    assert tm.int4_mm.launches == tm.int4_mm_a8.launches == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", MATMUL_SHAPES)
def test_cuda_w4a8_route_composition_matches_jax(shape, dtype):
    """The card's w4a8 route, composed of its parts' CPU paths: quantize_a8
    (quantize_activations_per_token), int4_mm_a8 without the token scale
    (int4_matmul_a8_plain), then acc * xs in fp32 cast once to x's dtype, the
    kernel epilogue's order; against the JAX matmul_int4_a8 (interpret mode)
    under the a8 tolerances, zero rows and rounding ties included."""
    k, n, group = shape
    assert jm.int4_kernel_eligible(k, n, k // group)
    jp, js, tp, ts = _weights(k, n, group, seed=k + n + 1)
    x = np.random.default_rng(12).normal(size=(37, k)).astype(np.float32)
    x[3] = 0.0
    x[5, :4] = [127.0, 0.5, 1.5, -2.5]
    xj = jnp.asarray(x, dtype=dtype)
    xt = torch.from_numpy(_f32(xj)).to(getattr(torch, dtype))
    q, xs = tm.quantize_a8(xt)
    got = (tm.int4_mm_a8(q, tp, ts) * xs).to(xt.dtype)
    assert torch.equal(got, tm.matmul_int4_a8(xt, tp, ts))
    _assert_close(got.float().numpy(), _f32(jm.matmul_int4_a8(xj, jp, js)), *TOLS[("a8", dtype)])
    assert tm.int4_mm_a8.launches == tm.quantize_a8.launches == 0


def test_int4_kernels_plain_versions_agree_with_dequant_reference():
    """Each plain version against dequantize-then-matmul in float64: the a8
    one exactly (integer sums, scales applied per group in fp32: rtol 1e-6),
    the float one to fp32 order (rtol 1e-5)."""
    k, n, group = 512, 512, 256
    _, _, tp, ts = _weights(k, n, group, seed=7)
    w = tq.dequant_int4(tp, ts, torch.float64)
    rng = np.random.default_rng(8)
    q = torch.from_numpy(rng.integers(-127, 128, size=(9, k)).astype(np.int8))
    np.testing.assert_allclose(tm.int4_matmul_a8_plain(q, tp, ts).numpy(), (q.double() @ w).numpy(), rtol=1e-6,
                               atol=1e-6 * float((q.double() @ w).abs().max()))
    x = torch.from_numpy(rng.normal(size=(9, k)).astype(np.float32))
    want = (x.double() @ w).numpy()
    np.testing.assert_allclose(tm.int4_matmul_plain(x, tp, ts).numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("mode", ["a8", "float"])
def test_ineligible_shape_takes_the_fallback_in_both(mode):
    k, n, group = 64, 32, 32
    assert not tm.int4_kernel_eligible(k, n, k // group) and not jm.int4_kernel_eligible(k, n, k // group)
    jp, js, tp, ts = _weights(k, n, group, seed=9)
    x = np.random.default_rng(10).normal(size=(2, 5, k)).astype(np.float32)
    jfn, tfn = (jm.matmul_int4_a8, tm.matmul_int4_a8) if mode == "a8" else (jm.matmul_int4, tm.matmul_int4)
    np.testing.assert_allclose(tfn(torch.from_numpy(x), tp, ts).numpy(), np.asarray(jfn(jnp.asarray(x), jp, js)),
                               rtol=1e-6, atol=1e-6)


def test_blocked_route_equals_per_shard_products():
    """n_shards=2: each packed column block runs as a plain v2 matrix; the
    result equals the JAX blocked route and dequantize-then-matmul."""
    w = np.random.default_rng(11).normal(size=(256, 1024)).astype(np.float32)
    jp, js = jq._quantize4_2d(jnp.asarray(w), 128, n_shards=2)
    tp, ts = torch.from_numpy(np.asarray(jp)), torch.from_numpy(_f32(js)).to(torch.bfloat16)
    assert tm.int4_kernel_eligible(256, 512, 2)  # each shard block: K=256, N=512
    x = np.random.default_rng(12).normal(size=(3, 256)).astype(np.float32)
    got = tm.matmul_int4(torch.from_numpy(x), tp, ts, n_shards=2).numpy()
    want = np.asarray(jm.matmul_int4(jnp.asarray(x), jp, js, 2, False))
    _assert_close(got, want, *TOLS[("float", "float32")])
    ref = x @ tq.dequant_int4(tp, ts, torch.float32, n_shards=2).numpy()
    _assert_close(got, ref, *TOLS[("float", "float32")])


@pytest.mark.parametrize("mode", ["a8", "float"])
def test_blocked_vjp_matches_jax(mode):
    """n_shards=2 forward and backward agree with the JAX functions (the
    backward dequantizes shard-blocked, as the forward reads): the forward
    under TOLS, dx atol 1e-5 * max|dx|."""
    w = np.random.default_rng(21).normal(size=(256, 1024)).astype(np.float32)
    jp, js = jq._quantize4_2d(jnp.asarray(w), 128, n_shards=2)
    tp, ts = torch.from_numpy(np.asarray(jp)), torch.from_numpy(_f32(js)).to(torch.bfloat16)
    rng = np.random.default_rng(22)
    x = rng.normal(size=(2, 3, 256)).astype(np.float32)
    g = rng.normal(size=(2, 3, 1024)).astype(np.float32)
    jfn, tfn = (jm.matmul_int4_a8, tm.matmul_int4_a8) if mode == "a8" else (jm.matmul_int4, tm.matmul_int4)
    want_y, vjp = jax.vjp(lambda a: jfn(a, jp, js, 2, False), jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tfn(xt, tp, ts, n_shards=2)
    _assert_close(y.detach().numpy(), np.asarray(want_y), *TOLS[(mode, "float32")])
    (dx,) = torch.autograd.grad(y, xt, torch.from_numpy(g))
    np.testing.assert_allclose(dx.numpy(), np.asarray(want), rtol=0, atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("k,n,group", [(256, 512, 128), (512, 256, 256), (4096, 11008, 128), (4096, 5504, 128),
                                       (4096, 4096, 64), (256, 192, 128)])
def test_cuda_kernel_shape_rule_covers_the_jax_rule(k, n, group):
    """Every shape the JAX package's kernel takes, the CUDA kernels take; they
    also take 7B's 5504-wide shard blocks (N/2 = 64 x 43), which the JAX
    kernel does not, and refuse groups that are no multiple of 128 and N/2
    that is no multiple of 64."""
    jax_ok = jm.int4_kernel_eligible(k, n, k // group)
    assert tm.int4_kernel_eligible(k, n, k // group) == jax_ok
    want = n % 128 == 0 and group % 128 == 0
    assert tm.cuda_kernel_shape_ok(k, n, k // group) == want
    assert want or not jax_ok


@pytest.mark.parametrize("mode", ["a8", "float"])
def test_int4_vjp_matches_jax(mode):
    k, n, group = 512, 256, 128
    jp, js, tp, ts = _weights(k, n, group, seed=13)
    rng = np.random.default_rng(14)
    x = rng.normal(size=(2, 5, k)).astype(np.float32)
    g = rng.normal(size=(2, 5, n)).astype(np.float32)
    jfn, tfn = (jm.matmul_int4_a8, tm.matmul_int4_a8) if mode == "a8" else (jm.matmul_int4, tm.matmul_int4)
    _, vjp = jax.vjp(lambda a: jfn(a, jp, js), jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    scales = ts.clone().requires_grad_(True)
    y = tfn(xt, tp, scales)
    assert y.grad_fn is not None
    dx, ds = torch.autograd.grad(y, (xt, scales), torch.from_numpy(g))
    np.testing.assert_allclose(dx.numpy(), np.asarray(want), rtol=0, atol=1e-5 * float(np.abs(want).max()))
    assert not ds.any()  # frozen scales: zero gradient, as the JAX VJP


# --- the decoder and the VLA over int4 ---------------------------------------------------


@pytest.mark.parametrize("w8a8", [True, False])
def test_llm_forward_logits_over_int4_match_jax(w8a8):
    _check_eligible(SMALL_VOCAB, 128)
    jcfg, jq4 = _jax_int4_llm(SMALL_VOCAB, seed=15, w8a8=w8a8)
    tcfg = tllama.LLMConfig(**SMALL_VOCAB, w8a8=w8a8)
    tparams = llm_params_from_jax(_np(jq4))
    rng = np.random.default_rng(16)
    b, t = 2, 12
    emb = rng.normal(size=(b, t, jcfg.dim)).astype(np.float32)
    pos = np.broadcast_to(np.arange(t), (b, t)).copy()
    lens = np.asarray([12, 7])
    mask = ((np.arange(t)[None, :] <= np.arange(t)[:, None])[None] & (np.arange(t) < lens[:, None, None]))[:, None]
    jh, _ = jllama.llm_forward(jq4, jcfg, jnp.asarray(emb), jnp.asarray(pos), jnp.asarray(mask))
    want = np.asarray(jllama.lm_logits(jq4, jh, jcfg))
    th, _ = tllama.llm_forward(tparams, tcfg, torch.from_numpy(emb), torch.from_numpy(pos), torch.from_numpy(mask))
    got = tllama.lm_logits(tparams, th, tcfg).numpy()
    for i, n in enumerate(lens):  # rows past an example's length are don't-care
        np.testing.assert_allclose(got[i, :n], want[i, :n], rtol=0, atol=1e-4 * float(np.abs(want).max()))
    ids = rng.integers(0, SMALL_VOCAB["padded_vocab_size"], size=(2, 5))
    np.testing.assert_array_equal(tllama.embed_tokens(tparams, torch.from_numpy(ids), torch.float32).numpy(),
                                  np.asarray(jllama.embed_tokens(jq4, jnp.asarray(ids), jnp.float32)))


@pytest.fixture(scope="module")
def int4_vla_pair():
    """The tiny dual-tower OpenVLA over an int4 w4a8 decoder (dim 256), the
    LM head's action columns scaled up so that decoding lands in the action
    range (tests/test_torch_vla.py's device), then quantized by the JAX
    package and converted."""
    jcfg = dataclasses.replace(JVLMConfig(), llm=JLLMConfig(**LLM, w8a8=True),
                               vision_override=(JViTConfig(**DINO), JViTConfig(**SIG)))
    jmodel = JOpenVLA(jcfg, TINY_NORM_STATS, tokenizer=JTokenizer(), dtype=jnp.float32)
    jmodel.image_transform = jimg.ImageTransformConfig(
        "resize-naive", tuple(jimg.ImageTowerSpec(*t) for t in TOWERS))
    jparams = jmodel.init_params(jax.random.key(0))
    llm = dict(jparams["llm"], lm_head=jparams["llm"]["lm_head"].at[:, 31744:32000].multiply(8.0))
    jparams = dict(jparams, llm=jq.quantize_llm_int4(llm, group=128))
    tcfg = dataclasses.replace(VLMConfig(), llm=tllama.LLMConfig(**LLM, w8a8=True),
                               vision_override=(ViTConfig(**DINO), ViTConfig(**SIG)))
    tmodel = OpenVLA(tcfg, norm_stats_from_json(TINY_NORM_STATS), tokenizer=ByteFallbackTokenizer(),
                     dtype=torch.float32, device="cpu")
    tmodel.image_transform = timg.ImageTransformConfig(
        "resize-naive", tuple(timg.ImageTowerSpec(*t) for t in TOWERS))
    return jmodel, jparams, tmodel, params_from_jax(_np(jparams))


def _with_w8a8(jmodel, tmodel, w8a8):
    """Both models over the same int4 weights with `LLMConfig.w8a8` set."""
    jm2 = JOpenVLA(dataclasses.replace(jmodel.cfg, llm=dataclasses.replace(jmodel.cfg.llm, w8a8=w8a8)),
                   TINY_NORM_STATS, tokenizer=JTokenizer(), dtype=jnp.float32)
    tm2 = OpenVLA(dataclasses.replace(tmodel.cfg, llm=dataclasses.replace(tmodel.cfg.llm, w8a8=w8a8)),
                  norm_stats_from_json(TINY_NORM_STATS), tokenizer=ByteFallbackTokenizer(), dtype=torch.float32,
                  device="cpu")
    jm2.image_transform, tm2.image_transform = jmodel.image_transform, tmodel.image_transform
    return jm2, tm2


W4A8_LOGIT_BAND = 0.05  # b = 0.05 max|logit| per step: tie noise measured <= 0.016, a real fault is O(1)


@pytest.mark.parametrize("w8a8", [False, True])
def test_int4_w4a8_greedy_token_ids_equal_jax(int4_vla_pair, w8a8):
    """Greedy ids over the int4 decoder, the port against the JAX package on
    the same pixels.

    w8a8 off (fp32 activations x int4 weights): the hidden states agree to
    ~2e-6 relative, so the ids are equal.

    w8a8 on: each activation row is rounded to int8 codes, and a value that
    sits within ~1e-6 of a half tie rounds one way on XLA-CPU and the other
    on torch-CPU (their fp32 orders differ by that much). Such a flipped code
    moves hidden states by up to ~2e-2 relative at scattered rows; measured
    over both examples' 14 steps, the logits moved by at most 0.33
    (0.016 max|logit|, max|logit| 21-28), enough to flip a greedy id where
    the top two sit 0.13-0.19 apart, and how often depends on the host. So
    the ids are not compared step by step. Instead both packages'
    `forward_train` run teacher-forced over the JAX greedy sequence (the same
    ids and pixels), and at every step |logit_port - logit_jax| <= b =
    0.05 max|logit_jax|: a wrong nibble, group scale or token scale moves
    logits by O(1). Where the JAX top-2 margin exceeds 2b no tie can flip the
    argmax, so there the port's argmax must be the JAX id; at least 4 of the
    14 steps must clear 2b (6 do: JAX margins 3.06, 0.13, 0.39, 4.03, 1.44,
    5.57, 1.19 and 1.11, 0.17, 4.07, 4.82, 3.13, 0.68, 0.19)."""
    jmodel, jparams, tmodel, tparams = int4_vla_pair
    jmodel, tmodel = _with_w8a8(jmodel, tmodel, w8a8)
    _check_eligible(LLM, 128)
    frames = np.random.default_rng(17).integers(0, 256, size=(2, 48, 64, 3), dtype=np.uint8)
    ids, mask = jmodel.pad_prompt([jmodel.prepare_prompt_ids(t) for t in INSTRUCTIONS])
    pixels = np.array(jimg.preprocess_batch(jnp.asarray(frames), jmodel.image_transform))
    j_tok = np.asarray(jmodel.generate_greedy(jparams, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(pixels),
                                              max_new_tokens=7))
    assert ((j_tok >= 31744) & (j_tok < 32000)).mean() > 0.5, "decoding should land in the action range"
    assert not np.array_equal(j_tok[0], j_tok[1])
    if not w8a8:
        t_tok = tmodel.generate_greedy(tparams, torch.from_numpy(ids), torch.from_numpy(mask),
                                       torch.from_numpy(pixels), max_new_tokens=7).numpy()
        np.testing.assert_array_equal(t_tok, j_tok)
        return

    cleared = 0
    for i, text in enumerate(INSTRUCTIONS):  # one example at a time: no padding inside the sequence
        seq = np.concatenate([jmodel.prepare_prompt_ids(text), j_tok[i, :-1]]).astype(np.int32)[None]
        ones = np.ones_like(seq)
        jl, _ = jmodel.forward_train(jparams, jnp.asarray(seq), jnp.asarray(ones), jnp.asarray(pixels[i:i + 1]),
                                     jnp.asarray(seq), remat=False)
        with torch.no_grad():
            tl, _ = tmodel.forward_train(tparams, torch.from_numpy(seq), torch.from_numpy(ones),
                                         torch.from_numpy(pixels[i:i + 1]), torch.from_numpy(seq), remat=False)
        want = np.asarray(jl)[0, -7:]  # the logits that chose each of the 7 ids
        got = tl.numpy()[0, -7:]
        for step in range(7):
            band = W4A8_LOGIT_BAND * float(np.abs(want[step]).max())
            diff = float(np.abs(got[step] - want[step]).max())
            assert diff <= band, f"example {i} step {step}: |dlogit| {diff:.4f} > {band:.4f}"
            top2 = np.sort(want[step])[-2:]
            if top2[1] - top2[0] > 2 * band:
                cleared += 1
                assert int(np.argmax(got[step])) == int(j_tok[i, step]), f"example {i} step {step}"
    assert cleared >= 4, f"only {cleared} of 14 steps clear the 2b margin: the id check is near empty"


def test_int4_w4a8_predict_action_batch_matches_jax(int4_vla_pair, monkeypatch):
    """`predict_action_batch` end to end over int4 w4a8, on arbitrary frames
    (48 x 64: the resize runs). Each package's preprocessing gives pixels
    that agree to fp32 order (atol 1e-5); over w4a8 that noise can move an
    activation code across a rounding tie and flip a near-tied argmax, so the
    actions are compared on shared pixels: the port's `predict_action_batch`,
    its preprocessing handed the JAX package's pixels for these frames,
    returns the JAX `predict_action_device` actions for them (equal ids: the
    same bins, atol 1e-6)."""
    jmodel, jparams, tmodel, tparams = int4_vla_pair
    frames = np.random.default_rng(19).integers(0, 256, size=(2, 48, 64, 3), dtype=np.uint8)
    pixels = np.array(jimg.preprocess_batch(jnp.asarray(frames), jmodel.image_transform))
    own = timg.preprocess_batch(torch.from_numpy(frames), tmodel.image_transform).numpy()
    np.testing.assert_allclose(own, pixels, rtol=0, atol=1e-5)

    stats = jmodel.norm_stats[next(iter(jmodel.norm_stats))]["action"]
    ids, mask = jmodel.pad_prompt([jmodel.prepare_prompt_ids(t) for t in INSTRUCTIONS])
    j_act = np.asarray(jmodel.predict_action_device(
        jparams, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(pixels), jnp.asarray(stats["q01"], jnp.float32),
        jnp.asarray(stats["q99"], jnp.float32), jnp.asarray(stats["mask"]), action_dim=7))

    def shared_pixels(frames_u8, config, dtype=torch.float32):
        np.testing.assert_array_equal(frames_u8.numpy(), frames)
        return torch.from_numpy(pixels).to(dtype)

    monkeypatch.setattr(tvla, "preprocess_batch", shared_pixels)
    t_act = tmodel.predict_action_batch(tparams, list(frames), INSTRUCTIONS)
    assert t_act.shape == (2, 7)
    np.testing.assert_allclose(t_act, j_act, atol=1e-6, rtol=0)
