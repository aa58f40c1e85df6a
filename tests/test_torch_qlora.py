"""QLoRA in the port vs the JAX package, on the CPU in fp32: LoRA adapters
over a packed-int4 base (`w8a8` off, as scripts/finetune.py runs it).

The tiny dual-tower VLA of tests/test_torch_training.py with a kernel-eligible
decoder (dim 256, 4 heads, 4 KV heads, intermediate 512, 2 layers, group 128),
so that the JAX forward runs its Pallas kernel in interpret mode. The JAX
package quantizes; the tree is converted; adapters are drawn in numpy and
handed to both.

Tolerances, and why:
* losses, grad norms and L1 per train step: rtol 1e-5, as the float LoRA
  test. Both sides run fp32; the int4 products differ in fp32 order only (the
  JAX kernel recovers the high nibble as a difference of two byte sums).
* adapters after 3 Adam steps at lr 2e-5: all but 0.1 % of the entries to
  atol 1e-5, as the float LoRA test, and each entry within 6 lr (an entry
  with a near-zero gradient can take another Adam step on the two sides, as
  the float LoRA test explains; 1 entry of 34816 does here).
* merged weights: the requantized bytes and scales exactly equal, and the
  dequantized weights too (the fp32 B A product of rank 4 rounds alike).
* remat none / full / dots over int4: atol 1e-6 (the same ops on the same
  inputs; only what the backward recomputes differs).
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
from bridgelang_tpu.ops import quant as jq
from bridgelang_tpu.training import lora as jlora
from bridgelang_tpu.training import trainer as jtrainer
from bridgelang_tpu.vla import action_tokenizer as jat
from bridgelang_tpu.vla.datasets import datasets as jds
from bridgelang_tpu_torch.convert import llm_params_from_jax, params_from_jax
from bridgelang_tpu_torch.models.llm import llama as tllama
from bridgelang_tpu_torch.models.llm.tokenizer import ByteFallbackTokenizer
from bridgelang_tpu_torch.models.vision.vit import ViTConfig
from bridgelang_tpu_torch.models.vla import OpenVLA, norm_stats_from_json
from bridgelang_tpu_torch.models.vlm import VLMConfig
from bridgelang_tpu_torch.ops import image_ops as timg
from bridgelang_tpu_torch.ops import int4_matmul as tm
from bridgelang_tpu_torch.ops import quant as tq
from bridgelang_tpu_torch.training import lora as tlora
from bridgelang_tpu_torch.training import trainer as ttrainer
from bridgelang_tpu_torch.vla import action_tokenizer as tat
from bridgelang_tpu_torch.vla.datasets import datasets as tds
from tests.helpers import TINY_NORM_STATS

DINO = dict(image_size=32, patch_size=8, width=32, depth=2, num_heads=4, mlp_dim=64,
            use_cls_token=True, num_reg_tokens=4, no_embed_class=True, layerscale_init=1e-5)
SIG = dict(image_size=32, patch_size=8, width=48, depth=2, num_heads=4, mlp_dim=96,
           use_cls_token=False, act="gelu_tanh")
LLM = dict(vocab_size=32000, padded_vocab_size=32064, dim=256, n_layers=2, n_heads=4, n_kv_heads=4,
           intermediate_size=512)
TOWERS = ((32, jimg.IMAGENET_DEFAULT_MEAN, jimg.IMAGENET_DEFAULT_STD), (32, jimg.INCEPTION_MEAN, jimg.INCEPTION_STD))
RANK = 4
MAX_LEN = 96


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _numpy_adapters(jlayers, rank, seed, b_std):
    """Stacked JAX-layout adapters over an int4 base: A [L, in, r], B [L, r,
    out] with out twice the packed width."""
    rng = np.random.default_rng(seed)
    out = {}
    for name in tlora.ALL_LINEAR:
        n_layers, d_in, packed_w = np.asarray(jlayers[name]).shape
        d_out = 2 * packed_w
        out[name + "_lora_a"] = (rng.normal(size=(n_layers, d_in, rank)) * rank ** -0.5).astype(np.float32)
        out[name + "_lora_b"] = (rng.normal(size=(n_layers, rank, d_out)) * b_std).astype(np.float32)
    return out


def _with_adapters(jllm, adapters):
    return dict(jllm, layers=dict(jllm["layers"], **{k: jnp.asarray(v) for k, v in adapters.items()}))


@pytest.fixture(scope="module")
def pair():
    jcfg = dataclasses.replace(JVLMConfig(), llm=JLLMConfig(**LLM),
                               vision_override=(JViTConfig(**DINO), JViTConfig(**SIG)))
    jmodel = JOpenVLA(jcfg, TINY_NORM_STATS, tokenizer=JTokenizer(), dtype=jnp.float32)
    jmodel.image_transform = jimg.ImageTransformConfig(
        "resize-naive", tuple(jimg.ImageTowerSpec(*t) for t in TOWERS))
    jparams = jmodel.init_params(jax.random.key(0))
    jparams = dict(jparams, llm=jq.quantize_llm_int4(jparams["llm"], group=128))
    tcfg = dataclasses.replace(VLMConfig(), llm=tllama.LLMConfig(**LLM),
                               vision_override=(ViTConfig(**DINO), ViTConfig(**SIG)))
    tmodel = OpenVLA(tcfg, norm_stats_from_json(TINY_NORM_STATS), tokenizer=ByteFallbackTokenizer(),
                     dtype=torch.float32, device="cpu")
    tmodel.image_transform = timg.ImageTransformConfig(
        "resize-naive", tuple(timg.ImageTowerSpec(*t) for t in TOWERS))
    return jmodel, jparams, tmodel


def _batches(n_examples, seed):
    jt = jds.RLDSBatchTransform(jat.ActionTokenizer(JTokenizer()), JTokenizer())
    tt = tds.RLDSBatchTransform(tat.ActionTokenizer(ByteFallbackTokenizer()), ByteFallbackTokenizer())
    jb = jds.PaddedCollatorForActionPrediction(max_length=MAX_LEN)(
        list(jds.DummyDataset(jt, n=n_examples, seed=seed, image_hw=(32, 32))))
    tb = tds.PaddedCollatorForActionPrediction(max_length=MAX_LEN)(
        list(tds.DummyDataset(tt, n=n_examples, seed=seed, image_hw=(32, 32))))
    return jb, tb


def test_add_lora_params_over_int4_is_full_width(pair):
    _, jparams, _ = pair
    base = llm_params_from_jax(_np(jparams["llm"]))
    lp = tlora.add_lora_params(torch.Generator().manual_seed(0), base, rank=8)
    j_lp = jlora.add_lora_params(jax.random.key(0), jparams["llm"], rank=8)["layers"]
    for name in tlora.ALL_LINEAR:
        a, b = lp["layers"][1][name + "_lora_a"], lp["layers"][1][name + "_lora_b"]
        ja, jb = j_lp[name + "_lora_a"], j_lp[name + "_lora_b"]  # [L, in, r], [L, r, out]
        assert a.shape == (8, ja.shape[1]) and b.shape == (jb.shape[2], 8), name
        assert b.shape[0] == 2 * base["layers"][1][name].shape[1] and not b.any()
    assert lp["layers"][0]["w_down_lora_a"].shape == (8, LLM["intermediate_size"])
    assert lp["layers"][0]["w_gate_lora_b"].shape == (LLM["intermediate_size"], 8)
    assert lp["layers"][0]["wq"] is base["layers"][0]["wq"]


def test_quantized_leaves_never_train(pair):
    jmodel, jparams, tmodel = pair
    tp = params_from_jax(_np(jparams))
    tp = dict(tp, llm=tlora.add_lora_params(torch.Generator().manual_seed(1), tp["llm"], rank=RANK))
    mask = tlora.lora_trainable_mask(tp)
    opt = ttrainer.make_optimizer(ttrainer.OptimConfig(), tp, trainable_mask=mask)
    ttrainer.init_train_state(tp, opt, trainable_mask=mask)
    packed = [v for v in ttrainer.tree_leaves(tp) if v.dtype == torch.int8]
    assert len(packed) == 7 * LLM["n_layers"] + 2 and not any(v.requires_grad for v in packed)
    stage = tmodel.trainable_mask(tp, "vla-train")  # marks every decoder tensor, the packed ones too
    with pytest.raises(ValueError, match="integer"):
        ttrainer.make_optimizer(ttrainer.OptimConfig(), tp, trainable_mask=stage)
    with pytest.raises(ValueError, match="integer"):
        ttrainer.init_train_state(tp, opt, trainable_mask=stage)


def test_merge_lora_over_int4_matches_jax(pair):
    _, jparams, _ = pair
    jl = _with_adapters(jparams["llm"], _numpy_adapters(jparams["llm"]["layers"], RANK, seed=2, b_std=0.05))
    j_merged = _np(jlora.merge_lora(jl))
    t_merged = tlora.merge_lora(llm_params_from_jax(_np(jl)))
    for i, lp in enumerate(t_merged["layers"]):
        assert not any("_lora_" in k for k in lp)
        for name in tlora.ALL_LINEAR:
            np.testing.assert_array_equal(lp[name].numpy(), j_merged["layers"][name][i], err_msg=name)
            np.testing.assert_array_equal(lp[name + "_scale4"].float().numpy(),
                                          np.asarray(j_merged["layers"][name + "_scale4"][i], np.float32))
    # the merge moved the weights, and the merged int4 base still serves
    before = llm_params_from_jax(_np(jparams["llm"]))
    assert not torch.equal(before["layers"][0]["wq"], t_merged["layers"][0]["wq"])
    deq = tq.dequantize_llm_int4(t_merged, torch.float32)
    assert deq["layers"][0]["wq"].shape == (LLM["dim"], LLM["dim"])
    # an int8 base of the same decoder merges as the JAX package merges it
    j8 = jq.quantize_llm_int8(jq.dequantize_llm_int4(jparams["llm"], jnp.float32))
    rng = np.random.default_rng(4)
    adapters = {}
    for name in tlora.ALL_LINEAR:
        n_layers, d_in, d_out = np.asarray(j8["layers"][name]).shape
        adapters[name + "_lora_a"] = (rng.normal(size=(n_layers, d_in, RANK)) * RANK ** -0.5).astype(np.float32)
        adapters[name + "_lora_b"] = (rng.normal(size=(n_layers, RANK, d_out)) * 0.05).astype(np.float32)
    j8 = _with_adapters(j8, adapters)
    t8 = tlora.merge_lora(llm_params_from_jax(_np(j8)))
    for tlp, jlp in zip(t8["layers"], llm_params_from_jax(_np(jlora.merge_lora(j8)))["layers"]):
        for name in tlora.ALL_LINEAR:
            np.testing.assert_array_equal(tlp[name].numpy(), jlp[name].numpy(), err_msg=name)
            assert torch.equal(tlp[name + "_scale"], jlp[name + "_scale"])


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_policies_give_equal_grads_over_int4(pair, policy):
    _, jparams, _ = pair
    jl = _with_adapters(jparams["llm"], _numpy_adapters(jparams["llm"]["layers"], RANK, seed=3, b_std=0.05))
    tcfg = tllama.LLMConfig(**LLM)
    rng = np.random.default_rng(4)
    b, t = 2, 16
    emb = torch.from_numpy(rng.normal(size=(b, t, LLM["dim"])).astype(np.float32))
    pos = torch.arange(t).expand(b, t)
    lens = torch.tensor([16, 11])
    mask = ((torch.arange(t)[None, :] <= torch.arange(t)[:, None])[None] & (torch.arange(t) < lens[:, None, None]))[:, None]

    def grads(remat, remat_policy):
        tp = llm_params_from_jax(_np(jl))
        leaves = [lp[k] for lp in tp["layers"] for k in sorted(lp) if "_lora_" in k]
        for x in leaves:
            x.requires_grad_(True)
        h, _ = tllama.llm_forward(tp, tcfg, emb, pos, mask, lengths=lens, remat=remat, remat_policy=remat_policy)
        loss = (h ** 2).sum()
        return loss.item(), torch.autograd.grad(loss, leaves)

    l0, g0 = grads(False, None)
    l1, g1 = grads(True, policy)
    assert l0 == l1
    for a, b_ in zip(g0, g1):
        np.testing.assert_allclose(b_.numpy(), a.numpy(), atol=1e-6, rtol=1e-6)


def test_three_qlora_train_steps_match_jax(pair):
    jmodel, jparams, tmodel = pair
    adapters = _numpy_adapters(jparams["llm"]["layers"], RANK, seed=11, b_std=0.02)
    jp = dict(jparams, llm=_with_adapters(jparams["llm"], adapters))
    tp = params_from_jax(_np(jp))
    jb, tb = _batches(4, seed=12)
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
    base_before = tp["llm"]["layers"][0]["w_up"].clone()
    losses = []
    for _ in range(3):
        jstate, jm = jstep(jstate, jbatch)
        tstate, tmetrics = tstep(tstate, tbatch)
        for key in ("loss", "grad_norm", "l1_loss"):
            np.testing.assert_allclose(float(tmetrics[key]), float(jm[key]), rtol=1e-5, err_msg=key)
        np.testing.assert_allclose(float(tmetrics["action_accuracy"]), float(jm["action_accuracy"]), atol=1e-6)
        losses.append(float(tmetrics["loss"]))
    assert losses[-1] < losses[0]
    assert torch.equal(tp["llm"]["layers"][0]["w_up"], base_before) and tm.int4_mm.launches == 0

    after = llm_params_from_jax(_np(jstate.params["llm"]))
    names = [(i, k) for i, lp in enumerate(after["layers"]) for k in lp if "_lora_" in k]
    got = np.concatenate([tstate.params["llm"]["layers"][i][k].detach().numpy().ravel() for i, k in names])
    want = np.concatenate([after["layers"][i][k].numpy().ravel() for i, k in names])
    # Adam moves each entry by ~lr whatever its gradient's size, so an entry
    # whose gradient is near zero can step differently on the two sides from
    # fp32 rounding alone, by up to 2 lr a step (1 entry in 34816 here): each
    # entry within 3 steps of that, and all but 0.1 % of the entries within
    # the float LoRA test's atol 1e-5.
    np.testing.assert_allclose(got, want, atol=3 * 2 * cfg["learning_rate"], rtol=0)
    assert (np.abs(got - want) > 1e-5).mean() <= 1e-3
