"""The port's training path vs the JAX package, on the CPU in fp32.

The tiny VLA of tests/test_torch_vla.py (dual towers, a 2-layer GQA Llama with
the real 32000/32064 vocabulary, so that the byte tokenizer, the '▁' token and
the action-token range fit) is initialised by the JAX package and converted.
LoRA adapters are made in numpy and handed to both packages.

Tolerances, and why:
* LoRA forward and `forward_train` logits: atol 1e-4, as
  tests/test_torch_models.py (fp32 sums in another order through two layers).
* merged weights: atol 1e-6 (one fp32 product of A and B, summed in another
  order).
* losses, grad norms and L1 per train step: rtol 1e-5. Both sides run fp32;
  the JAX step attends through XLA's masked softmax, the port through the
  plain flash forward and backward, so the sums differ in order only
  (~1e-7 relative per op through ~40 ops).
* action accuracy: atol 1e-6 (a count ratio; equal unless an argmax flips).
* adapters after 3 Adam steps: atol 1e-5 at the default lr 2e-5, and the
  whole update to 1e-3 relative at lr 1e-3 (the test's docstring says why).
* chunked vs dense CE: rtol 1e-5, as the JAX package's own test.
* remat none / full / dots: atol 1e-6 (the same ops on the same inputs; only
  what the backward recomputes differs).
"""

import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
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
from bridgelang_tpu.training import metrics as jmetrics
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
from bridgelang_tpu_torch.training import lora as tlora
from bridgelang_tpu_torch.training import metrics as tmetrics
from bridgelang_tpu_torch.training import trainer as ttrainer
from bridgelang_tpu_torch.vla import action_tokenizer as tat
from bridgelang_tpu_torch.vla.datasets import datasets as tds
from tests.helpers import TINY_LLM, TINY_NORM_STATS

DINO = dict(image_size=32, patch_size=8, width=32, depth=4, num_heads=4, mlp_dim=128,
            use_cls_token=True, num_reg_tokens=4, no_embed_class=True, layerscale_init=1e-5)
SIG = dict(image_size=32, patch_size=8, width=48, depth=4, num_heads=4, mlp_dim=96,
           use_cls_token=False, act="gelu_tanh")
LLM = dict(vocab_size=32000, padded_vocab_size=32064, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
           intermediate_size=128)
TOWERS = ((32, jimg.IMAGENET_DEFAULT_MEAN, jimg.IMAGENET_DEFAULT_STD), (32, jimg.INCEPTION_MEAN, jimg.INCEPTION_STD))
STAGES = ["align", "finetune", "vla-train", "full-finetune", "vla-full-train", "last-layer-finetune",
          "vla-last-layer-train", "vla-sandwich-train"]
RANK = 4
MAX_LEN = 96  # collator bucket: the byte tokenizer's ~80-token VLA example fits


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _numpy_adapters(jllm, rank, seed, b_std):
    """Stacked JAX-layout adapters in numpy: A [L, in, r] ~ N(0, 1/r),
    B [L, r, out] ~ N(0, b_std) (B = 0 when b_std is 0)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name in tlora.ALL_LINEAR:
        n_layers, d_in, d_out = np.asarray(jllm["layers"][name]).shape
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
    tcfg = dataclasses.replace(VLMConfig(), llm=tllama.LLMConfig(**LLM),
                               vision_override=(ViTConfig(**DINO), ViTConfig(**SIG)))
    tmodel = OpenVLA(tcfg, norm_stats_from_json(TINY_NORM_STATS), tokenizer=ByteFallbackTokenizer(),
                     dtype=torch.float32, device="cpu")
    tmodel.image_transform = timg.ImageTransformConfig(
        "resize-naive", tuple(timg.ImageTowerSpec(*t) for t in TOWERS))
    return jmodel, jparams, tmodel


def _batches(n_examples, seed):
    """The same DummyDataset frames through each package's transform + collator."""
    jt = jds.RLDSBatchTransform(jat.ActionTokenizer(JTokenizer()), JTokenizer())
    tt = tds.RLDSBatchTransform(tat.ActionTokenizer(ByteFallbackTokenizer()), ByteFallbackTokenizer())
    jb = jds.PaddedCollatorForActionPrediction(max_length=MAX_LEN)(
        list(jds.DummyDataset(jt, n=n_examples, seed=seed, image_hw=(32, 32))))
    tb = tds.PaddedCollatorForActionPrediction(max_length=MAX_LEN)(
        list(tds.DummyDataset(tt, n=n_examples, seed=seed, image_hw=(32, 32))))
    return jb, tb


# --- data ----------------------------------------------------------------------------


def test_batch_transform_and_collator_match_jax():
    jb, tb = _batches(6, seed=3)
    assert set(jb) == set(tb)
    for key in ("input_ids", "labels", "attention_mask", "frames"):
        assert tb[key].dtype == jb[key].dtype
        np.testing.assert_array_equal(tb[key], jb[key])
    assert tb["dataset_names"] == jb["dataset_names"] == ["dummy_dataset"] * 6
    assert tb["input_ids"].shape == (6, MAX_LEN)
    n_valid = tb["attention_mask"].sum(axis=1)
    assert ((tb["labels"] != -100).sum(axis=1) == 8).all() and (n_valid > 70).all()


def test_action_tokenizer_matches_jax():
    rng = np.random.default_rng(4)
    actions = rng.uniform(-1.3, 1.3, size=(5, 7)).astype(np.float32)
    actions[0, :3] = [-1.0, 1.0, 0.0]  # bin edges
    jt, tt = jat.ActionTokenizer(JTokenizer()), tat.ActionTokenizer(ByteFallbackTokenizer())
    ids = tt.encode_to_ids(actions)
    np.testing.assert_array_equal(ids, jt.encode_to_ids(actions))
    assert tt.action_token_begin_idx == jt.action_token_begin_idx == 31743
    np.testing.assert_array_equal(tt.decode_token_ids_to_actions(ids), jt.decode_token_ids_to_actions(ids))
    bins = tt.bins
    np.testing.assert_array_equal(
        tat.bin_actions(torch.from_numpy(actions), torch.from_numpy(bins)).numpy(),
        np.asarray(jat.bin_actions(jnp.asarray(actions), jnp.asarray(bins))))


# --- LoRA ----------------------------------------------------------------------------


def _llm_logits_pair(jllm, tllm, seed):
    rng = np.random.default_rng(seed)
    b, t = 2, 10
    emb = rng.normal(size=(b, t, TINY_LLM.dim)).astype(np.float32)
    pos = np.broadcast_to(np.arange(t), (b, t)).copy()
    lens = np.asarray([10, 6])
    mask = ((np.arange(t)[None, :] <= np.arange(t)[:, None])[None] & (np.arange(t) < lens[:, None, None]))[:, None]
    tcfg = tllama.LLMConfig(**dataclasses.asdict(TINY_LLM))
    jh, _ = jllama.llm_forward(jllm, TINY_LLM, jnp.asarray(emb), jnp.asarray(pos), jnp.asarray(mask))
    th, _ = tllama.llm_forward(tllm, tcfg, torch.from_numpy(emb), torch.from_numpy(pos), torch.from_numpy(mask))
    return (np.asarray(jllama.lm_logits(jllm, jh, TINY_LLM)), tllama.lm_logits(tllm, th, tcfg).detach().numpy())


def test_lora_forward_merge_and_mask_match_jax():
    base = jllama.init_llm_params(jax.random.key(5), TINY_LLM)
    jl = _with_adapters(base, _numpy_adapters(base, RANK, seed=6, b_std=0.05))
    tl = llm_params_from_jax(_np(jl))
    assert tl["layers"][1]["wq_lora_a"].shape == (RANK, TINY_LLM.dim)
    assert tl["layers"][1]["w_down_lora_b"].shape == (TINY_LLM.dim, RANK)
    j_logits, t_logits = _llm_logits_pair(jl, tl, seed=7)
    np.testing.assert_allclose(t_logits, j_logits, atol=1e-4, rtol=1e-4)

    j_merged = llm_params_from_jax(_np(jlora.merge_lora(jl)))
    t_merged = tlora.merge_lora(tl)
    for jlp, tlp in zip(j_merged["layers"], t_merged["layers"]):
        assert set(tlp) == set(jlp) and not any("_lora_" in k for k in tlp)
        for k in tlp:
            np.testing.assert_allclose(tlp[k].numpy(), jlp[k].numpy(), atol=1e-6, rtol=0)

    j_mask = jlora.lora_trainable_mask(jl)
    t_mask = tlora.lora_trainable_mask(tl)
    for i, lp in enumerate(t_mask["layers"]):
        assert lp == {k: bool(np.asarray(j_mask["layers"][k]).all()) for k in lp}
    assert t_mask["embed"] is False and t_mask["lm_head"] is False and t_mask["layers"][0]["wq_lora_b"] is True
    # an int8 base with adapters converts bit for bit, the adapters as before
    j8 = _np(jq.quantize_llm_int8(jl))
    t8 = llm_params_from_jax(j8)
    for i, lp in enumerate(t8["layers"]):
        np.testing.assert_array_equal(lp["wq"].numpy(), j8["layers"]["wq"][i].T)
        np.testing.assert_array_equal(lp["wq_scale"].float().numpy(), j8["layers"]["wq_scale"][i].astype(np.float32).T)
        np.testing.assert_array_equal(lp["wq_lora_a"].numpy(), j8["layers"]["wq_lora_a"][i].T)
    t_base, t_adapters = tlora.split_lora(tl)
    j_base, j_adapters = jlora.split_lora(jl)
    assert set(t_adapters["layers"][0]) == set(j_adapters["layers"]) and set(t_base["layers"][0]) == set(j_base["layers"])


def test_add_lora_params_starts_at_the_base_model():
    base = llm_params_from_jax(_np(jllama.init_llm_params(jax.random.key(5), TINY_LLM)))
    lp = tlora.add_lora_params(torch.Generator().manual_seed(0), base, rank=8, alpha=16.0)
    a, b = lp["layers"][0]["w_up_lora_a"], lp["layers"][0]["w_up_lora_b"]
    assert a.shape == (8, TINY_LLM.dim) and b.shape == (TINY_LLM.intermediate_size, 8)
    assert a.dtype == b.dtype == torch.float32 and not b.any()
    # A ~ N(0, 1/r) * alpha / r: std (1/8)^0.5 * 2
    assert abs(float(torch.cat([l["wq_lora_a"].flatten() for l in lp["layers"]]).std()) - 2 * 8 ** -0.5) < 0.05
    assert lp["layers"][0]["wq"] is base["layers"][0]["wq"]
    jl = jllama.init_llm_params(jax.random.key(5), TINY_LLM)
    j_logits, t_logits = _llm_logits_pair(jl, lp, seed=8)
    np.testing.assert_allclose(t_logits, j_logits, atol=1e-4, rtol=1e-4)
    with pytest.raises(NotImplementedError):
        tlora.merge_lora(dict(lp, layers=[dict(l, wq_scale=l["wq"]) for l in lp["layers"]]))


# --- optimizer, loss -------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["constant", "linear-warmup+cosine-decay"])
def test_lr_schedule_matches_optax(kind):
    cfg = dict(learning_rate=3e-4, lr_scheduler_type=kind, warmup_ratio=0.05, total_steps=1000)
    j = jtrainer.make_lr_schedule(jtrainer.OptimConfig(**cfg))
    t = ttrainer.make_lr_schedule(ttrainer.OptimConfig(**cfg))
    for count in (0, 1, 7, 49, 50, 51, 400, 999, 1000, 1500):
        # optax evaluates in float32 (a few roundings of 2^-24 of the peak value,
        # cos near pi included); the port in float64
        np.testing.assert_allclose(t(count), float(j(count)), rtol=1e-5, atol=1e-5 * cfg["learning_rate"])


def test_chunked_ce_matches_dense_and_jax():
    jp = jllama.init_llm_params(jax.random.key(0), TINY_LLM)
    tp = llm_params_from_jax(_np(jp))
    tcfg = tllama.LLMConfig(**dataclasses.asdict(TINY_LLM))
    rng = np.random.default_rng(0)
    b, f = 2, 37  # deliberately not a multiple of the chunk
    hidden = rng.normal(size=(b, f, TINY_LLM.dim)).astype(np.float32)
    labels = np.full((b, f), -100, np.int32)
    labels[:, 20:28] = rng.integers(TINY_LLM.vocab_size - 256, TINY_LLM.vocab_size, (b, 8))
    labels[:, 10:14] = rng.integers(2, 400, (b, 4))
    _, centers = tat.make_bins()
    begin = TINY_LLM.vocab_size - 257

    j_logits = jllama.lm_logits(jp, jnp.asarray(hidden), TINY_LLM)
    j_loss = float(jtrainer.cross_entropy_ignore_index(j_logits, jnp.asarray(labels)))
    j_m = jtrainer.vla_metrics_on_device(j_logits, jnp.asarray(labels), begin, centers, TINY_LLM.vocab_size)
    h = torch.from_numpy(hidden).requires_grad_(True)
    y = torch.from_numpy(labels)
    t_logits = tllama.lm_logits(tp, h, tcfg)
    dense = ttrainer.cross_entropy_ignore_index(t_logits, y)
    dense_m = ttrainer.vla_metrics_on_device(t_logits, y, begin, centers, TINY_LLM.vocab_size)
    loss, m = ttrainer.chunked_ce_and_metrics(tp, tcfg, h, y, begin, centers, chunk=16)
    np.testing.assert_allclose(dense.item(), j_loss, rtol=1e-5)
    np.testing.assert_allclose(loss.item(), dense.item(), rtol=1e-5)
    for key in ("action_accuracy", "l1_loss", "per_example_accuracy", "per_example_l1"):
        np.testing.assert_allclose(m[key].numpy(), dense_m[key].numpy(), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(m[key].numpy(), np.asarray(j_m[key]), rtol=1e-5, atol=1e-6)
    g_chunk, = torch.autograd.grad(loss, h)
    g_dense, = torch.autograd.grad(dense, h)
    assert float(g_chunk.abs().sum()) > 0
    np.testing.assert_allclose(g_chunk.numpy(), g_dense.numpy(), atol=1e-6)


def test_optimizer_clip_and_accumulation_match_optax():
    rng = np.random.default_rng(9)
    shapes = [(4, 3), (5,), (2, 6)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[(rng.normal(size=s) * scale).astype(np.float32) for s in shapes] for scale in (3.0, 0.01, 2.0, 0.5)]
    cfg = dict(learning_rate=1e-2, weight_decay=0.1, max_grad_norm=1.0)
    jtx = jtrainer.make_optimizer(jtrainer.OptimConfig(**cfg), params, grad_accum_steps=2)
    jstate = jtx.init(params)
    jp = [jnp.asarray(p) for p in params]
    tp = [torch.from_numpy(p.copy()) for p in params]
    ttx = ttrainer.make_optimizer(ttrainer.OptimConfig(**cfg), tp, grad_accum_steps=2)
    tstate = ttx.init(tp)
    for g in grads:
        upd, jstate = jtx.update([jnp.asarray(x) for x in g], jstate, jp)
        jp = optax.apply_updates(jp, upd)
        ttx.update([torch.from_numpy(x) for x in g], tstate, tp)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=1e-6)
    assert tstate["count"] == 2


# --- freeze stages -------------------------------------------------------------------


@pytest.mark.parametrize("stage", STAGES)
def test_trainable_mask_matches_jax(pair, stage):
    jmodel, jparams, tmodel = pair
    tparams = params_from_jax(_np(jparams))
    j_mask = jmodel.trainable_mask(jparams, stage)
    t_mask = tmodel.trainable_mask(tparams, stage)
    for part in ("vision", "projector"):
        j_vals = {bool(np.asarray(x).all()) for x in jax.tree_util.tree_leaves(j_mask[part])}
        assert len(j_vals) == 1 and set(ttrainer.tree_leaves(t_mask[part])) == j_vals
        assert set(t_mask[part]) == set(tparams[part])
    for i, lp in enumerate(t_mask["llm"]["layers"]):
        # a JAX mask leaf is a bool, or (stage "last") an array over the stacked layers
        j_layer = {k: np.asarray(v)[i] if np.ndim(v) else np.asarray(v) for k, v in j_mask["llm"]["layers"].items()}
        assert all(v.all() == v.any() for v in j_layer.values())
        assert lp == {k: bool(v.all()) for k, v in j_layer.items()}
    for k in ("embed", "final_norm", "lm_head"):
        assert t_mask["llm"][k] == bool(np.asarray(j_mask["llm"][k]).all())


def test_metrics_trackers_match_jax(tmp_path, monkeypatch):
    lines, status = {}, {}
    for name, mod in (("jax", jmetrics), ("torch", tmetrics)):
        tracker = mod.JSONLinesTracker("run", tmp_path / name, hparams={"lr": 1e-4})
        tracker.write_hyperparameters()
        m = mod.VLAMetrics([tracker], "run", window_size=2)
        for step in range(3):
            m.commit(global_step=step, lr=1e-4, loss=2.0 - step * 0.5, action_accuracy=0.25 * step, l1_loss=0.1)
            m.commit_for_dataset("bridge_orig", action_accuracy=0.5 + step)
            status[name] = m.push()
        m.finalize()
        rows = [json.loads(x) for x in (tmp_path / name / "run.jsonl").read_text().splitlines()]
        lines[name] = [{k: v for k, v in r.items() if k != "train/step_time"} for r in rows]
        assert (tmp_path / name / "run-metrics.jsonl").exists()
    assert lines["torch"] == lines["jax"] and len(lines["torch"]) == 6
    t_parts, j_parts = status["torch"].split("|"), status["jax"].split("|")
    assert t_parts[:2] + t_parts[3:] == j_parts[:2] + j_parts[3:]  # all but the step's ms
    monkeypatch.setitem(sys.modules, "wandb", None)  # `import wandb` raises ImportError
    with pytest.raises(ImportError, match="wandb"):
        tmetrics.WeightsBiasesTracker("run", tmp_path / "wandb")


def test_forward_train_matches_jax(pair):
    jmodel, jparams, tmodel = pair
    jp = dict(jparams, llm=_with_adapters(jparams["llm"], _numpy_adapters(jparams["llm"], RANK, seed=13, b_std=0.02)))
    tp = params_from_jax(_np(jp))
    jb, tb = _batches(2, seed=14)
    pixels = np.array(jimg.preprocess_batch(jnp.asarray(jb["frames"]), jmodel.image_transform))
    j_logits, j_labels = jmodel.forward_train(jp, jnp.asarray(jb["input_ids"]), jnp.asarray(jb["attention_mask"]),
                                              jnp.asarray(pixels), jnp.asarray(jb["labels"]))
    t_logits, t_labels = tmodel.forward_train(tp, torch.from_numpy(tb["input_ids"]), torch.from_numpy(tb["attention_mask"]),
                                              torch.from_numpy(pixels), torch.from_numpy(tb["labels"]), remat=False)
    assert t_logits.shape == (2, MAX_LEN + 16, LLM["padded_vocab_size"])
    np.testing.assert_array_equal(t_labels.numpy(), np.asarray(j_labels))
    np.testing.assert_allclose(t_logits.detach().numpy(), np.asarray(j_logits), atol=1e-4, rtol=1e-4)


# --- the train step ------------------------------------------------------------------


@pytest.mark.parametrize("lr", [2e-5, 1e-3])
def test_three_lora_train_steps_match_jax(pair, lr):
    """lr 2e-5 is the OptimConfig default: every adapter entry is held to
    atol 1e-5 after 3 steps. Adam normalizes each entry's update to ~lr
    whatever the gradient's size, so an entry whose gradient is near zero
    (~1e-6 of the norm) can take a different update on the two sides from
    fp32 rounding alone, by up to 2 lr. At lr 1e-3 one such entry in ~500
    does, so there the adapters' update as a whole is held instead:
    ||d_port - d_jax|| <= 1e-3 ||d_jax||."""
    jmodel, jparams, tmodel = pair
    adapters = _numpy_adapters(jparams["llm"], RANK, seed=11, b_std=0.02)
    jp = dict(jparams, llm=_with_adapters(jparams["llm"], adapters))
    tp = params_from_jax(_np(jp))
    jb, tb = _batches(4, seed=12)
    cfg = dict(learning_rate=lr, lr_scheduler_type="constant", max_grad_norm=1.0)

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
    assert len(tstate.opt_state["mu"]) == 2 * len(tlora.ALL_LINEAR) * LLM["n_layers"]

    jbatch = {k: jnp.asarray(v) for k, v in jb.items() if k != "dataset_names"}
    tbatch = {k: torch.from_numpy(v) for k, v in tb.items() if k != "dataset_names"}
    frozen_before = tp["llm"]["layers"][0]["wq"].clone()
    losses = []
    for _ in range(3):
        jstate, jm = jstep(jstate, jbatch)
        tstate, tm = tstep(tstate, tbatch)
        for key in ("loss", "grad_norm", "l1_loss"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-5, err_msg=key)
        np.testing.assert_allclose(float(tm["action_accuracy"]), float(jm["action_accuracy"]), atol=1e-6)
        np.testing.assert_allclose(tm["per_example_l1"].numpy(), np.asarray(jm["per_example_l1"]), rtol=1e-5)
        losses.append(float(tm["loss"]))
    assert tstate.step == 3 and losses[-1] < losses[0]
    assert torch.equal(tp["llm"]["layers"][0]["wq"], frozen_before) and not frozen_before.requires_grad

    after = llm_params_from_jax(_np(jstate.params["llm"]))
    names = [(i, k) for i, lp in enumerate(after["layers"]) for k in lp if "_lora_" in k]
    got = np.concatenate([tstate.params["llm"]["layers"][i][k].detach().numpy().ravel() for i, k in names])
    want = np.concatenate([after["layers"][i][k].numpy().ravel() for i, k in names])
    if lr <= 2e-5:
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    else:
        start = np.concatenate([np.asarray(adapters[k])[i].T.ravel() for i, k in names])
        assert np.linalg.norm((got - start) - (want - start)) <= 1e-3 * np.linalg.norm(want - start)


def test_train_state_refuses_inference_tensors(pair):
    _, jparams, tmodel = pair
    with torch.inference_mode():
        tp = params_from_jax(_np(jparams))
    opt = ttrainer.make_optimizer(ttrainer.OptimConfig(), tp)
    with pytest.raises(ValueError, match="inference"):
        ttrainer.init_train_state(tp, opt)


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_policies_give_equal_grads(policy):
    jp = jllama.init_llm_params(jax.random.key(1), TINY_LLM)
    jp = _with_adapters(jp, _numpy_adapters(jp, RANK, seed=2, b_std=0.05))
    tcfg = tllama.LLMConfig(**dataclasses.asdict(TINY_LLM))
    rng = np.random.default_rng(3)
    b, t = 2, 16
    emb = torch.from_numpy(rng.normal(size=(b, t, TINY_LLM.dim)).astype(np.float32))
    pos = torch.arange(t).expand(b, t)
    lens = torch.tensor([16, 11])
    mask = ((torch.arange(t)[None, :] <= torch.arange(t)[:, None])[None] & (torch.arange(t) < lens[:, None, None]))[:, None]

    def grads(remat, remat_policy):
        tp = llm_params_from_jax(_np(jp))
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
    with pytest.raises(ValueError):
        tllama.llm_forward(llm_params_from_jax(_np(jp)), tcfg, emb, pos, mask, remat=True, remat_policy="bogus")


def test_parallel_actions_objective_is_not_ported(pair):
    _, jparams, tmodel = pair
    tp = params_from_jax(_np(jparams))
    _, tb = _batches(1, seed=0)
    with pytest.raises(NotImplementedError):
        tmodel.forward_hidden(tp, torch.from_numpy(tb["input_ids"]), torch.from_numpy(tb["attention_mask"]),
                              torch.zeros((1, 6, 32, 32)), torch.from_numpy(tb["labels"]), parallel_actions=True)
