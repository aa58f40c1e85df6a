"""The port's DeepSeek-V2 decoder (models/llm/deepseek_v2.py: latent
attention, routed experts) against the plain reference
(bench_port/reference/mla_moe.py, fp32, the published expanded form), on
seeded random weights on the CPU at a tiny DeepSeek-V2-shaped size: dim 64,
4 heads, latent 32, rope 16, nope 16, v 16, 8 experts top-3 with one shared
expert, a dense layer 0, 3 layers, YaRN on.

* the prefill, then greedy decode through the latent cache, against the
  reference's full forward (logits);
* the absorbed decode against the expanded form, one layer;
* YaRN's inverse frequencies and softmax scale against the formula;
* the fp8-expert control (one precision below the stated one) fails the
  comparison that the port passes;
* a VLA on the decoder served over /act (spans, /stats);
* every refusal, and the registry rows.

The grouped-expert kernels and the (192, 128) flash forward are held
against their plain versions in tests/test_torch_kernels_emulated.py.
"""

import dataclasses
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from bridgelang_tpu_torch.models.llm import deepseek_v2 as dsv2
from bridgelang_tpu_torch.models.llm.llama import (
    LLM_CONFIGS,
    LLM_FAMILIES,
    DeepSeekV2Config,
    init_kv_cache,
    init_llm_params,
    llm_forward,
    lm_logits,
)
from bridgelang_tpu_torch.util import profiling

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "bench_port"))
from reference import mla_moe  # noqa: E402

TINY = DeepSeekV2Config(vocab_size=320, padded_vocab_size=384, dim=64, n_layers=3, n_heads=4, n_kv_heads=4,
                        intermediate_size=128, kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=16,
                        v_head_dim=16, n_routed_experts=8, n_shared_experts=1, moe_intermediate_size=32,
                        num_experts_per_tok=3, pad_token_id=320, bos_token_id=1, eos_token_id=2)
# fp32 throughout: the port's absorbed decode and the reference's expanded form sum in other orders
# (and the flash plain path normalises once), so logits of magnitude ~4 agree to ~1e-5; 1e-4 leaves room
# and still fails the fp8-expert control by orders of magnitude.
LOGIT_ATOL = 1e-4


def _params(cfg=TINY, seed=1, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    p = init_llm_params(g, cfg, dtype)
    for lp in p["layers"]:  # norms away from one, so that their weights enter the comparison
        for k in ("attn_norm", "kv_norm", "mlp_norm"):
            lp[k] = lp[k] + 0.1 * torch.randn(lp[k].shape, generator=g).to(dtype)
    return p


def _served(cfg, p, emb, lens, n_new):
    """Prefill each example's prompt (right-padded), then n_new - 1 cached
    decode steps feeding emb's next rows -> logits [B, n_new, V] and the load."""
    b, t = len(lens), max(lens)
    cache = init_kv_cache(cfg, b, t + n_new, torch.float32)
    pos = torch.arange(t).expand(b, t)
    valid = torch.arange(t)[None, :] < torch.tensor(lens)[:, None]
    mask = (torch.arange(t)[None, :] <= torch.arange(t)[:, None])[None, None] & valid[:, None, None, :]
    load = torch.zeros((cfg.n_moe_layers, cfg.n_routed_experts), dtype=torch.int32)
    h, cache = llm_forward(p, cfg, emb[:, :t], pos, mask, cache=cache, cache_positions=pos, cache_write="contiguous",
                           lengths=torch.tensor(lens, dtype=torch.int32), expert_load=load)
    out = [lm_logits(p, h[torch.arange(b), torch.tensor(lens) - 1], cfg)]
    for i in range(n_new - 1):
        tok = torch.stack([emb[j, lens[j] + i] for j in range(b)])[:, None]
        pp = torch.tensor(lens)[:, None] + i
        m = torch.arange(t + n_new)[None, None, None, :] <= pp[:, None, :, None]
        hh, _ = llm_forward(p, cfg, tok, pp, m, cache=cache, cache_positions=pp)
        out.append(lm_logits(p, hh[:, 0], cfg))
    return torch.stack(out, dim=1), load


def _reference(cfg, p, emb, lens, n_new, variant=None):
    embeds = [emb[j, :lens[j] + n_new - 1] for j in range(len(lens))]
    rows = [range(lens[j] - 1, lens[j] - 1 + n_new) for j in range(len(lens))]
    return torch.stack(mla_moe.decoder_logits(p, dataclasses.asdict(cfg), embeds, rows, variant))


@pytest.mark.parametrize("norm_topk", [False, True], ids=["scaled", "renormalised"])
def test_prefill_then_cached_decode_matches_the_reference(norm_topk):
    cfg = dataclasses.replace(TINY, norm_topk_prob=norm_topk, routed_scaling_factor=1.5)
    p = _params(cfg)
    emb = torch.randn((2, 26, cfg.dim), generator=torch.Generator().manual_seed(2))
    lens, n_new = [20, 15], 5
    before = profiling.counters()
    got, load = _served(cfg, p, emb, lens, n_new)
    want = _reference(cfg, p, emb, lens, n_new)
    assert float((got - want).abs().max()) <= LOGIT_ATOL, float((got - want).abs().max())
    # every prefill row is routed (the padding's too): 20 rows x 2 examples x top-3 per MoE layer
    assert load.sum(dim=1).tolist() == [2 * 20 * 3] * cfg.n_moe_layers
    after = profiling.counters()
    for name, n in (("attn:mla_flash", 3), ("attn:mla_absorbed", 3 * (n_new - 1)), ("moe:plain", 2 * n_new)):
        assert after.get(name, 0) - before.get(name, 0) == n, name


@pytest.mark.parametrize("variant", mla_moe.VARIANTS)
def test_the_controls_fail_the_comparison(variant):
    """The reference one precision below bf16 in the experts (fp8 e4m3), with
    the top-k weights renormalised, or without the shared experts, is told
    apart from the port by the tolerance the port passes."""
    p = _params()
    emb = torch.randn((2, 26, TINY.dim), generator=torch.Generator().manual_seed(2))
    got, _ = _served(TINY, p, emb, [20, 15], 5)
    control = _reference(TINY, p, emb, [20, 15], 5, variant)
    assert float((got - control).abs().max()) > 10 * LOGIT_ATOL


def test_absorbed_decode_matches_the_expanded_form():
    cfg, lp = TINY, _params()["layers"][1]
    g = torch.Generator().manual_seed(5)
    t, h = 12, cfg.n_heads
    q_nope = torch.randn((1, t, h, cfg.qk_nope_head_dim), generator=g)
    q_pe = torch.randn((1, t, h, cfg.qk_rope_head_dim), generator=g)
    c = torch.randn((1, t, cfg.kv_lora_rank), generator=g)
    k_pe = torch.randn((1, t, 1, cfg.qk_rope_head_dim), generator=g)
    expanded = dsv2.mla_expanded(cfg, lp, q_nope, q_pe, c, k_pe, torch.tensor([t], dtype=torch.int32))
    latent = torch.cat([c, k_pe[:, :, 0]], dim=-1)
    mask = (torch.arange(t)[None, :] <= torch.arange(t)[:, None])[None, None]
    absorbed = dsv2.mla_absorbed(cfg, lp, q_nope, q_pe, latent, mask)
    torch.testing.assert_close(absorbed, expanded, atol=1e-5, rtol=1e-5)  # fp32, sums in other orders


def test_yarn_frequencies_and_softmax_scale_follow_the_formula():
    cfg = LLM_CONFIGS["deepseek-v2-lite-pure"]
    inv = dsv2.yarn_inv_freq(cfg)
    base = 10000.0 ** (-torch.arange(0, 64, 2, dtype=torch.float64) / 64)
    # correction dims of beta_fast 32 and beta_slow 1 rotations over the original 4096 positions
    dim = lambda rot: 64 * math.log(4096 / (rot * 2 * math.pi)) / (2 * math.log(10000))  # noqa: E731
    lo, hi = math.floor(dim(32)), math.ceil(dim(1))
    ramp = torch.clamp((torch.arange(32, dtype=torch.float64) - lo) / (hi - lo), 0, 1)
    want = base / 40 * ramp + base * (1 - ramp)
    torch.testing.assert_close(inv.double(), want, rtol=1e-6, atol=0)
    torch.testing.assert_close(inv, mla_moe.yarn_inv_freq(dataclasses.asdict(cfg)), rtol=0, atol=0)
    assert (lo, hi) == (10, 23) and inv[0] == 1.0 and float(inv[-1]) == pytest.approx(float(base[-1]) / 40)
    mscale = 0.1 * 0.707 * math.log(40) + 1.0
    assert dsv2.softmax_scale(cfg) == pytest.approx(192 ** -0.5 * mscale ** 2, rel=1e-12)
    assert dsv2.softmax_scale(cfg) == pytest.approx(0.11473, abs=1e-5)
    cos, sin = dsv2.yarn_cos_sin(cfg, torch.arange(3))  # mscale == mscale_all_dim: cos/sin unscaled
    torch.testing.assert_close(cos[2, :32], torch.cos(2 * inv))


def test_the_registry_holds_the_published_shapes():
    cfg = LLM_CONFIGS["deepseek-v2-lite-pure"]
    assert (cfg.dim, cfg.n_layers, cfg.n_heads, cfg.vocab_size, cfg.padded_vocab_size) == (2048, 27, 16, 102400, 102464)
    assert (cfg.kv_lora_rank, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim) == (512, 128, 64, 128)
    assert (cfg.n_routed_experts, cfg.num_experts_per_tok, cfg.n_shared_experts) == (64, 6, 2)
    assert (cfg.moe_intermediate_size, cfg.intermediate_size, cfg.first_k_dense_replace) == (1408, 10944, 1)
    assert cfg.norm_eps == 1e-6 and not cfg.norm_topk_prob and cfg.routed_scaling_factor == 1.0
    shapes = jax_free_leaf_shapes(cfg)
    n = sum(math.prod(s) for s in shapes.values())
    experts = sum(math.prod(s) for k, s in shapes.items() if ".we_" in k)
    assert round(n / 1e9, 1) == 15.7 and round(experts / 1e9, 2) == 14.39
    assert LLM_FAMILIES["deepseek-v2-lite-pure"] == "deepseek-v2-pure"
    from bridgelang_tpu_torch.conf.models import ModelConfig
    from bridgelang_tpu_torch.models.llm.prompting import build_vla_prompt, get_prompt_builder

    reg = ModelConfig.get_choice_class("prism-deepseekv2lite-dinosiglip+16b")()
    assert reg.llm_backbone_id == "deepseek-v2-lite-pure" and reg.vision_backbone_id == "dinosiglip-vit-so-224px"
    assert get_prompt_builder("deepseek-v2-pure").fmt is get_prompt_builder("mistral-pure").fmt
    assert build_vla_prompt("open the drawer", "deepseek-v2-pure").endswith("\nOut:")


def jax_free_leaf_shapes(cfg):
    """Every decoder leaf's shape, drawn on the meta device."""
    p = dsv2.init_params(None, cfg, torch.bfloat16, torch.device("meta"))
    shapes = {name: tuple(t.shape) for name, t in p.items() if name != "layers"}
    for i, lp in enumerate(p["layers"]):
        shapes.update({f"{i}.{k}": tuple(t.shape) for k, t in lp.items()})
    return shapes


# --- a VLA on the decoder, and the refusals ---------------------------------------------------------


@pytest.fixture(scope="module")
def vla():
    from bridgelang_tpu_torch.models.llm.tokenizer import ByteFallbackTokenizer
    from bridgelang_tpu_torch.models.vision.vit import ViTConfig
    from bridgelang_tpu_torch.models.vla import OpenVLA
    from bridgelang_tpu_torch.models.vlm import VLMConfig
    from bridgelang_tpu_torch.ops.image_ops import ImageTowerSpec, ImageTransformConfig

    tower = ViTConfig(image_size=32, patch_size=8, width=32, depth=3, num_heads=4, mlp_dim=64)
    vcfg = VLMConfig(model_id="prism-deepseekv2lite-dinosiglip+16b", llm_backbone_id="deepseek-v2-lite-pure",
                     llm=TINY, vision_override=tower)
    stats = {"bridge_orig": {"action": {"q01": [-0.1] * 7, "q99": [0.1] * 7, "mask": [True] * 6 + [False]}}}
    model = OpenVLA(vcfg, stats, tokenizer=ByteFallbackTokenizer(), dtype=torch.float32, device="cpu")
    model.image_transform = ImageTransformConfig("resize-naive", (ImageTowerSpec(size=32),))
    params = model.init_params(torch.Generator().manual_seed(0))
    params["llm"] = _params(seed=3)
    return model, params


def test_a_vla_on_the_decoder_serves_act(vla):
    from bridgelang_tpu_torch.serving.server import VLAServer, client_act

    model, params = vla
    server = VLAServer(model, params, speculative_default=False, device="cpu")
    httpd = server.serve_background(port=0)
    t0 = profiling.time.perf_counter_ns()
    frame = np.random.default_rng(4).integers(0, 256, size=(32, 32, 3), dtype=np.uint8)
    try:
        action = client_act("127.0.0.1", httpd.server_address[1], frame, "pick up the block")
        stats = server.stats()
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.close()
    assert np.asarray(action).shape == (7,)
    (pass_,) = profiling.spans(t0, name="serve:pass")
    assert set(pass_.attrs) == {"rows", "experts_touched", "expert_max_over_mean"}
    assert 1.0 <= pass_.attrs["experts_touched"] <= TINY.n_routed_experts and pass_.attrs["expert_max_over_mean"] >= 1
    load = model.last_expert_load
    assert load.shape == (2, 8) and (load.sum(axis=1) == load.sum(axis=1)[0]).all()
    assert stats["moe"]["experts_touched"] == pass_.attrs["experts_touched"]
    assert {"moe:plain", "attn:mla_flash", "attn:mla_absorbed"} <= set(stats["moe"]["routes"])


def test_greedy_ids_are_the_reference_argmax(vla):
    """The served ids of a predict against the reference teacher-forced over
    the same fused sequence: each is the reference's best (fp32, no ties)."""
    model, params = vla
    frame = np.random.default_rng(9).integers(0, 256, size=(32, 32, 3), dtype=np.uint8)
    actions, ids, _ = model._host_predict("greedy", params, [frame], ["open the drawer"], None)
    pixels = model.preprocess_frames(torch.as_tensor(frame[None]))
    patches = model.encode_vision(params, pixels)[0]
    prompt = torch.as_tensor(model.prepare_prompt_ids("open the drawer"), dtype=torch.long)
    fed = torch.cat([prompt, torch.as_tensor(ids[0][:-1], dtype=torch.long)])
    te = params["llm"]["embed"][fed]
    seq = torch.cat([te[:1], patches, te[1:]])
    n_prompt = len(prompt) + patches.shape[0]
    ref = mla_moe.decoder_logits(params["llm"], dataclasses.asdict(TINY), [seq],
                                 [range(n_prompt - 1, n_prompt - 1 + ids.shape[1])])[0]
    assert ref.argmax(dim=-1).tolist() == ids[0].tolist()


def _refuse_speculative(model, params):
    model.generate_speculative(params, torch.ones((1, 4), dtype=torch.long), torch.ones((1, 4), dtype=torch.long),
                               torch.zeros((1, 3, 32, 32)), torch.zeros((1, 7), dtype=torch.long))


def _refuse_server_speculative(model, params):
    from bridgelang_tpu_torch.serving.server import VLAServer

    VLAServer(model, params, speculative_default=True, device="cpu")


def _refuse_int8(model, params):
    from bridgelang_tpu_torch.deploy import quantize_for_serving

    quantize_for_serving(model, params, True, False, 128)  # deploy's default --quantize_int8 true


def _refuse_int4(model, params):
    from bridgelang_tpu_torch.ops.quant import quantize_llm_int4

    quantize_llm_int4(params["llm"])


def _refuse_int8_cache(model, params):
    init_kv_cache(model.cfg.llm, 1, 8, torch.int8)


def _refuse_deploy_int8_cache(model, params):
    from bridgelang_tpu_torch import deploy

    args = deploy.parse_args(["--device", "cpu", "--kv_cache_int8", "true"])
    original = deploy.load_for_serving
    deploy.load_for_serving = lambda args, device: (model, params)
    try:
        deploy.build_server(args)
    finally:
        deploy.load_for_serving = original


def _refuse_mesh(model, params):
    model.use_mesh(None, params)


def _refuse_finetune(model, params):
    llm_forward(params["llm"], model.cfg.llm, torch.zeros((1, 4, TINY.dim)), torch.arange(4)[None],
                torch.ones((1, 1, 4, 4), dtype=torch.bool), remat=True)


def _refuse_parallel_decode(model, params):
    model.generate_parallel(params, torch.ones((1, 4), dtype=torch.long), torch.ones((1, 4), dtype=torch.long),
                            torch.zeros((1, 3, 32, 32)), 7, query_token_id=3)


REFUSALS = {"speculative": (_refuse_speculative, "speculative decoding"),
            "server_speculative_default": (_refuse_server_speculative, "--speculative_default"),
            "int8_weights": (_refuse_int8, "int8 quantization of a decoder with routed experts"),
            "int4_weights": (_refuse_int4, "int4 quantization of a decoder with routed experts"),
            "int8_kv_cache": (_refuse_int8_cache, "the int8 KV cache"),
            "deploy_kv_cache_int8": (_refuse_deploy_int8_cache, "--kv_cache_int8"),
            "tensor_parallel": (_refuse_mesh, "tensor-parallel serving"),
            "finetune": (_refuse_finetune, "training (finetune, LoRA)"),
            "parallel_decode": (_refuse_parallel_decode, "the parallel decode")}


@pytest.mark.parametrize("what", sorted(REFUSALS))
def test_paths_the_decoder_does_not_take_are_refused(vla, what):
    fn, message = REFUSALS[what]
    with pytest.raises(ValueError, match="not supported") as err:
        fn(*vla)
    assert message in str(err.value)


def test_deploy_serves_it_in_bf16_as_it_is(vla):
    from bridgelang_tpu_torch.deploy import quantize_for_serving

    model, params = vla
    assert quantize_for_serving(model, params, False, False, 128) == (model, params)


@pytest.mark.gpu
def test_a_bf16_vla_on_the_card_replays_one_graph_per_predict(monkeypatch):
    """On the card: the kernels' shapes (heads of 192 / 128, D and the expert
    width multiples of 64), bf16; the graph replay gives the eager predict's
    ids, counts its kernels' launches, and never takes a plain path."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the grouped-expert and flash kernels have no CPU build")
    from bridgelang_tpu_torch.models.llm.tokenizer import ByteFallbackTokenizer
    from bridgelang_tpu_torch.models.vision.vit import ViTConfig
    from bridgelang_tpu_torch.models.vla import OpenVLA
    from bridgelang_tpu_torch.models.vlm import VLMConfig
    from bridgelang_tpu_torch.ops import moe
    from bridgelang_tpu_torch.ops.flash_attention import flash_attention
    from bridgelang_tpu_torch.ops.image_ops import ImageTowerSpec, ImageTransformConfig

    cfg = dataclasses.replace(TINY, dim=128, n_heads=2, n_kv_heads=2, kv_lora_rank=64, qk_nope_head_dim=128,
                              qk_rope_head_dim=64, v_head_dim=128, moe_intermediate_size=64, intermediate_size=256)
    tower = ViTConfig(image_size=32, patch_size=8, width=64, depth=3, num_heads=4, mlp_dim=128)
    stats = {"bridge_orig": {"action": {"q01": [-0.1] * 7, "q99": [0.1] * 7, "mask": [True] * 6 + [False]}}}
    model = OpenVLA(VLMConfig(llm_backbone_id="deepseek-v2-lite-pure", llm=cfg, vision_override=tower), stats,
                    tokenizer=ByteFallbackTokenizer(), dtype=torch.bfloat16, device="cuda")
    model.image_transform = ImageTransformConfig("resize-naive", (ImageTowerSpec(size=32),))
    params = model.init_params(torch.Generator(device="cuda").manual_seed(0))
    monkeypatch.setattr(moe, "moe_experts_plain", lambda *a, **k: pytest.fail("a CUDA tensor took the plain path"))
    frame = np.random.default_rng(2).integers(0, 256, size=(32, 32, 3), dtype=np.uint8)
    model.use_graphs = False
    _, eager, _ = model._host_predict("greedy", params, [frame], ["open the drawer"], None)
    model.use_graphs = True
    model._host_predict("greedy", params, [frame], ["open the drawer"], None)  # capture
    flash0, moe0 = flash_attention.launches, moe.moe_experts.launches
    _, replayed, _ = model._host_predict("greedy", params, [frame], ["open the drawer"], None)
    assert replayed.tolist() == eager.tolist() and len(model.graphs.entries) == 1
    assert flash_attention.launches - flash0 == 3  # each layer's prefill, the (192, 128) instance
    assert moe.moe_experts.launches - moe0 == 5 * 2 * 7  # two MoE layers: the prefill and six decode steps
    assert model.last_expert_load.sum(axis=1).tolist() == [model.last_expert_load.sum(axis=1)[0]] * 2
