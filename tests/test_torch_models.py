"""Port modules vs their JAX counterparts on the CPU, fp32, at tiny sizes.

Parameters are drawn by the JAX package, converted with
`bridgelang_tpu_torch.convert`, and both packages run the same numpy inputs.
Tolerances: ViT / projector / decoder atol 1e-4 (fp32 sums in another order
through a few layers), preprocessing atol 5e-5 (the two bicubic antialias
resamplers agree to ~4e-6 on [0, 1] images, then normalization divides by
std >= 0.22).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from bridgelang_tpu.models.llm import llama as jllama
from bridgelang_tpu.models.projector import apply_projector, init_projector_params
from bridgelang_tpu.models.vision.vit import FusedViT as JFusedViT
from bridgelang_tpu.models.vision.vit import ViT as JViT
from bridgelang_tpu.models.vision.vit import ViTConfig as JViTConfig
from bridgelang_tpu.ops import image_ops as jimg
from bridgelang_tpu_torch.convert import llm_params_from_jax, projector_state_from_jax, vision_state_from_jax
from bridgelang_tpu_torch.models.llm import llama as tllama
from bridgelang_tpu_torch.models.projector import Projector
from bridgelang_tpu_torch.models.vision.vit import FusedViT, ViT, ViTConfig
from bridgelang_tpu_torch.ops import image_ops as timg
from tests.helpers import TINY_LLM

# The tiny dual-tower geometry of tests/test_e2e_torch_parity.py.
DINO = dict(image_size=32, patch_size=8, width=32, depth=4, num_heads=4, mlp_dim=128,
            use_cls_token=True, num_reg_tokens=4, no_embed_class=True, layerscale_init=1e-5)
SIG = dict(image_size=32, patch_size=8, width=48, depth=4, num_heads=4, mlp_dim=96,
           use_cls_token=False, act="gelu_tanh")
CLIP = dict(image_size=32, patch_size=8, width=32, depth=3, num_heads=2, mlp_dim=64,
            use_cls_token=True, act="quick_gelu", pre_norm=True, ln_eps=1e-5)
TOL = dict(atol=1e-4, rtol=1e-4)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _torch_state(state):
    return {k: torch.from_numpy(np.array(v)) for k, v in state.items()}


def _pixels(b, c, size, seed=0):
    return np.random.default_rng(seed).normal(size=(b, c, size, size)).astype(np.float32)


def _visible_layerscale(tower):
    """LayerScale at its 1e-5 init would hide the blocks: raise it so they show."""
    blocks = tower["blocks"]
    return dict(tower, blocks=dict(blocks, ls1=blocks["ls1"] + 0.5, ls2=blocks["ls2"] + 0.5))


def test_clip_vit_matches_jax():
    """The single-tower ViT with quick_gelu, pre-norm and a class token under
    the position embedding (DINOv2 and SigLIP run in the fused test)."""
    kw = CLIP
    jm = JViT(JViTConfig(**kw))
    x = _pixels(2, 3, 32, seed=1)
    jparams = jm.init(jax.random.key(1), jnp.zeros((1, 3, 32, 32)))["params"]
    jout = np.asarray(jm.apply({"params": jparams}, jnp.asarray(x)))

    module = ViT(ViTConfig(**kw), device="meta")
    tout = functional_call(module, _torch_state(vision_state_from_jax(_np(jparams))), (torch.from_numpy(x),))
    assert tout.shape == jout.shape == (2, 16, kw["width"])
    np.testing.assert_allclose(tout.numpy(), jout, **TOL)


def test_fused_vit_matches_jax():
    jm = JFusedViT(JViTConfig(**DINO), JViTConfig(**SIG))
    x = _pixels(2, 6, 32, seed=3)
    jparams = jm.init(jax.random.key(2), jnp.zeros((1, 6, 32, 32)))["params"]
    jparams = dict(jparams, featurizer=_visible_layerscale(jparams["featurizer"]))
    jout = np.asarray(jm.apply({"params": jparams}, jnp.asarray(x)))
    module = FusedViT(ViTConfig(**DINO), ViTConfig(**SIG), device="meta")
    state = _torch_state(vision_state_from_jax(_np(jparams)))
    assert set(state) == {n for n, _ in module.named_parameters()}
    tout = functional_call(module, state, (torch.from_numpy(x),))
    assert tout.shape == (2, 16, 80)
    np.testing.assert_allclose(tout.numpy(), jout, **TOL)


@pytest.mark.parametrize("arch", ["no-align+linear", "gelu-mlp", "no-align+fused-gelu-mlp"])
def test_projector_matches_jax(arch):
    jp = init_projector_params(jax.random.key(3), arch, 80, 64)
    x = np.random.default_rng(4).normal(size=(2, 16, 80)).astype(np.float32)
    jout = np.asarray(apply_projector(jp, jnp.asarray(x)))
    module = Projector(arch, 80, 64, device="meta")
    tout = functional_call(module, _torch_state(projector_state_from_jax(_np(jp))), (torch.from_numpy(x),))
    np.testing.assert_allclose(tout.numpy(), jout, **TOL)


@pytest.mark.parametrize("strategy", ["resize-naive", "resize-crop", "letterbox"])
@pytest.mark.parametrize("hw", [(60, 90), (90, 61), (20, 28)])
def test_preprocess_batch_matches_jax(strategy, hw):
    towers = (timg.ImageTowerSpec(32, timg.IMAGENET_DEFAULT_MEAN, timg.IMAGENET_DEFAULT_STD),
              timg.ImageTowerSpec(32, timg.INCEPTION_MEAN, timg.INCEPTION_STD))
    jtowers = tuple(jimg.ImageTowerSpec(t.size, t.mean, t.std) for t in towers)
    frames = np.random.default_rng(5).integers(0, 256, size=(2, *hw, 3), dtype=np.uint8)
    jout = np.asarray(jimg.preprocess_batch(jnp.asarray(frames), jimg.ImageTransformConfig(strategy, jtowers)))
    tout = timg.preprocess_batch(torch.from_numpy(frames), timg.ImageTransformConfig(strategy, towers))
    assert tout.shape == jout.shape == (2, 6, 32, 32)
    np.testing.assert_allclose(tout.numpy(), jout, atol=5e-5, rtol=0)


def test_transform_config_table_matches_jax():
    for bid in ("dinosiglip-vit-so-224px", "dinoclip-vit-l-336px", "siglip-vit-b16-256px", "in1k-vit-l"):
        a = jimg.transform_config_for_backbone(bid, "letterbox")
        b = timg.transform_config_for_backbone(bid, "letterbox")
        assert [dataclasses.asdict(t) for t in a.towers] == [dataclasses.asdict(t) for t in b.towers]


# --- decoder ------------------------------------------------------------------


@pytest.fixture(scope="module")
def llm_pair():
    jp = jllama.init_llm_params(jax.random.key(5), TINY_LLM)
    tcfg = tllama.LLMConfig(**dataclasses.asdict(TINY_LLM))
    return jp, llm_params_from_jax(_np(jp)), tcfg


def _causal(lengths, t, s):
    q = np.arange(t)[:, None]
    k = np.arange(s)[None, :]
    valid = k[None] < np.asarray(lengths)[:, None, None]
    return ((k <= q)[None] & valid)[:, None]  # [B, 1, T, S]


def test_llm_forward_no_cache_matches_jax(llm_pair):
    jp, tp, tcfg = llm_pair
    rng = np.random.default_rng(6)
    b, t = 2, 12
    emb = rng.normal(size=(b, t, TINY_LLM.dim)).astype(np.float32)
    pos = np.broadcast_to(np.arange(t), (b, t)).copy()
    mask = _causal([12, 7], t, t)
    jh, _ = jllama.llm_forward(jp, TINY_LLM, jnp.asarray(emb), jnp.asarray(pos), jnp.asarray(mask))
    th, cache = tllama.llm_forward(tp, tcfg, torch.from_numpy(emb), torch.from_numpy(pos), torch.from_numpy(mask))
    assert cache is None
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    jl = np.asarray(jllama.lm_logits(jp, jh, TINY_LLM))
    tl = tllama.lm_logits(tp, th, tcfg).numpy()
    assert tl.shape[-1] == TINY_LLM.padded_vocab_size
    np.testing.assert_allclose(tl, jl, **TOL)


@pytest.mark.parametrize("cache_write", ["contiguous", "scatter"])
def test_llm_forward_cache_then_decode_matches_jax(llm_pair, cache_write):
    jp, tp, tcfg = llm_pair
    rng = np.random.default_rng(7)
    b, t, s = 2, 10, 14
    lengths = [10, 6]
    emb = rng.normal(size=(b, t, TINY_LLM.dim)).astype(np.float32)
    pos = np.broadcast_to(np.arange(t), (b, t)).copy()
    # contiguous: chunk-extent mask; scatter: the chunk attends the whole cache
    mask = _causal(lengths, t, t if cache_write == "contiguous" else s)
    jc = jllama.init_kv_cache(TINY_LLM, b, s)
    tc = tllama.init_kv_cache(tcfg, b, s)
    jh, jc = jllama.llm_forward(jp, TINY_LLM, jnp.asarray(emb), jnp.asarray(pos), jnp.asarray(mask),
                                cache=jc, cache_positions=jnp.asarray(pos), cache_write=cache_write)
    th, tc = tllama.llm_forward(tp, tcfg, torch.from_numpy(emb), torch.from_numpy(pos), torch.from_numpy(mask),
                                cache=tc, cache_positions=torch.from_numpy(pos), cache_write=cache_write)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    for key in ("k", "v"):  # bf16 storage: at most one bf16 rounding step apart
        np.testing.assert_allclose(tc[key].float().numpy(), np.asarray(jc[key], np.float32), atol=1e-4, rtol=2 ** -7)

    # One decode step at slot lengths[b] over each side's own cache.
    tok = rng.normal(size=(b, 1, TINY_LLM.dim)).astype(np.float32)
    dpos = np.asarray(lengths)[:, None]
    dmask = (np.arange(s)[None, None, None, :] <= dpos[:, :, None, None])
    jh2, _ = jllama.llm_forward(jp, TINY_LLM, jnp.asarray(tok), jnp.asarray(dpos), jnp.asarray(dmask),
                                cache=jc, cache_positions=jnp.asarray(dpos))
    th2, _ = tllama.llm_forward(tp, tcfg, torch.from_numpy(tok), torch.from_numpy(dpos), torch.from_numpy(dmask),
                                cache=tc, cache_positions=torch.from_numpy(dpos))
    np.testing.assert_allclose(th2.numpy(), np.asarray(jh2), **TOL)


def test_building_blocks_match_jax():
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 5, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 300, size=(2, 5))
    jc, js = jllama.rope_cos_sin(jnp.asarray(pos), 16, 10000.0)
    tc, ts = tllama.rope_cos_sin(torch.from_numpy(pos), 16, 10000.0)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)
    jr = jllama.apply_rope(jnp.asarray(x), jc, js, 16)
    tr = tllama.apply_rope(torch.from_numpy(x), tc, ts, 16)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-5)
    w = rng.normal(size=(16,)).astype(np.float32)
    np.testing.assert_allclose(tllama.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5).numpy(),
                               np.asarray(jllama.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)), atol=1e-5)
    k = rng.normal(size=(2, 9, 2, 16)).astype(np.float32)
    m = rng.random(size=(2, 1, 5, 9)) < 0.7
    m[..., 0] = True
    np.testing.assert_allclose(
        tllama.cached_attention(torch.from_numpy(x), torch.from_numpy(k), torch.from_numpy(k), torch.from_numpy(m)).numpy(),
        np.asarray(jllama.cached_attention(jnp.asarray(x), jnp.asarray(k), jnp.asarray(k), jnp.asarray(m))), atol=1e-5)


def test_unported_llm_options_raise():
    """Every registered LLM is ported (the registries match, but for the
    port's own decoders, which the JAX package lacks); what the kernels
    still refuse is a head dim outside KERNEL_HEAD_DIMS, checked before the
    device (a CPU tensor at a kernel head dim is refused for its device
    instead)."""
    from bridgelang_tpu_torch.ops import flash_attention as tfa

    own = {"deepseek-v2-lite-pure"}  # the port's own decoder
    shared = {k: v for k, v in tllama.LLM_CONFIGS.items() if k not in own}
    assert own <= set(tllama.LLM_CONFIGS) and not own & set(jllama.LLM_CONFIGS)
    assert shared == {k: tllama.LLMConfig(**dataclasses.asdict(v)) for k, v in jllama.LLM_CONFIGS.items()}
    assert tfa.KERNEL_HEAD_DIMS == (64, 80, 128)
    assert {c.head_dim for c in tllama.LLM_CONFIGS.values()} <= set(tfa.KERNEL_HEAD_DIMS)
    lengths = torch.tensor([4], dtype=torch.int32)
    for d, match in ((96, "head dims"), (80, "CUDA device")):
        q = torch.zeros((1, 4, 2, d), dtype=torch.bfloat16)
        with pytest.raises(ValueError, match=match):
            tfa._launch(q, q, q, lengths, True, None)
