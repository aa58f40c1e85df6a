"""The port's `load_vla` against the JAX package's, on checkpoints that the JAX
`export_checkpoint` writes locally (tiny fused and single-tower OpenVLAs; fp32
safetensors, the JAX exporter's contract). Nothing is downloaded.

Loaded leaves must equal `params_from_jax(jax load_vla leaves)` bit for bit
(same dtype, same bits) at fp32 and bf16, and quantized on load to int8 and
int4 (groups 128 and 256; w8a8 on and off). The loaded fp32 model's greedy
ids must equal the JAX package's exactly, its actions to 1e-6.

The checkpoints are written once per session (the JAX models built with
their tiny towers given explicitly). A test that loads one patches the
registries under the real ids for its own duration (`registries`), as
tests/test_lifecycle.py does: `VIT_CONFIGS` and `LLM_CONFIGS` of both
packages. Other test files import the fixtures and helpers from here.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bridgelang_tpu.models.llm.llama as jllama
import bridgelang_tpu.models.load as jload
import bridgelang_tpu.models.vision.vit as jvit
import bridgelang_tpu_torch.models.llm.llama as tllama
import bridgelang_tpu_torch.models.vision.vit as tvit
from bridgelang_tpu.extern.hf_export import export_checkpoint as jax_export
from bridgelang_tpu.models.llm.tokenizer import ByteFallbackTokenizer as JTokenizer
from bridgelang_tpu.models.vla import OpenVLA as JOpenVLA
from bridgelang_tpu.models.vlm import VLMConfig as JVLMConfig
from bridgelang_tpu.ops import image_ops as jimg
from bridgelang_tpu_torch.convert import params_from_jax
from bridgelang_tpu_torch.models import load as tload
from bridgelang_tpu_torch.models.llm.tokenizer import ByteFallbackTokenizer
from bridgelang_tpu_torch.ops import image_ops as timg
from tests.helpers import TINY_NORM_STATS

DINO = dict(image_size=32, patch_size=8, width=32, depth=4, num_heads=4, mlp_dim=128,
            use_cls_token=True, num_reg_tokens=4, no_embed_class=True, layerscale_init=1e-5)
SIG = dict(image_size=32, patch_size=8, width=48, depth=4, num_heads=4, mlp_dim=96,
           use_cls_token=False, act="gelu_tanh")
# The real vocabulary (the byte tokenizer and the action range fit); widths
# that let int4 take groups of 128 and 256.
LLM = dict(vocab_size=32000, padded_vocab_size=32064, dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
           intermediate_size=256)
TOWERS = {"fused": ((32, jimg.IMAGENET_DEFAULT_MEAN, jimg.IMAGENET_DEFAULT_STD),
                    (32, jimg.INCEPTION_MEAN, jimg.INCEPTION_STD)),
          "single": ((32, jimg.INCEPTION_MEAN, jimg.INCEPTION_STD),)}
BACKBONE = {"fused": "dinosiglip-vit-so-224px", "single": "siglip-vit-so400m"}
INSTRUCTIONS = ["pick up the red block", "put the small spoon on the towel next to the blue cup"]


def patch_registries(mp):
    """Tiny configs under the real ids, in both packages."""
    for pkg in (jvit, tvit):
        mp.setitem(pkg.VIT_CONFIGS, "dinov2-vit-l", pkg.ViTConfig(**DINO))
        mp.setitem(pkg.VIT_CONFIGS, "siglip-vit-so400m", pkg.ViTConfig(**SIG))
    mp.setitem(jllama.LLM_CONFIGS, "llama2-7b-pure", jllama.LLMConfig(**LLM))
    mp.setitem(tllama.LLM_CONFIGS, "llama2-7b-pure", tllama.LLMConfig(**LLM))


def jax_tiny_vla(kind: str, seed: int = 0):
    """A JAX OpenVLA under the real backbone ids with the tiny towers, its
    LM head's action columns scaled so greedy decoding lands in the action
    range."""
    towers = (jvit.ViTConfig(**DINO), jvit.ViTConfig(**SIG)) if kind == "fused" else jvit.ViTConfig(**SIG)
    cfg = dataclasses.replace(JVLMConfig(vision_backbone_id=BACKBONE[kind], arch_specifier="no-align+fused-gelu-mlp"),
                              llm=jllama.LLMConfig(**LLM), vision_override=towers)
    model = JOpenVLA(cfg, TINY_NORM_STATS, tokenizer=JTokenizer(), dtype=jnp.float32)
    set_transform(model, kind)
    params = model.init_params(jax.random.key(seed))
    params["llm"]["lm_head"] = params["llm"]["lm_head"].at[:, 31744:32000].multiply(8.0)
    return model, params


def set_transform(model, kind: str):
    mod = jimg if isinstance(model, JOpenVLA) else timg
    model.image_transform = mod.ImageTransformConfig("resize-naive", tuple(mod.ImageTowerSpec(*t) for t in TOWERS[kind]))


def frames(n, seed):
    return list(np.random.default_rng(seed).integers(0, 256, size=(n, 48, 64, 3), dtype=np.uint8))


_CKPTS = {}  # written once per process: the files that import this fixture share them (read-only)


@pytest.fixture
def ckpts(tmp_path_factory):
    """{"fused", "single"}: (JAX model, JAX params, exported checkpoint dir);
    callers must not modify them."""
    for kind in ("fused", "single"):
        if kind not in _CKPTS:
            model, params = jax_tiny_vla(kind)
            _CKPTS[kind] = (model, params, jax_export(model, params, tmp_path_factory.mktemp(kind)))
    return _CKPTS


@pytest.fixture
def registries(monkeypatch):
    """The tiny configs under the real ids, for one test."""
    patch_registries(monkeypatch)


def leaves(params):
    """name -> tensor over the port's params."""
    out = {f"vision.{k}": v for k, v in params["vision"].items()}
    out.update({f"projector.{k}": v for k, v in params["projector"].items()})
    llm = params["llm"]
    out.update({f"llm.{k}": v for k, v in llm.items() if k != "layers"})
    out.update({f"llm.layers.{i}.{k}": v for i, lp in enumerate(llm["layers"]) for k, v in lp.items()})
    return out


def bits(t):
    """A float tensor's bits as an integer tensor (NaN-safe equality)."""
    if not t.is_floating_point():
        return t
    return t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])


def assert_bit_equal(got, want):
    g, w = leaves(got), leaves(want)
    assert set(g) == set(w), sorted(set(g) ^ set(w))[:8]
    for k in w:
        assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, (k, g[k].dtype, w[k].dtype, g[k].shape)
        assert torch.equal(bits(g[k]), bits(w[k])), k


def jax_loaded(path, **kw):
    model, params = jload.load_vla(str(path), **kw)
    return model, params_from_jax(jax.tree.map(np.asarray, params))


@pytest.mark.parametrize("kind", ["fused", "single"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_load_vla_leaves_bit_equal_jax(ckpts, registries, kind, dtype):
    path = ckpts[kind][2]
    jmodel, want = jax_loaded(path, dtype=getattr(jnp, dtype))
    model, got = tload.load_vla(str(path), dtype=getattr(torch, dtype), device="cpu")
    assert_bit_equal(got, want)
    assert dataclasses.asdict(model.cfg.llm) == dataclasses.asdict(jmodel.cfg.llm)
    assert model.cfg.vision_backbone_id == jmodel.cfg.vision_backbone_id == BACKBONE[kind]
    assert model.norm_stats == jmodel.norm_stats
    assert model.device.type == "cpu" and model.dtype == getattr(torch, dtype)


QUANT_CASES = [dict(quantize_int8=True), dict(quantize_int8=True, w8a8=False),
               dict(quantize_int4=True), dict(quantize_int4=True, int4_group=256, w8a8=False),
               dict(quantize_int4=True, int4_shards=2)]


@pytest.mark.parametrize("kw", QUANT_CASES, ids=["int8", "int8-w8a8off", "int4-g128", "int4-g256-w8a8off",
                                                 "int4-shards2"])
def test_load_vla_quantized_bit_equal_jax(ckpts, registries, kw):
    """Quantized while loading (one projection at a time) == the JAX
    package quantizing its loaded bf16 tree; and == the port quantizing its
    own loaded bf16 tree in memory."""
    from bridgelang_tpu_torch.ops.quant import quantize_llm_int4, quantize_llm_int8

    path = ckpts["fused"][2]
    jmodel, want = jax_loaded(path, **kw)
    model, got = tload.load_vla(str(path), device="cpu", **kw)
    assert_bit_equal(got, want)
    assert model.cfg.llm.w8a8 == jmodel.cfg.llm.w8a8 == kw.get("w8a8", True)
    assert model.cfg.llm.int4_shards == jmodel.cfg.llm.int4_shards
    _, float_params = tload.load_vla(str(path), device="cpu")
    if kw.get("quantize_int4"):
        llm = quantize_llm_int4(float_params["llm"], group=kw.get("int4_group", 128),
                                n_shards=kw.get("int4_shards", 1))
    else:
        llm = quantize_llm_int8(float_params["llm"])
    assert_bit_equal(got, dict(float_params, llm=llm))


def test_norm_stats_sidecar_overrides_config(ckpts, registries, tmp_path):
    import shutil

    src = ckpts["single"][2]
    dst = tmp_path / "ckpt"
    shutil.copytree(src, dst)
    cfg = json.loads((dst / "config.json").read_text())
    stale = {"q01": [0.0] * 7, "q99": [1.0] * 7, "mask": [True] * 7}
    cfg["norm_stats"] = {"bridge_orig": {"action": stale}, "only_in_config": {"action": stale}}
    (dst / "config.json").write_text(json.dumps(cfg))
    jmodel, _ = jload.load_vla(str(dst), load_weights=False)
    model, params = tload.load_vla(str(dst), load_weights=False, device="cpu")
    assert params is None
    assert model.norm_stats == jmodel.norm_stats
    assert model.norm_stats["bridge_orig"] == TINY_NORM_STATS["bridge_orig"]  # the sidecar wins
    assert model.norm_stats["only_in_config"]["action"] == stale


def test_resolve_checkpoint_dir_contract(tmp_path):
    """Mirrors tests/test_lifecycle.py:117 (local dirs pass through; a bare id
    names `openvla/<id>` and the files to pre-stage), without any fetch."""
    assert tload.resolve_checkpoint_dir(str(tmp_path)) == tmp_path
    with pytest.raises(FileNotFoundError) as exc:
        tload.resolve_checkpoint_dir("openvla-7b-nonexistent-xyz")
    msg = str(exc.value)
    assert "openvla/openvla-7b-nonexistent-xyz" in msg and "safetensors" in msg and "zero-egress" in msg
    with pytest.raises(FileNotFoundError, match="some-org/some-model-xyz"):
        tload.resolve_checkpoint_dir("some-org/some-model-xyz")
    with pytest.raises(FileNotFoundError, match="openvla/openvla-7b.*zero-egress"):
        tload.load_vla("openvla-7b", device="cpu")
    assert tload.available_models() == jload.available_models()
    assert tload.MODEL_REGISTRY == jload.MODEL_REGISTRY


def test_loaded_fp32_predict_ids_equal_jax(ckpts, registries):
    path = ckpts["fused"][2]
    jm, jp = jload.load_vla(str(path), dtype=jnp.float32)
    tm, tp = tload.load_vla(str(path), dtype=torch.float32, device="cpu")
    for m in (jm, tm):
        set_transform(m, "fused")
    jm.tokenizer, tm.tokenizer = JTokenizer(), ByteFallbackTokenizer()
    imgs = frames(2, seed=1)
    ids, mask = tm.pad_prompt([tm.prepare_prompt_ids(t) for t in INSTRUCTIONS])
    pixels = np.array(jimg.preprocess_batch(jnp.asarray(np.stack(imgs)), jm.image_transform))
    j_ids = np.asarray(jm.generate_greedy(jp, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(pixels),
                                          max_new_tokens=7))
    t_ids = tm.generate_greedy(tp, torch.from_numpy(ids), torch.from_numpy(mask), torch.from_numpy(pixels),
                               max_new_tokens=7).numpy()
    np.testing.assert_array_equal(t_ids, j_ids)
    assert ((t_ids >= 31744) & (t_ids < 32000)).mean() > 0.5
    assert not np.array_equal(t_ids[0], t_ids[1])
    _, t_pred_ids = tm.predict_action_batch(tp, imgs, INSTRUCTIONS, return_tokens=True)
    np.testing.assert_array_equal(t_pred_ids, j_ids)


def test_bf16_checkpoint_loads_as_fp32_cast(ckpts, registries, tmp_path):
    """A published-style bf16 checkpoint (written by safetensors.torch, in
    three shards) loads equal to the fp32 checkpoint loaded at bf16."""
    import shutil

    st = pytest.importorskip("safetensors.torch")
    src = ckpts["fused"][2]
    dst = tmp_path / "bf16"
    dst.mkdir()
    for name in ("config.json", "dataset_statistics.json"):
        shutil.copy(src / name, dst / name)
    sd = {k: v.to(torch.bfloat16) for k, v in st.load_file(str(src / "model.safetensors")).items()}
    keys = sorted(sd)
    for i in range(3):
        part = {k: sd[k] for k in keys[i::3]}
        st.save_file(part, str(dst / f"model-0000{i + 1}-of-00003.safetensors"), metadata={"format": "pt"})
    _, want = tload.load_vla(str(src), device="cpu")
    _, got = tload.load_vla(str(dst), device="cpu")
    assert_bit_equal(got, want)


def test_skips_source_only_tensors_and_raises_on_missing(ckpts, registries, tmp_path):
    """Tensors a published file carries that the model never runs (towers'
    `norm`, SigLIP's `attn_pool`, the final block) are skipped; a missing
    tensor the model runs raises KeyError, a wrong shape ValueError."""
    from bridgelang_tpu_torch.util import safetensors_io as sio

    src = ckpts["fused"][2]
    sd = sio.load_file(src / "model.safetensors")
    extra = {"vision_backbone.featurizer.norm.weight": torch.ones(32),
             "vision_backbone.fused_featurizer.attn_pool.latent": torch.zeros(1, 1, 48),
             "vision_backbone.fused_featurizer.attn_pool.kv.weight": torch.zeros(96, 48)}
    for name, tensors in (("extra", {**sd, **extra}),
                          ("missing", {k: v for k, v in sd.items() if not k.endswith("layers.1.mlp.up_proj.weight")}),
                          ("shape", {**sd, "projector.fc3.bias": torch.zeros(7)})):
        d = tmp_path / name
        d.mkdir()
        for f in ("config.json", "dataset_statistics.json"):
            (d / f).write_bytes((src / f).read_bytes())
        sio.save_file(tensors, d / "model.safetensors")
    _, want = tload.load_vla(str(src), device="cpu")
    _, got = tload.load_vla(str(tmp_path / "extra"), device="cpu")
    assert_bit_equal(got, want)
    with pytest.raises(KeyError, match="layers.1.w_up"):
        tload.load_vla(str(tmp_path / "missing"), device="cpu")
    with pytest.raises(ValueError, match="projector.fc3.bias"):
        tload.load_vla(str(tmp_path / "shape"), device="cpu")


def test_load_vla_defaults_to_cuda(ckpts, registries):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tload.load_vla(str(ckpts["single"][2]))
