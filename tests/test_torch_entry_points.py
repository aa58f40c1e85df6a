"""The port's entry points of this slice against the JAX package's scripts.

* `deploy.parse_args` takes every field of scripts/deploy.py's
  `DeployConfig` under its name, with its default; a non-local
  `--checkpoint` raises with the pre-stage message; without a card and
  without `--device cpu` it raises; unported switches are refused.
* `deploy --checkpoint <tiny exported dir> --device cpu` answers /act with
  the JAX package's `predict_action` of the same checkpoint loaded the same
  way (bf16, quantization off, greedy): actions within 1e-6, ids equal.
* `convert_weights --direction to_hf` on a tiny port run dir (a LoRA state
  saved with `only_trainable_mask`) writes a checkpoint that the JAX
  `load_vla` reads with leaves bit-equal to the run's merged params.
* `--tokenizer_path`: the port's tokenizer.json reader gives the `tokenizers`
  library's ids and text on a Llama-style tokenizer (SentencePiece BPE, byte
  fallback; normalizer and Metaspace variants) built here.
* No module of the port imports safetensors, transformers,
  huggingface_hub, tensorflow, tensorflow_datasets, dlimp, PIL or JAX (an
  AST scan, as tests/test_torch_package.py scans for jax).
"""

import dataclasses
import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import bridgelang_tpu_torch
import bridgelang_tpu_torch.models.vlm as tvlm
from bridgelang_tpu.models import load as jload
from bridgelang_tpu.models.llm.tokenizer import ByteFallbackTokenizer as JTokenizer
from bridgelang_tpu_torch import convert_weights, deploy
from bridgelang_tpu_torch.convert import params_from_jax
from bridgelang_tpu_torch.ops import image_ops as timg
from bridgelang_tpu_torch.serving.server import client_act
from tests.test_torch_load import (  # noqa: F401 (fixtures)
    INSTRUCTIONS, TOWERS, assert_bit_equal, ckpts, frames, registries, set_transform)
from tests.test_torch_package import _imported_roots

ROOT = Path(__file__).resolve().parent.parent


def _jax_deploy_config():
    import sys

    spec = importlib.util.spec_from_file_location("jax_deploy_script", ROOT / "scripts" / "deploy.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # dataclasses resolve annotations through it
    try:
        spec.loader.exec_module(mod)
    finally:
        del sys.modules[spec.name]
    return mod.DeployConfig


def test_parse_args_takes_every_deploy_config_field():
    cfg_cls = _jax_deploy_config()
    defaults = vars(deploy.parse_args([]))
    for f in dataclasses.fields(cfg_cls):
        want = f.default
        assert f.name in defaults, f.name
        assert defaults[f.name] == want, (f.name, defaults[f.name], want)
        value = {bool: "true", int: "3", float: "0.5"}.get(type(want), "x")
        assert f.name in vars(deploy.parse_args([f"--{f.name}", value]))


def test_deploy_refuses_what_it_cannot_serve(ckpts, registries, monkeypatch):
    with pytest.raises(FileNotFoundError, match="openvla/openvla-7b.*zero-egress"):
        deploy.build_server(deploy.parse_args(["--device", "cpu"]))
    for flag, value in (("--int4_shards", "2"), ("--mesh_spec", "tensor=2")):
        with pytest.raises(ValueError, match=flag):
            deploy.build_server(deploy.parse_args(["--checkpoint", str(ckpts["single"][2]), "--device", "cpu",
                                                   flag, value]))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        deploy.build_server(deploy.parse_args(["--checkpoint", str(ckpts["single"][2])]))


def test_deploy_serves_the_int8_kv_cache_without_the_speculative_default():
    """`deploy --kv_cache_int8 true` on the smoke model: the model decodes
    over the int8 cache, the server's speculative default is off (the JAX
    deploy turns it off too), and /act answers what an eager predict over
    that cache gives."""
    server = deploy.build_server(deploy.parse_args(
        ["--random_init_for_smoke", "true", "--device", "cpu", "--kv_cache_int8", "true", "--warmup", "false"]))
    model, params = server.model, server.params
    assert model.cache_dtype == torch.int8 and not server.speculative_default and model.cfg.llm.w8a8
    img = np.random.default_rng(5).integers(0, 256, size=(64, 64, 3), dtype=np.uint8)
    httpd = server.serve_background(port=0)
    try:
        got, tokens = client_act("127.0.0.1", httpd.server_address[1], img, "pick up the red block",
                                 return_tokens=True)
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.close()
    assert tokens is None  # a greedy answer: a speculative one carries its ids
    assert np.asarray(got).shape == (7,) and np.isfinite(got).all()
    np.testing.assert_array_equal(np.asarray(got, np.float32), model.predict_action(params, img, "pick up the red block"))
    assert server.stats()["requests"] == 1


def test_deploy_checkpoint_serves_what_jax_predicts(ckpts, registries, monkeypatch):
    tiny = timg.ImageTransformConfig("resize-naive", tuple(timg.ImageTowerSpec(*t) for t in TOWERS["fused"]))
    monkeypatch.setattr(tvlm, "transform_config_for_backbone", lambda *a: tiny)
    path = str(ckpts["fused"][2])
    server = deploy.build_server(deploy.parse_args(
        ["--checkpoint", path, "--device", "cpu", "--quantize_int8", "false", "--speculative_default", "false"]))
    jm, jp = jload.load_vla(path, quantize_int8=False)
    set_transform(jm, "fused")
    jm.tokenizer = JTokenizer()
    assert server.model.dtype == torch.bfloat16 and not server.model.cfg.llm.w8a8
    httpd = server.serve_background(port=0)
    try:
        for img, instruction in zip(frames(2, seed=7), INSTRUCTIONS):
            got = client_act("127.0.0.1", httpd.server_address[1], img, instruction)
            np.testing.assert_allclose(got, np.asarray(jm.predict_action(jp, img, instruction)), atol=1e-6, rtol=0)
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.close()


def test_convert_to_hf_of_a_lora_run_reads_in_jax(ckpts, registries, tmp_path):
    from bridgelang_tpu_torch.models.load import load_vla
    from bridgelang_tpu_torch.training.checkpointing import CheckpointManager, save_sidecars
    from bridgelang_tpu_torch.training.lora import add_lora_params, lora_trainable_mask, merge_lora
    from bridgelang_tpu_torch.training.trainer import OptimConfig, init_train_state, make_optimizer

    src = ckpts["fused"][2]
    model, params = load_vla(str(src), device="cpu")
    g = torch.Generator().manual_seed(3)
    llm = add_lora_params(g, params["llm"], rank=4)
    for lp in llm["layers"]:
        for k in [k for k in lp if k.endswith("_lora_b")]:
            lp[k].normal_(0.0, 0.05, generator=g)
    params = dict(params, llm=llm)
    mask = lora_trainable_mask(params)
    state = init_train_state(params, make_optimizer(OptimConfig(), params, trainable_mask=mask), trainable_mask=mask)
    run = tmp_path / "run"
    save_sidecars(run, {"vla_id": "debug"}, model.norm_stats)
    CheckpointManager(run).save(state, step=3, epoch=0, loss=1.25, only_trainable_mask=mask)

    with pytest.raises(ValueError, match="source_hf"):
        convert_weights.main(["--direction", "to_hf", "--run_dir", str(run), "--out_dir", str(tmp_path / "x"),
                              "--device", "cpu"])
    out = tmp_path / "hf"
    convert_weights.main(["--direction", "to_hf", "--run_dir", str(run), "--out_dir", str(out),
                          "--source_hf", str(src), "--device", "cpu"])
    merged = dict(params, llm=merge_lora(params["llm"]))
    jm, jp = jload.load_vla(str(out))  # bf16, as the run
    assert_bit_equal(params_from_jax(jax.tree.map(np.asarray, jp)), merged)
    assert jm.norm_stats == model.norm_stats
    _, verified = convert_weights.verify_hf(convert_weights.ConvertConfig(direction="verify_hf",
                                                                          checkpoint=str(out), device="cpu"))
    assert_bit_equal(verified, merged)


def test_port_imports_no_checkpoint_libraries():
    """Nor TensorFlow, TFDS, dlimp, PIL or JAX: the card has none of them, and
    the data pipeline and the finetune / train entry points must run there."""
    pkg = Path(bridgelang_tpu_torch.__file__).resolve().parent
    files = sorted(pkg.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for new in ("finetune.py", "train.py", "native/__init__.py", "vla/materialize.py", "vla/datasets/native_loader.py",
                "vla/datasets/rlds/dataset.py", "vla/datasets/rlds/obs_transforms.py",
                "vla/datasets/rlds/oxe/transforms.py", "vla/datasets/rlds/utils/data_utils.py", "pretrain.py",
                "preprocess.py", "generate.py", "demo.py", "native/image.py", "preprocessing/__init__.py",
                "preprocessing/datasets.py", "preprocessing/materialize.py", "preprocessing/download.py",
                "util/profiling.py", "verify.py", "inspect_checkpoint.py", "experiments/robot/robot_utils.py",
                "experiments/robot/openvla_utils.py", "experiments/robot/libero/run_libero_eval.py",
                "experiments/robot/libero/regenerate_libero_dataset.py", "experiments/robot/bridge/widowx_env.py",
                "experiments/robot/bridge/bridgev2_utils.py", "experiments/robot/bridge/run_bridgev2_eval.py"):
        assert pkg / new in files, new
    banned = {"safetensors", "transformers", "huggingface_hub", "tensorflow", "tensorflow_datasets", "dlimp", "PIL",
              "jax", "jaxlib", "bridgelang_tpu"}
    bad = {str(f.relative_to(ROOT)): sorted(set(_imported_roots(f)) & banned) for f in files}
    assert not {f: m for f, m in bad.items() if m}


TOKENIZER_TEXTS = ["In: What action should the robot take to pick up the red block?\nOut:", "put the spoon  on the towel",
                   " leading space", "", "a", "é中 unicode ✓ bytes", "open the drawer\tand\nmove the blue cup"]


def _llama_style_tokenizer(tmp_path, metaspace: bool):
    tokenizers = pytest.importorskip("tokenizers")
    from tokenizers import decoders, models, normalizers, pre_tokenizers, processors, trainers

    tok = tokenizers.Tokenizer(models.BPE(unk_token="<unk>", byte_fallback=True, fuse_unk=True))
    if metaspace:
        tok.pre_tokenizer = pre_tokenizers.Metaspace(replacement="▁", prepend_scheme="first", split=True)
    else:
        tok.normalizer = normalizers.Sequence([normalizers.Prepend("▁"), normalizers.Replace(" ", "▁")])
    tok.decoder = decoders.Sequence([decoders.Replace("▁", " "), decoders.ByteFallback(), decoders.Fuse(),
                                     decoders.Strip(" ", 1, 0)])
    special = ["<unk>", "<s>", "</s>"] + [f"<0x{i:02X}>" for i in range(256)]
    trainer = trainers.BpeTrainer(vocab_size=700, special_tokens=special, limit_alphabet=60)
    tok.train_from_iterator([t for t in TOKENIZER_TEXTS[:3] + TOKENIZER_TEXTS[6:] for _ in range(20)], trainer)
    tok.post_processor = processors.TemplateProcessing(single="<s> $A", special_tokens=[("<s>", 1)])
    (tmp_path / "tok").mkdir()
    tok.save(str(tmp_path / "tok" / "tokenizer.json"))
    return tok, tmp_path / "tok"


@pytest.mark.parametrize("metaspace", [False, True])
def test_tokenizer_json_reader_matches_tokenizers(tmp_path, metaspace):
    from bridgelang_tpu_torch.models.llm.tokenizer import get_tokenizer

    ref, path = _llama_style_tokenizer(tmp_path, metaspace)
    ours = get_tokenizer(str(path))
    assert ours.vocab_size == ref.get_vocab_size() and ours.pad_token_id == ref.get_vocab_size()
    assert ours.bos_token_id == 1 and ours.eos_token_id == 2
    for text in TOKENIZER_TEXTS:
        want = ref.encode(text).ids
        assert ours(text).input_ids == want, text
        assert ours.decode(want) == ref.decode(want), text
    assert any(ours.id_to_token[i].startswith("<0x") for i in ours.encode(TOKENIZER_TEXTS[5]))
