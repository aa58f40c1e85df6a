"""The fine-tuning entry point on the card: launch counts of the flash kernels.

Both tests carry the `gpu` marker and skip without a CUDA card. The file
imports neither JAX nor the JAX package, so it runs on a GPU machine:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_finetune_gpu.py -q

* `finetune.main` on a tiny checkpoint (written by the port's exporter) and
  a tiny native store, on CUDA by default: each LoRA step launches
  `flash_fwd` twice per decoder layer (forward, and again under remat) and
  each backward kernel once per layer, as the causal training path does.
* One train step of the parallel_actions objective launches no flash
  kernel: its general mask runs the masked attention.
"""

import dataclasses

import numpy as np
import pytest
import torch

import bridgelang_tpu_torch.models.llm.llama as tllama
import bridgelang_tpu_torch.models.vision.vit as tvit
import bridgelang_tpu_torch.models.vlm as tvlm
from bridgelang_tpu_torch import finetune, native
from bridgelang_tpu_torch.conf import parse_cli
from bridgelang_tpu_torch.extern.hf_export import export_checkpoint
from bridgelang_tpu_torch.models.llm.tokenizer import ByteFallbackTokenizer
from bridgelang_tpu_torch.models.vla import OpenVLA
from bridgelang_tpu_torch.models.vlm import VLMConfig
from bridgelang_tpu_torch.ops import image_ops as timg
from bridgelang_tpu_torch.ops.flash_attention import flash_attention, flash_bwd_dkv, flash_bwd_dq
from bridgelang_tpu_torch.training import lora as tlora
from bridgelang_tpu_torch.training import trainer as ttrainer
from bridgelang_tpu_torch.vla.action_tokenizer import ActionTokenizer
from bridgelang_tpu_torch.vla.datasets import datasets as tds
from bridgelang_tpu_torch.vla.datasets.native_loader import write_episode

DINO = dict(image_size=32, patch_size=8, width=32, depth=2, num_heads=4, mlp_dim=64,
            use_cls_token=True, num_reg_tokens=4, no_embed_class=True, layerscale_init=1e-5)
SIG = dict(image_size=32, patch_size=8, width=48, depth=2, num_heads=4, mlp_dim=96,
           use_cls_token=False, act="gelu_tanh")
LLM = dict(vocab_size=32000, padded_vocab_size=32064, dim=256, n_layers=2, n_heads=4, n_kv_heads=2,
           intermediate_size=512)
TOWERS = ((32, timg.IMAGENET_DEFAULT_MEAN, timg.IMAGENET_DEFAULT_STD), (32, timg.INCEPTION_MEAN, timg.INCEPTION_STD))
COUNTED = (flash_attention, flash_bwd_dq, flash_bwd_dkv)


@pytest.fixture
def tiny(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash kernels have no CPU build")
    monkeypatch.setitem(tvit.VIT_CONFIGS, "dinov2-vit-l", tvit.ViTConfig(**DINO))
    monkeypatch.setitem(tvit.VIT_CONFIGS, "siglip-vit-so400m", tvit.ViTConfig(**SIG))
    monkeypatch.setitem(tllama.LLM_CONFIGS, "llama2-7b-pure", tllama.LLMConfig(**LLM))
    transform = timg.ImageTransformConfig("resize-naive", tuple(timg.ImageTowerSpec(*t) for t in TOWERS))
    monkeypatch.setattr(tvlm, "transform_config_for_backbone", lambda *a: transform)
    cfg = dataclasses.replace(VLMConfig(), llm=tllama.LLMConfig(**LLM),
                              vision_override=(tvit.ViTConfig(**DINO), tvit.ViTConfig(**SIG)))
    model = OpenVLA(cfg, {}, tokenizer=ByteFallbackTokenizer(), dtype=torch.float32, device="cuda")
    model.image_transform = transform
    return model, model.init_params(torch.Generator(device="cuda").manual_seed(0))


def _counts():
    return [fn.launches for fn in COUNTED]


@pytest.mark.gpu
def test_finetune_main_launches_the_flash_kernels_per_layer(tiny, tmp_path, monkeypatch):
    model, params = tiny
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    ckpt = export_checkpoint(model, params, tmp_path / "ckpt")
    store = tmp_path / "data" / "libero_spatial_no_noops"
    store.mkdir(parents=True)
    rng = np.random.default_rng(0)
    with native.TFRecordWriter(store / "a.tfrecord") as w:
        for ep in range(2):
            write_episode(w, images=rng.integers(0, 256, (6, 40, 40, 3), dtype=np.uint8),
                          actions=rng.uniform(-1, 1, (6, 7)).astype(np.float32),
                          states=rng.normal(size=(6, 8)).astype(np.float32), language="pick up the red block")
    steps = 2
    before = _counts()
    run = finetune.main(parse_cli(finetune.FinetuneConfig, [
        "--vla_path", str(ckpt), "--data_root_dir", str(tmp_path / "data"), "--run_root_dir", str(tmp_path / "runs"),
        "--batch_size", "2", "--max_steps", str(steps), "--lora_rank", "4", "--shuffle_buffer_size", "4",
        "--export_hf", "false"]))
    n = LLM["n_layers"]
    assert [a - b for a, b in zip(_counts(), before)] == [2 * n * steps, n * steps, n * steps]
    assert (run / "checkpoints").exists()


@pytest.mark.gpu
def test_parallel_objective_step_launches_no_flash_kernel(tiny):
    model, params = tiny
    params = dict(params, llm=tlora.add_lora_params(torch.Generator(device="cuda").manual_seed(1), params["llm"],
                                                    rank=4))
    mask = tlora.lora_trainable_mask(params)
    opt = ttrainer.make_optimizer(ttrainer.OptimConfig(), params, trainable_mask=mask)
    state = ttrainer.init_train_state(params, opt, trainable_mask=mask)
    tok = ByteFallbackTokenizer()
    transform = tds.RLDSBatchTransform(ActionTokenizer(tok), tok)
    batch = tds.PaddedCollatorForActionPrediction(max_length=96)(list(tds.DummyDataset(transform, n=2, image_hw=(32, 32))))
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in batch.items() if k != "dataset_names"}
    for objective, want in ((True, [0, 0, 0]), (False, [2 * LLM["n_layers"], LLM["n_layers"], LLM["n_layers"]])):
        step = ttrainer.make_vla_train_step(model, opt, trainable_mask=mask, compute_dtype=torch.float32,
                                            image_transform=model.image_transform, remat_policy="full",
                                            parallel_decode_objective=objective)
        before = _counts()
        state, m = step(state, batch)
        assert np.isfinite(float(m["loss"]))
        assert [a - b for a, b in zip(_counts(), before)] == want
