"""The port's pretraining entry point (bridgelang_tpu_torch/pretrain.py)
against the loop of scripts/pretrain.py, on the CPU.

A tiny VLM (dual 32-px towers and a 2-layer GQA Llama with the real
32000/32064 vocabulary, registered under the real ids in both packages for
each test) is initialised by the JAX package and handed to the port by
convert.py. The port runs its own loop (`pretrain.run`) over a LLaVA-layout
directory; the JAX side runs the JAX script's loop body (its dataset,
collator, batcher, optimizer with MultiSteps accumulation and jitted step)
over the same directory, with the stage hyperparameters picked as the JAX
script picks them. Both compute in fp32 here (the test sets the port's model
and step to fp32; the entry points' bf16 differs by design).

Tolerances, and why:
* loss and grad norm per micro-step, 4 micro-steps at grad_accum 2: rtol
  1e-5. Both sides run fp32; the JAX step attends through XLA's masked
  softmax, the port through the plain flash forward and backward, so sums
  differ in order only (as tests/test_torch_training.py).
* trainable tensors after the two updates: atol 1e-5, at the align stage's
  lr 1e-3 and the finetune stages' 2e-5 (the first update of a 4-update
  warmup-cosine schedule has lr 0, so one update moves them).
* the update itself (trained tensor after minus before), which at lr 2e-5
  is below that atol: relative error in norm, ||d_port - d_jax|| /
  ||d_jax||, at most 1e-2 for each trained tensor. AdamW's step m/sqrt(v)
  is about lr wherever the gradient is not ~0, so a wrong step size,
  schedule or weight decay moves it by 10 % or more (decay skipped on the
  norms: 13 %). Elements whose gradient is 0 but for rounding (the key part
  of a qkv bias) take a step of noise: 0.3 % of a SigLIP qkv bias's update.
* frozen tensors: bit-equal to their initial values.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import bridgelang_tpu.models.llm.llama as jllama
import bridgelang_tpu.models.vision.vit as jvit
import bridgelang_tpu.models.vlm as jvlm
import bridgelang_tpu_torch.models.llm.llama as tllama
import bridgelang_tpu_torch.models.vision.vit as tvit
import bridgelang_tpu_torch.models.vlm as tvlm
from bridgelang_tpu.conf import DatasetConfig as JDatasetConfig
from bridgelang_tpu.models.llm.tokenizer import ByteFallbackTokenizer as JTokenizer
from bridgelang_tpu.ops import image_ops as jimg
from bridgelang_tpu.preprocessing import get_dataset_and_collator as j_get_dataset_and_collator
from bridgelang_tpu.preprocessing.datasets import SplitModalityBatcher as JBatcher
from bridgelang_tpu.training import trainer as jtrainer
from bridgelang_tpu_torch import pretrain
from bridgelang_tpu_torch.conf import DatasetConfig, ModelConfig
from bridgelang_tpu_torch.convert import params_from_jax
from bridgelang_tpu_torch.ops import image_ops as timg
from bridgelang_tpu_torch.training import trainer as ttrainer
from bridgelang_tpu_torch.training.checkpointing import STATE_FILE

DINO = dict(image_size=32, patch_size=8, width=32, depth=2, num_heads=4, mlp_dim=64,
            use_cls_token=True, num_reg_tokens=4, no_embed_class=True, layerscale_init=1e-5)
SIG = dict(image_size=32, patch_size=8, width=48, depth=2, num_heads=4, mlp_dim=96,
           use_cls_token=False, act="gelu_tanh")
LLM = dict(vocab_size=32000, padded_vocab_size=32064, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
           intermediate_size=128)
TOWERS = ((32, jimg.IMAGENET_DEFAULT_MEAN, jimg.IMAGENET_DEFAULT_STD), (32, jimg.INCEPTION_MEAN, jimg.INCEPTION_STD))
MAX_LEN = 96       # llm_max_length: the collator's bucket (long chats truncate)
MICRO = 2          # per-device batch
GLOBAL = 4         # global batch: grad_accum 2
MICRO_STEPS = 4    # max_steps_override: two updates
STAGES = ["align", "finetune", "full-finetune", "last-layer-finetune"]


def _transform(mod):
    return mod.ImageTransformConfig("resize-naive", tuple(mod.ImageTowerSpec(*t) for t in TOWERS))


@pytest.fixture
def registries(monkeypatch):
    """The tiny configs under the real ids, in both packages, for one test."""
    for pkg in (jvit, tvit):
        monkeypatch.setitem(pkg.VIT_CONFIGS, "dinov2-vit-l", pkg.ViTConfig(**DINO))
        monkeypatch.setitem(pkg.VIT_CONFIGS, "siglip-vit-so400m", pkg.ViTConfig(**SIG))
    monkeypatch.setitem(jllama.LLM_CONFIGS, "llama2-7b-pure", jllama.LLMConfig(**LLM))
    monkeypatch.setitem(tllama.LLM_CONFIGS, "llama2-7b-pure", tllama.LLMConfig(**LLM))
    monkeypatch.setattr(jvlm, "transform_config_for_backbone", lambda bid, strategy: _transform(jimg))
    monkeypatch.setattr(tvlm, "transform_config_for_backbone", lambda bid, strategy: _transform(timg))


@pytest.fixture(scope="module")
def llava(tmp_path_factory):
    """A LLaVA-layout root: 8 images (JPEG and PNG, several sizes), an align
    chat.json (558k shape) and a finetune JSON (mix665k shape: multi-turn
    chats and 4 text-only ones, two longer than the bucket)."""
    root = tmp_path_factory.mktemp("llava")
    (root / "images").mkdir()
    rng = np.random.default_rng(0)
    names = []
    for i in range(8):
        h, w = (48, 64) if i % 2 else (70, 41)
        name = f"images/{i:03d}.{'png' if i == 5 else 'jpg'}"
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(root / name)
        names.append(name)
    words = "a red block on a wooden table next to the blue cup and a spoon".split()
    align = [{"id": str(i), "image": n, "conversations": [
        {"from": "human", "value": "<image>\nGive a brief description of the image."},
        {"from": "gpt", "value": " ".join(words[: 3 + i])}]} for i, n in enumerate(names)]
    finetune = [{"id": str(i), "image": n, "conversations": [
        {"from": "human", "value": "<image>\nWhat is on the table?"}, {"from": "gpt", "value": " ".join(words[i:])},
        {"from": "human", "value": "Where?"}, {"from": "gpt", "value": "left" * (i + 1)}][: 2 + 2 * (i % 2)]}
        for i, n in enumerate(names)]
    finetune += [{"id": f"t{i}", "conversations": [{"from": "human", "value": "Count."},
                                                   {"from": "gpt", "value": "one two " * (1 + 30 * (i % 2))}]}
                 for i in range(4)]
    (root / "chat.json").write_text(json.dumps(align))
    (root / "mix.json").write_text(json.dumps(finetune))
    return root


def _configs(llava, stage, lr, tmp_path, **over):
    comps = dict(align_stage_components=("chat.json", "."), finetune_stage_components=("mix.json", "."),
                 dataset_root_dir=str(llava))
    p = "align" if stage == "align" else "finetune"
    m = dataclasses.replace(ModelConfig.get("prism-dinosiglip-224px+7b"), llm_max_length=MAX_LEN,
                            **{f"{p}_global_batch_size": GLOBAL, f"{p}_per_device_batch_size": MICRO,
                               f"{p}_learning_rate": lr})
    cfg = pretrain.PretrainConfig(model=m, dataset=dataclasses.replace(DatasetConfig.get("llava-v15"), **comps),
                                  stage=stage, run_root_dir=str(tmp_path / "runs"), run_id="r", seed=3,
                                  max_steps_override=MICRO_STEPS, device="cpu", **over)
    return cfg, dataclasses.replace(JDatasetConfig.get("llava-v15"), **comps)


def _jax_stage_hparams(m, stage):
    """scripts/pretrain.py's own choice of the stage's hyperparameters."""
    if stage == "align":
        epochs, global_bsz, per_dev_bsz = m.align_epochs, m.align_global_batch_size, m.align_per_device_batch_size
        lr, wd, grad_clip = m.align_learning_rate, m.align_weight_decay, m.align_max_grad_norm
        schedule, warmup = m.align_lr_scheduler_type, m.align_warmup_ratio
    else:
        epochs, global_bsz, per_dev_bsz = m.finetune_epochs, m.finetune_global_batch_size, m.finetune_per_device_batch_size
        lr, wd, grad_clip = m.finetune_learning_rate, m.finetune_weight_decay, m.finetune_max_grad_norm
        schedule, warmup = m.finetune_lr_scheduler_type, m.finetune_warmup_ratio
    return dict(epochs=epochs, global_batch_size=global_bsz, per_device_batch_size=per_dev_bsz, learning_rate=lr,
                weight_decay=wd, max_grad_norm=grad_clip, lr_scheduler_type=schedule, warmup_ratio=warmup)


def _jax_loop(cfg, jds_cfg, jparams, stage):
    """The body of scripts/pretrain.py main, in fp32 on the given params:
    per-micro-step (loss, grad_norm) and the final params."""
    m = cfg.model
    hp = _jax_stage_hparams(m, stage)
    jcfg = jvlm.VLMConfig.from_ids(model_id=m.model_id, vision_backbone_id=m.vision_backbone_id,
                                   llm_backbone_id=m.llm_backbone_id, arch_specifier=m.arch_specifier,
                                   image_resize_strategy=m.image_resize_strategy, llm_max_length=m.llm_max_length)
    model = jvlm.PrismaticVLM(jcfg, dtype=jnp.float32)
    dataset, collator = j_get_dataset_and_collator("align" if stage == "align" else "finetune", jds_cfg, JTokenizer(),
                                                   jcfg.llm_family, max_length=m.llm_max_length,
                                                   pad_token_id=jcfg.llm.pad_token_id)
    trainable = model.trainable_mask(jparams, stage)
    grad_accum = max(1, hp["global_batch_size"] // hp["per_device_batch_size"])
    ocfg = jtrainer.OptimConfig(learning_rate=hp["learning_rate"], weight_decay=hp["weight_decay"],
                                max_grad_norm=hp["max_grad_norm"], lr_scheduler_type=hp["lr_scheduler_type"],
                                warmup_ratio=hp["warmup_ratio"], total_steps=cfg.max_steps_override)
    optimizer = jtrainer.make_optimizer(ocfg, jparams, trainable_mask=trainable, grad_accum_steps=grad_accum)
    step_fn = jax.jit(jtrainer.make_vla_train_step(model, optimizer, trainable_mask=trainable,
                                                   compute_dtype=jnp.float32, image_transform=model.image_transform,
                                                   remat_policy=cfg.remat_policy))
    state = jtrainer.init_train_state(jparams, optimizer, trainable_mask=trainable)
    batcher = JBatcher(dataset.get_modality_lengths(), hp["per_device_batch_size"], seed=cfg.seed)
    history = []
    for batch_indices in batcher.batches(0)[: cfg.max_steps_override]:
        batch = collator([dataset[i] for i in batch_indices])
        state, mtr = step_fn(state, {k: jnp.asarray(v) for k, v in batch.items() if k != "multimodal_indices"})
        history.append((float(mtr["loss"]), float(mtr["grad_norm"])))
    return history, jax.tree.map(np.asarray, state.params)


def _leaves(params):
    out = {f"vision.{k}": v for k, v in params["vision"].items()}
    out.update({f"projector.{k}": v for k, v in params["projector"].items()})
    llm = params["llm"]
    out.update({f"llm.{k}": v for k, v in llm.items() if k != "layers"})
    out.update({f"llm.layers.{i}.{k}": v for i, lp in enumerate(llm["layers"]) for k, v in lp.items()})
    return out


@pytest.mark.parametrize("stage", STAGES)
def test_pretrain_micro_steps_match_jax(registries, llava, tmp_path, monkeypatch, stage):
    lr = 1e-3 if stage == "align" else 2e-5
    cfg, jds_cfg = _configs(llava, stage, lr, tmp_path, remat_policy="full")
    jmodel = jvlm.PrismaticVLM(jvlm.VLMConfig.from_ids("m", "dinosiglip-vit-so-224px", "llama2-7b-pure",
                                                       "no-align+fused-gelu-mlp"), dtype=jnp.float32)
    jparams = jmodel.init_params(jax.random.key(0), param_dtype=jnp.float32)
    np_params = jax.tree.map(np.asarray, jparams)
    initial = _leaves(params_from_jax(np_params))
    vlm_cls = tvlm.PrismaticVLM
    monkeypatch.setattr(vlm_cls, "init_params", lambda self, gen, param_dtype=None: params_from_jax(np_params))
    monkeypatch.setattr(tvlm, "PrismaticVLM", lambda vlm_cfg, dtype=None, device=None: vlm_cls(
        vlm_cfg, dtype=torch.float32, device=device))
    history = []
    make_step = ttrainer.make_vla_train_step

    def recording_step(*a, **kw):
        step = make_step(*a, **dict(kw, compute_dtype=torch.float32))

        def run(state, batch):
            state, m = step(state, batch)
            history.append((float(m["loss"]), float(m["grad_norm"])))
            return state, m

        return run

    monkeypatch.setattr(ttrainer, "make_vla_train_step", recording_step)
    state = pretrain.run(cfg, pretrain.vlm_config(cfg.model))
    j_history, j_after = _jax_loop(cfg, jds_cfg, jparams, stage)

    assert len(history) == len(j_history) == MICRO_STEPS
    np.testing.assert_allclose(np.asarray(history), np.asarray(j_history), rtol=1e-5)
    assert state.opt_state["count"] == 2 and state.step == MICRO_STEPS

    got, want = _leaves(state.params), _leaves(params_from_jax(j_after))
    mask = _leaves(tvlm.PrismaticVLM(pretrain.vlm_config(cfg.model), device="cpu").trainable_mask(state.params, stage))
    trained = [k for k in got if mask[k]]
    assert trained and len(trained) < len(got) or stage == "full-finetune"
    for k in got:
        if not mask[k]:
            assert torch.equal(got[k], initial[k]), f"frozen {k} changed"
    moved = [k for k in trained if not torch.equal(got[k], initial[k])]
    assert moved, "no trainable tensor moved"
    for k in trained:
        np.testing.assert_allclose(got[k].detach().numpy(), want[k].numpy(), atol=1e-5, rtol=0, err_msg=k)
        d_port = got[k].detach().double() - initial[k].double()
        d_jax = want[k].double() - initial[k].double()
        rel = float(torch.linalg.vector_norm(d_port - d_jax) / torch.linalg.vector_norm(d_jax))
        assert rel <= 1e-2, f"{k}: the update differs from JAX's by {rel:.3g} in relative norm"
    if stage == "align":
        assert set(trained) == {k for k in got if k.startswith("projector.")}


def test_pretrain_main_end_to_end(registries, llava, tmp_path):
    """pretrain.main on the CPU in bf16, as a user runs it: run dir, sidecars,
    the metrics file, the epoch-end checkpoint of the whole state, the
    micro-step count under max_steps_override, a malformed --mesh_shape refused."""
    cfg, _ = _configs(llava, "align", 1e-3, tmp_path, remat_policy="dots")
    state = pretrain.main(cfg)
    run = tmp_path / "runs" / "r"
    assert json.loads((run / "config.json").read_text())["stage"] == "align"
    assert (run / "r.jsonl").exists()  # pushed every 10 micro-steps, as the JAX script: none of 4 here
    ckpts = sorted((run / "checkpoints").iterdir())
    assert [c.name.split("-loss")[0] for c in ckpts] == [f"step-{MICRO_STEPS:06d}-epoch-00"]
    assert np.isfinite(float(ckpts[0].name.split("loss=")[1]))
    saved = torch.load(ckpts[0] / STATE_FILE, map_location="cpu", weights_only=True)
    assert saved["step"] == MICRO_STEPS and saved["opt_state"]["count"] == 2
    assert torch.equal(saved["params"]["projector"]["fc1.weight"], state.params["projector"]["fc1.weight"])
    assert torch.equal(saved["params"]["llm"]["embed"], state.params["llm"]["embed"])  # the whole state
    assert len(saved["opt_state"]["mu"]) == len(state.params["projector"])
    assert (run / "latest-checkpoint.txt").read_text() == ckpts[0].name

    with pytest.raises(ValueError):  # as the JAX parse_mesh_shape: "1" is no "axis=size"
        pretrain.main(dataclasses.replace(cfg, mesh_shape="1,1"))
    assert not torch.distributed.is_initialized()


def test_pretrain_cli_matches_jax_config():
    """Every PretrainConfig field of scripts/pretrain.py, under its name and
    default, plus --device; the stage hyperparameters from the registry."""
    from tests.test_torch_pretraining_data import _load_script

    jcls = _load_script("pretrain").PretrainConfig
    jfields = {f.name: f for f in dataclasses.fields(jcls)}
    tfields = {f.name: f for f in dataclasses.fields(pretrain.PretrainConfig)}
    assert set(tfields) - set(jfields) == {"device"} and set(jfields) <= set(tfields)
    for name, f in jfields.items():
        if f.default is not dataclasses.MISSING:
            assert tfields[name].default == f.default, name
    from bridgelang_tpu_torch.conf import parse_cli

    cfg = parse_cli(pretrain.PretrainConfig, ["--stage", "align", "--model.type", "prism-dinosiglip-224px+7b",
                                              "--dataset.dataset_root_dir", "/data/llava", "--device", "cpu"])
    assert (cfg.stage, cfg.dataset.dataset_root_dir, cfg.device) == ("align", "/data/llava", "cpu")
    hp = pretrain.stage_hparams(cfg.model, "align")
    assert (hp["global_batch_size"], hp["per_device_batch_size"], hp["learning_rate"]) == (256, 16, 1e-3)
    hp = pretrain.stage_hparams(cfg.model, "full-finetune")
    assert (hp["global_batch_size"], hp["per_device_batch_size"], hp["learning_rate"]) == (128, 16, 2e-5)
