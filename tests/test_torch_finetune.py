"""The port's fine-tuning slice against the JAX package, on the CPU: the
parallel_actions objective, int8 bases for QLoRA, and the `finetune` and
`train` entry points over a native episode store.

The tiny VLA and the batches are those of tests/test_torch_training.py
(dual towers, a 2-layer GQA Llama with the real vocabulary, adapters drawn
in numpy and handed to both packages). Tolerances, as that file states:
* hidden states of `forward_hidden(parallel_actions=True)`: atol 1e-4 (fp32
  sums in another order through two layers; here both sides attend under the
  same general mask with a plain softmax);
* losses, grad norms and L1 per train step: rtol 1e-5; action accuracy atol
  1e-6; adapters after 3 Adam steps at lr 2e-5: atol 1e-5;
* int8 merge: codes equal, scales atol 1e-6 (bf16 scales: equal here).

`finetune.main` runs on a tiny checkpoint written by the JAX exporter and a
tiny native store (device cpu): run dir, sidecars, checkpoints of the
trainable state, and the HF export of the merged model, which equals the
source with the saved adapters merged, loads in both packages and predicts
the same ids.
`train.main` trains, saves, resumes through `--pretrained_checkpoint` and
`--resume_step` (validate_resume) and ends bit-equal to the uninterrupted run.
Both entry points also read TFDS directories (JPEG frames, written as the
smoke run's tfds phase writes them) with no flag: the directory's layout
picks the reader, and train.main's mixture draws from both datasets.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bridgelang_tpu_torch.models.vlm as tvlm
from bridgelang_tpu.models import load as jload
from bridgelang_tpu.models.llm.tokenizer import ByteFallbackTokenizer as JTokenizer
from bridgelang_tpu.ops import image_ops as jimg
from bridgelang_tpu.ops import quant as jq
from bridgelang_tpu.training import lora as jlora
from bridgelang_tpu.training import trainer as jtrainer
from bridgelang_tpu_torch import finetune, train
from bridgelang_tpu_torch.conf import parse_cli
from bridgelang_tpu_torch.convert import llm_params_from_jax, params_from_jax
from bridgelang_tpu_torch.models import load as tload
from bridgelang_tpu_torch.models.llm.tokenizer import ByteFallbackTokenizer
from bridgelang_tpu_torch.ops import image_ops as timg
from bridgelang_tpu_torch.training import lora as tlora
from bridgelang_tpu_torch.training import trainer as ttrainer
from bridgelang_tpu_torch.training.checkpointing import validate_resume
import chip_smoke
from bridgelang_tpu_torch.vla.datasets.rlds.oxe.mixtures import OXE_NAMED_MIXTURES
from bridgelang_tpu_torch.vla.datasets.rlds.tfds_reader import TfdsBuilder
from tests.test_torch_data_pipeline import write_store
from tests.test_torch_load import TOWERS, ckpts, registries, set_transform  # noqa: F401 (fixtures)
from tests.test_torch_training import RANK, _batches, _np, _numpy_adapters, _with_adapters, pair  # noqa: F401


def _pixels(jmodel, jb):
    return np.array(jimg.preprocess_batch(jnp.asarray(jb["frames"]), jmodel.image_transform))


def test_parallel_actions_forward_hidden_matches_jax(pair):
    jmodel, jparams, tmodel = pair
    jp = dict(jparams, llm=_with_adapters(jparams["llm"], _numpy_adapters(jparams["llm"], RANK, seed=21, b_std=0.02)))
    tp = params_from_jax(_np(jp))
    jb, tb = _batches(3, seed=22)
    jb["attention_mask"][2, -10:] = 0  # a shorter example: padding rows and keys
    tb["attention_mask"][2, -10:] = 0
    pixels = _pixels(jmodel, jb)
    args = [jnp.asarray(jb[k]) for k in ("input_ids", "attention_mask")]
    jh, jl = jmodel.forward_hidden(jp, *args, jnp.asarray(pixels), jnp.asarray(jb["labels"]), remat=False,
                                   parallel_actions=True)
    for remat, policy in ((False, None), (True, "full"), (True, "dots")):
        th, tl = tmodel.forward_hidden(tp, torch.from_numpy(tb["input_ids"]), torch.from_numpy(tb["attention_mask"]),
                                       torch.from_numpy(pixels), torch.from_numpy(tb["labels"]), remat=remat,
                                       remat_policy=policy, parallel_actions=True)
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        np.testing.assert_allclose(th.detach().numpy(), np.asarray(jh), atol=1e-4, rtol=1e-4)
    causal, _ = tmodel.forward_hidden(tp, torch.from_numpy(tb["input_ids"]), torch.from_numpy(tb["attention_mask"]),
                                      torch.from_numpy(pixels), torch.from_numpy(tb["labels"]), remat=False)
    assert not torch.allclose(causal, th)  # the objective changes the supervised rows


def _three_steps(jmodel, jp, tmodel, tp, jb, tb, **flags):
    cfg = dict(learning_rate=2e-5, lr_scheduler_type="constant", max_grad_norm=1.0)
    j_mask = jlora.lora_trainable_mask(jp)
    jtx = jtrainer.make_optimizer(jtrainer.OptimConfig(**cfg), jp, trainable_mask=j_mask)
    jstep = jax.jit(jtrainer.make_vla_train_step(jmodel, jtx, trainable_mask=j_mask, compute_dtype=jnp.float32,
                                                 image_transform=jmodel.image_transform, **flags))
    jstate = jtrainer.init_train_state(jp, jtx, trainable_mask=j_mask)
    t_mask = tlora.lora_trainable_mask(tp)
    ttx = ttrainer.make_optimizer(ttrainer.OptimConfig(**cfg), tp, trainable_mask=t_mask)
    tstep = ttrainer.make_vla_train_step(tmodel, ttx, trainable_mask=t_mask, compute_dtype=torch.float32,
                                         image_transform=tmodel.image_transform, **flags)
    tstate = ttrainer.init_train_state(tp, ttx, trainable_mask=t_mask)
    jbatch = {k: jnp.asarray(v) for k, v in jb.items() if k != "dataset_names"}
    tbatch = {k: torch.from_numpy(v) for k, v in tb.items() if k != "dataset_names"}
    losses = []
    for _ in range(3):
        jstate, jm = jstep(jstate, jbatch)
        tstate, tm = tstep(tstate, tbatch)
        for key in ("loss", "grad_norm", "l1_loss"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-5, err_msg=key)
        np.testing.assert_allclose(float(tm["action_accuracy"]), float(jm["action_accuracy"]), atol=1e-6)
        losses.append(float(tm["loss"]))
    assert losses[-1] < losses[0]
    after = llm_params_from_jax(_np(jstate.params["llm"]))
    names = [(i, k) for i, lp in enumerate(after["layers"]) for k in lp if "_lora_" in k]
    got = np.concatenate([tstate.params["llm"]["layers"][i][k].detach().numpy().ravel() for i, k in names])
    want = np.concatenate([after["layers"][i][k].numpy().ravel() for i, k in names])
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    return tstate


def test_three_parallel_objective_lora_steps_match_jax(pair):
    jmodel, jparams, tmodel = pair
    jp = dict(jparams, llm=_with_adapters(jparams["llm"], _numpy_adapters(jparams["llm"], RANK, seed=23, b_std=0.02)))
    jb, tb = _batches(4, seed=24)
    _three_steps(jmodel, jp, tmodel, params_from_jax(_np(jp)), jb, tb, parallel_decode_objective=True)


def _int8_with_adapters(jllm, seed, b_std):
    base = jq.quantize_llm_int8(jllm)
    return _with_adapters(base, _numpy_adapters(base, RANK, seed=seed, b_std=b_std))


def test_merge_lora_over_int8_matches_jax(pair):
    _, jparams, _ = pair
    jl = _int8_with_adapters(jparams["llm"], seed=25, b_std=0.05)
    j_merged = llm_params_from_jax(_np(jlora.merge_lora(jl)))
    t_merged = tlora.merge_lora(llm_params_from_jax(_np(jl)))
    before = llm_params_from_jax(_np(jl))
    n_moved = 0
    for jlp, tlp, blp in zip(j_merged["layers"], t_merged["layers"], before["layers"]):
        assert set(tlp) == set(jlp) and not any("_lora_" in k for k in tlp)
        for name in tlora.ALL_LINEAR:
            assert tlp[name].dtype == torch.int8 and tlp[name + "_scale"].dtype == torch.bfloat16
            np.testing.assert_array_equal(tlp[name].numpy(), jlp[name].numpy(), err_msg=name)
            np.testing.assert_allclose(tlp[name + "_scale"].float().numpy(), jlp[name + "_scale"].float().numpy(),
                                       atol=1e-6, rtol=0)
            n_moved += int((tlp[name] != blp[name]).sum())
    assert n_moved > 0
    # the plain formula: dequantize, add B A, requantize per output column
    lp, mlp = before["layers"][1], t_merged["layers"][1]
    w32 = lp["w_up"].float() * lp["w_up_scale"].float() + lp["w_up_lora_b"] @ lp["w_up_lora_a"]
    absmax = w32.abs().amax(dim=1, keepdim=True)
    scale = absmax * torch.tensor(1 / 127.0, dtype=torch.float32)
    np.testing.assert_array_equal(mlp["w_up"].numpy(), torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8).numpy())


def test_three_int8_qlora_steps_match_jax(pair):
    jmodel, jparams, tmodel = pair
    jp = dict(jparams, llm=_int8_with_adapters(jparams["llm"], seed=26, b_std=0.02))
    tp = params_from_jax(_np(jp))
    codes = [lp["wq"].clone() for lp in tp["llm"]["layers"]]
    jb, tb = _batches(4, seed=27)
    _three_steps(jmodel, jp, tmodel, tp, jb, tb)
    assert all(torch.equal(c, lp["wq"]) for c, lp in zip(codes, tp["llm"]["layers"]))


# --- entry points -------------------------------------------------------------------


@pytest.fixture
def tiny_transform(monkeypatch):
    tiny = timg.ImageTransformConfig("resize-naive", tuple(timg.ImageTowerSpec(*t) for t in TOWERS["fused"]))
    monkeypatch.setattr(tvlm, "transform_config_for_backbone", lambda *a: tiny)


def test_finetune_main_end_to_end(ckpts, registries, tiny_transform, tmp_path, monkeypatch):  # noqa: F811
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    write_store(tmp_path / "data", "libero_spatial_no_noops", n_episodes=3, t=6, hw=40, seed=3)
    src = ckpts["fused"][2]
    cfg = parse_cli(finetune.FinetuneConfig, [
        "--vla_path", str(src), "--data_root_dir", str(tmp_path / "data"), "--run_root_dir", str(tmp_path / "runs"),
        "--batch_size", "4", "--max_steps", "3", "--save_steps", "2", "--lora_rank", "4", "--learning_rate", "1e-3",
        "--shuffle_buffer_size", "8", "--image_aug", "true", "--device", "cpu"])
    run = finetune.main(cfg)
    assert run.parent == tmp_path / "runs" and run.name.endswith("+lora-r4")
    saved_cfg = json.loads((run / "config.json").read_text())
    assert saved_cfg["max_steps"] == 3 and saved_cfg["device"] == "cpu"
    stats = json.loads((run / "dataset_statistics.json").read_text())
    assert stats["libero_spatial_no_noops"]["num_transitions"] == 18
    ckpt_names = sorted(p.name for p in (run / "checkpoints").iterdir())
    assert [n[:11] for n in ckpt_names] == ["step-000002", "step-000003"]
    saved = torch.load(run / "checkpoints" / ckpt_names[-1] / "state.pt", weights_only=True)
    layer0 = saved["params"]["llm"]["layers"][0]
    assert layer0["wq"] is None and layer0["wq_lora_a"].shape == (4, 128)  # the trainable state, the base dropped

    # the export is the source with the trained adapters merged, in the source's dtype (fp32 here)
    export = run / "hf_export"
    jm, jp = jload.load_vla(str(export), dtype=jnp.float32)
    tm, tp = tload.load_vla(str(export), dtype=torch.float32, device="cpu")
    _, base = tload.load_vla(str(src), device="cpu")
    adapters = [{k: v for k, v in lp.items() if "_lora_" in k} for lp in saved["params"]["llm"]["layers"]]
    merged = tlora.merge_lora(dict(base["llm"], layers=[dict(b, **a) for b, a in zip(base["llm"]["layers"], adapters)]))
    assert torch.equal(tp["llm"]["layers"][1]["w_down"], merged["layers"][1]["w_down"].float())
    assert not torch.equal(merged["layers"][1]["w_down"], base["llm"]["layers"][1]["w_down"])
    assert json.loads((export / "dataset_statistics.json").read_text()).keys() == {"bridge_orig",
                                                                                      "libero_spatial_no_noops"}
    for m in (jm, tm):
        set_transform(m, "fused")
    jm.tokenizer, tm.tokenizer = JTokenizer(), ByteFallbackTokenizer()
    imgs = list(np.random.default_rng(1).integers(0, 256, size=(2, 48, 64, 3), dtype=np.uint8))
    instructions = ["pick up the red block", "open the drawer"]
    ids, mask = tm.pad_prompt([tm.prepare_prompt_ids(t) for t in instructions])
    pixels = np.array(jimg.preprocess_batch(jnp.asarray(np.stack(imgs)), jm.image_transform))
    j_ids = np.asarray(jm.generate_greedy(jp, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(pixels),
                                          max_new_tokens=7))
    t_ids = tm.generate_greedy(tp, torch.from_numpy(ids), torch.from_numpy(mask), torch.from_numpy(pixels),
                               max_new_tokens=7).numpy()
    np.testing.assert_array_equal(t_ids, j_ids)
    action = tm.predict_action(tp, imgs[0], instructions[0], unnorm_key="libero_spatial_no_noops")
    q = stats["libero_spatial_no_noops"]["action"]
    assert np.isfinite(action).all() and action.shape == (7,)
    assert (action[:6] >= np.array(q["q01"][:6]) - 1e-6).all() and (action[:6] <= np.array(q["q99"][:6]) + 1e-6).all()
    with pytest.raises(AssertionError, match="devices"):  # a mesh larger than the world (one process)
        finetune.main(parse_cli(finetune.FinetuneConfig, ["--mesh_shape", "fsdp=2", "--device", "cpu"]))
    assert not torch.distributed.is_initialized()


def test_train_main_saves_resumes_bit_equal(registries, tiny_transform, tmp_path, monkeypatch):  # noqa: F811
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    write_store(tmp_path / "data", "libero_spatial_no_noops", n_episodes=3, t=5, hw=32, seed=4)
    common = ["--vla.type", "debug", "--vla.data_mix", "libero_spatial_no_noops", "--vla.save_interval", "2",
              "--vla.learning_rate", "1e-3", "--data_root_dir", str(tmp_path / "data"),
              "--run_root_dir", str(tmp_path / "runs"), "--max_steps_override", "3", "--log_interval", "2",
              "--remat_policy", "full", "--device", "cpu"]
    full = train.main(parse_cli(train.TrainConfig, common + ["--run_id", "a"]))
    assert full.step == 3
    ckpts_a = sorted((tmp_path / "runs" / "a" / "checkpoints").iterdir())
    assert [p.name[:11] for p in ckpts_a] == ["step-000002", "step-000003"]
    metrics = [json.loads(line) for p in (tmp_path / "runs" / "a").glob("*.jsonl") for line in p.read_text().splitlines()]
    assert any("train/loss" in m for m in metrics)
    with pytest.raises(AssertionError):
        validate_resume(ckpts_a[0], resume_step=3, resume_epoch=0)
    resumed = train.main(parse_cli(train.TrainConfig, common + [
        "--run_id", "b", "--pretrained_checkpoint", str(ckpts_a[0]), "--resume_step", "2"]))
    assert resumed.step == 3
    for a, b in zip(ttrainer.tree_leaves(full.params), ttrainer.tree_leaves(resumed.params)):
        assert torch.equal(a, b)
    for a, b in zip(ttrainer.tree_leaves(full.opt_state), ttrainer.tree_leaves(resumed.opt_state)):
        assert not isinstance(a, torch.Tensor) or torch.equal(a, b)
    data_state = torch.load(ckpts_a[0] / "data_state.pt", weights_only=True)  # read on from here by the resume
    assert data_state["datasets"] == ["libero_spatial_no_noops"] and data_state["refs"].shape[1] == 4
    (ckpts_a[0] / "data_state.pt").unlink()
    with pytest.raises(FileNotFoundError, match="data_state"):
        train.main(parse_cli(train.TrainConfig, common + [
            "--run_id", "c", "--pretrained_checkpoint", str(ckpts_a[0]), "--resume_step", "2"]))
    assert train.stage_of(parse_cli(train.TrainConfig, ["--vla.freeze_vision_backbone", "true"]).vla) == "vla-train"


def test_entry_points_read_tfds_directories(ckpts, registries, tiny_transform, tmp_path, monkeypatch):  # noqa: F811
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    data = str(tmp_path / "tfds")
    cams = chip_smoke.camera_fixtures()
    chip_smoke.write_tfds_dataset(data, "libero_spatial_no_noops", [chip_smoke.libero_episode(e, 6, cams)
                                                                    for e in range(3)], chip_smoke.libero_features(), 2)
    chip_smoke.write_tfds_dataset(data, chip_smoke.TFDS_FRACTAL, [chip_smoke.fractal_episode(e, 4, cams)
                                                                  for e in range(2)], chip_smoke.fractal_features(), 1)
    assert isinstance(TfdsBuilder(data, "libero_spatial_no_noops"), TfdsBuilder)
    run = finetune.main(parse_cli(finetune.FinetuneConfig, [
        "--vla_path", str(ckpts["fused"][2]), "--data_root_dir", data, "--run_root_dir", str(tmp_path / "runs"),
        "--batch_size", "4", "--max_steps", "2", "--save_steps", "1000", "--lora_rank", "4",
        "--shuffle_buffer_size", "8", "--export_hf", "false", "--device", "cpu"]))
    stats = json.loads((run / "dataset_statistics.json").read_text())
    assert stats["libero_spatial_no_noops"]["num_transitions"] == 18

    names = []  # the dataset of every frame train.main's batches hold
    from bridgelang_tpu_torch.vla import materialize

    real = materialize.get_vla_dataset_and_collator

    def watched(*a, **k):
        ds, tok, coll = real(*a, **k)
        batches = ds.batches

        def recording(state=None):
            it = batches(state)
            nxt = it.__next__

            class Recorded:
                def __iter__(self):
                    return self

                def __next__(self):
                    b = nxt()
                    names.extend(b["dataset_names"])
                    return b

                def __getattr__(self, name):
                    return getattr(it, name)

            return Recorded()

        ds.batches = recording
        return ds, tok, coll

    monkeypatch.setattr(materialize, "get_vla_dataset_and_collator", watched)
    monkeypatch.setitem(OXE_NAMED_MIXTURES, "tfds_mix", [("libero_spatial_no_noops", 1.0),
                                                          (chip_smoke.TFDS_FRACTAL, 1.0)])
    state = train.main(parse_cli(train.TrainConfig, [
        "--vla.type", "debug", "--vla.data_mix", "tfds_mix", "--vla.save_interval", "1000",
        "--data_root_dir", data, "--run_root_dir", str(tmp_path / "runs"), "--max_steps_override", "3",
        "--run_id", "mix", "--device", "cpu"]))
    assert state.step == 3
    assert set(names) == {"libero_spatial_no_noops", chip_smoke.TFDS_FRACTAL}
