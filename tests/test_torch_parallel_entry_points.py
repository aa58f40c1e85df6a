"""The training entry points on a mesh of 2 gloo ranks vs one rank, on the CPU.

finetune.main (LoRA over the tiny exported checkpoint of
tests/test_torch_load.py, a native store), train.main (`--vla.type debug`)
and pretrain.run (a LLaVA layout, the finetune stage) run once in this
process (one rank, no mesh) and once on 2 ranks with `--mesh_shape fsdp=2`
(tests/torch_mesh_worker.py, no JAX in the ranks). The ranks read the
one-rank run's data stream and keep their rows of each global batch; for
pretrain, whose micro-batch is per-device batch x data ranks, the one-rank
run takes twice the per-device batch. The mesh runs save sharded
checkpoints and rank 0 writes the HF export; inspect_checkpoint reads the
run dir.
"""

import dataclasses

import numpy as np
import pytest

from bridgelang_tpu_torch.training import trainer as ttrainer
from tests.test_torch_pretrain import llava  # noqa: F401 (fixture)
from tests.torch_mesh_worker import run_group


def _recording_losses(monkeypatch):
    losses, make = [], ttrainer.make_vla_train_step

    def recording(*a, **k):
        step = make(*a, **k)

        def run(state, batch):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            return state, m

        return run

    monkeypatch.setattr(ttrainer, "make_vla_train_step", recording)
    return losses


def _pretrain_spec(cfg) -> dict:
    """A PretrainConfig as plain values (its registry classes do not pickle):
    the registry ids and every field that differs from them."""
    from bridgelang_tpu_torch.conf import DatasetConfig, ModelConfig

    def diff(obj, base):
        return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)
                if getattr(obj, f.name) != getattr(base, f.name)}

    return {"model": (cfg.model.model_id, diff(cfg.model, ModelConfig.get(cfg.model.model_id))),
            "dataset": (cfg.dataset.dataset_id, diff(cfg.dataset, DatasetConfig.get(cfg.dataset.dataset_id))),
            "fields": {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg) if f.name not in ("model",
                                                                                                       "dataset")}}


@pytest.fixture(scope="module")
def entries(llava, tmp_path_factory):  # noqa: F811
    """finetune.main, train.main and pretrain.run in this process (one rank,
    no mesh) and on 2 gloo ranks with --mesh_shape fsdp=2 over the same
    global batches (the ranks read the one-rank stream and keep their rows;
    pretrain's micro-batch is per-device x ranks, so its one-rank run takes
    twice the per-device batch)."""
    from bridgelang_tpu_torch import finetune, pretrain, train
    from bridgelang_tpu_torch.conf import parse_cli
    from bridgelang_tpu_torch.models import vlm as tvlm
    from bridgelang_tpu_torch.ops import image_ops as timg
    from tests.test_torch_data_pipeline import write_store
    from tests.test_torch_load import DINO as LDINO, LLM as LLLM, SIG as LSIG, TOWERS as LTOWERS
    from tests.test_torch_load import _CKPTS, jax_export, jax_tiny_vla, patch_registries
    from tests.test_torch_pretrain import MICRO, _configs

    tmp = tmp_path_factory.mktemp("entries")
    if "fused" not in _CKPTS:  # the tiny exported checkpoint tests/test_torch_load.py's `ckpts` makes
        jm, jp = jax_tiny_vla("fused")
        _CKPTS["fused"] = (jm, jp, jax_export(jm, jp, tmp / "ckpt"))
    ckpts = _CKPTS
    write_store(tmp / "data", "libero_spatial_no_noops", n_episodes=3, t=6, hw=40, seed=3)
    common = ["--data_root_dir", str(tmp / "data"), "--device", "cpu"]
    ft = common + ["--vla_path", str(ckpts["fused"][2]), "--batch_size", "4", "--max_steps", "3", "--save_steps", "2",
                   "--lora_rank", "4", "--learning_rate", "1e-3", "--shuffle_buffer_size", "8", "--image_aug", "false"]
    tr = common + ["--vla.type", "debug", "--vla.data_mix", "libero_spatial_no_noops", "--vla.save_interval", "1000",
                   "--vla.global_batch_size", "4", "--vla.per_device_batch_size", "2", "--vla.learning_rate", "1e-3",
                   "--max_steps_override", "2", "--remat_policy", "full"]
    cfg, _ = _configs(llava, "finetune", 1e-3, tmp / "pt")
    cfg = dataclasses.replace(cfg, max_steps_override=2)
    refs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HOME", str(tmp / "home"))
        patch_registries(mp)
        tiny = timg.ImageTransformConfig("resize-naive", tuple(timg.ImageTowerSpec(*t) for t in LTOWERS["fused"]))
        mp.setattr(tvlm, "transform_config_for_backbone", lambda *a: tiny)
        losses = _recording_losses(mp)
        finetune.main(parse_cli(finetune.FinetuneConfig, ft + ["--run_root_dir", str(tmp / "one")]))
        refs["finetune"] = list(losses)
        losses.clear()
        train.main(parse_cli(train.TrainConfig, tr + ["--run_root_dir", str(tmp / "one")]))
        refs["train"] = list(losses)
        losses.clear()
        m = cfg.model
        one = dataclasses.replace(cfg, model=dataclasses.replace(m, finetune_per_device_batch_size=2 * MICRO))
        pretrain.run(one, pretrain.vlm_config(one.model))
        refs["pretrain"] = list(losses)
    job = {"suite": "entry", "home": str(tmp / "home"), "dino": LDINO, "sig": LSIG, "llm": LLLM,
           "transform": [list(t) for t in LTOWERS["fused"]],
           "finetune": ft + ["--run_root_dir", str(tmp / "two")], "train": tr + ["--run_root_dir", str(tmp / "two")],
           "pretrain": _pretrain_spec(dataclasses.replace(cfg, run_root_dir=str(tmp / "two")))}
    return refs, run_group(job, 2, tmp / "w2")


@pytest.mark.parametrize("entry", ["finetune", "train", "pretrain"])
def test_entry_points_on_two_ranks_match_one(entries, entry):
    """The losses on fsdp=2 against the one-rank run on the same global
    batches. The entry points compute in bf16: the first step (the same
    weights on the same rows; the data split and the global loss) at rtol
    1e-5; the later ones at rtol 1e-2, since a batch split over two ranks
    rounds the bf16 gradient sums apart and Adam's first updates move each
    entry by about lr whatever its gradient's size (measured 0.1-0.5 % at lr
    1e-3)."""
    refs, outs = entries
    assert len(outs[entry]) == len(refs[entry]) > 1
    np.testing.assert_allclose(outs[entry][0], refs[entry][0], rtol=1e-5)
    np.testing.assert_allclose(outs[entry], refs[entry], rtol=1e-2)


def test_finetune_on_two_ranks_saves_sharded_and_exports_once(entries):
    """Both ranks wrote their blocks of each save (a sharded checkpoint);
    rank 0 alone wrote the HF export; inspect_checkpoint reads the run."""
    from pathlib import Path

    from bridgelang_tpu_torch import inspect_checkpoint

    _, outs = entries
    run = Path(outs["finetune_run"])
    steps = sorted((run / "checkpoints").iterdir())
    assert [p.name[:11] for p in steps] == ["step-000002", "step-000003"]
    for step in steps:
        assert len(list((step / "dcp").glob("*.distcp"))) == 2
    assert (run / "hf_export" / "config.json").exists()
    summary = inspect_checkpoint.main(inspect_checkpoint.InspectConfig(path=str(run), device="cpu"))
    assert summary["tensors"] > 0 and "params" in summary["by_prefix"] and "opt_state" in summary["by_prefix"]
