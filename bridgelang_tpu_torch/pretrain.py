"""VLM pretraining (align / finetune stages) on the card.

    python -m bridgelang_tpu_torch.pretrain --stage align --remat_policy full \
        --dataset.dataset_root_dir /data/llava [--model.type prism-dinosiglip-224px+7b] [--device cuda]

Counterpart of scripts/pretrain.py: every field of its `PretrainConfig`
under its name and default, plus `--device` (CUDA unless `--device cpu`; no
fallback). The stage picks the hyperparameters of the `--model` registry
entry (align: `align_*`, every other stage: `finetune_*`) and the trainable
tensors (align: the projector; finetune: projector + LLM; full-finetune:
everything; last-layer-finetune: the last decoder layer, final norm and
head). Every parameter is drawn at random from `--seed` in fp32; the step
computes in bf16. The data are LLaVA chat JSON + image directories under
`--dataset.dataset_root_dir` (preprocessing/: images read as PIL reads them,
without PIL), padded to `llm_max_length` tokens, batched by modality
(`SplitModalityBatcher`, one order per epoch). Gradients accumulate over
max(1, global // per-device batch) micro-steps (optax.MultiSteps'
semantics); the learning rate follows the stage's schedule over
`max_steps_override` or epochs x (examples // global batch) updates, while
the loop counts micro-steps against that number, as the JAX script does.
Each epoch ends with a save of the whole state (parameters and optimizer
state) under `<run_root_dir>/<run_id>/checkpoints/`.

As in the JAX script, `--pretrained_checkpoint` is accepted and not read
(the reference loads an align-stage projector there; neither package does
yet). `--mesh_shape` ("fsdp=N", "replica=R,fsdp=F", "fsdp=F,tensor=T"; one
process per device under torchrun) shards the state with FSDP
(parallel/fsdp.py), which the 7B's finetune stage needs (~109 GB of fp32
state and moments), and runs the decoder tensor-parallel over `tensor`:
each rank keeps its blocks, the micro-batch is per-device batch x data
ranks (replica x fsdp), every rank draws the same batch order and collates
its data rank's rows of each micro-batch (tensor peers the same rows), and
each epoch's save is sharded (`dcp/`). On one 80 GB card
the 7B's align stage at 16 x (2048 + 256) tokens needs `--remat_policy
full`: the default "dots" keeps every layer's matmul outputs.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Optional

import torch

from bridgelang_tpu_torch.conf import DatasetConfig, ModelConfig, config_to_dict, parse_cli
from bridgelang_tpu_torch.overwatch import initialize_overwatch

overwatch = initialize_overwatch(__name__)


@dataclass
class PretrainConfig:
    model: ModelConfig = field(default_factory=lambda: ModelConfig.get("prism-dinosiglip-224px+7b"))
    dataset: DatasetConfig = field(default_factory=lambda: DatasetConfig.get("llava-v15"))
    stage: str = "finetune"  # align | finetune | full-finetune | last-layer-finetune
    run_root_dir: str = "runs"
    run_id: Optional[str] = None
    tokenizer_path: Optional[str] = None
    pretrained_checkpoint: Optional[str] = None  # align-stage projector checkpoint: accepted, not read (as JAX)
    seed: int = 7
    remat_policy: str = "dots"  # "dots" (faster) | "full" (min memory)
    max_steps_override: Optional[int] = None
    mesh_shape: Optional[str] = None
    trackers: str = "jsonl"
    device: Optional[str] = None  # cuda (default) | cpu


def stage_hparams(m: ModelConfig, stage: str) -> Dict[str, Any]:
    """The stage's hyperparameters from the model config (reference
    pretrain.py:81-113)."""
    p = "align" if stage == "align" else "finetune"
    return {k: getattr(m, f"{p}_{k}") for k in ("epochs", "global_batch_size", "per_device_batch_size",
                                                 "learning_rate", "weight_decay", "max_grad_norm",
                                                 "lr_scheduler_type", "warmup_ratio")}


def vlm_config(m: ModelConfig):
    from bridgelang_tpu_torch.models.vlm import VLMConfig

    return VLMConfig.from_ids(model_id=m.model_id, vision_backbone_id=m.vision_backbone_id,
                              llm_backbone_id=m.llm_backbone_id, arch_specifier=m.arch_specifier,
                              image_resize_strategy=m.image_resize_strategy, llm_max_length=m.llm_max_length)


def main(cfg: PretrainConfig):
    """Pretrain as configured; returns the final TrainState."""
    return run(cfg, vlm_config(cfg.model))


def run(cfg: PretrainConfig, vlm_cfg):
    """The pretraining loop on `vlm_cfg` (the registry model's, or a cut of
    it), computing in bf16 as the JAX script does."""
    from bridgelang_tpu_torch._device import resolve_device
    from bridgelang_tpu_torch.finetune import to_device
    from bridgelang_tpu_torch.models.llm.tokenizer import get_tokenizer
    from bridgelang_tpu_torch.models.vlm import PrismaticVLM
    from bridgelang_tpu_torch.preprocessing import get_dataset_and_collator
    from bridgelang_tpu_torch.preprocessing.datasets import SplitModalityBatcher
    from bridgelang_tpu_torch.training.checkpointing import CheckpointManager, save_sidecars
    from bridgelang_tpu_torch.training.metrics import Metrics, build_trackers
    from bridgelang_tpu_torch.training.trainer import (
        OptimConfig, init_train_state, make_optimizer, make_vla_train_step)
    from bridgelang_tpu_torch.util.seeding import root_key, set_global_seed

    from bridgelang_tpu_torch.parallel.fsdp import MeshTraining, training_mesh
    from bridgelang_tpu_torch.parallel.sharding import data_rank_and_count

    mesh, device = training_mesh(cfg.mesh_shape, resolve_device(cfg.device))
    data_rank, data_ranks = data_rank_and_count(mesh) if mesh is not None else (0, 1)
    set_global_seed(cfg.seed)
    m, stage = cfg.model, cfg.stage
    hp = stage_hparams(m, stage)
    run_id = cfg.run_id or f"{cfg.dataset.dataset_id}+{m.model_id}+stage-{stage}+x{cfg.seed}"
    run_dir = Path(cfg.run_root_dir) / run_id

    model = PrismaticVLM(vlm_cfg, dtype=torch.bfloat16, device=device)
    tokenizer = get_tokenizer(cfg.tokenizer_path)
    dataset, collator = get_dataset_and_collator(
        "align" if stage == "align" else "finetune", cfg.dataset, tokenizer, vlm_cfg.llm_family,
        max_length=m.llm_max_length, pad_token_id=vlm_cfg.llm.pad_token_id)

    params = model.init_params(root_key(cfg.seed, device), param_dtype=torch.float32)
    trainable = model.trainable_mask(params, stage)
    micro_bsz = hp["per_device_batch_size"] * data_ranks
    grad_accum = max(1, hp["global_batch_size"] // micro_bsz)
    steps_per_epoch = len(dataset) // hp["global_batch_size"]
    total_steps = cfg.max_steps_override or (hp["epochs"] * steps_per_epoch) or 1000

    ocfg = OptimConfig(learning_rate=hp["learning_rate"], weight_decay=hp["weight_decay"],
                       max_grad_norm=hp["max_grad_norm"], lr_scheduler_type=hp["lr_scheduler_type"],
                       warmup_ratio=hp["warmup_ratio"], total_steps=total_steps)
    optimizer = make_optimizer(ocfg, params, trainable_mask=trainable, grad_accum_steps=grad_accum)
    mesh_training = None
    if mesh is not None:
        mesh_training = MeshTraining.for_params(mesh, params)
        params = mesh_training.shard(params)
    step_fn = make_vla_train_step(model, optimizer, trainable_mask=trainable, compute_dtype=torch.bfloat16,
                                  image_transform=model.image_transform, remat_policy=cfg.remat_policy,
                                  mesh=mesh_training)
    state = init_train_state(params, optimizer, trainable_mask=trainable, mesh=mesh_training)
    del params
    ckpt = CheckpointManager(run_dir)
    if overwatch.is_rank_zero():
        save_sidecars(run_dir, config_to_dict(cfg))
    metrics = Metrics(build_trackers(cfg.trackers.split(","), run_id, run_dir, config_to_dict(cfg)), run_id,
                      is_rank_zero=overwatch.is_rank_zero())
    overwatch.info("Pretraining stage %s: %d examples, micro-batch %d, grad_accum %d, %d steps", stage, len(dataset),
                   micro_bsz, grad_accum, total_steps)

    batcher = SplitModalityBatcher(dataset.get_modality_lengths(), micro_bsz, seed=cfg.seed)
    rows = micro_bsz // data_ranks  # this rank's rows of each micro-batch
    step, mtr = 0, None
    for epoch in range(hp["epochs"]):
        for batch_indices in batcher.batches(epoch):
            if step >= total_steps:
                break
            mine = batch_indices[data_rank * rows:(data_rank + 1) * rows]
            batch = collator([dataset[i] for i in mine])
            del batch["multimodal_indices"]
            state, mtr = step_fn(state, to_device(batch, device))
            step += 1
            metrics.commit(global_step=step, loss=float(mtr["loss"]), lr=hp["learning_rate"])
            if step % 10 == 0:
                overwatch.info(metrics.push())
        if mtr is None:
            raise ValueError(f"epoch {epoch} gave no batch: {len(dataset)} examples, micro-batch {micro_bsz}")
        ckpt.save(state, step=step, epoch=epoch, loss=float(mtr["loss"]), mesh=mesh_training)
    metrics.finalize()
    return state


if __name__ == "__main__":
    main(parse_cli(PretrainConfig))
