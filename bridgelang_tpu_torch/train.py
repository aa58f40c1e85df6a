"""VLA training (pretraining a VLA from a VLM config, or full fine-tuning) on
the card.

    python -m bridgelang_tpu_torch.train --vla.type prism-dinosiglip-224px+mx-bridge \
        --data_root_dir /data/tfds --run_root_dir runs [--pretrained_checkpoint ... --resume_step N]

Counterpart of scripts/train.py: every field of its `TrainConfig` under its
name and default, plus `--device` (CUDA unless `--device cpu`; no fallback).
The freeze flags of `--vla` pick the stage; the parameters are drawn from
`--seed` in fp32 (the step computes in bf16); AdamW follows the VLA config's
schedule. `--pretrained_checkpoint` restores a port run's checkpoint (a
torch `state.pt`, training/checkpointing.py) and, with `--resume_step`,
`validate_resume` checks its name and the data stream goes on from the
state saved beside it (`data_state.pt`: each dataset's cursor, the
generators, the shuffle buffer as references to frames; restoring it reads
the buffer's trajectories again, not the steps before), so the resumed run
reads the batches the interrupted one would have. Metrics sync to the host every `log_interval`
steps; an exception saves an emergency checkpoint before it propagates.
`--profile_dir` writes a torch.profiler trace of steps 10-12.

The data are read from `--data_root_dir`, one directory per dataset of
`--vla.data_mix`, each a TFDS dataset (`<root>/<dataset>/<version>/`, read
by vla/datasets/rlds/tfds_reader.py) or a native episode store
(`<root>/<dataset>/*.tfrecord`): its layout picks the reader. The byte-fallback
stand-in tokenizer (no `--tokenizer_path`) takes the finetune entry point's
wider collator bucket. `--attention_impl` sets `VLMConfig.attention_impl`
(scripts/train.py:101-104): "ring" (or "ring:<axis>") runs the decoder's
attention as ring attention over the mesh's fsdp (or named) axis, the
sequence split in time across its ranks (ops/ring_attention.py); on a mesh
whose axis has one rank, or without a mesh, the flash kernels as by default.

Multi-GPU: under torchrun (`torchrun --nproc_per_node N -m
bridgelang_tpu_torch.train ...`) or with `--vla.mesh_shape`, each rank trains
on one device over the mesh `--vla.mesh_shape` names, or by default the one
`strategy_mesh_spec(--vla.train_strategy, world, devices per node)` gives
(fsdp-full-shard and fsdp-shard-grad-op: fsdp inside a node, replicas
across nodes; ddp: replicas); fsdp-shard-grad-op keeps the parameters whole
and shards AdamW's state (parallel/fsdp.py). `--vla.mesh_shape` with
`tensor` > 1 runs the decoder tensor-parallel (no strategy gives one, as in
the JAX package). Each data rank (replica x fsdp; tensor peers read the same
rows) reads its share of the data; checkpoints are sharded (`dcp/`) and
resume at another mesh shape (each rank's data stream resumes when the world
size is the run's).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

import torch

from bridgelang_tpu_torch.conf import VLAConfig, config_to_dict, parse_cli, save_config
from bridgelang_tpu_torch.overwatch import initialize_overwatch
from bridgelang_tpu_torch.util import profiling

overwatch = initialize_overwatch(__name__)


@dataclass
class TrainConfig:
    vla: VLAConfig = field(default_factory=lambda: VLAConfig.get("prism-dinosiglip-224px+mx-oxe-magic-soup-plus"))
    data_root_dir: str = "data/oxe"
    run_root_dir: str = "runs"
    run_id: Optional[str] = None
    pretrained_checkpoint: Optional[str] = None
    tokenizer_path: Optional[str] = None  # a tokenizer.json directory (Llama-2)
    is_resume: bool = True
    resume_step: Optional[int] = None
    resume_epoch: Optional[int] = None
    trackers: str = "jsonl"  # comma-separated: jsonl,wandb
    seed: int = 7
    max_steps_override: Optional[int] = None
    profile_dir: Optional[str] = None  # a torch.profiler trace of steps 10-12
    log_interval: int = 10  # device->host metric sync every N steps
    remat_policy: str = "dots"  # "dots" saves matmul outputs; "full" recomputes the whole layer
    attention_impl: Optional[str] = None  # None / "pallas" (flash), "xla", "einsum", "ring", "ring:<axis>"
    device: Optional[str] = None  # cuda (default) | cpu


def stage_of(vla: VLAConfig) -> str:
    """The training stage from the freeze flags (JAX scripts/train.py:129-136)."""
    if vla.freeze_vision_backbone and vla.freeze_llm_backbone:
        return "vla-last-layer-train" if vla.unfreeze_last_llm_layer else "align"
    if vla.freeze_vision_backbone:
        return "vla-train"
    if vla.freeze_llm_backbone:
        return "vla-sandwich-train" if vla.unfreeze_last_llm_layer else "vla-train"
    return "vla-full-train"


def main(cfg: TrainConfig):
    """Train as configured; returns the final TrainState."""
    from bridgelang_tpu_torch._device import resolve_device
    from bridgelang_tpu_torch.conf.models import ModelConfig
    from bridgelang_tpu_torch.finetune import jsonable, prompt_bucket_for, to_device
    from bridgelang_tpu_torch.models.llm.tokenizer import get_tokenizer
    from bridgelang_tpu_torch.models.vlm import PrismaticVLM, VLMConfig
    from bridgelang_tpu_torch.training.checkpointing import CheckpointManager, save_sidecars, validate_resume
    from bridgelang_tpu_torch.training.metrics import VLAMetrics, build_trackers
    from bridgelang_tpu_torch.training.trainer import (
        OptimConfig, init_train_state, make_lr_schedule, make_optimizer, make_vla_train_step)
    from bridgelang_tpu_torch.util.seeding import root_key, set_global_seed
    from bridgelang_tpu_torch.vla.materialize import get_vla_dataset_and_collator

    from bridgelang_tpu_torch.parallel.fsdp import MeshTraining, mesh_strategy, training_mesh
    from bridgelang_tpu_torch.parallel.mesh import initialize_distributed, strategy_mesh_spec
    from bridgelang_tpu_torch.parallel.sharding import data_rank_and_count

    vla = cfg.vla
    device = resolve_device(cfg.device)
    mesh_shape = vla.mesh_shape
    if mesh_shape is None and int(os.environ.get("WORLD_SIZE", "1")) > 1:
        initialize_distributed(device_type=device.type)
        world = torch.distributed.get_world_size()
        mesh_shape = strategy_mesh_spec(vla.train_strategy, world, int(os.environ.get("LOCAL_WORLD_SIZE", world)))
    mesh, device = training_mesh(mesh_shape, device)
    set_global_seed(cfg.seed)
    world = overwatch.world_size()
    data_rank, data_ranks = data_rank_and_count(mesh) if mesh is not None else (0, 1)
    if world != vla.expected_device_count:
        overwatch.warning("Running %r on %d device(s) (config expects %d): the batch per device adjusts",
                          vla.vla_id, world, vla.expected_device_count)
    run_id = cfg.run_id or f"{vla.vla_id}+n{world}+b{vla.per_device_batch_size}+x{cfg.seed}"
    run_dir = Path(cfg.run_root_dir) / run_id
    overwatch.info("Starting run %s on %d device(s)", run_id, world)

    base = ModelConfig.get(vla.base_vlm) if vla.base_vlm in ModelConfig.available() else None
    vlm_cfg = VLMConfig.from_ids(
        model_id=vla.base_vlm,
        vision_backbone_id=base.vision_backbone_id if base else "dinosiglip-vit-so-224px",
        llm_backbone_id=base.llm_backbone_id if base else "llama2-7b-pure",
        arch_specifier=base.arch_specifier if base else "no-align+fused-gelu-mlp",
        image_resize_strategy=base.image_resize_strategy if base else "resize-naive",
    )
    if cfg.attention_impl:  # scripts/train.py:101-104
        vlm_cfg = dataclasses.replace(vlm_cfg, attention_impl=cfg.attention_impl)
    model = PrismaticVLM(vlm_cfg, dtype=torch.bfloat16, device=device)

    tokenizer = get_tokenizer(cfg.tokenizer_path)
    dataset, _, _ = get_vla_dataset_and_collator(
        cfg.data_root_dir,
        vla.data_mix,
        base_tokenizer=tokenizer,
        llm_family=vlm_cfg.llm_family,
        batch_size=vla.global_batch_size // data_ranks,
        prompt_bucket=prompt_bucket_for(tokenizer),
        shuffle_buffer_size=vla.shuffle_buffer_size // data_ranks,
        image_aug=vla.image_aug,
        pad_token_id=vlm_cfg.llm.pad_token_id,
        seed=cfg.seed,
        num_workers=0 if device.type == "cpu" else None,  # the CPU's cores run the step too
        data_shard=(data_ranks, data_rank) if mesh is not None else None,
    )
    if overwatch.is_rank_zero():
        save_sidecars(run_dir, config_to_dict(cfg), jsonable(dataset.dataset_statistics))
        save_config(cfg, run_dir / "config.json")

    start_step, data_state = 0, None
    if cfg.pretrained_checkpoint is not None and cfg.is_resume and cfg.resume_step is not None:
        validate_resume(cfg.pretrained_checkpoint, cfg.resume_step, cfg.resume_epoch or 0)
        start_step = cfg.resume_step
        data_state = CheckpointManager.load_data_state(cfg.pretrained_checkpoint)
        if data_state is None:
            raise FileNotFoundError(f"{cfg.pretrained_checkpoint} holds no data_state.pt: a resume reads on from "
                                    "the data stream's saved state")
    batches = dataset.batches(data_state)  # the data processes fill the shuffle buffer while the model is set up

    stage = stage_of(vla)
    overwatch.info("Training stage: %s", stage)
    params = model.init_params(root_key(cfg.seed, device), param_dtype=torch.float32)
    trainable = model.trainable_mask(params, stage)
    total_steps = cfg.max_steps_override or vla.max_steps or 200_000
    ocfg = OptimConfig(learning_rate=vla.learning_rate, weight_decay=vla.weight_decay,
                       max_grad_norm=vla.max_grad_norm, lr_scheduler_type=vla.lr_scheduler_type,
                       warmup_ratio=vla.warmup_ratio, total_steps=total_steps)
    optimizer = make_optimizer(ocfg, params, trainable_mask=trainable)
    mesh_training = None
    if mesh is not None:
        mesh_training = MeshTraining.for_params(mesh, params, mesh_strategy(vla.train_strategy))
        params = mesh_training.shard(params)
    step_fn = make_vla_train_step(model, optimizer, trainable_mask=trainable, image_transform=model.image_transform,
                                  remat_policy=cfg.remat_policy, mesh=mesh_training)
    state = init_train_state(params, optimizer, trainable_mask=trainable, mesh=mesh_training)
    del params

    ckpt = CheckpointManager(run_dir)
    if cfg.pretrained_checkpoint is not None:
        state = ckpt.restore(cfg.pretrained_checkpoint, state, mesh=mesh_training)
        overwatch.info("Restored checkpoint %s", cfg.pretrained_checkpoint)
    metrics = VLAMetrics(build_trackers(cfg.trackers.split(","), run_id, run_dir, config_to_dict(cfg)), run_id,
                         is_rank_zero=overwatch.is_rank_zero(), resume_step=start_step)

    lr_schedule = make_lr_schedule(ocfg)
    pending = []  # (global step, device metrics, dataset names), synced to the host at flush

    def flush():
        for s, dm, names in pending:
            host = {k: v.detach().cpu().numpy() for k, v in dm.items()}
            metrics.commit(global_step=s, loss=float(host["loss"]), action_accuracy=float(host["action_accuracy"]),
                           l1_loss=float(host["l1_loss"]), grad_norm=float(host["grad_norm"]),
                           lr=float(lr_schedule(s)))
            for name in set(names):
                idx = [i for i, n in enumerate(names) if n == name]
                metrics.commit_for_dataset(name, action_accuracy=float(host["per_example_accuracy"][idx].mean()),
                                           l1_loss=float(host["per_example_l1"][idx].mean()))
        pending.clear()

    step, last_loss = start_step, None
    profiler = contextlib.ExitStack()  # holds profiling.trace over steps 10-12
    try:
        for batch in batches:
            if step >= total_steps:
                break
            names = batch["dataset_names"]
            device_batch = to_device(batch, device)
            if cfg.profile_dir and step == 9:
                profiler.enter_context(profiling.trace(cfg.profile_dir, f"{run_id}-steps-10-12.json"))
            state, m = step_fn(state, device_batch)
            step += 1
            last_loss = m["loss"]
            if cfg.profile_dir and step == 12:
                profiler.close()
                overwatch.info("Wrote profiler trace to %s", cfg.profile_dir)
            pending.append((step, m, names))
            if step % cfg.log_interval == 0:
                flush()
                overwatch.info(metrics.push())
            if step % vla.save_interval == 0:
                flush()
                t0 = time.time()
                ckpt.save(state, step=step, epoch=0, loss=float(m["loss"]), data_state=batches.state(step - start_step),
                          mesh=mesh_training)
                overwatch.info("Saved checkpoint at step %d (%.1fs)", step, time.time() - t0)
    except (KeyboardInterrupt, Exception) as e:  # noqa: BLE001 (re-raised)
        if mesh_training is not None:  # the other ranks may be inside a collective: no collective save
            overwatch.error("Training interrupted at step %d (%s) on a mesh; no emergency checkpoint", step, e)
            raise
        overwatch.error("Training interrupted at step %d (%s); saving emergency checkpoint", step, e)
        ckpt.save(state, step=step, epoch=0, loss=0.0, data_state=batches.state(step - start_step))
        raise
    finally:
        profiler.close()
        batches.close()
    flush()
    ckpt.save(state, step=step, epoch=0, loss=float(last_loss) if last_loss is not None else float("nan"),
              data_state=batches.state(step - start_step), mesh=mesh_training)
    metrics.finalize()
    overwatch.info("Training complete at step %d", step)
    return state


if __name__ == "__main__":
    main(parse_cli(TrainConfig))
