"""LoRA (or full) fine-tuning of an OpenVLA checkpoint on the card.

    python -m bridgelang_tpu_torch.finetune --vla_path /ckpts/openvla-7b \
        --data_root_dir /data/tfds --dataset_name libero_spatial_no_noops \
        [--use_lora true] [--lora_rank 32] [--use_quantization true] [--quantization_bits 8] \
        [--parallel_decode true] [--action_chunk 8] [--device cuda]

Counterpart of scripts/finetune.py: every field of its `FinetuneConfig`
under its name and default, plus `--device` (CUDA unless `--device cpu`; no
fallback). `--vla_path` is a local checkpoint in the HF OpenVLA layout
(`models/load.load_vla`, w8a8 off: a quantized base trains with bf16
activations). `--data_root_dir` holds the dataset as TFDS prepared it
(`<root>/<dataset_name>/<version>/`, read without TensorFlow by
vla/datasets/rlds/tfds_reader.py) or as a native episode store
(`<root>/<dataset_name>/*.tfrecord`, vla/datasets/native_loader.py); the
layout of the directory picks the reader.

LoRA adds r=`lora_rank` adapters to every projection; `--use_quantization`
freezes an int8 (`--quantization_bits 8`) or packed int4 (4) base under them.
`--parallel_decode` trains the parallel action objective (serve with
`deploy --parallel_decode`), `--action_chunk` supervises that many actions
per example. Every `save_steps` steps and at the end the run saves a
checkpoint, and with `--export_hf` (rank 0) the model with the adapters
merged into the base (bf16, int8 or int4) as `<run_dir>/hf_export` in the HF
layout, in the source checkpoint's dtype (a bf16 published checkpoint gives
a bf16 export), its unused tensors passed through. A LoRA run's checkpoint
holds its trainable state, the adapters and their AdamW moments, with the
frozen base dropped (`only_trainable_mask`): `convert_weights --direction
to_hf --source_hf <vla_path>` merges it into an HF checkpoint. The JAX
package saves the merged parameters there instead, so its checkpoint holds
a second copy of the base and no adapters to resume from. The export's
statistics are the source's plus the fine-tuning dataset's, so `deploy
--checkpoint` serves it under `--unnorm_key <dataset_name>`.

With the byte-fallback stand-in tokenizer (no `--tokenizer_path`), one token
per byte makes a prompt ~70 tokens: the collator's bucket is 96 instead of
64 (widened for action chunks as usual).

`--mesh_shape` ("fsdp=N", "replica=R,fsdp=F", "fsdp=F,tensor=T") trains on a
device mesh, one process per device started by torchrun (`torchrun
--nproc_per_node N -m bridgelang_tpu_torch.finetune ... --mesh_shape
fsdp=N`; a single process with `--mesh_shape fsdp=1` runs the same code on
one device): each rank keeps its blocks of the parameters
(parallel/sharding.PARAM_RULES; the adapters whole), the decoder runs
tensor-parallel over `tensor` (the adapters used by block), each data rank
(replica x fsdp; tensor peers read the same rows) reads its share of the
data and the batch splits over the data ranks, and the step gathers and
reduce-scatters (parallel/fsdp.py). The checkpoint is sharded (`dcp/`,
every rank writes its blocks); rank 0 writes the HF export from the
gathered parameters. A packed int4 base (`--quantization_bits 4`) trains
at tensor = 1 only.
"""

from __future__ import annotations

import contextlib
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, Optional

import torch

from bridgelang_tpu_torch.conf import config_to_dict, parse_cli
from bridgelang_tpu_torch.overwatch import initialize_overwatch

overwatch = initialize_overwatch(__name__)

BYTE_TOKENIZER_PROMPT_BUCKET = 96  # the collator bucket under the byte-fallback stand-in tokenizer


@dataclass
class FinetuneConfig:
    vla_path: str = "openvla-7b"
    data_root_dir: str = "data/rlds"
    dataset_name: str = "libero_spatial_no_noops"
    run_root_dir: str = "runs"
    tokenizer_path: Optional[str] = None

    batch_size: int = 16
    remat_policy: str = "dots"  # "dots" (faster) | "full" (min memory)
    max_steps: int = 200_000
    save_steps: int = 5000
    learning_rate: float = 5e-4
    grad_accumulation_steps: int = 1
    image_aug: bool = True
    shuffle_buffer_size: int = 100_000
    seed: int = 7

    parallel_decode: bool = False  # train the parallel action objective
    action_chunk: int = 1  # supervise the current and the next action_chunk - 1 actions

    use_lora: bool = True
    lora_rank: int = 32
    lora_dropout: float = 0.0
    use_quantization: bool = False  # a quantized frozen base (QLoRA)
    quantization_bits: int = 8  # 8 = int8 weight-only; 4 = packed int4
    export_hf: bool = True  # also write the HF-layout checkpoint
    mesh_shape: Optional[str] = None
    trackers: str = "jsonl"
    device: Optional[str] = None  # cuda (default) | cpu


def prompt_bucket_for(tokenizer, action_chunk: int = 1, action_dim: int = 7) -> int:
    """The collator bucket: the JAX default 64 (which the dataset widens for
    action chunks), or under the byte-fallback stand-in tokenizer 96 plus
    the chunk's extra action tokens."""
    from bridgelang_tpu_torch.models.llm.tokenizer import ByteFallbackTokenizer

    if isinstance(tokenizer, ByteFallbackTokenizer):
        return BYTE_TOKENIZER_PROMPT_BUCKET + action_dim * (action_chunk - 1)
    return 64


def jsonable(tree: Any) -> Any:
    """Statistics trees (numpy arrays inside) as JSON values."""
    import numpy as np

    return json.loads(json.dumps(tree, default=lambda x: np.asarray(x).tolist()))


def to_device(batch: Dict[str, Any], device: torch.device) -> Dict[str, torch.Tensor]:
    """A collated host batch on the card (`dataset_names` dropped)."""
    return {k: torch.as_tensor(v).to(device, non_blocking=True) for k, v in batch.items() if k != "dataset_names"}


def main(cfg: FinetuneConfig) -> Path:
    """Fine-tune as configured; returns the run directory."""
    from bridgelang_tpu_torch._device import resolve_device
    from bridgelang_tpu_torch.models.llm.tokenizer import get_tokenizer
    from bridgelang_tpu_torch.models.load import load_vla
    from bridgelang_tpu_torch.training.checkpointing import CheckpointManager, save_sidecars
    from bridgelang_tpu_torch.training.lora import add_lora_params, lora_trainable_mask
    from bridgelang_tpu_torch.training.metrics import VLAMetrics, build_trackers
    from bridgelang_tpu_torch.training.trainer import (
        OptimConfig, init_train_state, make_optimizer, make_vla_train_step)
    from bridgelang_tpu_torch.util.seeding import root_key, set_global_seed
    from bridgelang_tpu_torch.vla.materialize import get_vla_dataset_and_collator

    from bridgelang_tpu_torch.parallel.fsdp import MeshTraining, training_mesh
    from bridgelang_tpu_torch.parallel.sharding import data_rank_and_count

    if cfg.use_quantization and cfg.quantization_bits not in (4, 8):
        raise ValueError(f"quantization_bits must be 4 or 8, got {cfg.quantization_bits}")
    mesh, device = training_mesh(cfg.mesh_shape, resolve_device(cfg.device))
    set_global_seed(cfg.seed)
    data_rank, data_ranks = data_rank_and_count(mesh) if mesh is not None else (0, 1)

    exp_id = (
        f"{Path(cfg.vla_path).name}+{cfg.dataset_name}+b{cfg.batch_size}+lr-{cfg.learning_rate}"
        + (f"+lora-r{cfg.lora_rank}" if cfg.use_lora else "")
        + (f"+q-int{cfg.quantization_bits}" if cfg.use_quantization else "")
    )
    run_dir = Path(cfg.run_root_dir) / exp_id

    # the data processes start first and fill the shuffle buffer while the weights load
    shell, _ = load_vla(cfg.vla_path, load_weights=False, device=device)
    tokenizer = get_tokenizer(cfg.tokenizer_path)
    dataset, _, _ = get_vla_dataset_and_collator(
        cfg.data_root_dir,
        cfg.dataset_name,
        base_tokenizer=tokenizer,
        llm_family=shell.cfg.llm_family,
        batch_size=cfg.batch_size // data_ranks,
        prompt_bucket=prompt_bucket_for(tokenizer, cfg.action_chunk),
        shuffle_buffer_size=cfg.shuffle_buffer_size,
        image_aug=cfg.image_aug,
        pad_token_id=shell.cfg.llm.pad_token_id,
        action_chunk=cfg.action_chunk,
        seed=cfg.seed,
        num_workers=0 if device.type == "cpu" else None,  # the CPU's cores run the step too
        data_shard=(data_ranks, data_rank) if mesh is not None else None,
    )
    batches = iter(dataset)
    del shell

    model, params = load_vla(
        cfg.vla_path,
        quantize_int8=cfg.use_quantization and cfg.quantization_bits == 8,
        quantize_int4=cfg.use_quantization and cfg.quantization_bits == 4,
        w8a8=False,
        device=device,
    )
    if cfg.use_lora:
        params = dict(params, llm=add_lora_params(root_key(cfg.seed, device), params["llm"], rank=cfg.lora_rank))
        trainable = lora_trainable_mask(params)
    else:
        trainable = model.trainable_mask(params, "vla-full-train")

    statistics = jsonable(dataset.dataset_statistics)
    if overwatch.is_rank_zero():
        save_sidecars(run_dir, config_to_dict(cfg), statistics)
    model.norm_stats = {**model.norm_stats, **statistics}  # what the export serves

    ocfg = OptimConfig(learning_rate=cfg.learning_rate, lr_scheduler_type="constant", total_steps=cfg.max_steps)
    optimizer = make_optimizer(ocfg, params, trainable_mask=trainable, grad_accum_steps=cfg.grad_accumulation_steps)
    mesh_training = None
    if mesh is not None:
        mesh_training = MeshTraining.for_params(mesh, params)
        params = mesh_training.shard(params)
    step_fn = make_vla_train_step(model, optimizer, trainable_mask=trainable, image_transform=model.image_transform,
                                  remat_policy=cfg.remat_policy, parallel_decode_objective=cfg.parallel_decode,
                                  mesh=mesh_training)
    state = init_train_state(params, optimizer, trainable_mask=trainable, mesh=mesh_training)
    del params
    ckpt = CheckpointManager(run_dir)
    metrics = VLAMetrics(build_trackers(cfg.trackers.split(","), exp_id, run_dir, config_to_dict(cfg)),
                         exp_id, is_rank_zero=overwatch.is_rank_zero())
    source_hf = cfg.vla_path if Path(cfg.vla_path).is_dir() else None
    export_dir = run_dir if cfg.export_hf else None

    step, loss = 0, float("nan")
    with contextlib.closing(batches):
        for batch in batches:
            if step >= cfg.max_steps:
                break
            state, m = step_fn(state, to_device(batch, device))
            step += 1
            loss = float(m["loss"])
            metrics.commit(global_step=step, loss=loss, action_accuracy=float(m["action_accuracy"]),
                           l1_loss=float(m["l1_loss"]))
            if step % 10 == 0:
                overwatch.info(metrics.push())
            if step % cfg.save_steps == 0:
                _save(ckpt, state, step, loss, trainable if cfg.use_lora else None, model, export_dir, source_hf,
                      mesh_training)
    _save(ckpt, state, step, loss, trainable if cfg.use_lora else None, model, export_dir, source_hf, mesh_training)
    metrics.finalize()
    return run_dir


def _save(ckpt, state, step: int, loss: float, lora_mask=None, model=None, hf_export_dir=None, source_hf=None,
          mesh_training=None):
    """The checkpoint (a LoRA run's: its trainable state, `lora_mask`), and
    with `hf_export_dir` the HF export (`<hf_export_dir>/hf_export`, latest
    only) of the parameters with the adapters merged into the base (the
    reference's merge-and-unload), in the source checkpoint's dtype. On a
    mesh every rank saves its blocks and joins the gathers; rank 0 alone
    writes the export."""
    from bridgelang_tpu_torch.extern.hf_export import export_checkpoint, source_dtype
    from bridgelang_tpu_torch.parallel.fsdp import full_params
    from bridgelang_tpu_torch.training.lora import merge_lora

    ckpt.save(state, step=step, epoch=0, loss=loss, only_trainable_mask=lora_mask, mesh=mesh_training)
    if hf_export_dir is not None and model is not None:
        whole = full_params(mesh_training, state.params)
        if not overwatch.is_rank_zero():
            return
        params = dict(whole, llm=merge_lora(whole["llm"])) if lora_mask is not None else whole
        dtype = source_dtype(source_hf) if source_hf is not None else torch.float32
        export_checkpoint(model, params, Path(hf_export_dir) / "hf_export", source_hf=source_hf, dtype=dtype)


if __name__ == "__main__":
    main(parse_cli(FinetuneConfig))
