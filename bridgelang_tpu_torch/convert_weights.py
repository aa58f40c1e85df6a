"""Checkpoint conversion: a port run dir -> the HF OpenVLA format, and checks.

Counterpart of scripts/convert_weights.py (`ConvertConfig`, the same fields
plus `device`):

    # a training checkpoint of the port (training/checkpointing.py) -> HF directory
    python -m bridgelang_tpu_torch.convert_weights --direction to_hf \\
        --run_dir runs/myrun --out_dir /ckpts/myrun-hf [--checkpoint DIR] [--source_hf /ckpts/openvla-7b]

    # an HF checkpoint loads: parameter count and norm-stats keys
    python -m bridgelang_tpu_torch.convert_weights --direction verify_hf --checkpoint /ckpts/openvla-7b

`to_hf` restores the run's latest checkpoint (or `--checkpoint`) into a
fresh `init_train_state` of the `--base_vlm` model and exports its params
(`extern/hf_export.export_checkpoint`). A LoRA run's adapters are restored
with it and merged before the export. `--source_hf` is the HF checkpoint
the run started from: it supplies the frozen weights a checkpoint saved
with `only_trainable_mask` does not hold, and the export passes its unused
tensors through. The device defaults to CUDA (`--device cpu` to run on the
host).
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

import torch

from bridgelang_tpu_torch.conf import parse_cli


@dataclass
class ConvertConfig:
    direction: str = "to_hf"  # to_hf | verify_hf
    run_dir: Optional[str] = None
    checkpoint: Optional[str] = None  # specific checkpoint dir (default: latest)
    out_dir: str = "hf_export"
    base_vlm: str = "prism-dinosiglip-224px+7b"
    # The HF checkpoint the run started from: its frozen weights, and its
    # dead tensors (final ViT blocks, SigLIP pool head) passed through.
    source_hf: Optional[str] = None
    device: Optional[str] = None  # cuda (default) | cpu


def _lora_rank(saved_params) -> Optional[int]:
    """The adapters' rank in a saved params tree (None without adapters)."""
    for lp in saved_params["llm"]["layers"]:
        for k, v in lp.items():
            if k.endswith("_lora_a") and v is not None:
                return int(v.shape[0])
    return None


def _has_none(tree) -> bool:
    if isinstance(tree, dict):
        return any(_has_none(v) for v in tree.values())
    if isinstance(tree, list):
        return any(_has_none(v) for v in tree)
    return tree is None


def to_hf(cfg: ConvertConfig) -> Path:
    from bridgelang_tpu_torch._device import resolve_device
    from bridgelang_tpu_torch.conf.models import ModelConfig
    from bridgelang_tpu_torch.extern.hf_export import export_checkpoint
    from bridgelang_tpu_torch.models.load import load_vla
    from bridgelang_tpu_torch.models.vla import OpenVLA
    from bridgelang_tpu_torch.models.vlm import VLMConfig
    from bridgelang_tpu_torch.training.checkpointing import STATE_FILE, CheckpointManager, load_dataset_statistics
    from bridgelang_tpu_torch.training.lora import add_lora_params, lora_trainable_mask, merge_lora
    from bridgelang_tpu_torch.training.trainer import OptimConfig, init_train_state, make_optimizer

    if cfg.run_dir is None:
        raise ValueError("--direction to_hf needs --run_dir")
    device = resolve_device(cfg.device)
    run_dir = Path(cfg.run_dir)
    mgr = CheckpointManager(run_dir)
    ckpt_path = Path(cfg.checkpoint) if cfg.checkpoint else mgr.latest()
    if ckpt_path is None:
        raise FileNotFoundError(f"no checkpoint under {run_dir}")
    saved = torch.load(ckpt_path / STATE_FILE, map_location="cpu", weights_only=True)["params"]
    if _has_none(saved) and cfg.source_hf is None:
        raise ValueError(f"{ckpt_path} holds the trainable parameters only (saved with only_trainable_mask): "
                         "pass --source_hf, the HF checkpoint the run started from")

    if cfg.source_hf is not None:
        model, params = load_vla(cfg.source_hf, device=device)
    else:
        base = ModelConfig.get(cfg.base_vlm)
        vlm_cfg = VLMConfig.from_ids(model_id=base.model_id, vision_backbone_id=base.vision_backbone_id,
                                     llm_backbone_id=base.llm_backbone_id, arch_specifier=base.arch_specifier,
                                     image_resize_strategy=base.image_resize_strategy)
        model = OpenVLA(vlm_cfg, {}, dtype=torch.bfloat16, device=device)
        params = model.init_params(torch.Generator(device=device).manual_seed(0))
    stats_file = run_dir / "dataset_statistics.json"
    if stats_file.exists():
        model.norm_stats = load_dataset_statistics(stats_file)

    rank = _lora_rank(saved)
    mask = None
    if rank is not None:
        params = dict(params, llm=add_lora_params(torch.Generator(device=device).manual_seed(0), params["llm"],
                                                  rank=rank))
        mask = lora_trainable_mask(params)
    optimizer = make_optimizer(OptimConfig(), params, trainable_mask=mask)
    state = mgr.restore(ckpt_path, init_train_state(params, optimizer, trainable_mask=mask))
    params = state.params
    if rank is not None:
        params = dict(params, llm=merge_lora(params["llm"]))
    out = export_checkpoint(model, params, cfg.out_dir, source_hf=cfg.source_hf)
    print(f"to_hf: wrote {out}")
    return out


def verify_hf(cfg: ConvertConfig):
    from bridgelang_tpu_torch.models.load import load_vla
    from bridgelang_tpu_torch.training.trainer import tree_leaves

    model, params = load_vla(cfg.checkpoint, dtype=torch.bfloat16, device=cfg.device)
    n = sum(t.numel() for t in tree_leaves(params))
    print(f"verify_hf: loaded {cfg.checkpoint} ({n / 1e9:.2f}B params, norm_stats keys: {list(model.norm_stats)})")
    return model, params


def main(argv: Optional[List[str]] = None) -> None:
    cfg = parse_cli(ConvertConfig, argv)
    if cfg.direction == "verify_hf":
        verify_hf(cfg)
    elif cfg.direction == "to_hf":
        to_hf(cfg)
    else:
        raise ValueError(f"--direction must be to_hf or verify_hf, got {cfg.direction!r}")


if __name__ == "__main__":
    main()
