"""VLM experiment configs (`ModelConfig` ChoiceRegistry), host only.

The port's copy of bridgelang_tpu/conf/models.py: every variant pins the
vision backbone, LLM backbone, arch specifier, resize strategy and the
two-stage (align / finetune) hyperparameters, under the reference's ids
(prismatic/conf/models.py), so checkpoints and command lines carry over.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum, unique
from typing import Optional

from bridgelang_tpu_torch.conf.registry import ChoiceRegistry


@dataclass(frozen=True)
class ModelConfig(ChoiceRegistry):
    model_id: str = "prism-dinosiglip-224px+7b"
    arch_specifier: str = "no-align+fused-gelu-mlp"

    vision_backbone_id: str = "dinosiglip-vit-so-224px"
    llm_backbone_id: str = "llama2-7b-pure"

    image_resize_strategy: str = "resize-naive"
    llm_max_length: int = 2048

    # Align stage (projector-only pretraining) hparams
    align_epochs: int = 1
    align_max_steps: Optional[int] = None
    align_global_batch_size: int = 256
    align_per_device_batch_size: int = 16
    align_learning_rate: float = 1e-3
    align_weight_decay: float = 0.0
    align_max_grad_norm: float = 1.0
    align_lr_scheduler_type: str = "linear-warmup+cosine-decay"
    align_warmup_ratio: float = 0.03
    align_train_strategy: str = "fsdp-shard-grad-op"

    # Finetune stage (full VLM training) hparams
    finetune_epochs: int = 1
    finetune_max_steps: Optional[int] = None
    finetune_global_batch_size: int = 128
    finetune_per_device_batch_size: int = 16
    finetune_learning_rate: float = 2e-5
    finetune_weight_decay: float = 0.1
    finetune_max_grad_norm: float = 1.0
    finetune_lr_scheduler_type: str = "linear-warmup+cosine-decay"
    finetune_warmup_ratio: float = 0.03
    finetune_train_strategy: str = "fsdp-full-shard"

    enable_gradient_checkpointing: bool = True
    enable_mixed_precision_training: bool = True
    reduce_in_full_precision: bool = False


def _register(model_id: str, **kw) -> None:
    ModelConfig.register_subclass(model_id, _make_variant(model_id, dict(model_id=model_id, **kw)))


def _make_variant(model_id: str, defaults: dict) -> type:
    import dataclasses as _dc

    base_fields = {f.name: f for f in _dc.fields(ModelConfig)}
    new_fields = []
    for name, f in base_fields.items():
        default = defaults.get(name, f.default)
        new_fields.append((name, f.type, _dc.field(default=default)))
    cls = _dc.make_dataclass(
        "ModelConfig_" + model_id.replace("-", "_").replace("+", "_").replace(".", "_"),
        new_fields,
        bases=(ModelConfig,),
        frozen=True,
    )
    return cls


# --- Registered variants (ids match reference prismatic/conf/models.py) ------

# Reproduction LLaVa v1.5 (CLIP + Vicuna, letterbox-free "resize" naive path uses letterbox in ref)
_register(
    "reproduction-llava-v15+7b",
    arch_specifier="gelu-mlp",
    vision_backbone_id="clip-vit-l-336px",
    llm_backbone_id="vicuna-v15-7b",
    image_resize_strategy="letterbox",
)
_register(
    "reproduction-llava-v15+13b",
    arch_specifier="gelu-mlp",
    vision_backbone_id="clip-vit-l-336px",
    llm_backbone_id="vicuna-v15-13b",
    image_resize_strategy="letterbox",
)

# One-stage (no-align) Prism models
_register(
    "one-stage+7b",
    arch_specifier="no-align+gelu-mlp",
    vision_backbone_id="clip-vit-l-336px",
    llm_backbone_id="vicuna-v15-7b",
    image_resize_strategy="letterbox",
)

# Single-backbone ablations
for _vb in ("clip-vit-l", "siglip-vit-so400m", "dinov2-vit-l", "in1k-vit-l"):
    _register(
        f"{_vb}+7b",
        arch_specifier="no-align+gelu-mlp",
        vision_backbone_id=_vb,
        llm_backbone_id="vicuna-v15-7b",
        image_resize_strategy="letterbox",
    )

# Prism flagship family (fused DINOv2 + SigLIP)
_register(
    "prism-clip+7b",
    arch_specifier="no-align+gelu-mlp",
    vision_backbone_id="clip-vit-l-336px",
    llm_backbone_id="llama2-7b-pure",
    image_resize_strategy="resize-naive",
)
_register(
    "prism-siglip+7b",
    arch_specifier="no-align+gelu-mlp",
    vision_backbone_id="siglip-vit-so400m-384px",
    llm_backbone_id="llama2-7b-pure",
    image_resize_strategy="resize-naive",
)
_register(
    "prism-dinosiglip+7b",
    arch_specifier="no-align+fused-gelu-mlp",
    vision_backbone_id="dinosiglip-vit-so-384px",
    llm_backbone_id="llama2-7b-pure",
    image_resize_strategy="resize-naive",
)
_register(
    "prism-dinosiglip-224px+7b",
    arch_specifier="no-align+fused-gelu-mlp",
    vision_backbone_id="dinosiglip-vit-so-224px",
    llm_backbone_id="llama2-7b-pure",
    image_resize_strategy="resize-naive",
)
_register(
    "prism-dinosiglip+13b",
    arch_specifier="no-align+fused-gelu-mlp",
    vision_backbone_id="dinosiglip-vit-so-384px",
    llm_backbone_id="llama2-13b-pure",
    image_resize_strategy="resize-naive",
)
_register(
    "prism-dinosiglip-controlled+7b",
    arch_specifier="no-align+fused-gelu-mlp",
    vision_backbone_id="dinosiglip-vit-so-224px",
    llm_backbone_id="vicuna-v15-7b",
    image_resize_strategy="letterbox",
)
_register(
    "prism-mistral-dinosiglip+7b",
    arch_specifier="no-align+fused-gelu-mlp",
    vision_backbone_id="dinosiglip-vit-so-224px",
    llm_backbone_id="mistral-v0.1-7b-pure",
    image_resize_strategy="resize-naive",
)
_register(
    "prism-phi-dinosiglip+3b",
    arch_specifier="no-align+fused-gelu-mlp",
    vision_backbone_id="dinosiglip-vit-so-224px",
    llm_backbone_id="phi-2-3b",
    image_resize_strategy="resize-naive",
)
_register(  # DeepSeek-V2-Lite under the fused towers: latent attention, 64 routed experts (bf16 serving only)
    "prism-deepseekv2lite-dinosiglip+16b",
    arch_specifier="no-align+fused-gelu-mlp",
    vision_backbone_id="dinosiglip-vit-so-224px",
    llm_backbone_id="deepseek-v2-lite-pure",
    image_resize_strategy="resize-naive",
)

# --- Extended registry: remaining reference variants (prismatic/conf/models.py
# ids; hparams inherit family defaults unless noted) ---
_register(
    "one-stage+13b",
    arch_specifier="no-align+gelu-mlp",
    vision_backbone_id="clip-vit-l-336px",
    llm_backbone_id="vicuna-v15-13b",
    image_resize_strategy="letterbox",
)
for _mid in ("full-ft-multi-stage+7b", "full-ft-one-stage+7b"):
    _register(
        _mid,
        arch_specifier="gelu-mlp" if "multi" in _mid else "no-align+gelu-mlp",
        vision_backbone_id="clip-vit-l-336px",
        llm_backbone_id="vicuna-v15-7b",
        image_resize_strategy="letterbox",
    )
# Vision-backbone ablations at 224px
for _mid, _vb in (("in1k-224px+7b", "in1k-vit-l"), ("dinov2-224px+7b", "dinov2-vit-l"),
                  ("clip-224px+7b", "clip-vit-l"), ("siglip-224px+7b", "siglip-vit-so400m")):
    _register(_mid, arch_specifier="no-align+gelu-mlp", vision_backbone_id=_vb,
              llm_backbone_id="vicuna-v15-7b", image_resize_strategy="letterbox")
# Resolution / resize-strategy ablations
for _mid, _vb, _strategy in (
    ("clip-336px-resize-crop+7b", "clip-vit-l-336px", "resize-crop"),
    ("clip-336px-resize-naive+7b", "clip-vit-l-336px", "resize-naive"),
    ("siglip-384px-letterbox+7b", "siglip-vit-so400m-384px", "letterbox"),
    ("siglip-384px-resize-crop+7b", "siglip-vit-so400m-384px", "resize-crop"),
    ("siglip-384px-resize-naive+7b", "siglip-vit-so400m-384px", "resize-naive"),
    ("dinoclip-336px-letterbox+7b", "dinoclip-vit-l-336px", "letterbox"),
    ("dinoclip-336px-resize-naive+7b", "dinoclip-vit-l-336px", "resize-naive"),
    ("dinosiglip-384px-letterbox+7b", "dinosiglip-vit-so-384px", "letterbox"),
    ("dinosiglip-384px-resize-naive+7b", "dinosiglip-vit-so-384px", "resize-naive"),
):
    _register(_mid, arch_specifier="no-align+fused-gelu-mlp" if "dino" in _vb else "no-align+gelu-mlp",
              vision_backbone_id=_vb, llm_backbone_id="vicuna-v15-7b", image_resize_strategy=_strategy)
# LLM-backbone ablations
for _mid, _llm in (("llama2+7b", "llama2-7b-pure"), ("llama2+13b", "llama2-13b-pure"),
                   ("llama2-chat+7b", "llama2-7b-chat"), ("llama2-chat+13b", "llama2-13b-chat"),
                   ("mistral-v0.1+7b", "mistral-v0.1-7b-pure"),
                   ("mistral-instruct-v0.1+7b", "mistral-v0.1-7b-instruct"),
                   ("phi-2+3b", "phi-2-3b"),
                   ("vicuna-no-cotraining+7b", "vicuna-v15-7b"), ("llama2-no-cotraining+7b", "llama2-7b-pure")):
    _register(_mid, arch_specifier="no-align+gelu-mlp", vision_backbone_id="clip-vit-l-336px",
              llm_backbone_id=_llm, image_resize_strategy="letterbox")
# Schedule / data ablations
for _mid, _ep in (("train-1.25-epochs+7b", 2), ("train-1.5-epochs+7b", 2),
                  ("train-2-epochs+7b", 2), ("train-3-epochs+7b", 3)):
    _register(_mid, arch_specifier="no-align+gelu-mlp", vision_backbone_id="siglip-vit-so400m-384px",
              llm_backbone_id="vicuna-v15-7b", image_resize_strategy="letterbox", finetune_epochs=_ep)
for _mid in ("llava-lvis4v+7b", "llava-lrv+7b", "llava-lvis4v-lrv+7b"):
    _register(_mid, arch_specifier="no-align+gelu-mlp", vision_backbone_id="siglip-vit-so400m-384px",
              llm_backbone_id="vicuna-v15-7b", image_resize_strategy="letterbox")
# Prism controlled + full-recipe family
for _mid, _vb, _llm, _strategy in (
    ("prism-clip-controlled+7b", "clip-vit-l-336px", "vicuna-v15-7b", "letterbox"),
    ("prism-clip-controlled+13b", "clip-vit-l-336px", "vicuna-v15-13b", "letterbox"),
    ("prism-clip+13b", "clip-vit-l-336px", "llama2-13b-pure", "resize-naive"),
    ("prism-siglip-controlled+7b", "siglip-vit-so400m-384px", "vicuna-v15-7b", "letterbox"),
    ("prism-siglip+13b", "siglip-vit-so400m-384px", "llama2-13b-pure", "resize-naive"),
    ("prism-dinosiglip-controlled+13b", "dinosiglip-vit-so-384px", "vicuna-v15-13b", "letterbox"),
    ("prism-dinosiglip-224px-controlled+7b", "dinosiglip-vit-so-224px", "vicuna-v15-7b", "letterbox"),
):
    _register(_mid, arch_specifier="no-align+fused-gelu-mlp" if "dino" in _vb else "no-align+gelu-mlp",
              vision_backbone_id=_vb, llm_backbone_id=_llm, image_resize_strategy=_strategy)
