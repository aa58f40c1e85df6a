"""VLA experiment configs (`VLAConfig` ChoiceRegistry), host only.

The port's copy of bridgelang_tpu/conf/vla.py (the reference's
prismatic/conf/vla.py ids), field for field: `expected_device_count` and
`mesh_shape` keep the JAX package's names, so a config serialized by either
package reads in the other.
"""

from __future__ import annotations

from dataclasses import make_dataclass, field, fields, dataclass
from typing import Optional

from bridgelang_tpu_torch.conf.registry import ChoiceRegistry


@dataclass(frozen=True)
class VLAConfig(ChoiceRegistry):
    vla_id: str = "prism-dinosiglip-224px+mx-oxe-magic-soup-plus"
    base_vlm: str = "prism-dinosiglip-224px+7b"

    freeze_vision_backbone: bool = False
    freeze_llm_backbone: bool = False
    unfreeze_last_llm_layer: bool = False

    # Data mixture (reference: rlds/oxe/mixtures.py ids)
    data_mix: str = "oxe_magic_soup_plus_minus"
    shuffle_buffer_size: int = 256_000

    # Scale gate + optimization (reference: conf/vla.py:126-136 — flagship is
    # 64 A100s, global batch 2048)
    expected_device_count: int = 64
    global_batch_size: int = 2048
    per_device_batch_size: int = 32

    epochs: int = 1000
    max_steps: Optional[int] = None
    learning_rate: float = 2e-5
    weight_decay: float = 0.0
    max_grad_norm: float = 1.0
    lr_scheduler_type: str = "constant"
    warmup_ratio: float = 0.0

    train_strategy: str = "fsdp-full-shard"
    enable_gradient_checkpointing: bool = True
    enable_mixed_precision_training: bool = True
    reduce_in_full_precision: bool = True

    # Additions of the JAX package (no reference equivalent): explicit mesh knobs.
    mesh_shape: Optional[str] = None  # e.g. "replica=2,fsdp=32"; None = auto
    save_interval: int = 2500
    image_aug: bool = False
    seed: int = 7


def _register(vla_id: str, **kw) -> None:
    defaults = dict(vla_id=vla_id, **kw)
    new_fields = [(f.name, f.type, field(default=defaults.get(f.name, f.default))) for f in fields(VLAConfig)]
    cls = make_dataclass(
        "VLAConfig_" + vla_id.replace("-", "_").replace("+", "_").replace(".", "_"),
        new_fields,
        bases=(VLAConfig,),
        frozen=True,
    )
    VLAConfig.register_subclass(vla_id, cls)


# === Registered experiments (ids match reference conf/vla.py) ===

# Bridge-only dev configs (reference: conf/vla.py:44-103)
_register(
    "debug",
    base_vlm="prism-dinosiglip-224px+7b",
    data_mix="bridge",
    shuffle_buffer_size=16,
    expected_device_count=1,
    global_batch_size=2,
    per_device_batch_size=2,
)
_register(
    "prism-dinosiglip-224px+mx-bridge",
    data_mix="bridge",
    shuffle_buffer_size=256_000,
    expected_device_count=8,
    global_batch_size=256,
    per_device_batch_size=32,
)
_register(
    "prism-dinosiglip-224px+mx-oxe-magic-soup",
    data_mix="oxe_magic_soup",
    expected_device_count=64,
    global_batch_size=2048,
    per_device_batch_size=32,
)
# Flagship: openvla-7b training config (reference: conf/vla.py:126-136)
_register(
    "prism-dinosiglip-224px+mx-oxe-magic-soup-plus",
    data_mix="oxe_magic_soup_plus_minus",
    expected_device_count=64,
    global_batch_size=2048,
    per_device_batch_size=32,
    shuffle_buffer_size=1_000_000,
    image_aug=True,
)
# Fine-tuning mixes (reference: conf/vla.py droid/tdroid/libero entries)
for _mix in (
    "droid_wipe",
    "tdroid_carrot_in_bowl",
    "libero_spatial_no_noops",
    "libero_object_no_noops",
    "libero_goal_no_noops",
    "libero_10_no_noops",
):
    _register(
        f"prism-dinosiglip-224px+mx-{_mix.replace('_', '-')}",
        data_mix=_mix,
        expected_device_count=8,
        global_batch_size=256,
        per_device_batch_size=32,
        shuffle_buffer_size=256_000,
        image_aug=True,
    )

# --- Remaining reference experiment ids (prismatic/conf/vla.py) ---
_register(
    "siglip-224px+mx-bridge",
    base_vlm="siglip-224px+7b",
    data_mix="bridge",
    expected_device_count=8,
    global_batch_size=256,
    per_device_batch_size=32,
    shuffle_buffer_size=256_000,
)
_register(
    "siglip-224px-icy+mx-bridge",
    base_vlm="siglip-224px+7b",
    freeze_vision_backbone=True,
    data_mix="bridge",
    expected_device_count=8,
    global_batch_size=256,
    per_device_batch_size=32,
    shuffle_buffer_size=256_000,
)
_register(
    "siglip-224px+mx-oxe-magic-soup",
    base_vlm="siglip-224px+7b",
    data_mix="oxe_magic_soup",
    expected_device_count=64,
    global_batch_size=2048,
    per_device_batch_size=32,
)
for _suffix, _kw in (
    ("siglip-224px+mx-tdroid_carrot_in_bowl", {}),
    ("siglip-224px+mx-tdroid_pour_corn_in_pot", {"data_mix": "tdroid_pour_corn_in_pot"}),
    ("siglip-224px-icy+mx-tdroid_carrot_in_bowl", {"freeze_vision_backbone": True}),
    ("siglip-224px-last_layer+mx-tdroid_carrot_in_bowl",
     {"freeze_vision_backbone": True, "freeze_llm_backbone": True, "unfreeze_last_llm_layer": True}),
    ("siglip-224px-sandwich+mx-tdroid_carrot_in_bowl",
     {"freeze_llm_backbone": True, "unfreeze_last_llm_layer": True}),
):
    _register(
        _suffix,
        base_vlm="siglip-224px+7b",
        data_mix=_kw.pop("data_mix", "tdroid_carrot_in_bowl"),
        expected_device_count=8,
        global_batch_size=128,
        per_device_batch_size=16,
        shuffle_buffer_size=100_000,
        image_aug=True,
        **_kw,
    )
_register(
    "siglip-224px+mx-droid_wipe",
    base_vlm="siglip-224px+7b",
    data_mix="droid_wipe",
    expected_device_count=8,
    global_batch_size=128,
    per_device_batch_size=16,
    shuffle_buffer_size=100_000,
    image_aug=True,
)
