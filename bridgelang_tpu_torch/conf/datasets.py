"""VLM pretraining dataset configs (`DatasetConfig` ChoiceRegistry), host only.

The port's copy of bridgelang_tpu/conf/datasets.py (the reference's
prismatic/conf/datasets.py): each entry names the align-stage and
finetune-stage annotation JSON + image roots relative to a dataset root.
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields, make_dataclass
from pathlib import Path
from typing import Tuple

from bridgelang_tpu_torch.conf.registry import ChoiceRegistry


@dataclass(frozen=True)
class DatasetConfig(ChoiceRegistry):
    dataset_id: str = "llava-v15"
    # (annotation json, image dir) pairs relative to dataset_root_dir
    align_stage_components: Tuple[str, str] = (
        "download/llava-laion-cc-sbu-558k/chat.json",
        "download/llava-laion-cc-sbu-558k",
    )
    finetune_stage_components: Tuple[str, str] = (
        "download/llava-v1.5-instruct/llava_v1_5_mix665k.json",
        "download/llava-v1.5-instruct",
    )
    dataset_root_dir: str = "data"


def _register(dataset_id: str, **kw) -> None:
    defaults = dict(dataset_id=dataset_id, **kw)
    new_fields = [(f.name, f.type, field(default=defaults.get(f.name, f.default))) for f in fields(DatasetConfig)]
    cls = make_dataclass(
        "DatasetConfig_" + dataset_id.replace("-", "_").replace("+", "_"),
        new_fields,
        bases=(DatasetConfig,),
        frozen=True,
    )
    DatasetConfig.register_subclass(dataset_id, cls)


_register("llava-v15")
_register(
    "llava-multimodal",
    finetune_stage_components=(
        "download/llava-v1.5-instruct/llava_v1_5_stripped625k.json",
        "download/llava-v1.5-instruct",
    ),
)
_register(
    "llava-lvis4v",
    finetune_stage_components=(
        "download/llava-v1.5-instruct/llava_v1_5_lvis4v_mix888k.json",
        "download/llava-v1.5-instruct",
    ),
)
_register(
    "llava-lrv",
    finetune_stage_components=(
        "download/llava-v1.5-instruct/llava_v1_5_lrv_mix1008k.json",
        "download/llava-v1.5-instruct",
    ),
)
_register(
    "llava-lvis4v-lrv",
    finetune_stage_components=(
        "download/llava-v1.5-instruct/llava_v1_5_lvis4v_lrv_mix1231k.json",
        "download/llava-v1.5-instruct",
    ),
)
