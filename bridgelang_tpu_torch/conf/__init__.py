from bridgelang_tpu_torch.conf.registry import ChoiceRegistry, parse_cli, config_to_dict, save_config
from bridgelang_tpu_torch.conf.models import ModelConfig
from bridgelang_tpu_torch.conf.vla import VLAConfig
from bridgelang_tpu_torch.conf.datasets import DatasetConfig

__all__ = [
    "ChoiceRegistry",
    "parse_cli",
    "config_to_dict",
    "save_config",
    "ModelConfig",
    "VLAConfig",
    "DatasetConfig",
]
