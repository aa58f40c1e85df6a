"""What the benchmark asks of the port: the model a configuration file
describes, built through the port's own classes, and the checks that the
file is what runs.

The only module of the benchmark besides the drivers that imports
`bridgelang_tpu_torch`; the reference never imports it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def vlm_config(cfg: Dict):
    """The port's VLMConfig for the file's "port" section. With
    "registry_check" (the default) the file's decoder and towers must equal
    what the port registers under its ids."""
    from bridgelang_tpu_torch.models.llm.llama import LLM_CONFIGS
    from bridgelang_tpu_torch.models.vision.vit import FUSED_BACKBONES, VIT_CONFIGS, ViTConfig
    from bridgelang_tpu_torch.models.vlm import VLMConfig

    port = cfg["port"]
    base = LLM_CONFIGS[port["llm_backbone_id"]]
    llm = dataclasses.replace(base, **port["llm"])
    vit_fields = {f.name for f in dataclasses.fields(ViTConfig)}
    towers = tuple(ViTConfig(**{k: v for k, v in t.items() if k in vit_fields}) for t in port["towers"])
    if port.get("registry_check", True):
        if llm != base:
            raise ValueError(f"{cfg['name']}: the file's decoder differs from the port's {port['llm_backbone_id']}: "
                             f"{dataclasses.asdict(llm)} vs {dataclasses.asdict(base)}")
        registered = tuple(VIT_CONFIGS[i] for i in FUSED_BACKBONES[port["vision_backbone_id"]])
        if towers != registered:
            raise ValueError(f"{cfg['name']}: the file's towers differ from the port's {port['vision_backbone_id']}")
    return VLMConfig(model_id=port["model_id"], vision_backbone_id=port["vision_backbone_id"],
                     llm_backbone_id=port["llm_backbone_id"], arch_specifier=port["arch_specifier"],
                     llm=llm, vision_override=towers)


def build_model(cfg: Dict, dtype: torch.dtype, device):
    """The port's OpenVLA for the file (byte-fallback tokenizer, the file's
    statistics and image transform)."""
    from bridgelang_tpu_torch.models.llm.tokenizer import ByteFallbackTokenizer
    from bridgelang_tpu_torch.models.vla import OpenVLA
    from bridgelang_tpu_torch.ops.image_ops import ImageTowerSpec, ImageTransformConfig

    model = OpenVLA(vlm_config(cfg), cfg["norm_stats"], tokenizer=ByteFallbackTokenizer(), dtype=dtype,
                    device=device)
    if model.cfg.llm_family != cfg["port"]["llm_family"]:
        raise ValueError(f"the port calls {cfg['port']['llm_backbone_id']} {model.cfg.llm_family!r}, "
                         f"the file {cfg['port']['llm_family']!r}")
    model.image_transform = ImageTransformConfig("resize-naive", tuple(
        ImageTowerSpec(size=t["image_size"], mean=tuple(t["mean"]), std=tuple(t["std"])) for t in cfg["port"]["towers"]))
    return model


def check_layout(model, params: Dict) -> None:
    """The benchmark's weights have exactly the names and shapes of the
    port's vision modules and projector (the decoder reads its leaves by
    name, and a missing one raises)."""
    want = {n: tuple(p.shape) for n, p in model.vision_module.named_parameters()}
    got = {n: tuple(t.shape) for n, t in params["vision"].items()}
    if want != got:
        raise ValueError(f"vision leaves differ: missing {sorted(set(want) - set(got))[:5]}, "
                         f"extra {sorted(set(got) - set(want))[:5]}")
    want = {n: tuple(p.shape) for n, p in model.projector.named_parameters()}
    if want != {n: tuple(t.shape) for n, t in params["projector"].items()}:
        raise ValueError("projector leaves differ")


def device_facts(device) -> Tuple[str, str, int]:
    dev = torch.device(device)
    if dev.type == "cuda":
        return "gpu", torch.cuda.get_device_name(dev), 1
    return "cpu", "cpu", 1


def memory_peak(device) -> int:
    return int(torch.cuda.max_memory_allocated()) if torch.device(device).type == "cuda" else 0
