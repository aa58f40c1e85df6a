"""Vision -> LLM projectors (linear / gelu-mlp / fused-gelu-mlp).

Counterpart of bridgelang_tpu/models/projector.py. GELU is exact.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F


def projector_kind(arch_specifier: str) -> str:
    if arch_specifier.endswith("linear"):
        return "linear"
    if arch_specifier.endswith("fused-gelu-mlp"):
        return "fused-gelu-mlp"
    if arch_specifier.endswith("gelu-mlp"):
        return "gelu-mlp"
    raise ValueError(f"Projector for arch specifier {arch_specifier!r} is not supported")


class Projector(nn.Module):
    """[B, P, vision_dim] -> [B, P, llm_dim].

      linear         : fc1
      gelu-mlp       : fc1 -> gelu -> fc2                       (vision -> llm -> llm)
      fused-gelu-mlp : fc1 -> gelu -> fc2 -> gelu -> fc3         (vision -> 4*vision -> llm -> llm)
    """

    def __init__(self, arch_specifier: str, vision_dim: int, llm_dim: int, device=None):
        super().__init__()
        self.kind = projector_kind(arch_specifier)
        if self.kind == "linear":
            dims = [(vision_dim, llm_dim)]
        elif self.kind == "gelu-mlp":
            dims = [(vision_dim, llm_dim), (llm_dim, llm_dim)]
        else:
            dims = [(vision_dim, 4 * vision_dim), (4 * vision_dim, llm_dim), (llm_dim, llm_dim)]
        for i, (din, dout) in enumerate(dims):
            self.add_module(f"fc{i + 1}", nn.Linear(din, dout, device=device))
        self.n_layers = len(dims)

    def forward(self, patches: torch.Tensor) -> torch.Tensor:
        h = patches
        for i in range(1, self.n_layers + 1):
            h = getattr(self, f"fc{i}")(h)
            if i < self.n_layers:
                h = F.gelu(h)
        return h


def init_projector_params(
    module: Projector, generator: torch.Generator, dtype: torch.dtype, device: torch.device,
) -> Dict[str, torch.Tensor]:
    """Weights normal * fan_in^-0.5, biases zero (the JAX package's init)."""
    out: Dict[str, torch.Tensor] = {}
    for name, p in module.named_parameters():
        if name.endswith("weight"):
            out[name] = torch.randn(p.shape, generator=generator, device=device, dtype=dtype).mul_(p.shape[1] ** -0.5)
        else:
            out[name] = torch.zeros(p.shape, device=device, dtype=dtype)
    return out
