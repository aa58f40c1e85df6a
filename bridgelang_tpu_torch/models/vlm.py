"""PrismaticVLM in torch: fused-backbone VLM with fuse-after-BOS and greedy
KV-cache generation.

Counterpart of bridgelang_tpu/models/vlm.py (the serving half). The model
object holds configs and module definitions; parameters travel separately as
a dict {"vision", "projector", "llm"}, as in the JAX package. The vision and
projector modules live on the `meta` device and run through
`torch.func.functional_call` over that dict.

Generation: one prefill of the fused sequence into a preallocated bf16 KV
cache (contiguous write, attention through the flash kernel with the true
per-example lengths), then `max_new_tokens - 1` single-token decode steps in
a Python loop. Unlike the JAX package, the prefill always takes the flash
kernel: the JAX package's short-prompt switch to einsum attention
(`_prefill_impl`) rests on a TPU measurement and is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch.func import functional_call

from bridgelang_tpu_torch._device import resolve_device
from bridgelang_tpu_torch.models.llm.llama import (
    LLM_FAMILIES,
    LLMConfig,
    embed_tokens,
    init_kv_cache,
    init_llm_params,
    llm_forward,
    lm_logits,
)
from bridgelang_tpu_torch.models.projector import Projector, init_projector_params
from bridgelang_tpu_torch.models.vision.vit import FusedViT, ViT, build_vision_backbone, init_vision_params
from bridgelang_tpu_torch.ops.image_ops import transform_config_for_backbone

# Llama SPIECE_UNDERLINE token ('▁'): training prompts end with it, so inference must too.
LLAMA_EMPTY_TOKEN = 29871

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class VLMConfig:
    model_id: str = "prism-dinosiglip-224px+7b"
    vision_backbone_id: str = "dinosiglip-vit-so-224px"
    llm_backbone_id: str = "llama2-7b-pure"
    arch_specifier: str = "no-align+fused-gelu-mlp"
    image_resize_strategy: str = "resize-naive"
    llm_max_length: int = 2048
    llm: LLMConfig = dataclasses.field(default_factory=LLMConfig)
    # Explicit vision config(s) overriding the registry: a ViTConfig, or a
    # (ViTConfig, ViTConfig) pair for fused towers (tiny test models).
    vision_override: Optional[Any] = None

    @property
    def llm_family(self) -> str:
        return LLM_FAMILIES.get(self.llm_backbone_id, "llama2-pure")


class PrismaticVLM:
    """Model orchestrator: configs + module definitions, and functions over
    the parameter dict. `device` defaults to CUDA and raises without a card."""

    def __init__(self, cfg: VLMConfig, dtype: torch.dtype = torch.bfloat16, device=None):
        self.cfg = cfg
        self.dtype = dtype
        self.device = resolve_device(device)
        meta = torch.device("meta")
        vo = cfg.vision_override
        if vo is None:
            self.vision_module, self.vision_dim, self.num_patches = build_vision_backbone(
                cfg.vision_backbone_id, device=meta
            )
        elif isinstance(vo, tuple):
            self.vision_module = FusedViT(vo[0], vo[1], device=meta)
            self.vision_dim, self.num_patches = vo[0].width + vo[1].width, vo[0].num_patches
        else:
            self.vision_module = ViT(vo, device=meta)
            self.vision_dim, self.num_patches = vo.width, vo.num_patches
        self.projector = Projector(cfg.arch_specifier, self.vision_dim, cfg.llm.dim, device=meta)
        self.image_transform = transform_config_for_backbone(cfg.vision_backbone_id, cfg.image_resize_strategy)

    # --- params ---------------------------------------------------------

    def init_params(self, generator: torch.Generator) -> Params:
        """Random parameters in the model dtype, drawn on the model's device
        from `generator` (a generator on that device, e.g.
        torch.Generator(device="cuda"))."""
        dtype = self.dtype
        return {
            "vision": init_vision_params(self.vision_module, generator, dtype, self.device),
            "projector": init_projector_params(self.projector, generator, dtype, self.device),
            "llm": init_llm_params(generator, self.cfg.llm, dtype=dtype, device=self.device),
        }

    # --- forward pieces ---------------------------------------------------

    def encode_vision(self, params: Params, pixel_values: torch.Tensor) -> torch.Tensor:
        """[B, n_towers*3, H, W] -> projected patch embeddings [B, P, llm_dim]."""
        patches = functional_call(self.vision_module, params["vision"], (pixel_values.to(self.dtype),))
        return functional_call(self.projector, params["projector"], (patches,))

    def fuse_after_bos(
        self,
        token_embeds: torch.Tensor,
        patch_embeds: torch.Tensor,
        attention_mask: torch.Tensor,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """[bos | patches | text...] and its [B, F] validity mask; requires
        position 0 to be BOS (right padding)."""
        b, p = patch_embeds.shape[0], patch_embeds.shape[1]
        fused = torch.cat([token_embeds[:, :1], patch_embeds.to(token_embeds.dtype), token_embeds[:, 1:]], dim=1)
        patch_mask = torch.ones((b, p), dtype=attention_mask.dtype, device=attention_mask.device)
        fused_mask = torch.cat([attention_mask[:, :1], patch_mask, attention_mask[:, 1:]], dim=1)
        return fused, fused_mask

    def _causal_mask(self, fused_mask: torch.Tensor) -> torch.Tensor:
        """[B, T] validity -> [B, 1, T, T] causal + padding (+ window) bool mask."""
        t = fused_mask.shape[1]
        key_valid = fused_mask.bool()
        q_idx = torch.arange(t, device=fused_mask.device)[:, None]
        k_idx = torch.arange(t, device=fused_mask.device)[None, :]
        causal = k_idx <= q_idx
        window = self.cfg.llm.sliding_window
        if window is not None:
            causal = causal & (k_idx > q_idx - window)
        return causal[None, None] & key_valid[:, None, None, :]

    # --- generation ---------------------------------------------------------

    @torch.inference_mode()
    def generate_greedy(
        self,
        params: Params,
        input_ids: torch.Tensor,
        attention_mask: torch.Tensor,
        pixel_values: torch.Tensor,
        max_new_tokens: int,
    ) -> torch.Tensor:
        """input_ids / attention_mask [B, T] right-padded prompts (BOS first)
        -> greedy token ids [B, max_new_tokens] (argmax over the padded vocab)."""
        b = input_ids.shape[0]
        cfg = self.cfg.llm
        dev = input_ids.device
        patch_embeds = self.encode_vision(params, pixel_values)
        token_embeds = embed_tokens(params["llm"], input_ids, dtype=self.dtype)
        fused, fused_mask = self.fuse_after_bos(token_embeds, patch_embeds, attention_mask)
        f_len = fused.shape[1]
        s_len = f_len + max_new_tokens
        true_len = fused_mask.sum(dim=1).to(torch.int32)  # [B]; exact under right padding

        cache = init_kv_cache(cfg, b, s_len, device=dev)
        positions = torch.arange(f_len, device=dev).expand(b, f_len)
        mask = self._causal_mask(fused_mask)  # chunk extent: the fresh cache holds nothing else
        hidden, cache = llm_forward(
            params["llm"], cfg, fused, positions, mask,
            cache=cache, cache_positions=positions, cache_write="contiguous", lengths=true_len,
        )
        # The last REAL token's hidden state gives token 0.
        last_idx = torch.clamp(true_len.long() - 1, 0, f_len - 1)
        last_hidden = hidden[torch.arange(b, device=dev), last_idx][:, None]  # [B, 1, D]
        token = lm_logits(params["llm"], last_hidden, cfg).argmax(dim=-1)  # [B, 1]
        tokens = [token]
        k_idx = torch.arange(s_len, device=dev)[None, None, None, :]
        # Prefill produced token 0, so only max_new_tokens - 1 decode passes run.
        # Step i writes its K/V at slot true_len + i (over the prefill's pad rows).
        for i in range(max_new_tokens - 1):
            pos = (true_len.long() + i)[:, None]  # [B, 1] position and cache slot
            step_mask = k_idx <= pos[:, :, None, None]
            if cfg.sliding_window is not None:
                step_mask = step_mask & (k_idx > pos[:, :, None, None] - cfg.sliding_window)
            tok_embed = embed_tokens(params["llm"], token, dtype=self.dtype)
            hidden, cache = llm_forward(
                params["llm"], cfg, tok_embed, pos, step_mask, cache=cache, cache_positions=pos,
            )
            token = lm_logits(params["llm"], hidden, cfg).argmax(dim=-1)
            tokens.append(token)
        return torch.cat(tokens, dim=1)
