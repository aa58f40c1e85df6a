"""PrismaticVLM in torch: fused-backbone VLM with fuse-after-BOS, greedy
KV-cache generation, the training forward and the freeze stages.

Counterpart of bridgelang_tpu/models/vlm.py. The model
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

Training: `forward_train` / `forward_hidden` run the fused sequence through
the decoder without a cache; attention goes through the flash kernels
(forward and backward) with the true per-example lengths. The
`parallel_actions` objective is not yet ported: its general mask lies outside
the kernel's causal + length family.
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

IGNORE_INDEX = -100
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
        labels: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
        """[bos | patches | text...], its [B, F] validity mask and, given
        `labels`, the fused labels (IGNORE_INDEX over the patches); requires
        position 0 to be BOS (right padding)."""
        b, p = patch_embeds.shape[0], patch_embeds.shape[1]
        fused = torch.cat([token_embeds[:, :1], patch_embeds.to(token_embeds.dtype), token_embeds[:, 1:]], dim=1)
        patch_mask = torch.ones((b, p), dtype=attention_mask.dtype, device=attention_mask.device)
        fused_mask = torch.cat([attention_mask[:, :1], patch_mask, attention_mask[:, 1:]], dim=1)
        fused_labels = None
        if labels is not None:
            patch_labels = torch.full((b, p), IGNORE_INDEX, dtype=labels.dtype, device=labels.device)
            fused_labels = torch.cat([labels[:, :1], patch_labels, labels[:, 1:]], dim=1)
        return fused, fused_mask, fused_labels

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

    # --- training forward -------------------------------------------------

    def forward_hidden(
        self,
        params: Params,
        input_ids: torch.Tensor,
        attention_mask: torch.Tensor,
        pixel_values: torch.Tensor,
        labels: torch.Tensor,
        remat: bool = True,
        remat_policy: Optional[str] = None,
        parallel_actions: bool = False,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Multimodal forward -> (final hidden states [B, F, D], fused labels
        [B, F]); the caller computes the loss with a chunked LM head
        (training.trainer.chunked_ce_and_metrics)."""
        if parallel_actions:
            raise NotImplementedError(
                "the parallel_actions objective is not yet ported: it needs generate_parallel and a general "
                "attention mask outside the flash kernel's causal + length family")
        patch_embeds = self.encode_vision(params, pixel_values)
        token_embeds = embed_tokens(params["llm"], input_ids, dtype=self.dtype)
        fused, fused_mask, fused_labels = self.fuse_after_bos(token_embeds, patch_embeds, attention_mask, labels)
        b, t = fused.shape[:2]
        positions = torch.arange(t, device=fused.device).expand(b, t)
        lengths = fused_mask.sum(dim=1).to(torch.int32)  # exact under right padding
        hidden, _ = llm_forward(
            params["llm"], self.cfg.llm, fused, positions, self._causal_mask(fused_mask),
            lengths=lengths, remat=remat, remat_policy=remat_policy,
        )
        return hidden, fused_labels

    def forward_train(
        self,
        params: Params,
        input_ids: torch.Tensor,
        attention_mask: torch.Tensor,
        pixel_values: torch.Tensor,
        labels: torch.Tensor,
        remat: bool = True,
        remat_policy: Optional[str] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Multimodal forward -> (logits [B, F, V], fused labels [B, F])."""
        hidden, fused_labels = self.forward_hidden(
            params, input_ids, attention_mask, pixel_values, labels, remat=remat, remat_policy=remat_policy)
        return lm_logits(params["llm"], hidden, self.cfg.llm), fused_labels

    # --- freeze stages ------------------------------------------------------

    def trainable_mask(self, params: Params, stage: str) -> Params:
        """Bools in the structure of `params`: which tensors train at `stage`
        (JAX `trainable_mask`). The layers are a list here, so "last" marks
        every tensor of the last decoder layer plus the final norm and the
        LM head, with no partial-tensor mask."""
        F, T = False, True
        group = {
            "align": dict(vision=F, projector=T, llm=F),
            "finetune": dict(vision=F, projector=T, llm=T),
            "vla-train": dict(vision=F, projector=T, llm=T),
            "full-finetune": dict(vision=T, projector=T, llm=T),
            "vla-full-train": dict(vision=T, projector=T, llm=T),
            "last-layer-finetune": dict(vision=F, projector=F, llm="last"),
            "vla-last-layer-train": dict(vision=F, projector=F, llm="last"),
            "vla-sandwich-train": dict(vision=T, projector=T, llm="last"),
        }[stage]

        from bridgelang_tpu_torch.training.trainer import tree_map  # imported here: the trainer imports this module

        def fill(tree, value):
            return tree_map(lambda _: value, tree)

        llm = params["llm"]
        if group["llm"] == "last":
            llm_mask = fill(llm, False)
            llm_mask["layers"][-1] = fill(llm["layers"][-1], True)
            for name in ("final_norm", "lm_head", "final_norm_bias", "lm_head_bias"):
                if name in llm:
                    llm_mask[name] = True
        else:
            llm_mask = fill(llm, group["llm"])
        return {"vision": fill(params["vision"], group["vision"]),
                "projector": fill(params["projector"], group["projector"]), "llm": llm_mask}

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
        fused, fused_mask, _ = self.fuse_after_bos(token_embeds, patch_embeds, attention_mask)
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
