"""PrismaticVLM in torch: fused-backbone VLM with fuse-after-BOS, greedy
KV-cache generation, the training forward and the freeze stages.

Counterpart of bridgelang_tpu/models/vlm.py. The model
object holds configs and module definitions; parameters travel separately as
a dict {"vision", "projector", "llm"}, as in the JAX package. The vision and
projector modules live on the `meta` device and run through
`torch.func.functional_call` over that dict.

Generation: one prefill of the fused sequence into a preallocated KV cache
(`cache_dtype`: bf16 by default, fp32, or int8 codes with per-(token, head)
scales; contiguous write, attention through the flash kernel with the true
per-example lengths), then `max_new_tokens - 1` single-token decode steps. Unlike the JAX package, the prefill always takes
the flash kernel: the JAX package's short-prompt switch to einsum attention
(`_prefill_impl`) rests on a TPU measurement and is not ported.

* `generate_greedy`: argmax, or temperature sampling from an explicit
  `torch.Generator`.
* `generate_speculative`: the prefill, one verify chunk [token0, draft[1:]]
  through `cached_attention` (the decode path's attention, so verify and
  decode logits agree), a top-2 margin gate, then sequential fix-up steps
  from the first rejected position. It is split into `speculative_verify`
  and `speculative_step` so that a CUDA graph can hold each
  (models/graphs.py); eagerly the fix-up runs as a host loop.
* `generate_parallel`: one forward in which the query rows see only the
  valid prefix, a mask outside the flash kernel's family: the decoder runs
  it with `attention="masked"`.

Training: `forward_train` / `forward_hidden` run the fused sequence through
the decoder without a cache; attention goes through the flash kernels
(forward and backward) with the true per-example lengths, or as
`VLMConfig.attention_impl` names it (`decoder_attention`: the masked or
einsum attention, or ring attention over a mesh axis). The
`parallel_actions` objective's mask lies outside the kernel's causal +
length family, so that forward runs `attention="masked"` with plain autograd
for its backward, as the JAX package runs it on XLA.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch.func import functional_call

from bridgelang_tpu_torch._device import resolve_device
from bridgelang_tpu_torch.models.llm.llama import (
    LLM_CONFIGS,
    LLM_FAMILIES,
    W8A8_MIN_CHUNK,
    LLMConfig,
    check_attention,
    embed_tokens,
    init_kv_cache,
    init_llm_params,
    is_mla,
    kv_cache_len,
    llm_forward,
    lm_logits,
    refuse_mla,
)
from bridgelang_tpu_torch.models.projector import Projector, init_projector_params
from bridgelang_tpu_torch.models.vision.vit import FusedViT, ViT, build_vision_backbone, init_vision_params
from bridgelang_tpu_torch.ops.image_ops import transform_config_for_backbone
from bridgelang_tpu_torch.util import profiling

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
    # The training forward's attention (JAX `attention_impl`): None or
    # "pallas" the flash kernels, "xla" the masked `full_attention`, "einsum"
    # `cached_attention`, "ring" / "ring:<axis>" ring attention over a mesh
    # axis (fsdp by default; the flash kernels without a mesh axis of more
    # than one rank). Generation keeps its cached paths.
    attention_impl: Optional[str] = None

    @classmethod
    def from_ids(
        cls,
        model_id: str,
        vision_backbone_id: str,
        llm_backbone_id: str,
        arch_specifier: str,
        image_resize_strategy: str = "resize-naive",
        llm_max_length: int = 2048,
        llm_overrides: Optional[Dict[str, Any]] = None,
    ) -> "VLMConfig":
        """A config from registered ids (`LLM_CONFIGS`, read at call time,
        so a test may patch an entry), with `llm_overrides` replacing fields
        of the LLM config."""
        llm = LLM_CONFIGS[llm_backbone_id]
        if llm_overrides:
            llm = dataclasses.replace(llm, **llm_overrides)
        return cls(model_id=model_id, vision_backbone_id=vision_backbone_id, llm_backbone_id=llm_backbone_id,
                   arch_specifier=arch_specifier, image_resize_strategy=image_resize_strategy,
                   llm_max_length=llm_max_length, llm=llm)

    @property
    def llm_family(self) -> str:
        return LLM_FAMILIES.get(self.llm_backbone_id, "llama2-pure")


ATTENTION_IMPLS = {None: "flash", "pallas": "flash", "xla": "masked", "einsum": "einsum"}


def decoder_attention(attention_impl: Optional[str]) -> str:
    """The decoder's attention kind (llama.llm_forward's `attention`) for a
    JAX `attention_impl`; an unknown one raises, naming it."""
    if attention_impl in ATTENTION_IMPLS:
        return ATTENTION_IMPLS[attention_impl]
    if (attention_impl or "").startswith("ring"):
        return check_attention(attention_impl)
    raise ValueError(f"attention_impl={attention_impl!r}: use None, 'pallas', 'xla', 'einsum', 'ring' or 'ring:<axis>'")


class PrismaticVLM:
    """Model orchestrator: configs + module definitions, and functions over
    the parameter dict. `device` defaults to CUDA and raises without a card."""

    def __init__(self, cfg: VLMConfig, dtype: torch.dtype = torch.bfloat16, device=None):
        self.cfg = cfg
        self.dtype = dtype
        self.device = resolve_device(device)
        self.cache_dtype = torch.bfloat16  # the KV cache's dtype (fp32: the exact speculative contract; int8)
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
        self.attention = decoder_attention(cfg.attention_impl)
        self.image_transform = transform_config_for_backbone(cfg.vision_backbone_id, cfg.image_resize_strategy)
        self._expert_load: Optional[torch.Tensor] = None

    def expert_load(self) -> Optional[torch.Tensor]:
        """A mixture-of-experts decoder's prefill load: [MoE layers, experts]
        int32 on the device, the picks of each expert in the last prefill
        (written by the routing in place, so a captured predict refills the
        same buffer on every replay); None for a dense decoder."""
        llm = self.cfg.llm
        if not is_mla(llm):
            return None
        if self._expert_load is None:
            with torch.inference_mode(False):  # a normal tensor: any predict, in inference mode or not, writes it
                self._expert_load = torch.zeros((llm.n_moe_layers, llm.n_routed_experts), dtype=torch.int32,
                                                device=self.device)
        return self._expert_load

    # --- params ---------------------------------------------------------

    def init_params(self, generator: torch.Generator, param_dtype: Optional[torch.dtype] = None) -> Params:
        """Random parameters in `param_dtype` (the model dtype by default;
        fp32 master weights for full training, which the train step casts to
        its compute dtype), drawn on the model's device from `generator` (a
        generator on that device, e.g. torch.Generator(device="cuda"))."""
        dtype = param_dtype or self.dtype
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
        (training.trainer.chunked_ce_and_metrics).

        `parallel_actions=True` trains the parallel-decode objective that
        `generate_parallel` serves (JAX vlm.py:253-281): every supervised
        position's embedding becomes the query token's, keys from the first
        supervised position on are cut (serve-time keys are the prompt
        prefix), supervised rows attend only that valid prefix and the other
        rows stay causal. The [B, 1, F, F] mask runs through the masked
        attention, not the flash kernel."""
        patch_embeds = self.encode_vision(params, pixel_values)
        token_embeds = embed_tokens(params["llm"], input_ids, dtype=self.dtype)
        fused, fused_mask, fused_labels = self.fuse_after_bos(token_embeds, patch_embeds, attention_mask, labels)
        b, t = fused.shape[:2]
        positions = torch.arange(t, device=fused.device).expand(b, t)
        if parallel_actions:
            act = fused_labels != IGNORE_INDEX  # [B, F] supervised targets
            query = torch.full((1, 1), LLAMA_EMPTY_TOKEN, dtype=torch.long, device=fused.device)
            q_embed = embed_tokens(params["llm"], query, dtype=self.dtype)[0, 0]
            fused = torch.where(act[..., None], q_embed.to(fused.dtype), fused)
            idx = torch.arange(t, device=fused.device)
            has_act = act.any(dim=1)
            first_act = act.int().argmax(dim=1)  # first supervised position
            tail = idx[None, :] >= first_act[:, None]
            key_ok = fused_mask.bool() & ~(tail & has_act[:, None])
            causal = idx[None, :] <= idx[:, None]
            row_mask = torch.where(act[:, :, None], True, causal[None])
            mask = (row_mask & key_ok[:, None, :])[:, None]  # [B, 1, F, F]
            hidden, _ = llm_forward(params["llm"], self.cfg.llm, fused, positions, mask, remat=remat,
                                    remat_policy=remat_policy, attention="masked")
            return hidden, fused_labels
        lengths = fused_mask.sum(dim=1).to(torch.int32)  # exact under right padding
        hidden, _ = llm_forward(
            params["llm"], self.cfg.llm, fused, positions, self._causal_mask(fused_mask),
            lengths=lengths, remat=remat, remat_policy=remat_policy, attention=self.attention,
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


    def _prefill(self, params: Params, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                 pixel_values: torch.Tensor, n_new: int, cache_dtype: Optional[torch.dtype]):
        """Vision, fuse-after-BOS and the prefill into a fresh KV cache of
        fused length + `n_new` slots -> (the last REAL row's hidden state
        [B, 1, D], the cache, true lengths [B] int64)."""
        b = input_ids.shape[0]
        dev = input_ids.device
        patch_embeds = self.encode_vision(params, pixel_values)
        profiling.mark("vision")
        token_embeds = embed_tokens(params["llm"], input_ids, dtype=self.dtype)
        fused, fused_mask, _ = self.fuse_after_bos(token_embeds, patch_embeds, attention_mask)
        f_len = fused.shape[1]
        true_len = fused_mask.sum(dim=1).long()  # exact under right padding
        cache = init_kv_cache(self.cfg.llm, b, f_len + n_new, dtype=cache_dtype or self.cache_dtype, device=dev)
        positions = torch.arange(f_len, device=dev).expand(b, f_len)
        mask = self._causal_mask(fused_mask)  # chunk extent: the fresh cache holds nothing else
        hidden, cache = llm_forward(
            params["llm"], self.cfg.llm, fused, positions, mask,
            cache=cache, cache_positions=positions, cache_write="contiguous", lengths=true_len.to(torch.int32),
            expert_load=self.expert_load(),
        )
        last_idx = torch.clamp(true_len - 1, 0, f_len - 1)
        return hidden[torch.arange(b, device=dev), last_idx][:, None], cache, true_len

    def _chunk_mask(self, pos: torch.Tensor, s_len: int) -> torch.Tensor:
        """[B, 1, T, S] mask of query rows at cache positions `pos` [B, T]:
        causal over the cache (+ the window)."""
        k_idx = torch.arange(s_len, device=pos.device)[None, None, None, :]
        p = pos[:, None, :, None]
        mask = k_idx <= p
        if self.cfg.llm.sliding_window is not None:
            mask = mask & (k_idx > p - self.cfg.llm.sliding_window)
        return mask

    def _decode_logits(self, params: Params, cfg: LLMConfig, tokens: torch.Tensor, pos: torch.Tensor,
                       cache: Params) -> torch.Tensor:
        """Tokens [B, T] at positions `pos` [B, T] (also their cache slots)
        through the cached decoder -> logits [B, T, V]."""
        hidden, _ = llm_forward(
            params["llm"], cfg, embed_tokens(params["llm"], tokens, dtype=self.dtype), pos,
            self._chunk_mask(pos, kv_cache_len(cfg, cache)), cache=cache, cache_positions=pos,
        )
        return lm_logits(params["llm"], hidden, cfg)

    @torch.inference_mode()
    def generate_greedy(
        self,
        params: Params,
        input_ids: torch.Tensor,
        attention_mask: torch.Tensor,
        pixel_values: torch.Tensor,
        max_new_tokens: int,
        cache_dtype: Optional[torch.dtype] = None,
        temperature: float = 0.0,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """input_ids / attention_mask [B, T] right-padded prompts (BOS first)
        -> token ids [B, max_new_tokens]: the argmax over the padded vocab,
        or, with `temperature` > 0 and a `generator` (on the model's device),
        samples from softmax(logits / temperature). Under active device marks
        (util/profiling.marking) it marks "vision" after the towers, "token0"
        after the prefill's token and "last" after the last decode step."""
        cfg = self.cfg.llm
        sample = temperature > 0.0 and generator is not None

        def select(logits: torch.Tensor) -> torch.Tensor:  # [B, 1, V] -> [B, 1]
            if sample:
                return torch.multinomial(torch.softmax(logits[:, 0].float() / temperature, dim=-1), 1,
                                         generator=generator)
            return logits.argmax(dim=-1)

        last_hidden, cache, true_len = self._prefill(params, input_ids, attention_mask, pixel_values,
                                                     max_new_tokens, cache_dtype)
        token = select(lm_logits(params["llm"], last_hidden, cfg))  # token 0, from the last real row
        profiling.mark("token0")
        tokens = [token]
        # Prefill produced token 0, so only max_new_tokens - 1 decode passes run.
        # Step i writes its K/V at slot true_len + i (over the prefill's pad rows).
        for i in range(max_new_tokens - 1):
            token = select(self._decode_logits(params, cfg, token, (true_len + i)[:, None], cache))
            tokens.append(token)
        profiling.mark("last")
        return torch.cat(tokens, dim=1)

    def speculative_verify(
        self,
        params: Params,
        input_ids: torch.Tensor,
        attention_mask: torch.Tensor,
        pixel_values: torch.Tensor,
        draft_tokens: torch.Tensor,
        cache_dtype: Optional[torch.dtype] = None,
        margin_threshold: Union[float, torch.Tensor] = 0.25,
    ) -> "SpeculativeState":
        """The first part of `generate_speculative`, free of host reads: the
        prefill gives token 0; one verify chunk [token0, draft[1:]] at
        positions true_len + i runs through the cached decoder (the decode
        path's `cached_attention`); position i is accepted while every
        earlier verify input matched its argmax and its top-1 margin exceeds
        `margin_threshold` (a float or a float32 tensor on the device).
        Returns the state whose `out` holds the accepted prefix, `accepts`
        min(k, n) per example and `j0` = min(min k, n)."""
        b, n = draft_tokens.shape
        cfg = self.cfg.llm
        refuse_mla(cfg, "speculative decoding (--speculative_default)")
        dev = input_ids.device
        last_hidden, cache, true_len = self._prefill(params, input_ids, attention_mask, pixel_values, n, cache_dtype)
        token0 = lm_logits(params["llm"], last_hidden, cfg).argmax(dim=-1)  # [B, 1]
        profiling.mark("token0")
        if n == 1:
            return SpeculativeState(token0, torch.ones(b, dtype=torch.long, device=dev),
                                    torch.ones((), dtype=torch.long, device=dev), cache, true_len, cfg)
        # An int8 decoder's w8a8 product starts at W8A8_MIN_CHUNK tokens; decode
        # (T=1) casts the weight. A verify chunk that long must cast too, or its
        # logits carry activation-quantization noise decode never sees. int4
        # weights quantize activations at every chunk length and keep w8a8.
        has_int4 = any(k.endswith("_scale4") for k in params["llm"]["layers"][0])
        if cfg.w8a8 and n >= W8A8_MIN_CHUNK and not has_int4:
            cfg = dataclasses.replace(cfg, w8a8=False)
        ver_in = torch.cat([token0, draft_tokens[:, 1:].long()], dim=1)  # [B, n]
        pos = true_len[:, None] + torch.arange(n, device=dev)[None, :]  # token i sits at true_len + i
        ver_logits = self._decode_logits(params, cfg, ver_in, pos, cache).float()  # [B, n, V]
        g = ver_logits.argmax(dim=-1)
        top2 = torch.topk(ver_logits, 2, dim=-1).values
        margin = torch.as_tensor(margin_threshold, dtype=torch.float32, device=dev)
        margin_ok = (top2[..., 0] - top2[..., 1]) > margin
        # out[0] = token0; out[i] = g[i-1], accepted while every verify input
        # matched and every accepted position cleared the margin.
        out = torch.cat([token0, g[:, :-1]], dim=1)
        input_ok = ver_in[:, 1:] == g[:, :-1]  # draft[i] == out[i]
        step_ok = margin_ok[:, : n - 1] & torch.cat(
            [torch.ones((b, 1), dtype=torch.bool, device=dev), input_ok[:, : n - 2]], dim=1)
        k = 1 + torch.cumprod(step_ok.long(), dim=1).sum(dim=1)  # [B] accepted count
        return SpeculativeState(out, torch.clamp(k, max=n), torch.clamp(k.min(), max=n), cache, true_len, cfg)

    def speculative_step(self, params: Params, state: "SpeculativeState", step: torch.Tensor) -> None:
        """One sequential fix-up step of `generate_speculative`: `step` is a
        one-element int64 tensor j (1 <= j < n) on the device; the token
        out[j-1] decodes at position true_len + j - 1, its argmax is written
        to out[j] and `step` incremented, all on the device (a CUDA graph
        replays this as is)."""
        b = state.out.shape[0]
        j = step.reshape(1, 1).expand(b, 1)
        tok = state.out.gather(1, j - 1)
        pos = state.true_len[:, None] + (j - 1)
        nxt = self._decode_logits(params, state.cfg, tok, pos, state.cache).argmax(dim=-1)
        state.out.scatter_(1, j, nxt)
        step.add_(1)

    @torch.inference_mode()
    def generate_speculative(
        self,
        params: Params,
        input_ids: torch.Tensor,
        attention_mask: torch.Tensor,
        pixel_values: torch.Tensor,
        draft_tokens: torch.Tensor,
        cache_dtype: Optional[torch.dtype] = None,
        margin_threshold: Union[float, torch.Tensor] = 0.25,
        return_accept_count: bool = False,
    ):
        """Speculative greedy decode against an external draft [B, n]:
        equal to `generate_greedy(max_new_tokens=n)` whatever the draft, where
        the verify-vs-decode numeric difference stays below the margin gate
        (exactly so with an fp32 model and cache). Returns [B, n] ids, and
        with `return_accept_count` also the accepted count per example ([B],
        in [1, n]; token 0 is always canonical). The fix-up loop from the
        first rejection reads `j0` on the host once.

        CAVEAT with an int8 KV cache (`cache_dtype=torch.int8`): a K/V
        element near an int8 rounding boundary can quantize differently in
        the verify chunk than sequential decode would, shifting later logits
        by up to a full quantization step, beyond what the margin gate
        guards. Keep the bf16 cache (the default) where strict
        greedy-equivalence matters; the server turns its speculative default
        off under an int8 cache."""
        state = self.speculative_verify(params, input_ids, attention_mask, pixel_values, draft_tokens,
                                        cache_dtype=cache_dtype, margin_threshold=margin_threshold)
        step = state.j0.reshape(1).clone()
        for _ in range(draft_tokens.shape[1] - int(state.j0)):
            self.speculative_step(params, state, step)
        return (state.out, state.accepts) if return_accept_count else state.out

    @torch.inference_mode()
    def generate_parallel(
        self,
        params: Params,
        input_ids: torch.Tensor,
        attention_mask: torch.Tensor,
        pixel_values: torch.Tensor,
        max_new_tokens: int,
        query_token_id: int = LLAMA_EMPTY_TOKEN,
    ) -> torch.Tensor:
        """One-forward parallel decode (for models fine-tuned with the
        parallel objective): token 0 from the last real prompt row, token i
        >= 1 from a query row at position true_len + i - 1 that attends the
        valid prefix only. The mask is outside the flash kernel's family, so
        the forward runs `attention="masked"`. Returns [B, max_new_tokens]."""
        b = input_ids.shape[0]
        cfg = self.cfg.llm
        dev = input_ids.device
        n_q = max_new_tokens - 1
        patch_embeds = self.encode_vision(params, pixel_values)
        token_embeds = embed_tokens(params["llm"], input_ids, dtype=self.dtype)
        fused, fused_mask, _ = self.fuse_after_bos(token_embeds, patch_embeds, attention_mask)
        f_len = fused.shape[1]
        true_len = fused_mask.sum(dim=1).long()
        q_ids = torch.full((b, max(n_q, 1)), query_token_id, dtype=torch.long, device=dev)
        seq = torch.cat([fused, embed_tokens(params["llm"], q_ids, dtype=self.dtype)[:, :n_q]], dim=1)
        t = f_len + n_q
        positions = torch.cat([torch.arange(f_len, device=dev).expand(b, f_len),
                               true_len[:, None] + torch.arange(n_q, device=dev)[None, :]], dim=1)
        # Prefix rows: causal over the valid prefix. Query rows: the valid prefix only.
        key_valid = torch.cat([fused_mask.bool(), torch.zeros((b, n_q), dtype=torch.bool, device=dev)], dim=1)
        rows = torch.arange(t, device=dev)
        row_mask = (rows[None, :] <= rows[:, None]) | (rows >= f_len)[:, None]
        mask = (row_mask[None] & key_valid[:, None, :])[:, None]
        hidden, _ = llm_forward(params["llm"], cfg, seq, positions, mask, attention="masked")
        last_idx = torch.clamp(true_len - 1, 0, f_len - 1)
        head_in = torch.cat([hidden[torch.arange(b, device=dev), last_idx][:, None], hidden[:, f_len:]], dim=1)
        return lm_logits(params["llm"], head_in, cfg).argmax(dim=-1)


@dataclasses.dataclass
class SpeculativeState:
    """What the verify pass hands the fix-up steps: the ids so far `out`
    [B, n], the accepted counts `accepts` [B], `j0` (a 0-d tensor: the first
    position re-decoded), the KV cache, the true lengths [B] and the decoder
    config the verify chunk ran with."""

    out: torch.Tensor
    accepts: torch.Tensor
    j0: torch.Tensor
    cache: Params
    true_len: torch.Tensor
    cfg: LLMConfig
