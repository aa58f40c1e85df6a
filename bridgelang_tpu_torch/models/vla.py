"""OpenVLA in torch: action prediction on top of PrismaticVLM.

Counterpart of bridgelang_tpu/models/vla.py. After tokenization the whole
path runs on the model's device: frame preprocessing, vision encode, the
decode of `action_dim` tokens (greedy, speculative against a draft, or one
parallel forward), bin de-tokenization and q01/q99 unnormalization; one
device-to-host copy returns the actions.

On a CUDA model every predict (`predict_action_device`,
`predict_from_frames_device`, their speculative twins and the host API
over them) replays captured CUDA graphs (models/graphs.py), the counterpart
of the JAX package's jitted programs; `use_graphs = False` runs the same
functions eagerly instead, and only when the caller says so. On the CPU the
predicts run eagerly: the same functions, which the tests hold against the
JAX package.

`use_mesh` serves over a device mesh (the JAX `use_mesh` / `_put`): the
decoder runs tensor-parallel on this rank's blocks of the weights
(parallel/sharding.SERVING_RULES; the collectives in models/llm/llama.py and
inside the captured graphs), one process per device, rank 0 leading each
predict and the other ranks following it (serving/mesh.MeshPredictor).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from bridgelang_tpu_torch.models.graphs import (PREDICT_MARKS, PREDICT_TIMES, PredictGraphs, pack_outputs,
                                                unpack_outputs)
from bridgelang_tpu_torch.models.llm.prompting import build_vla_prompt
from bridgelang_tpu_torch.models.vlm import LLAMA_EMPTY_TOKEN, Params, PrismaticVLM, VLMConfig
from bridgelang_tpu_torch.ops.image_ops import preprocess_batch
from bridgelang_tpu_torch.util import profiling
from bridgelang_tpu_torch.vla.action_tokenizer import make_bins, token_ids_to_actions, unnormalize_actions

DEFAULT_PROMPT_BUCKET = 48


def check_unnorm_key(norm_stats: Dict[str, Any], unnorm_key: Optional[str]) -> str:
    if unnorm_key is None:
        if len(norm_stats) != 1:
            raise ValueError(f"Model trained on multiple datasets; pass `unnorm_key` from: {list(norm_stats.keys())}")
        unnorm_key = next(iter(norm_stats.keys()))
    if unnorm_key not in norm_stats:
        raise ValueError(f"`unnorm_key` {unnorm_key!r} not in available statistics: {list(norm_stats.keys())}")
    return unnorm_key


class OpenVLA(PrismaticVLM):
    def __init__(
        self,
        cfg: VLMConfig,
        norm_stats: Dict[str, Any],
        tokenizer=None,
        dtype: torch.dtype = torch.bfloat16,
        n_action_bins: int = 256,
        prompt_bucket: int = DEFAULT_PROMPT_BUCKET,
        device=None,
    ):
        super().__init__(cfg, dtype=dtype, device=device)
        self.norm_stats = norm_stats
        self.tokenizer = tokenizer
        self.n_action_bins = n_action_bins
        self.prompt_bucket = prompt_bucket
        _, bin_centers = make_bins(n_action_bins)
        self.bin_centers = torch.as_tensor(bin_centers, dtype=torch.float32, device=self.device)
        # Serving mode: decode every action dim in ONE forward (generate_parallel);
        # only for models fine-tuned with the parallel objective.
        self.parallel_decode = False
        # CUDA: predicts replay captured graphs; False runs them eagerly (for
        # measurements and tests that ask for the eager path by name).
        self.use_graphs = True
        self.graphs = PredictGraphs(self)
        self.serving_mesh = None
        self.mesh_predictor = None
        self.last_marks: Optional[profiling.DeviceMarks] = None  # the last CUDA predict's device marks

    # --- multi-device serving ---

    def use_mesh(self, mesh, params: Params, int4_shards: int = 1) -> Params:
        """Serve over `mesh` (parallel/mesh.make_mesh; every rank calls this
        with the same whole `params`) -> this rank's blocks of `params`,
        placed by `parallel.sharding.serving_param_pspecs`. The decoder then
        runs tensor-parallel over the mesh's `tensor` axis, batches split over
        `replica` when they divide, and rank 0 leads every predict (the other
        ranks run `self.mesh_predictor.follow(local_params)`). A `tensor` that
        does not divide the head counts (or would split a GQA group) is
        refused, as scripts/deploy.py refuses it; `int4_shards` is the
        pack-time shard count of an int4 tree."""
        from bridgelang_tpu_torch.models.llm.llama import TensorParallelLLMConfig
        from bridgelang_tpu_torch.parallel.collectives import make_tensor_parallel
        from bridgelang_tpu_torch.parallel.mesh import mesh_sizes
        from bridgelang_tpu_torch.parallel.sharding import serving_param_pspecs, shard_params
        from bridgelang_tpu_torch.serving.mesh import MeshPredictor

        llm = self.cfg.llm
        tensor = mesh_sizes(mesh)["tensor"]
        if llm.n_heads % tensor or llm.n_kv_heads % tensor:
            raise ValueError(f"tensor={tensor} does not divide the head counts ({llm.n_heads}/{llm.n_kv_heads}): "
                             "a rank would hold part of a head or of a GQA group")
        specs = serving_param_pspecs(mesh, params, int4_shards)
        layer = specs["llm"]["layers"][0]
        names = [n for n in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down") if n in layer]
        split = {n: "tensor" in tuple(layer[n]) for n in names}
        split["lm_head"] = "tensor" in tuple(specs["llm"]["lm_head"])
        tp = make_tensor_parallel(mesh, split)
        self.cfg = dataclasses.replace(self.cfg, llm=TensorParallelLLMConfig.of(llm, tp))
        self.serving_mesh = mesh
        self.mesh_predictor = MeshPredictor(self, mesh)
        self.graphs.clear()
        return shard_params(mesh, params, specs)

    def get_action_dim(self, unnorm_key: Optional[str] = None) -> int:
        return len(self.get_action_stats(unnorm_key)["q01"])

    def get_action_stats(self, unnorm_key: Optional[str] = None) -> Dict[str, Any]:
        return self.norm_stats[check_unnorm_key(self.norm_stats, unnorm_key)]["action"]

    # --- the device functions (eager; a CUDA graph captures them) ---

    def preprocess_frames(self, frames_u8: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] uint8 on the device -> the towers' pixel values."""
        return preprocess_batch(frames_u8, self.image_transform, dtype=self.dtype)

    def decode_tokens(self, params: Params, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                      pixel_values: torch.Tensor, n_tokens: int, parallel_decode: bool) -> torch.Tensor:
        if parallel_decode:
            return self.generate_parallel(params, input_ids, attention_mask, pixel_values, max_new_tokens=n_tokens)
        return self.generate_greedy(params, input_ids, attention_mask, pixel_values, max_new_tokens=n_tokens)

    def tokens_to_actions(self, token_ids: torch.Tensor, q01: torch.Tensor, q99: torch.Tensor,
                          stat_mask: torch.Tensor) -> torch.Tensor:
        """Bin de-tokenization, then q01/q99 unnormalization -> float32 [B, n]."""
        normalized = token_ids_to_actions(token_ids, self.bin_centers, self.cfg.llm.vocab_size)
        return unnormalize_actions(normalized.float(), q01, q99, stat_mask)

    @torch.inference_mode()
    def predict_packed(self, mode: str, params: Params, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                       pixel_values: torch.Tensor, q01: torch.Tensor, q99: torch.Tensor, stat_mask: torch.Tensor,
                       n_tokens: int, draft_tokens: Optional[torch.Tensor] = None,
                       margin_threshold: Union[float, torch.Tensor] = 0.25) -> torch.Tensor:
        """One predict run eagerly, in `mode` ("greedy", "parallel" or
        "speculative" against `draft_tokens`) -> the packed [B, 2 n + 1]
        int32 output of models/graphs.py (actions, ids, accepted counts)."""
        if mode == "speculative":
            tokens, accepts = self.generate_speculative(params, input_ids, attention_mask, pixel_values, draft_tokens,
                                                        margin_threshold=margin_threshold, return_accept_count=True)
        else:
            tokens = self.decode_tokens(params, input_ids, attention_mask, pixel_values, n_tokens, mode == "parallel")
            accepts = torch.full((tokens.shape[0],), n_tokens, dtype=torch.int32, device=tokens.device)
        return pack_outputs(self.tokens_to_actions(tokens, q01, q99, stat_mask), tokens, accepts)

    def _predict(self, mode: str, params: Params, inputs: Dict[str, Any], n_tokens: int) -> torch.Tensor:
        """`inputs`: ids, mask, frames (uint8) or pixels, q01, q99, stat_mask,
        and for the speculative mode draft and margin, as numpy arrays or
        tensors. A CUDA model replays its graphs; otherwise the predict runs
        eagerly on the model's device. -> the packed output on the device.
        On a serving mesh rank 0 announces the predict to the other ranks
        first (serving/mesh.MeshPredictor)."""
        if self.mesh_predictor is not None:
            return self.mesh_predictor.predict(mode, params, inputs, n_tokens)
        return self._predict_local(mode, params, inputs, n_tokens)

    def _predict_local(self, mode: str, params: Params, inputs: Dict[str, Any], n_tokens: int) -> torch.Tensor:
        if self.device.type == "cuda" and self.use_graphs:
            return self.graphs.run(mode, params, dict(inputs), n_tokens)  # sets last_marks
        marks = profiling.DeviceMarks(PREDICT_MARKS) if self.device.type == "cuda" else None
        with profiling.span("predict:eager"), profiling.marking(marks):
            profiling.mark("start")
            t = {k: torch.as_tensor(v, device=self.device) for k, v in inputs.items() if k != "margin"}
            pixels = t["pixels"] if "pixels" in t else self.preprocess_frames(t["frames"])
            out = self.predict_packed(mode, params, t["ids"], t["mask"], pixels, t["q01"], t["q99"], t["stat_mask"],
                                      n_tokens, t.get("draft"), inputs.get("margin", 0.25))
        self.last_marks = marks
        return out

    def predict_action_device(
        self,
        params: Params,
        input_ids: torch.Tensor,
        attention_mask: torch.Tensor,
        pixel_values: torch.Tensor,
        q01: torch.Tensor,
        q99: torch.Tensor,
        stat_mask: torch.Tensor,
        action_dim: int,
        parallel_decode: bool = False,
    ) -> torch.Tensor:
        """[B, T] prompts + [B, C, H, W] images -> [B, action_dim] actions on
        the device; `parallel_decode` decodes with generate_parallel."""
        inputs = dict(ids=input_ids, mask=attention_mask, pixels=pixel_values, q01=q01, q99=q99, stat_mask=stat_mask)
        packed = self._predict("parallel" if parallel_decode else "greedy", params, inputs, action_dim)
        return packed[:, :action_dim].view(torch.float32).clone()

    def predict_from_frames_device(
        self,
        params: Params,
        input_ids: torch.Tensor,
        attention_mask: torch.Tensor,
        frames_u8: torch.Tensor,
        q01: torch.Tensor,
        q99: torch.Tensor,
        stat_mask: torch.Tensor,
        action_dim: int,
        parallel_decode: bool = False,
    ) -> torch.Tensor:
        """Raw frames [B, H, W, 3] uint8 -> [B, action_dim] actions: the
        preprocessing runs in the same program (graph) as the decode."""
        inputs = dict(ids=input_ids, mask=attention_mask, frames=frames_u8, q01=q01, q99=q99, stat_mask=stat_mask)
        packed = self._predict("parallel" if parallel_decode else "greedy", params, inputs, action_dim)
        return packed[:, :action_dim].view(torch.float32).clone()

    def predict_action_device_speculative(
        self,
        params: Params,
        input_ids: torch.Tensor,
        attention_mask: torch.Tensor,
        pixel_values: torch.Tensor,
        q01: torch.Tensor,
        q99: torch.Tensor,
        stat_mask: torch.Tensor,
        draft_tokens: torch.Tensor,
        margin_threshold: float = 0.25,
        return_accept_count: bool = False,
    ):
        """Like predict_action_device, decoding speculatively against
        `draft_tokens` [B, action_dim] (greedy-equivalent by the margin
        gate) -> (actions, token ids int32[, accepted counts]) on the device."""
        inputs = dict(ids=input_ids, mask=attention_mask, pixels=pixel_values, q01=q01, q99=q99, stat_mask=stat_mask,
                      draft=draft_tokens, margin=margin_threshold)
        return self._speculative_outputs(params, inputs, draft_tokens.shape[1], return_accept_count)

    def predict_from_frames_device_speculative(
        self,
        params: Params,
        input_ids: torch.Tensor,
        attention_mask: torch.Tensor,
        frames_u8: torch.Tensor,
        q01: torch.Tensor,
        q99: torch.Tensor,
        stat_mask: torch.Tensor,
        draft_tokens: torch.Tensor,
        margin_threshold: float = 0.25,
        return_accept_count: bool = False,
    ):
        inputs = dict(ids=input_ids, mask=attention_mask, frames=frames_u8, q01=q01, q99=q99, stat_mask=stat_mask,
                      draft=draft_tokens, margin=margin_threshold)
        return self._speculative_outputs(params, inputs, draft_tokens.shape[1], return_accept_count)

    def _speculative_outputs(self, params: Params, inputs: Dict[str, Any], n: int, return_accept_count: bool):
        packed = self._predict("speculative", params, inputs, n)
        out = (packed[:, :n].view(torch.float32).clone(), packed[:, n:2 * n].clone(), packed[:, 2 * n].clone())
        return out if return_accept_count else out[:2]

    # --- host-side API ---

    def prepare_prompt_ids(self, instruction: str) -> np.ndarray:
        """Tokenize the VLA prompt; append the '▁' token the Llama tokenizer drops."""
        if self.tokenizer is None:
            raise ValueError("predict_action from strings requires a tokenizer")
        prompt = build_vla_prompt(instruction, llm_family=self.cfg.llm_family)
        ids = np.asarray(self.tokenizer(prompt).input_ids)
        if ids.ndim > 1:
            ids = ids[0]
        if self.cfg.llm_family in ("llama2-pure", "llama2-chat", "vicuna") and ids[-1] != LLAMA_EMPTY_TOKEN:
            ids = np.concatenate([ids, [LLAMA_EMPTY_TOKEN]])
        return ids.astype(np.int32)

    def pad_prompt(self, ids_list: Sequence[np.ndarray]):
        """Right-pad id arrays to the bucket (doubled until the longest fits)."""
        bucket = self.prompt_bucket
        longest = max(len(i) for i in ids_list)
        while bucket < longest:
            bucket *= 2
        batch = np.full((len(ids_list), bucket), self.cfg.llm.pad_token_id, dtype=np.int32)
        mask = np.zeros((len(ids_list), bucket), dtype=np.int32)
        for r, ids in enumerate(ids_list):
            batch[r, : len(ids)] = ids
            mask[r, : len(ids)] = 1
        return batch, mask

    def _host_predict(self, mode: str, params: Params, images: Sequence[Any], instructions: Sequence[str],
                      unnorm_key: Optional[str], horizon: int = 1, draft_tokens: Optional[np.ndarray] = None,
                      margin_threshold: float = 0.25) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Host frames and instructions -> (actions, ids, accepted counts) as
        numpy, through one device-to-host copy. The stats tile across
        `horizon` steps (the same dims at every future step).

        Spans: `predict:prepare` (stats, tokenize, pad, stack frames), the
        predict's own (`graphs:copy_in` and `graphs:replay`, or
        `predict:eager`), `predict:wait` (the device-to-host copy: the host
        waits for the card) and `predict:unpack`. A CUDA predict's device
        times (`PREDICT_TIMES`, ms, from its marks) and its token count go
        into the enclosing span's attrs (the server's `serve:pass`)."""
        with profiling.span("predict:prepare"):
            stats = self.get_action_stats(unnorm_key)
            action_dim = len(stats["q01"])
            inputs: Dict[str, Any] = {
                "q01": np.tile(np.asarray(stats["q01"], np.float32), horizon),
                "q99": np.tile(np.asarray(stats["q99"], np.float32), horizon),
                "stat_mask": np.tile(np.asarray(stats.get("mask", [True] * action_dim), bool), horizon),
            }
            inputs["ids"], inputs["mask"] = self.pad_prompt([self.prepare_prompt_ids(t) for t in instructions])
            inputs["frames"] = np.ascontiguousarray(
                np.stack([np.asarray(im.convert("RGB") if hasattr(im, "convert") else im) for im in images]),
                dtype=np.uint8)
            if mode == "speculative":
                inputs["draft"] = np.asarray(draft_tokens, np.int32).reshape(len(images), action_dim)
                inputs["margin"] = float(margin_threshold)
        self.last_marks = None
        packed = self._predict(mode, params, inputs, action_dim * horizon)
        with profiling.span("predict:wait"):
            host = packed.cpu()
        with profiling.span("predict:unpack"):
            out = unpack_outputs(host.numpy())
            # the copy waited for the predict: its marks have passed
            times = self.last_marks.elapsed_ms(PREDICT_TIMES) if self.last_marks is not None else None
        if times is not None:
            profiling.note(tokens=action_dim * horizon, **times)
        return out

    def predict_action(
        self,
        params: Params,
        image: Union[np.ndarray, Any],
        instruction: str,
        unnorm_key: Optional[str] = None,
    ) -> np.ndarray:
        """Single image (PIL or uint8 [H, W, 3]) + instruction -> action (numpy)."""
        return self.predict_action_batch(params, [image], [instruction], unnorm_key)[0]

    def predict_action_batch(
        self,
        params: Params,
        images: Sequence[Union[np.ndarray, Any]],
        instructions: Sequence[str],
        unnorm_key: Optional[str] = None,
        return_tokens: bool = False,
    ):
        """Frames + instructions -> [B, action_dim] actions (and, with
        `return_tokens`, the [B, action_dim] ids); decodes with
        generate_parallel when the model's `parallel_decode` is set."""
        mode = "parallel" if self.parallel_decode else "greedy"
        actions, tokens, _ = self._host_predict(mode, params, images, instructions, unnorm_key)
        return (actions, tokens) if return_tokens else actions

    def predict_action_speculative(
        self,
        params: Params,
        image: Union[np.ndarray, Any],
        instruction: str,
        draft_tokens: np.ndarray,
        unnorm_key: Optional[str] = None,
        margin_threshold: float = 0.25,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Speculative predict for control loops: pass the ids the previous
        call returned as `draft_tokens` [action_dim] (any ints will do, e.g.
        zeros on the first tick) -> (action, ids), greedy-equivalent by the
        margin gate."""
        actions, tokens, _ = self._host_predict("speculative", params, [image], [instruction], unnorm_key,
                                                draft_tokens=draft_tokens, margin_threshold=margin_threshold)
        return actions[0], tokens[0]

    def calibrate_speculative_margin(
        self,
        params: Params,
        frames: Sequence[np.ndarray],
        instruction: str,
        unnorm_key: Optional[str] = None,
        grid: Sequence[float] = (2.0, 1.0, 0.5, 0.25, 0.1, 0.05, 0.02),
        safety: float = 0.5,
    ) -> float:
        """A margin gate matched to this checkpoint's logit margins: take each
        frame's own ids (a speculative call with a zero draft), re-feed them
        as the draft while sweeping `grid` from large to small, and return
        `safety` x the largest margin that fully accepts every frame's
        self-draft (0.0 if none does). The margin is a device operand of
        the one speculative graph, so the sweep captures nothing new."""
        action_dim = self.get_action_dim(unnorm_key)
        junk = np.zeros(action_dim, np.int32)
        own = [self._host_predict("speculative", params, [f], [instruction], unnorm_key, draft_tokens=junk,
                                  margin_threshold=0.0)[1][0] for f in frames]
        for margin in sorted(grid, reverse=True):
            if all(self._host_predict("speculative", params, [f], [instruction], unnorm_key, draft_tokens=toks,
                                      margin_threshold=margin)[2][0] == action_dim for f, toks in zip(frames, own)):
                return safety * float(margin)
        return 0.0

    def predict_action_chunk(
        self,
        params: Params,
        image: Union[np.ndarray, Any],
        instruction: str,
        horizon: int,
        unnorm_key: Optional[str] = None,
    ) -> np.ndarray:
        """Chunked control: ONE parallel forward emits the current action and
        the next horizon - 1 -> [horizon, action_dim] unnormalized (models
        fine-tuned with the parallel objective and that chunk)."""
        action_dim = self.get_action_dim(unnorm_key)
        actions, _, _ = self._host_predict("parallel", params, [image], [instruction], unnorm_key, horizon=horizon)
        return actions[0].reshape(horizon, action_dim)


def norm_stats_from_json(obj: Dict[str, Any]) -> Dict[str, Any]:
    """Accept a `dataset_statistics.json`-style payload."""
    return {k: {"action": dict(v["action"])} for k, v in obj.items()}
