"""One-program predicts on the card: captured CUDA graphs, replayed per request.

Counterpart of the JAX package's jit cache of predict programs
(bridgelang_tpu/models/vla.py `_predict_fns` and `_jitted_predict`,
`_jitted_predict_frames`, `_jitted_predict_frames_speculative`). Where the
JAX package compiles one XLA program per shape, a CUDA model here captures
one `torch.cuda.CUDAGraph` per key and replays it:

* Key: the mode ("greedy", "parallel", "speculative"), the number of tokens
  decoded (action_dim, times the horizon for a chunk), the shapes and dtypes
  of the inputs (batch bucket, prompt bucket, frame H x W), the KV cache
  dtype, and the decoder's weight kind (float dtype, int8 or int4) with
  `w8a8`.
* Buffers: every input has a static buffer (ids, mask, uint8 frames or
  pixels, q01, q99, stat mask; the draft and the margin for the speculative
  mode), filled by one copy per input before a replay. The graph writes one
  static int32 output [B, 2 A + 1]: the actions' float32 bits, the token ids
  and the accepted counts, which one device-to-host copy returns.
* Memory: every graph of a model allocates from one pool
  (`torch.cuda.graph_pool_handle()`). A graph's KV cache is allocated inside
  its capture, so the cache of a key lives in that pool and is zeroed by each
  replay, as `init_kv_cache` zeroes it eagerly (the int8 cache's four leaves,
  codes and scales, as the float caches' two). The graphs may share freed
  intermediates because one predict runs at a time (the server's model
  lock), and every buffer that outlives a replay is held by the entry.
* Greedy and parallel: one replay per predict.
* Speculative: a graph cannot hold the JAX fix-up `lax.while_loop`, so the
  predict is two graphs. Graph A runs frames -> prefill -> token 0 -> the
  verify chunk, writes the accepted prefix, the accepted counts and the
  actions, and leaves j0 in a one-element device step index. The host reads
  the step index (the one read in the middle of a predict) and replays
  graph B, one fix-up decode step that reads and increments the step index
  and rewrites the outputs, n - j0 times.
* Collectives: on a serving mesh (OpenVLA.use_mesh) a graph holds the
  decoder's all-reduces and the logits' gather as NCCL launches on the
  capture stream; the warm-up before the capture creates the communicator.
  Every rank captures and replays the same keys in the same order.
* Device marks (util/profiling.DeviceMarks, external events): graph A of a
  key records the predict's marks (`PREDICT_MARKS`: its start,
  after the towers, after token 0, after the last decode step), so every
  replay times itself; each run leaves its key's marks in the model's
  `last_marks`.
* Spans: `graphs:copy_in` (the static buffers' copies), `graphs:capture`
  (a key's first use; counted in the `graphs:captures` counter) and
  `graphs:replay` (the replays, and the speculative step index's read).
* Launch counts: the kernel wrappers (and a mesh's tensor group, its
  collectives) count launches on the host, which a replay never reaches.
  Each graph records the launches its capture made and adds them to the
  wrappers' `.launches` on every replay; the capture
  itself counts nothing (the warm-up run before it counts, as the eager
  launches it is).
* The weights: a graph reads the tensors of the params it was captured
  with. The entries belong to one params object; a call with another one
  drops every graph first.

No fallback: a capture or replay that fails raises, and a CUDA model never
runs a predict eagerly unless its caller set `use_graphs = False`.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from bridgelang_tpu_torch.util import profiling

MODES = ("greedy", "parallel", "speculative")
# The device marks of a predict, and the times the host reads from them into
# the enclosing span once the predict's output is on the host.
PREDICT_MARKS = ("start", "vision", "token0", "last")
PREDICT_TIMES = {"vision_ms": ("start", "vision"), "prefill_ms": ("start", "token0"), "decode_ms": ("token0", "last")}


def counted_wrappers() -> List[Callable]:
    """The kernel wrappers that count their launches in `.launches`."""
    from bridgelang_tpu_torch.ops.flash_attention import flash_attention, flash_bwd_dkv, flash_bwd_dq
    from bridgelang_tpu_torch.ops.int4_matmul import int4_mm, int4_mm_a8, quantize_a8
    from bridgelang_tpu_torch.ops.int8_matmul import int8_gemv

    return [flash_attention, flash_bwd_dq, flash_bwd_dkv, int4_mm_a8, int4_mm, quantize_a8, int8_gemv]


def weight_kind(llm_params: Dict[str, Any], w8a8: bool) -> str:
    """"int4", "int8" or the float dtype of the decoder layers, and w8a8."""
    first = llm_params["layers"][0]
    if any(k.endswith("_scale4") for k in first):
        kind = "int4"
    elif any(k.endswith("_scale") for k in first):
        kind = "int8"
    else:
        kind = str(first["wq"].dtype).replace("torch.", "")
    return f"{kind}{'+w8a8' if w8a8 else ''}"


def pack_outputs(actions: torch.Tensor, tokens: torch.Tensor, accepts: torch.Tensor) -> torch.Tensor:
    """[B, A] float32 actions, [B, A] ids, [B] counts -> one [B, 2 A + 1] int32."""
    return torch.cat([actions.float().view(torch.int32), tokens.to(torch.int32), accepts.to(torch.int32)[:, None]],
                     dim=1)


def unpack_outputs(packed: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host side of `pack_outputs` -> (actions float32, tokens int32, accepts int32)."""
    a = (packed.shape[1] - 1) // 2
    return packed[:, :a].view(np.float32), packed[:, a:2 * a], packed[:, 2 * a]


class CapturedGraph:
    """One CUDA graph and the launches of each counted wrapper in it."""

    def __init__(self, graph: torch.cuda.CUDAGraph, launches: Dict[Callable, int]):
        self.graph, self.launches = graph, launches

    def replay(self) -> None:
        self.graph.replay()
        for fn, n in self.launches.items():
            fn.launches += n


class GraphEntry:
    """The static buffers and graphs of one key."""

    def __init__(self, statics: Dict[str, torch.Tensor], packed: torch.Tensor):
        self.statics, self.packed = statics, packed
        self.graphs: List[CapturedGraph] = []
        self.state = None   # speculative: the verify state the step graph reads
        self.step: Optional[torch.Tensor] = None  # speculative: the device step index
        self.marks: Optional[profiling.DeviceMarks] = None  # graph A's device marks


class PredictGraphs:
    """A CUDA model's captured predicts (`OpenVLA.graphs`)."""

    def __init__(self, model):
        self.model = model
        self.entries: Dict[Tuple, GraphEntry] = {}
        self.params = None
        self._pool = None
        self._stream: Optional[torch.cuda.Stream] = None

    def clear(self) -> None:
        """Drop every graph, its buffers and its pool memory."""
        self.entries.clear()
        self.params = None
        self._pool = None

    def key(self, mode: str, inputs: Dict[str, Any], n_tokens: int) -> Tuple:
        shapes = tuple((name, tuple(x.shape), str(x.dtype)) for name, x in sorted(inputs.items()))
        model = self.model
        return (mode, n_tokens, shapes, str(model.cache_dtype),
                weight_kind(self.params["llm"], model.cfg.llm.w8a8))

    def run(self, mode: str, params, inputs: Dict[str, Any], n_tokens: int) -> torch.Tensor:
        """Copy `inputs` (numpy arrays or tensors; the speculative mode also
        takes "draft" and a float "margin") into the key's static buffers,
        capturing its graphs on first use, and replay. Returns the static
        packed output (valid until the next replay of any graph)."""
        if mode not in MODES:
            raise ValueError(f"unknown predict mode {mode!r}")
        with torch.inference_mode():
            return self._run(mode, params, inputs, n_tokens)

    def _run(self, mode: str, params, inputs: Dict[str, Any], n_tokens: int) -> torch.Tensor:
        if self.params is not params:
            self.clear()
            self.params = params
        margin = inputs.pop("margin", None)
        key = self.key(mode, inputs, n_tokens)
        entry = self.entries.get(key)
        fresh = entry is None
        if fresh:
            entry = self._new_entry(inputs, n_tokens)
        with profiling.span("graphs:copy_in"):
            for name, x in inputs.items():
                entry.statics[name].copy_(torch.as_tensor(x))
            if mode == "speculative":
                entry.statics["margin"].fill_(float(margin))
        if fresh:
            with profiling.span("graphs:capture"):
                self._capture(mode, entry, n_tokens)
            profiling.count("graphs:captures")
            self.entries[key] = entry
        with profiling.span("graphs:replay"):
            entry.graphs[0].replay()
            if mode == "speculative":
                j0 = int(entry.step.item())  # the one read in the middle of a predict
                for _ in range(n_tokens - j0):
                    entry.graphs[1].replay()
        self.model.last_marks = entry.marks
        return entry.packed

    # --- capture -------------------------------------------------------------

    def _new_entry(self, inputs: Dict[str, Any], n_tokens: int) -> GraphEntry:
        dev = self.model.device
        statics = {}
        for name, x in inputs.items():
            t = torch.as_tensor(x)
            statics[name] = torch.empty(tuple(t.shape), dtype=t.dtype, device=dev)
        statics["margin"] = torch.zeros((), dtype=torch.float32, device=dev)
        b = statics["ids"].shape[0]
        return GraphEntry(statics, torch.zeros((b, 2 * n_tokens + 1), dtype=torch.int32, device=dev))

    def _body(self, mode: str, entry: GraphEntry, n_tokens: int):
        """The captured work of a key: (graph A's body, graph B's body or None)."""
        model, params, s = self.model, self.params, entry.statics

        def pixels():
            return s["pixels"] if "pixels" in s else model.preprocess_frames(s["frames"])

        if mode != "speculative":  # the eager predict, captured whole
            def main():
                entry.packed.copy_(model.predict_packed(mode, params, s["ids"], s["mask"], pixels(), s["q01"], s["q99"],
                                                        s["stat_mask"], n_tokens))
            return main, None

        def verify():
            entry.state = model.speculative_verify(params, s["ids"], s["mask"], pixels(), s["draft"],
                                                   margin_threshold=s["margin"])
            entry.step.copy_(entry.state.j0.reshape(1))
            write()

        def step():
            model.speculative_step(params, entry.state, entry.step)
            write()

        def write():
            st = entry.state
            entry.packed.copy_(pack_outputs(model.tokens_to_actions(st.out, s["q01"], s["q99"], s["stat_mask"]),
                                            st.out, st.accepts))

        return verify, step

    def _capture(self, mode: str, entry: GraphEntry, n_tokens: int) -> None:
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.model.device)
        first, second = self._body(mode, entry, n_tokens)
        if second is not None:
            entry.step = torch.ones(1, dtype=torch.long, device=self.model.device)
        entry.marks = profiling.DeviceMarks(PREDICT_MARKS, external=True)

        def marked():
            with profiling.marking(entry.marks):
                profiling.mark("start")
                first()

        entry.graphs.append(self._capture_one(marked))
        if second is not None and n_tokens > 1:  # at n = 1 the verify graph is the whole predict
            # The step graph reads the verify graph's state: fill it for real
            # first, and warm the step up at j = 1, a position every n > 1 has.
            entry.graphs[0].replay()
            entry.step.fill_(1)
            entry.graphs.append(self._capture_one(second))

    def _capture_one(self, body: Callable[[], None]) -> CapturedGraph:
        """Warm `body` up on the capture stream (builds, loads and allocates
        what its launches need), then capture it into the shared pool.

        cuBLAS keeps one workspace per (handle, stream) outside any pool; a
        capture that finds one (the warm-up leaves it) records its address,
        so the graph leans on memory it does not own. A graph captured on a
        server thread, replayed after other captures and cache releases, hit
        an illegal address; with the workspaces dropped before the capture
        (which then allocates the graph's own in the pool the graph keeps)
        and after it (so that no later call shares it), as PyTorch's own
        cudagraph trees do, it does not."""
        side = self._stream
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            body()
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        tp = getattr(self.model.cfg.llm, "tp", None)
        wrappers = counted_wrappers() + ([tp] if tp is not None else [])  # tp: its collectives
        before = [fn.launches for fn in wrappers]
        graph = torch.cuda.CUDAGraph()
        torch._C._cuda_clearCublasWorkspaces()
        with torch.cuda.graph(graph, pool=self._pool, stream=side, capture_error_mode="thread_local"):
            body()
        torch._C._cuda_clearCublasWorkspaces()
        launches = {fn: fn.launches - n for fn, n in zip(wrappers, before) if fn.launches != n}
        for fn, n in zip(wrappers, before):
            fn.launches = n  # a capture launches nothing
        return CapturedGraph(graph, launches)
