"""REST action server: POST /act {image, instruction, unnorm_key?} -> {action}.

Counterpart of bridgelang_tpu/serving/server.py: stdlib `http.server` with
a small numpy-JSON codec, GET /healthz and /stats, and micro-batching of
concurrent requests (`max_batch > 1`). The image is nested-list JSON or
{"__b64__", "shape", "dtype"} raw bytes. A request may carry
`draft_tokens` (speculative decoding against the client's draft; the
response adds "tokens") or `horizon` (a chunk of actions from one parallel
forward, for parallel-objective models). At batch 1 the server decodes
speculatively by default, drafting from its own history of the same
(instruction, unnorm_key). Every model pass holds one lock: a CUDA model's
graphs run one predict at a time. On a serving mesh (deploy --mesh_spec)
rank 0 runs this server and leads each predict (serving/mesh.py); /stats
adds the world size, the mesh shape, the predicts and the decoder's
collectives.

Every /act request is traced (util/profiling.py): one request id runs from
the handler to the reply through the spans `serve:request` and its children
`serve:parse` (body read, JSON, image decode), `serve:wait` (the model lock,
or the batcher's queue from put to the pass's start), `serve:pass` (the
model pass: the predict's own spans inside it, and its device times) and
`serve:respond` (encode, JSON, write). GET /stats reports, besides the
request and pass counts: `latency_ms` (p50 / p90 / p99 / last of this
server's last 512 `serve:request` spans), `stages_ms` (each span name's
count and p50 / p99 of its last 512 in this process,
`profiling.stage_summary`), `passes_by_rows` (model passes by the requests
they carried), `windows` (batcher windows closed full, at the deadline, and
by `close()`), `graph_captures` (CUDA graphs captured since the server
started listening: one on a live request is a graph built again) and
`memory` (per card, live and peak).
"""

from __future__ import annotations

import base64
import collections
import json
import queue
import threading
import time
import traceback
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from bridgelang_tpu_torch._device import resolve_device
from bridgelang_tpu_torch.models.llm.llama import is_mla, refuse_mla
from bridgelang_tpu_torch.util import profiling

# Each horizon is its own graph shape (7 x H decode positions); requests past
# any sane control-chunk length are refused rather than captured.
MAX_HORIZON = 32
DRAFT_CACHE_SIZE = 64  # (instruction, unnorm_key) histories the speculative default keeps
LATENCY_SPANS = 512  # this server's last serve:request spans that /stats latency_ms reads


def moe_stats(model) -> Dict[str, Any]:
    """/stats "moe": the route counters of the latent attention and the
    routed experts (counted when a path is taken; under a CUDA graph, at its
    capture), and the last prefill's expert load summary."""
    routes = {k: v for k, v in profiling.counters().items() if k.startswith(("moe:", "attn:mla_"))}
    load = getattr(model, "last_expert_load", None)
    out: Dict[str, Any] = {"routes": routes}
    if load is not None:
        from bridgelang_tpu_torch.models.vla import expert_load_summary

        out.update(expert_load_summary(load), layers=int(load.shape[0]), experts=int(load.shape[1]))
    return out


def decode_image(payload: Any) -> np.ndarray:
    if isinstance(payload, dict) and "__b64__" in payload:
        raw = base64.b64decode(payload["__b64__"])
        arr = np.frombuffer(raw, dtype=np.dtype(payload.get("dtype", "uint8")))
        return arr.reshape(payload["shape"]).copy()
    if isinstance(payload, str):
        return decode_image(json.loads(payload))  # double-encoded payload
    arr = np.asarray(payload)
    if arr.dtype != np.uint8:
        arr = np.clip(arr, 0, 255).astype(np.uint8)
    return arr


def encode_array(arr: np.ndarray) -> Any:
    return np.asarray(arr).tolist()


def draft_from_history(prev2: Optional[np.ndarray], prev1: np.ndarray, vocab_size: int,
                       step_thresh: int = 2, clamp: int = 8, n_bins: int = 256) -> np.ndarray:
    """A token-space draft from the last two ticks' action ids: per dim, the
    last step extrapolated (clamped to +-`clamp` bins) where it was at least
    `step_thresh` bins, else prev1 verbatim. Action ids are affine in the bin
    index (vocab_size - bin), so bin arithmetic is exact in id space; only
    extrapolated dims are clipped to the action range."""
    if prev2 is None:
        return prev1
    step = np.clip(prev1.astype(np.int64) - prev2, -clamp, clamp)
    step = np.where(np.abs(step) >= step_thresh, step, 0)
    ex = np.clip(prev1 + step, vocab_size - n_bins, vocab_size - 1)
    return np.where(step != 0, ex, prev1).astype(np.int32)


def batch_buckets(max_batch: int) -> List[int]:
    """The padded batch sizes the server executes: powers of two up to
    max_batch, plus max_batch itself when it is not one."""
    buckets, b = [1], 2
    while b < max_batch:
        buckets.append(b)
        b *= 2
    if max_batch > 1:
        buckets.append(max_batch)
    return buckets


class _Pending:
    """One queued request awaiting a batch slot."""

    __slots__ = ("image", "instruction", "unnorm_key", "event", "result", "error", "abandoned", "span", "thread",
                 "t_put")

    def __init__(self, image, instruction, unnorm_key):
        self.image, self.instruction, self.unnorm_key = image, instruction, unnorm_key
        self.event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None
        self.abandoned = False  # the submitter gave up; the worker skips it
        # the submitter's open span (its serve:request), thread and time of the put: its serve:wait
        self.span, self.thread, self.t_put = profiling.current(), threading.get_ident(), time.perf_counter_ns()


class VLAServer:
    """Wraps an OpenVLA model + params; `run()` blocks serving requests.

    With `max_batch > 1`, a worker thread drains the queue for up to
    `batch_window_ms` after the first request, groups compatible requests
    (same unnorm_key and image shape), pads each group to the next bucket
    and runs ONE batched predict_action pass; a queued request gives up after
    `request_timeout_s`. Requests with `draft_tokens` or `horizon` bypass the
    queue. At batch 1 with `speculative_default`, a request without a draft
    decodes speculatively against `draft_from_history` of the ids this server
    returned for the same (instruction, unnorm_key) (zeros on the first
    tick), gated at `speculative_margin`; greedy-equivalent, and the response
    carries "tokens". The default is off for a parallel-decode model and for
    an int8 KV cache. `device` defaults to CUDA (raising without a card) and
    must be the model's device.
    """

    def __init__(self, model, params, default_unnorm_key: Optional[str] = None,
                 max_batch: int = 1, batch_window_ms: float = 6.0, request_timeout_s: float = 600.0,
                 speculative_default: bool = True, speculative_margin: float = 0.25, device=None):
        self.device = resolve_device(device)
        if self.device.type != model.device.type:
            raise ValueError(f"server device {self.device} differs from the model's {model.device}")
        self.model = model
        self.params = params
        self.default_unnorm_key = default_unnorm_key
        self.max_batch = int(max_batch)
        self.batch_window_s = batch_window_ms / 1e3
        self.request_timeout_s = float(request_timeout_s)
        self.speculative_margin = float(speculative_margin)
        # A parallel-objective model decodes through generate_parallel: the
        # sequential speculative path would emit ids its fine-tune never
        # trained. An int8 KV cache could quantize the verify chunk apart from
        # decode beyond what the margin gate covers.
        self.speculative_default = (bool(speculative_default)
                                    and getattr(model, "cache_dtype", None) != torch.int8
                                    and not getattr(model, "parallel_decode", False))
        llm = getattr(getattr(model, "cfg", None), "llm", None)
        self._mla = llm is not None and is_mla(llm)
        if self.speculative_default and self._mla:
            refuse_mla(llm, "speculative decoding (--speculative_default)")
        self._draft_cache: "OrderedDict[Any, tuple]" = OrderedDict()  # (prev2, prev1) ids per key, LRU
        self._draft_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self._n_requests = 0
        self._n_errors = 0
        self._n_batches = 0
        self._started = time.time()
        self._latency_ms: "collections.deque[float]" = collections.deque(maxlen=LATENCY_SPANS)  # serve:request
        self._counters0 = profiling.counters()
        self._listening()
        # One model pass at a time: the batch-1 path runs on the HTTP threads.
        self._model_lock = threading.Lock()
        if self.max_batch > 1:
            self._queue: "queue.Queue[Optional[_Pending]]" = queue.Queue()
            self._worker = threading.Thread(target=self._batch_worker, daemon=True)
            self._worker.start()

    def _record(self, error: bool) -> None:
        with self._stats_lock:
            self._n_requests += 1
            self._n_errors += int(error)

    def _ended(self, request: profiling.Span) -> None:
        """A `serve:request` span of this server has ended: its time for /stats latency_ms."""
        self._latency_ms.append(request.ms)

    def _listening(self) -> None:
        """Graph captures count from here (again when the server starts
        listening: warm-up is over)."""
        self._captures0 = profiling.counters("graphs:").get("graphs:captures", 0)

    def _since_start(self, prefix: str) -> Dict[str, int]:
        return {k[len(prefix):]: v - self._counters0.get(k, 0) for k, v in profiling.counters(prefix).items()
                if v != self._counters0.get(k, 0)}

    def stats(self) -> Dict[str, Any]:
        with self._stats_lock:
            n, e, nb = self._n_requests, self._n_errors, self._n_batches
        recent = list(self._latency_ms)
        windows = self._since_start("serve:window_")
        payload: Dict[str, Any] = {
            "requests": n, "errors": e, "model_passes": nb, "uptime_s": round(time.time() - self._started, 1),
            "max_batch": self.max_batch,
            "passes_by_rows": self._since_start("serve:pass_rows="),
            "windows": {k: windows.get(k, 0) for k in ("full", "deadline", "close")},
            "graph_captures": profiling.counters("graphs:").get("graphs:captures", 0) - self._captures0,
            "stages_ms": profiling.stage_summary(),
            "memory": profiling.device_memory_stats(),
        }
        mesh = getattr(self.model, "serving_mesh", None)
        if mesh is not None:  # a tensor-parallel deploy: its shape, predicts and the decoder's collectives
            payload["world_size"] = int(mesh.size())
            payload["mesh"] = {name: int(mesh.size(i)) for i, name in enumerate(mesh.mesh_dim_names)}
            payload["predicts"] = self.model.mesh_predictor.predicts
            payload["collectives"] = self.model.cfg.llm.tp.launches
        if self.device.type == "cuda":  # each kernel wrapper's launches (replays count what their capture recorded)
            from bridgelang_tpu_torch.models.graphs import counted_wrappers

            payload["kernel_launches"] = {fn.__name__: fn.launches for fn in counted_wrappers()}
        if self._mla:
            payload["moe"] = moe_stats(self.model)
        if recent:
            payload["latency_ms"] = {
                "p50": round(float(np.percentile(recent, 50)), 1),
                "p90": round(float(np.percentile(recent, 90)), 1),
                "p99": round(float(np.percentile(recent, 99)), 1),
                "last": round(recent[-1], 1),
                "window": len(recent),
            }
        return payload

    def _model_pass(self, fn, *args, queued: Optional[List[_Pending]] = None, **kwargs):
        """One model pass under the lock, counted in /stats. Called on a
        request's own thread, its wait for the lock is its `serve:wait`; from
        the batch worker with the `queued` requests of the group, each one's
        wait runs from its put to the pass's start."""
        if queued is None:
            with profiling.span("serve:wait"):
                self._model_lock.acquire()
            attrs: Dict[str, Any] = {"rows": 1}
        else:
            self._model_lock.acquire()
            t = time.perf_counter_ns()
            for p in queued:
                profiling.record("serve:wait", p.t_put, t, rid=p.span.rid if p.span else None,
                                 parent=p.span.id if p.span else None, thread=p.thread)
            attrs = {"rows": len(queued), "request_ids": [p.span.rid if p.span else None for p in queued]}
        try:
            with profiling.span("serve:pass", **attrs):
                out = fn(self.params, *args, **kwargs)
        finally:
            self._model_lock.release()
        profiling.count(f"serve:pass_rows={attrs['rows']}")
        with self._stats_lock:
            self._n_batches += 1
        return out

    def _speculative(self, image, instruction, unnorm_key, draft) -> Dict[str, Any]:
        action, tokens = self._model_pass(self.model.predict_action_speculative, image, instruction,
                                          draft_tokens=draft, unnorm_key=unnorm_key,
                                          margin_threshold=self.speculative_margin)
        return {"action": action, "tokens": tokens}

    def predict(self, request: Dict[str, Any]) -> Dict[str, Any]:
        """One /act request's JSON object -> the response's (arrays as lists)."""
        return {k: encode_array(v) for k, v in self._answer(request).items()}

    def _answer(self, request: Dict[str, Any]) -> Dict[str, np.ndarray]:
        image = decode_image(request["image"])
        instruction = request["instruction"]
        # Clients may send an explicit null: `or` resolves it to the server key.
        unnorm_key = request.get("unnorm_key") or self.default_unnorm_key
        if request.get("horizon") is not None:  # horizon=0 must reach the range check
            horizon = int(request["horizon"])
            if not getattr(self.model, "parallel_decode", False):
                raise ValueError("horizon requires a parallel-objective model (deploy --parallel_decode true)")
            if not 1 <= horizon <= MAX_HORIZON:
                raise ValueError(f"horizon must be in [1, {MAX_HORIZON}], got {horizon}")
            chunk = self._model_pass(self.model.predict_action_chunk, image, instruction, horizon=horizon,
                                     unnorm_key=unnorm_key)
            return {"action": chunk}
        if request.get("draft_tokens") is not None and not getattr(self.model, "parallel_decode", False):
            # The client's draft (its previous response's tokens); a
            # parallel-decode model ignores it and decodes in parallel below.
            return self._speculative(image, instruction, unnorm_key, np.asarray(request["draft_tokens"], np.int32))
        if self.max_batch <= 1:
            if self.speculative_default:
                key = (instruction, unnorm_key)
                with self._draft_lock:
                    prev2, prev1 = self._draft_cache.get(key, (None, None))
                if prev1 is None:
                    draft = np.zeros(self.model.get_action_dim(unnorm_key), np.int32)
                else:
                    draft = draft_from_history(prev2, prev1, self.model.cfg.llm.vocab_size,
                                               n_bins=getattr(self.model, "n_action_bins", 256))
                out = self._speculative(image, instruction, unnorm_key, draft)
                with self._draft_lock:
                    self._draft_cache[key] = (prev1, np.asarray(out["tokens"], np.int32))
                    self._draft_cache.move_to_end(key)
                    while len(self._draft_cache) > DRAFT_CACHE_SIZE:
                        self._draft_cache.popitem(last=False)
                return out
            action = self._model_pass(self.model.predict_action_batch, [image], [instruction],
                                      unnorm_key=unnorm_key)[0]
            return {"action": action}
        pending = _Pending(image, instruction, unnorm_key)
        self._queue.put(pending)
        if not pending.event.wait(timeout=self.request_timeout_s):
            pending.abandoned = True
            raise TimeoutError("batched predict timed out")
        if pending.error is not None:
            raise pending.error
        return {"action": pending.result}

    # --- micro-batching worker -------------------------------------------

    def close(self) -> None:
        """Stop the micro-batching worker (a no-op at max_batch 1)."""
        if self.max_batch > 1 and self._worker.is_alive():
            self._queue.put(None)
            self._worker.join(timeout=60)

    def _batch_worker(self) -> None:
        while True:
            first = self._queue.get()
            if first is None:  # close()
                return
            batch = [first]
            deadline = time.monotonic() + self.batch_window_s
            closed = "full"
            while len(batch) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    closed = "deadline"
                    break
                try:
                    nxt = self._queue.get(timeout=remaining)
                except queue.Empty:
                    closed = "deadline"
                    break
                if nxt is None:  # close(): finish this batch, then stop
                    self._queue.put(None)
                    closed = "close"
                    break
                batch.append(nxt)
            profiling.count(f"serve:window_{closed}")
            live = [p for p in batch if not p.abandoned]
            for group in self._group_compatible(live):
                self._run_group(group)

    @staticmethod
    def _group_compatible(batch: List[_Pending]) -> List[List[_Pending]]:
        groups: Dict[Any, List[_Pending]] = {}
        for p in batch:
            groups.setdefault((p.unnorm_key, np.asarray(p.image).shape), []).append(p)
        return list(groups.values())

    def _run_group(self, group: List[_Pending]) -> None:
        group = [p for p in group if not p.abandoned]
        if not group:
            return
        try:
            n = len(group)
            bucket = next(b for b in batch_buckets(self.max_batch) if b >= n)
            images = [p.image for p in group] + [group[0].image] * (bucket - n)
            instructions = [p.instruction for p in group] + [group[0].instruction] * (bucket - n)
            actions = self._model_pass(self.model.predict_action_batch, images, instructions,
                                       unnorm_key=group[0].unnorm_key, queued=group)
            for p, action in zip(group, actions[:n]):
                p.result = np.asarray(action)
        except Exception as e:  # noqa: BLE001 — delivered to each request of the group
            for p in group:
                p.error = e
        finally:
            for p in group:
                p.event.set()

    def make_handler(server_self):
        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet
                pass

            def _send(self, code: int, payload: Dict[str, Any]) -> None:
                body = json.dumps(payload).encode("utf-8")
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._send(200, {"status": "ok"})
                elif self.path == "/stats":
                    self._send(200, server_self.stats())
                else:
                    self._send(404, {"error": "not found"})

            def do_POST(self):
                if self.path != "/act":
                    self._send(404, {"error": "not found"})
                    return
                with profiling.span("serve:request", rid=profiling.new_request_id()) as request:
                    self._act()
                server_self._ended(request)

            def _act(self):
                try:
                    with profiling.span("serve:parse"):
                        length = int(self.headers.get("Content-Length", "0"))
                        request = json.loads(self.rfile.read(length))
                        if isinstance(request, dict) and "image" in request:
                            request["image"] = decode_image(request["image"])
                    out = server_self._answer(request)
                except Exception:  # per-request error containment: report and keep serving
                    server_self._record(error=True)
                    traceback.print_exc()
                    with profiling.span("serve:respond", ends_parent=True):
                        try:
                            self._send(500, {"error": "error", "detail": traceback.format_exc(limit=3)})
                        except OSError:
                            pass  # client already gone
                    return
                server_self._record(error=False)
                with profiling.span("serve:respond", ends_parent=True):  # the reply written ends serve:request
                    try:
                        self._send(200, {k: encode_array(v) for k, v in out.items()})
                    except OSError:
                        pass  # client closed; the result is lost

        return Handler

    def run(self, host: str = "0.0.0.0", port: int = 8000):
        self._listening()
        httpd = ThreadingHTTPServer((host, port), self.make_handler())
        print(f"[serve] listening on {host}:{port} (POST /act)")
        try:
            httpd.serve_forever()
        finally:
            httpd.server_close()

    def serve_background(self, host: str = "127.0.0.1", port: int = 8000) -> ThreadingHTTPServer:
        """Serve from a daemon thread; stop with `httpd.shutdown(); httpd.server_close()`."""
        self._listening()
        httpd = ThreadingHTTPServer((host, port), self.make_handler())
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        return httpd


def client_act(host: str, port: int, image: np.ndarray, instruction: str, unnorm_key: Optional[str] = None,
               use_b64: bool = True, draft_tokens: Optional[np.ndarray] = None, return_tokens: bool = False,
               horizon: Optional[int] = None, timeout: float = 120.0):
    """Minimal client: POST /act with the frame as base64 bytes (or nested
    lists); returns the action. Speculative control loops pass the previous
    response's `tokens` as `draft_tokens` and set `return_tokens` to get
    (action, tokens) (tokens None when the server sent none); `horizon=H`
    asks a parallel-decode server for an [H, action_dim] chunk."""
    import http.client

    if use_b64:
        img_payload: Any = {
            "__b64__": base64.b64encode(np.ascontiguousarray(image).tobytes()).decode("ascii"),
            "shape": list(image.shape),
            "dtype": str(image.dtype),
        }
    else:
        img_payload = np.asarray(image).tolist()
    payload: Dict[str, Any] = {"image": img_payload, "instruction": instruction, "unnorm_key": unnorm_key}
    if draft_tokens is not None:
        payload["draft_tokens"] = np.asarray(draft_tokens).tolist()
    if horizon is not None:
        payload["horizon"] = int(horizon)
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        conn.request("POST", "/act", body=json.dumps(payload), headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = json.loads(resp.read())
    finally:
        conn.close()
    if resp.status != 200:
        raise RuntimeError(f"server error {resp.status}: {data}")
    action = np.asarray(data["action"])
    if return_tokens:
        return action, (np.asarray(data["tokens"]) if "tokens" in data else None)
    return action
