"""REST action server: POST /act {image, instruction, unnorm_key?} -> {action}.

Counterpart of bridgelang_tpu/serving/server.py (greedy path): stdlib
`http.server` with a small numpy-JSON codec, GET /healthz and /stats, and
micro-batching of concurrent requests (`max_batch > 1`). The image is
nested-list JSON or {"__b64__", "shape", "dtype"} raw bytes.

Not yet ported: speculative decoding (`draft_tokens`, and the JAX server's
speculative batch-1 default) and chunked parallel decoding (`horizon`). A
request that asks for either gets a 500 that says so.
"""

from __future__ import annotations

import base64
import json
import queue
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional

import numpy as np

from bridgelang_tpu_torch._device import resolve_device


REQUEST_TIMEOUT_S = 600.0  # a queued request gives up after this long


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

    __slots__ = ("image", "instruction", "unnorm_key", "event", "result", "error", "abandoned")

    def __init__(self, image, instruction, unnorm_key):
        self.image, self.instruction, self.unnorm_key = image, instruction, unnorm_key
        self.event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None
        self.abandoned = False  # the submitter gave up; the worker skips it


class VLAServer:
    """Wraps an OpenVLA model + params; `run()` blocks serving requests.

    With `max_batch > 1`, a worker thread drains the queue for up to
    `batch_window_ms` after the first request, groups compatible requests
    (same unnorm_key and image shape), pads each group to the next bucket
    and runs ONE batched predict_action pass. `device` defaults to CUDA
    (raising without a card) and must be the model's device.
    """

    def __init__(self, model, params, default_unnorm_key: Optional[str] = None,
                 max_batch: int = 1, batch_window_ms: float = 6.0, device=None):
        self.device = resolve_device(device)
        if self.device.type != model.device.type:
            raise ValueError(f"server device {self.device} differs from the model's {model.device}")
        self.model = model
        self.params = params
        self.default_unnorm_key = default_unnorm_key
        self.max_batch = int(max_batch)
        self.batch_window_s = batch_window_ms / 1e3
        self._stats_lock = threading.Lock()
        self._n_requests = 0
        self._n_errors = 0
        self._n_batches = 0
        self._recent_ms: List[float] = []
        self._started = time.time()
        # One model pass at a time: the batch-1 path runs on the HTTP threads.
        self._model_lock = threading.Lock()
        if self.max_batch > 1:
            self._queue: "queue.Queue[Optional[_Pending]]" = queue.Queue()
            self._worker = threading.Thread(target=self._batch_worker, daemon=True)
            self._worker.start()

    def _record(self, dt_s: float, error: bool) -> None:
        with self._stats_lock:
            self._n_requests += 1
            self._n_errors += int(error)
            self._recent_ms.append(dt_s * 1e3)
            if len(self._recent_ms) > 512:
                del self._recent_ms[: len(self._recent_ms) - 512]

    def stats(self) -> Dict[str, Any]:
        with self._stats_lock:
            recent = list(self._recent_ms)
            n, e, nb = self._n_requests, self._n_errors, self._n_batches
        payload: Dict[str, Any] = {
            "requests": n, "errors": e, "model_passes": nb, "uptime_s": round(time.time() - self._started, 1),
            "max_batch": self.max_batch,
        }
        if recent:
            payload["latency_ms"] = {
                "p50": round(float(np.percentile(recent, 50)), 1),
                "p90": round(float(np.percentile(recent, 90)), 1),
                "p99": round(float(np.percentile(recent, 99)), 1),
                "last": round(recent[-1], 1),
                "window": len(recent),
            }
        return payload

    def _predict_batch(self, images, instructions, unnorm_key) -> np.ndarray:
        with self._model_lock:
            actions = self.model.predict_action_batch(self.params, images, instructions, unnorm_key=unnorm_key)
        with self._stats_lock:
            self._n_batches += 1
        return actions

    def predict(self, request: Dict[str, Any]) -> Dict[str, Any]:
        if request.get("horizon") is not None:
            raise NotImplementedError("chunked parallel decoding (`horizon`) is not yet ported to the torch server")
        if request.get("draft_tokens") is not None:
            raise NotImplementedError("speculative decoding (`draft_tokens`) is not yet ported to the torch server")
        image = decode_image(request["image"])
        instruction = request["instruction"]
        unnorm_key = request.get("unnorm_key") or self.default_unnorm_key
        if self.max_batch <= 1:
            return {"action": encode_array(self._predict_batch([image], [instruction], unnorm_key)[0])}
        pending = _Pending(image, instruction, unnorm_key)
        self._queue.put(pending)
        if not pending.event.wait(timeout=REQUEST_TIMEOUT_S):
            pending.abandoned = True
            raise TimeoutError("batched predict timed out")
        if pending.error is not None:
            raise pending.error
        return {"action": encode_array(pending.result)}

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
            while len(batch) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:  # close(): finish this batch, then stop
                    self._queue.put(None)
                    break
                batch.append(nxt)
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
            actions = self._predict_batch(images, instructions, group[0].unnorm_key)
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
                t0 = time.perf_counter()
                try:
                    length = int(self.headers.get("Content-Length", "0"))
                    request = json.loads(self.rfile.read(length))
                    out = server_self.predict(request)
                except Exception:  # per-request error containment: report and keep serving
                    server_self._record(time.perf_counter() - t0, error=True)
                    traceback.print_exc()
                    try:
                        self._send(500, {"error": "error", "detail": traceback.format_exc(limit=3)})
                    except OSError:
                        pass  # client already gone
                    return
                server_self._record(time.perf_counter() - t0, error=False)
                try:
                    self._send(200, out)
                except OSError:
                    pass  # client closed; the result is lost

        return Handler

    def run(self, host: str = "0.0.0.0", port: int = 8000):
        httpd = ThreadingHTTPServer((host, port), self.make_handler())
        print(f"[serve] listening on {host}:{port} (POST /act)")
        try:
            httpd.serve_forever()
        finally:
            httpd.server_close()

    def serve_background(self, host: str = "127.0.0.1", port: int = 8000) -> ThreadingHTTPServer:
        """Serve from a daemon thread; stop with `httpd.shutdown(); httpd.server_close()`."""
        httpd = ThreadingHTTPServer((host, port), self.make_handler())
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        return httpd


def client_act(host: str, port: int, image: np.ndarray, instruction: str, unnorm_key: Optional[str] = None,
               timeout: float = 120.0) -> np.ndarray:
    """Minimal client: POST /act with a base64 frame; returns the action."""
    import http.client

    payload = {
        "image": {
            "__b64__": base64.b64encode(np.ascontiguousarray(image).tobytes()).decode("ascii"),
            "shape": list(image.shape),
            "dtype": str(image.dtype),
        },
        "instruction": instruction,
        "unnorm_key": unnorm_key,
    }
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        conn.request("POST", "/act", body=json.dumps(payload), headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = json.loads(resp.read())
    finally:
        conn.close()
    if resp.status != 200:
        raise RuntimeError(f"server error {resp.status}: {data}")
    return np.asarray(data["action"])
