"""Predicts over a serving mesh: one process per device, rank 0 leads.

The JAX package serves a mesh from one process (`OpenVLA.use_mesh` /
`_put`); torch's idiom is one rank per device, so every predict runs on
every rank at once. Rank 0 (the one that serves HTTP) announces each
predict over a gloo control group: one broadcast of a small message (the
op, the mode, the number of tokens and the host inputs, the speculative
draft and margin included). The other ranks wait in `follow`, run the same
predict with the same inputs in the same order (so their CUDA graphs replay
the same collectives), and wait again.

A batch splits over the `replica` axis when it divides (as the JAX `_put`):
each replica group predicts its rows and the packed outputs are gathered
over `replica`. The `fsdp` axis of a serving mesh holds no parameter blocks;
its ranks predict the same rows.

Shutdown and errors: `stop` tells the followers to return. While rank 0 is
idle it sends a heartbeat (`noop`) every `heartbeat_s`, so a follower's wait
stays inside the process group's timeout; when rank 0 dies, the followers'
next wait ends in that timeout and raises. A predict that raises on a
follower (the same inputs raise on rank 0, which answers 500) is logged and
the follower waits for the next one; an error of the process group ends it.
"""

from __future__ import annotations

import threading
import time
import traceback
from typing import Any, Dict

import numpy as np
import torch
import torch.distributed as dist

from bridgelang_tpu_torch.parallel.collectives import all_gather_dim
from bridgelang_tpu_torch.parallel.mesh import mesh_coordinate, mesh_sizes

BATCH_KEYS = ("ids", "mask", "frames", "pixels", "draft")
HEARTBEAT_S = 60.0
_GROUP_ERROR = getattr(dist, "DistError", RuntimeError)  # a collective failed or timed out


def _host(inputs: Dict[str, Any]) -> Dict[str, Any]:
    """Inputs as host numpy arrays (the margin stays a float)."""
    out = {}
    for k, v in inputs.items():
        if k == "margin":
            out[k] = float(v)
        elif isinstance(v, torch.Tensor):
            out[k] = v.detach().cpu().numpy()
        else:
            out[k] = np.asarray(v)
    return out


class MeshPredictor:
    """The predicts of an OpenVLA on a serving mesh (`OpenVLA.use_mesh`)."""

    def __init__(self, model, mesh, heartbeat_s: float = HEARTBEAT_S):
        self.model, self.mesh = model, mesh
        self.rank, self.world = dist.get_rank(), dist.get_world_size()
        self.control = dist.new_group(backend="gloo") if self.world > 1 else None
        self.replicas = mesh_sizes(mesh)["replica"]
        self.replica_index = mesh_coordinate(mesh)["replica"]
        self.replica_group = mesh.get_group("replica")
        self.lock = threading.Lock()
        self.predicts = 0
        self._last = time.monotonic()
        self._stopped = threading.Event()
        if self.rank == 0 and self.world > 1 and heartbeat_s > 0:
            threading.Thread(target=self._heartbeat, args=(heartbeat_s,), daemon=True).start()

    # --- rank 0 ------------------------------------------------------------------

    def _send(self, msg) -> None:
        dist.broadcast_object_list([msg], src=0, group=self.control)
        self._last = time.monotonic()

    def _heartbeat(self, every: float) -> None:
        while not self._stopped.wait(every / 4):
            if time.monotonic() - self._last >= every:
                with self.lock:
                    if not self._stopped.is_set():
                        self._send(("noop",))

    def predict(self, mode: str, params, inputs: Dict[str, Any], n_tokens: int) -> torch.Tensor:
        """Rank 0: announce the predict to the followers, then run it. ->
        the packed output of the whole batch."""
        if self.rank != 0:
            raise RuntimeError("only rank 0 leads the predicts of a serving mesh; the others `follow`")
        host = _host(inputs)
        with self.lock:
            if self.control is not None:
                self._send(("predict", mode, n_tokens, host))
            return self._local(mode, params, host, n_tokens)

    def stop(self) -> None:
        """Rank 0: release the followers (idempotent)."""
        with self.lock:
            if self.control is not None and not self._stopped.is_set():
                self._send(("stop",))
            self._stopped.set()

    # --- every rank --------------------------------------------------------------

    def _local(self, mode: str, params, inputs: Dict[str, Any], n_tokens: int) -> torch.Tensor:
        b = inputs["ids"].shape[0]
        split = self.replicas > 1 and b % self.replicas == 0
        if split:
            k = b // self.replicas
            rows = slice(self.replica_index * k, (self.replica_index + 1) * k)
            inputs = {n: (v[rows] if n in BATCH_KEYS else v) for n, v in inputs.items()}
        packed = self.model._predict_local(mode, params, inputs, n_tokens)
        self.predicts += 1
        if split:
            packed = all_gather_dim(packed.contiguous(), 0, self.replica_group, self.replicas)
        return packed

    def follow(self, params) -> None:
        """Ranks other than 0: run rank 0's predicts until it stops."""
        while True:
            box = [None]
            dist.broadcast_object_list(box, src=0, group=self.control)
            msg = box[0]
            if msg[0] == "stop":
                return
            if msg[0] != "predict":
                continue
            _, mode, n_tokens, inputs = msg
            try:
                self._local(mode, params, inputs, n_tokens)
            except _GROUP_ERROR:
                raise
            except Exception:  # noqa: BLE001 — rank 0 raised on the same inputs and answered 500
                traceback.print_exc()
