"""Device mesh construction + distributed bootstrap over `torch.distributed`.

Counterpart of bridgelang_tpu/parallel/mesh.py. The topology is explicit: a
`torch.distributed.device_mesh.DeviceMesh` with the axes

    ("replica", "fsdp", "tensor")

* `replica` — pure data parallelism; gradients all-reduce over it. It crosses
  nodes (the JAX package's slices).
* `fsdp`    — parameter / optimizer sharding (ZeRO-3); stays inside a node.
* `tensor`  — Megatron-style tensor parallelism; innermost, inside a node.

One process drives one device (torch's idiom; the JAX package drives the
whole mesh from one process): `torchrun --nproc_per_node N` starts the ranks,
and each rank's "cuda" is `cuda:LOCAL_RANK`. A process group is NCCL on CUDA
and gloo on the CPU, always with a timeout, so that a rank whose peer died
raises instead of waiting forever. The CPU (gloo) is used only when the
caller asks for device "cpu", as the tests do.

Batch is sharded over (replica, fsdp); params over (fsdp, tensor) per the
rules in bridgelang_tpu_torch.parallel.sharding.
"""

from __future__ import annotations

import os
import tempfile
import warnings
from datetime import timedelta
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

MESH_AXES = ("replica", "fsdp", "tensor")
DEFAULT_TIMEOUT_S = 1800.0  # a rank waits this long on a peer before it raises


def _backend(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device_type: str = "cuda",
    local_rank: Optional[int] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> None:
    """Join the process group. The topology comes from the arguments or from
    torchrun's environment (MASTER_ADDR / MASTER_PORT, WORLD_SIZE, RANK,
    LOCAL_RANK); `coordinator_address` (or DIST_INIT_METHOD) is an init
    method ("tcp://host:port" or "file:///path"; "host:port" means tcp),
    env:// (MASTER_ADDR / MASTER_PORT) without one. A no-op for a single process
    (no arguments, no WORLD_SIZE) and when a group exists already. On CUDA
    the rank's device becomes cuda:LOCAL_RANK first (NCCL's communicator is
    bound to it)."""
    if dist.is_initialized():
        return
    env = os.environ
    coordinator_address = coordinator_address or env.get("DIST_INIT_METHOD")
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if coordinator_address is None and num_processes is None and process_id is None:
        return
    if num_processes is None or process_id is None:
        raise ValueError("initialize_distributed needs both the world size and this process's rank")
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    if device_type == "cuda":
        local = int(env.get("LOCAL_RANK", process_id) if local_rank is None else local_rank)
        torch.cuda.set_device(local)
    dist.init_process_group(_backend(device_type), init_method=init_method, world_size=num_processes,
                            rank=process_id, timeout=timedelta(seconds=timeout_s))


def _ensure_process_group(device_type: str, timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """A one-rank group for a single process that was started without one (a
    mesh of one device is still a mesh: its collectives run). The store is a
    file in a fresh temporary directory: no port, no network."""
    if dist.is_initialized():
        return
    if "WORLD_SIZE" in os.environ:
        initialize_distributed(device_type=device_type, timeout_s=timeout_s)
        return
    store = os.path.join(tempfile.mkdtemp(prefix="bridgelang_pg_"), "store")
    initialize_distributed(f"file://{store}", 1, 0, device_type=device_type, local_rank=0, timeout_s=timeout_s)


def parse_mesh_shape(spec: Optional[str], n_devices: int) -> Tuple[int, int, int]:
    """Parse "replica=2,fsdp=4,tensor=1" (missing axes default to 1; one axis
    may be -1 to absorb the remainder)."""
    if not spec:
        return (1, n_devices, 1)
    sizes = {"replica": 1, "fsdp": 1, "tensor": 1}
    for part in spec.split(","):
        k, v = part.split("=")
        sizes[k.strip()] = int(v)
    unknowns = [k for k, v in sizes.items() if v == -1]
    known = int(np.prod([v for v in sizes.values() if v != -1]))
    if unknowns:
        assert len(unknowns) == 1, "only one mesh axis may be -1"
        sizes[unknowns[0]] = n_devices // known
    shape = (sizes["replica"], sizes["fsdp"], sizes["tensor"])
    assert int(np.prod(shape)) == n_devices, f"mesh {shape} != {n_devices} devices"
    return shape


def hybrid_mesh_plan(shape: Tuple[int, int, int], n_slices: int):
    """Multi-node layout: the replica axis crosses nodes, fsdp/tensor stay
    inside a node (shard within a node, replicate across nodes). Returns
    (per-node shape, across-node shape), or None when the shape cannot split
    cleanly across `n_slices` nodes."""
    if n_slices <= 1:
        return None
    replica, fsdp, tensor = shape
    if replica % n_slices != 0:
        return None
    return (replica // n_slices, fsdp, tensor), (n_slices, 1, 1)


def make_mesh(mesh_shape: Optional[str] = None, device_type: str = "cuda"):
    """The ("replica", "fsdp", "tensor") DeviceMesh over every rank of the
    process group (a one-rank group is made when none exists; the shape is
    checked against the world first). Nodes are WORLD_SIZE /
    LOCAL_WORLD_SIZE (torchrun's). Ranks are
    laid out row-major, torchrun numbers them node by node, so with
    replica = k x nodes the fsdp and tensor groups stay inside a node and
    only the replica all-reduce crosses nodes. Without `mesh_shape`, a
    multi-node job gets one replica per node and fsdp inside it."""
    from torch.distributed.device_mesh import init_device_mesh

    # The shape is checked before any process group is made.
    world = dist.get_world_size() if dist.is_initialized() else int(os.environ.get("WORLD_SIZE", "1"))
    nodes = max(1, world // max(1, int(os.environ.get("LOCAL_WORLD_SIZE", world))))
    if not mesh_shape and nodes > 1 and world % nodes == 0:
        shape: Tuple[int, int, int] = (nodes, world // nodes, 1)
    else:
        shape = parse_mesh_shape(mesh_shape, world)
    _ensure_process_group(device_type)
    if nodes > 1 and hybrid_mesh_plan(shape, nodes) is None:
        warnings.warn(f"mesh shape {shape} does not split the replica axis across {nodes} nodes; "
                      "fsdp/tensor collectives will cross nodes. Use replica=<nodes>*k.")
    return init_device_mesh(device_type, shape, mesh_dim_names=MESH_AXES)


def strategy_mesh_spec(train_strategy: str, n_devices: int, devices_per_slice: Optional[int] = None) -> str:
    """The reference's strategy ids as a mesh shape.

    fsdp-full-shard    -> shard params over every device of a node, replicate
                          across nodes (HYBRID_SHARD);
    fsdp-shard-grad-op -> the same mesh; the trainer keeps the parameters
                          whole and shards only the optimizer state over fsdp
                          (ZeRO-2, training/trainer.MeshContext);
    ddp                -> pure replication.
    """
    per_slice = devices_per_slice or n_devices
    if train_strategy in ("fsdp-full-shard", "fsdp-shard-grad-op"):
        return f"replica={n_devices // per_slice},fsdp={per_slice},tensor=1"
    if train_strategy == "ddp":
        return f"replica={n_devices},fsdp=1,tensor=1"
    raise ValueError(f"Unknown train strategy {train_strategy!r}")


def mesh_sizes(mesh) -> dict:
    """{"replica": r, "fsdp": f, "tensor": t} of a DeviceMesh."""
    return {name: mesh.size(i) for i, name in enumerate(mesh.mesh_dim_names)}


def mesh_coordinate(mesh) -> dict:
    """This rank's index along each axis of `mesh`."""
    return {name: mesh.get_local_rank(name) for name in mesh.mesh_dim_names}
