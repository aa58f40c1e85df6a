"""Data-parallel and FSDP training over the port's functional parameter trees.

The JAX package trains on a mesh by placing each leaf with its
PartitionSpec (parallel/sharding.PARAM_RULES) and letting GSPMD gather and
reduce-scatter. The port keeps its parameters as dicts of tensors, not
nn.Modules, so `fully_shard` does not fit; `MeshTraining` does the same
work by hand, leaf by leaf, over the ("replica", "fsdp", "tensor") mesh:

* "full-shard" (ZeRO-3, `fsdp-full-shard`): each rank keeps its block of
  every leaf the rules shard over `fsdp` (a DTensor Shard placement,
  `placements`). The train step gathers a leaf at use: the decoder's layers
  leaf by leaf inside their remat region (a `GatheredLayer` gathers a leaf
  when the decoder reads it), so the backward gathers them again, and
  the towers, the projector, the embedding and the head when the step
  starts. A float leaf is cast to the compute dtype before the gather (half
  the bytes; the same arithmetic as casting after it); a frozen int8 /
  int4 leaf is gathered as it is. The gather's backward reduce-scatters the
  gradient over `fsdp` (in fp32).
* "shard-grad-op" (ZeRO-2, `fsdp-shard-grad-op`): parameters stay whole on
  every rank; gradients are reduce-scattered over `fsdp`, AdamW keeps its
  moments for and updates only this rank's block, and the blocks are
  gathered back into the whole parameters.
* `fsdp` = 1 is data parallelism (`ddp`).

Then the gradients are summed over `replica` (one all-reduce of all sharded
leaves' gradients) and a replicated leaf's gradient over every data rank
(one all-reduce). The loss is each rank's summed token NLL over the global
token count (one all-reduce of the count), so the summed gradients are the
global batch's. The global norm sums fp64 squares locally and makes one
all-reduce. AdamW runs on the local tensors (no DTensor dispatch per op).
`tensor` > 1 in training (tensor-parallel training) is not ported yet.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from bridgelang_tpu_torch.parallel.collectives import all_gather_dim, all_reduce_, reduce_scatter_dim
from bridgelang_tpu_torch.parallel.mesh import mesh_coordinate, mesh_sizes
from bridgelang_tpu_torch.parallel.sharding import (
    P,
    param_pspecs,
    placements,
    shard_params,
    shard_range,
    tree_zip,
)

STRATEGIES = ("full-shard", "shard-grad-op")


def fsdp_dim(spec: P) -> Optional[int]:
    """The tensor dim `spec` splits over `fsdp`, or None."""
    for d, e in enumerate(spec):
        if e == "fsdp" or (isinstance(e, tuple) and "fsdp" in e):
            return d
    return None


class _GatherShard(torch.autograd.Function):
    """A float leaf's block -> the whole leaf in the compute dtype; the
    gradient comes back reduce-scattered (summed over `fsdp`, in fp32)."""

    @staticmethod
    def forward(ctx, local, dim, group, size, dtype):
        ctx.dim, ctx.group, ctx.size, ctx.local_dtype = dim, group, size, local.dtype
        return all_gather_dim(local.to(dtype), dim, group, size)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_dim(g.float(), ctx.dim, ctx.group, ctx.size).to(ctx.local_dtype), None, None, None, None


class GatheredLayer(Mapping):
    """A decoder layer of local blocks that reads as the whole layer: each
    leaf is gathered (and cast) when it is read. The decoder reads each
    leaf once per layer run, inside the layer's remat region, so the
    backward's recomputation gathers again and no whole leaf outlives its
    layer."""

    __slots__ = ("local", "specs", "mesh_training", "cast")

    def __init__(self, local: Dict[str, torch.Tensor], specs: Dict[str, P], mesh_training: "MeshTraining",
                 cast: Callable[[torch.Tensor], torch.Tensor]):
        self.local, self.specs, self.mesh_training, self.cast = local, specs, mesh_training, cast

    def __getitem__(self, key: str) -> torch.Tensor:
        return self.mesh_training.gather(self.local[key], self.specs[key], self.cast)

    def __contains__(self, key: object) -> bool:
        return key in self.local

    def __iter__(self):
        return iter(self.local)

    def __len__(self) -> int:
        return len(self.local)


def _leaves(tree) -> List[Any]:
    if isinstance(tree, P):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _coalesced_all_reduce(tensors: List[torch.Tensor], group) -> None:
    """Sum each tensor over `group` in place, with one all-reduce per dtype."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        all_reduce_(flat, group)
        offset = 0
        for t in ts:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


class MeshTraining:
    """What a train step does on a mesh (see the module docstring).

    `specs`: the port-layout specs of the whole parameter tree
    (`param_pspecs(params)`, PARAM_RULES; LoRA adapters replicate).
    `strategy`: "full-shard" or "shard-grad-op"."""

    def __init__(self, mesh, specs: Any, strategy: str = "full-shard"):
        if strategy not in STRATEGIES:
            raise ValueError(f"unknown strategy {strategy!r}: use one of {STRATEGIES}")
        sizes = mesh_sizes(mesh)
        if sizes["tensor"] > 1:
            raise NotImplementedError("training with tensor > 1 (tensor-parallel training) is not ported yet: "
                                      "ROADMAP.md Queue 1 item 7b; use replica and fsdp")
        self.mesh, self.specs, self.strategy = mesh, specs, strategy
        self.fsdp, self.replicas = sizes["fsdp"], sizes["replica"]
        self.fsdp_rank = mesh_coordinate(mesh)["fsdp"]
        self.fsdp_group, self.replica_group = mesh.get_group("fsdp"), mesh.get_group("replica")
        self.data_group = dist.group.WORLD  # tensor = 1: every rank is a data rank
        self.data_ranks = self.fsdp * self.replicas

    @classmethod
    def for_params(cls, mesh, params: Any, strategy: str = "full-shard") -> "MeshTraining":
        return cls(mesh, param_pspecs(params), strategy)

    @property
    def shards_params(self) -> bool:
        return self.strategy == "full-shard"

    def shard(self, params: Any) -> Any:
        """Whole parameters (the same on every rank) -> what this rank keeps:
        its blocks (full-shard) or the whole tensors (shard-grad-op)."""
        return shard_params(self.mesh, params, self.specs) if self.shards_params else params

    def leaf_specs(self, marks: Any) -> List[P]:
        """The specs of the leaves `marks` (a mask tree, or one bool per leaf
        in tree order: trainer.trainable_marks) marks, in tree order."""
        return [s for s, m in zip(_leaves(self.specs), _leaves(marks)) if m]

    # --- forward ---------------------------------------------------------------------

    def gather(self, t: torch.Tensor, spec: P, cast: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
        """A leaf for the forward: cast, and gathered over `fsdp` when this
        rank holds a block of it."""
        dim = fsdp_dim(spec) if self.shards_params else None
        if dim is None:
            return cast(t)
        if torch.is_grad_enabled() and t.requires_grad:
            dtype = cast(t[:0]).dtype if t.is_floating_point() else t.dtype
            return _GatherShard.apply(t, dim, self.fsdp_group, self.fsdp, dtype)
        return all_gather_dim(cast(t), dim, self.fsdp_group, self.fsdp)

    def compute_params(self, params: Any, cast: Callable[[torch.Tensor], torch.Tensor]) -> Any:
        """The tree the forward reads: decoder layers as `GatheredLayer`s,
        every other leaf gathered (and cast) now."""
        out = {k: tree_zip(lambda t, s: self.gather(t, s, cast), v, self.specs[k])
               for k, v in params.items() if k != "llm"}
        llm, llm_specs = params["llm"], self.specs["llm"]
        top = {k: self.gather(v, llm_specs[k], cast) for k, v in llm.items() if k != "layers"}
        top["layers"] = [GatheredLayer(lp, ls, self, cast) for lp, ls in zip(llm["layers"], llm_specs["layers"])]
        out["llm"] = top
        return out

    # --- backward --------------------------------------------------------------------

    def optimizer_params(self, trainable: List[torch.Tensor], specs: List[P]) -> List[torch.Tensor]:
        """The tensors AdamW updates: the trainable leaves (full-shard: this
        rank's blocks already), or under shard-grad-op this rank's block of
        each whole leaf (a view)."""
        if self.shards_params:
            return trainable
        out = []
        for t, s in zip(trainable, specs):
            dim = fsdp_dim(s)
            if dim is None:
                out.append(t)
            else:
                start, n = shard_range(s, dim, t.shape[dim], self.mesh)
                out.append(t.detach().narrow(dim, start, n))
        return out

    def sync_grads(self, grads: List[torch.Tensor], specs: List[P]) -> List[torch.Tensor]:
        """Per-rank gradients of the trainable leaves -> the global batch's
        gradients of what AdamW updates (`optimizer_params`)."""
        out = list(grads)
        sharded, replicated = [], []
        for i, (g, s) in enumerate(zip(grads, specs)):
            dim = fsdp_dim(s)
            if dim is None:
                replicated.append(i)
                continue
            if not self.shards_params:  # shard-grad-op: a whole gradient -> this rank's block, summed over fsdp
                out[i] = reduce_scatter_dim(g.float(), dim, self.fsdp_group, self.fsdp).to(g.dtype)
            sharded.append(i)
        if sharded:
            _coalesced_all_reduce([out[i] for i in sharded], self.replica_group)
        if replicated:
            _coalesced_all_reduce([out[i] for i in replicated], self.data_group)
        return out

    def global_norm(self, grads: List[torch.Tensor], specs: List[P]) -> torch.Tensor:
        """sqrt(sum of squares) of the global gradient as an fp32 scalar:
        fp64 squares of each tensor, blocks counted by their rank and whole
        tensors once (fsdp rank 0), one all-reduce over `fsdp`. With fsdp = 1
        every rank holds the whole summed gradients: the one-device
        `global_norm`, bit for bit."""
        if self.fsdp == 1:
            from bridgelang_tpu_torch.training.trainer import global_norm

            return global_norm(grads)
        dev = grads[0].device if grads else torch.device("cpu")
        sq = torch.zeros((), dtype=torch.float64, device=dev)
        for g, s in zip(grads, specs):
            if fsdp_dim(s) is not None or self.fsdp_rank == 0:
                sq = sq + torch.linalg.vector_norm(g, dtype=torch.float64).square()
        all_reduce_(sq, self.fsdp_group)
        return sq.sqrt().float()

    def after_update(self, trainable: List[torch.Tensor], specs: List[P]) -> None:
        """shard-grad-op: gather the updated blocks back into the whole leaves."""
        if self.shards_params:
            return
        with torch.no_grad():
            for t, s in zip(trainable, specs):
                dim = fsdp_dim(s)
                if dim is not None:
                    start, n = shard_range(s, dim, t.shape[dim], self.mesh)
                    t.copy_(all_gather_dim(t.narrow(dim, start, n), dim, self.fsdp_group, self.fsdp))

    # --- loss and metrics ------------------------------------------------------------

    def sum_(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the data ranks (a copy; no gradient)."""
        return all_reduce_(x.detach().clone(), self.data_group)

    def concat_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every data rank's rows, in rank order (no gradient)."""
        return all_gather_dim(x.detach().contiguous(), 0, self.data_group, self.data_ranks)

    # --- checkpoints -----------------------------------------------------------------

    def dtensor(self, t: torch.Tensor, spec: P, whole: bool = False):
        """`t` as a DTensor over the mesh (sharing its storage): this rank's
        block under `spec`, or a replicated whole tensor with `whole`."""
        from torch.distributed.tensor import DTensor

        pl = placements(P(*([None] * t.dim())) if whole else spec, self.mesh.mesh_dim_names)
        return DTensor.from_local(t, self.mesh, pl, run_check=False)

    def full(self, t: torch.Tensor, spec: P) -> torch.Tensor:
        """The whole leaf from this rank's block (every rank gets it)."""
        dim = fsdp_dim(spec) if self.shards_params else None
        return t if dim is None else all_gather_dim(t.detach(), dim, self.fsdp_group, self.fsdp)


def training_mesh(mesh_shape: Optional[str], device: torch.device):
    """(mesh or None, device) for a training entry point: with `mesh_shape`,
    or under torchrun with more than one rank, this process joins the
    process group (NCCL on CUDA, gloo on the CPU) and its device becomes
    cuda:LOCAL_RANK; the mesh defaults to fsdp over every rank."""
    import os

    from bridgelang_tpu_torch.parallel.mesh import make_mesh

    if mesh_shape is None and int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return None, device
    mesh = make_mesh(mesh_shape, device.type)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    return mesh, device


def full_params(mesh_training: Optional[MeshTraining], params: Any) -> Any:
    """The whole parameter tree (gathered leaf by leaf on every rank; the
    tree itself without a mesh)."""
    if mesh_training is None:
        return params
    return tree_zip(mesh_training.full, params, mesh_training.specs)


def mesh_strategy(train_strategy: Optional[str]) -> str:
    """The reference's strategy id -> MeshTraining's (ddp is full-shard over fsdp = 1)."""
    return "shard-grad-op" if train_strategy == "fsdp-shard-grad-op" else "full-shard"


def flat_state(prefix: str, tree: Any) -> List[Tuple[str, Any]]:
    """("a/b/0/c" key, leaf) pairs of a nested dict / list tree."""
    if isinstance(tree, P):
        return [(prefix, tree)]
    if isinstance(tree, dict):
        return [kv for k, v in tree.items() for kv in flat_state(f"{prefix}/{k}" if prefix else str(k), v)]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in flat_state(f"{prefix}/{i}", v)]
    return [(prefix, tree)]
