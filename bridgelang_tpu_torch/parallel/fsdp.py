"""Data-parallel, FSDP and tensor-parallel training over the port's
functional parameter trees.

The JAX package trains on a mesh by placing each leaf with its
PartitionSpec (parallel/sharding.PARAM_RULES) and letting GSPMD gather and
reduce-scatter. The port keeps its parameters as dicts of tensors, not
nn.Modules, so `fully_shard` does not fit; `MeshTraining` does the same
work by hand, leaf by leaf, over the ("replica", "fsdp", "tensor") mesh:

* "full-shard" (ZeRO-3, `fsdp-full-shard`): each rank keeps its block of
  every leaf under its spec (a DTensor placement, `placements`: its `fsdp`
  block, and its `tensor` block where the rules split the leaf over
  `tensor`). The train step gathers a leaf over `fsdp` at use: the
  decoder's layers leaf by leaf inside their remat region (a
  `GatheredLayer` gathers a leaf when the decoder reads it), so the
  backward gathers them again, and the towers, the projector, the embedding
  and the head when the step starts. A float leaf is cast to the compute
  dtype before the gather (half the bytes; the same arithmetic as casting
  after it); a frozen int8 leaf is gathered as it is. The gather's backward
  reduce-scatters the gradient over `fsdp` (in fp32).
* "shard-grad-op" (ZeRO-2, `fsdp-shard-grad-op`): parameters stay whole
  over `fsdp` (each rank keeps its `tensor` block); gradients are
  reduce-scattered over `fsdp`, AdamW keeps its moments for and updates only
  this rank's `fsdp` block, and the blocks are gathered back.
* `fsdp` = 1 is data parallelism (`ddp`).
* `tensor` (Megatron-style, the rules' column, row and vocab blocks): the
  rank computes on its `tensor` block of each split leaf, never gathered
  over `tensor`: the decoder runs the collectives of
  parallel/collectives.TensorParallel, which `bind` hands the model
  (`TensorParallelLLMConfig`, with the mesh for ring attention). The
  embedding's rows split over ("fsdp", "tensor") are gathered whole; its
  gradient is reduce-scattered over `fsdp` and this rank's `tensor` block
  taken (tensor peers hold the same gradient). Leaves the rules replicate
  over `tensor` are used whole on every tensor rank and get the same
  gradient there (the towers, the projector, the norms), except the LoRA
  adapters, which each rank uses by block (models/llm/llama._lora_update):
  their gradients are summed over `tensor`. A packed int4 base has no
  contiguous `tensor` block (its pairs cross the block bounds) and is
  refused at tensor > 1; at tensor = 1 it is not split.

Then the gradients are summed over `replica` (one all-reduce of all
fsdp-sharded leaves' gradients) and every other leaf's over the data ranks
(replica x fsdp of one tensor coordinate; one all-reduce). The loss is each
rank's summed token NLL over the global token count (one all-reduce of the
count over the data ranks), so the summed gradients are the global batch's.
The global norm sums fp64 squares of each rank's blocks, each leaf's blocks
counted once, and all-reduces over `fsdp` and `tensor`. AdamW runs on the
local tensors (no DTensor dispatch per op).
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from bridgelang_tpu_torch.parallel.collectives import (
    all_gather_dim,
    all_reduce_,
    make_tensor_parallel,
    reduce_scatter_dim,
)
from bridgelang_tpu_torch.parallel.mesh import mesh_coordinate, mesh_sizes
from bridgelang_tpu_torch.parallel.sharding import (
    P,
    param_pspecs,
    placements,
    shard_params,
    shard_range,
    tree_map_specs,
    tree_zip,
)

STRATEGIES = ("full-shard", "shard-grad-op")
_DECODER_SPLITS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def _axes(entry) -> Tuple[str, ...]:
    return () if entry is None else (entry if isinstance(entry, tuple) else (entry,))


def fsdp_dim(spec: P) -> Optional[int]:
    """The tensor dim `spec` splits over `fsdp`, or None."""
    for d, e in enumerate(spec):
        if "fsdp" in _axes(e):
            return d
    return None


@dataclasses.dataclass(frozen=True)
class LeafSpec:
    """How the mesh holds one leaf: `spec` its PARAM_RULES spec, `keep` the
    block this rank keeps of the parameter, `opt` the block AdamW updates,
    `tensor_sum` whether its gradient sums over `tensor` (an adapter used by
    block)."""

    spec: P
    keep: P
    opt: P
    tensor_sum: bool = False


class _GatherShard(torch.autograd.Function):
    """A float leaf's block -> the leaf gathered over `fsdp` (and over
    `tensor` first, for rows split over both) in the compute dtype; the
    gradient comes back reduce-scattered over `fsdp` (in fp32), then this
    rank's `tensor` block."""

    @staticmethod
    def forward(ctx, local, dim, mt, over_tensor, dtype):
        ctx.dim, ctx.mt, ctx.over_tensor, ctx.local_dtype = dim, mt, over_tensor, local.dtype
        return mt._gather_blocks(local.to(dtype), dim, over_tensor)

    @staticmethod
    def backward(ctx, g):
        mt = ctx.mt
        g = reduce_scatter_dim(g.float(), ctx.dim, mt.fsdp_group, mt.fsdp)
        if ctx.over_tensor:
            n = g.shape[ctx.dim] // mt.tensor
            g = g.narrow(ctx.dim, mt.tensor_rank * n, n).contiguous()
        return g.to(ctx.local_dtype), None, None, None, None


class GatheredLayer(Mapping):
    """A decoder layer of local blocks that reads as the layer the rank
    computes on: each leaf is gathered (and cast) when it is read. The
    decoder reads each leaf once per layer run, inside the layer's remat
    region, so the backward's recomputation gathers again and no gathered
    leaf outlives its layer."""

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
    if isinstance(tree, (P, LeafSpec)):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


# The gradient sync's staging buffer per dtype: the tensors' elements pass
# through it in order, one all-reduce each time it fills, so the sync holds
# 64 MiB more than the gradients, not a second copy of all of them (one
# all-reduce per 16 M fp32 elements).
ALL_REDUCE_BUCKET_BYTES = 64 << 20


def _coalesced_all_reduce(tensors: List[torch.Tensor], group) -> None:
    """Sum each tensor over `group` in place. Per dtype, the tensors'
    elements, in order, are copied into one buffer of at most
    ALL_REDUCE_BUCKET_BYTES, all-reduced each time it fills, and
    copied back; a bucket may end inside a tensor, which then spans two. A
    tensor that is not contiguous goes through a contiguous copy of itself,
    and its bucket is reduced early so that the copy can be written back.
    Each element's sum over the ranks is the one a single flat all-reduce
    gives."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        total = sum(t.numel() for t in ts)
        if total == 0:
            continue
        cap = max(1, min(total, ALL_REDUCE_BUCKET_BYTES // ts[0].element_size()))
        buf = torch.empty(cap, dtype=ts[0].dtype, device=ts[0].device)
        parts: List[Tuple[torch.Tensor, int]] = []  # (a slice of a tensor's elements, its offset in buf)
        fill = 0

        def flush() -> None:
            nonlocal fill
            all_reduce_(buf[:fill], group)
            for dst, at in parts:
                dst.copy_(buf[at:at + dst.numel()])
            parts.clear()
            fill = 0

        for t in ts:
            flat = t.view(-1) if t.is_contiguous() else t.contiguous().view(-1)
            start = 0
            while start < flat.numel():
                n = min(flat.numel() - start, cap - fill)
                buf[fill:fill + n].copy_(flat[start:start + n])
                parts.append((flat[start:start + n], fill))
                fill, start = fill + n, start + n
                if fill == cap:
                    flush()
            if not t.is_contiguous():
                if fill:
                    flush()
                t.copy_(flat.view_as(t))
        if fill:
            flush()


def _data_group(mesh):
    """The group of this rank's data peers: replica x fsdp at its tensor
    coordinate (every rank joins every such group's creation, in order)."""
    ranks, mine, out = mesh.mesh, mesh_coordinate(mesh)["tensor"], None
    for t in range(ranks.shape[2]):
        group = dist.new_group(ranks[:, :, t].flatten().tolist())
        if t == mine:
            out = group
    return out


class MeshTraining:
    """What a train step does on a mesh (see the module docstring).

    `specs`: the port-layout specs of the whole parameter tree
    (`param_pspecs(params)`, PARAM_RULES; LoRA adapters replicate).
    `strategy`: "full-shard" or "shard-grad-op". `split`: which decoder
    leaves (and "lm_head") are `tensor` blocks, the TensorParallel's split
    (`for_params` reads it off the tree: every leaf the rules split over
    `tensor`, packed int4 leaves excepted)."""

    def __init__(self, mesh, specs: Any, strategy: str, split: Dict[str, bool]):
        if strategy not in STRATEGIES:
            raise ValueError(f"unknown strategy {strategy!r}: use one of {STRATEGIES}")
        sizes, coord = mesh_sizes(mesh), mesh_coordinate(mesh)
        self.mesh, self.specs, self.strategy = mesh, specs, strategy
        self.fsdp, self.replicas, self.tensor = sizes["fsdp"], sizes["replica"], sizes["tensor"]
        self.fsdp_rank, self.tensor_rank = coord["fsdp"], coord["tensor"]
        self.fsdp_group, self.replica_group = mesh.get_group("fsdp"), mesh.get_group("replica")
        self.tensor_group = mesh.get_group("tensor")
        # tensor = 1: every rank is a data rank
        self.data_group = dist.group.WORLD if self.tensor == 1 else _data_group(mesh)
        self.data_ranks = self.fsdp * self.replicas
        self.tp = make_tensor_parallel(mesh, split)
        self.leaf_info = _map_paths(self._leaf_spec, specs)

    @classmethod
    def for_params(cls, mesh, params: Any, strategy: str = "full-shard") -> "MeshTraining":
        specs = param_pspecs(params)
        layers = params["llm"]["layers"]
        packed = {n for lp in layers for n in _DECODER_SPLITS if n + "_scale4" in lp}
        if packed and mesh_sizes(mesh)["tensor"] > 1:
            raise ValueError(f"tensor > 1 over a packed int4 base ({sorted(packed)}): a v2 pack pairs columns "
                             "across the tensor blocks; train with tensor = 1, or pack shard-blocked for serving")
        split = {n: "tensor" in _flat_axes(specs["llm"]["layers"][0][n]) and n not in packed
                 for n in _DECODER_SPLITS if layers and n in layers[0]}
        split["lm_head"] = "tensor" in _flat_axes(specs["llm"]["lm_head"])
        return cls(mesh, specs, strategy, split)

    def _leaf_spec(self, path: str, spec: P) -> LeafSpec:
        if self.shards_params:
            keep = opt = spec
        else:  # whole over fsdp; the tensor blocks stay (a leaf split over both is kept whole)
            keep = P(*(e if e == "tensor" else None for e in spec))
            d = fsdp_dim(spec)
            opt = keep if d is None else P(*("fsdp" if i == d else e for i, e in enumerate(keep)))
        return LeafSpec(spec, keep, opt, tensor_sum=self.tensor > 1 and "_lora_" in path)

    @property
    def shards_params(self) -> bool:
        return self.strategy == "full-shard"

    def bind(self, model):
        """A shallow copy of `model` whose decoder runs on this mesh: the
        TensorParallel and the mesh in a TensorParallelLLMConfig (the
        trainer's model; `model` itself is left as it is)."""
        import copy

        from bridgelang_tpu_torch.models.llm.llama import TensorParallelLLMConfig

        llm = model.cfg.llm
        if self.tp.heads_split() and (llm.n_heads % self.tensor or llm.n_kv_heads % self.tensor):
            raise ValueError(f"tensor={self.tensor} does not divide the head counts ({llm.n_heads}/{llm.n_kv_heads}):"
                             " a rank would hold part of a head or of a GQA group")
        bound = copy.copy(model)
        bound.cfg = dataclasses.replace(model.cfg, llm=TensorParallelLLMConfig.of(llm, self.tp, mesh=self.mesh))
        return bound

    def shard(self, params: Any) -> Any:
        """Whole parameters (the same on every rank) -> what this rank keeps
        (`LeafSpec.keep`)."""
        return shard_params(self.mesh, params, tree_map_specs(lambda leaf: leaf.keep, self.leaf_info))

    def leaf_specs(self, marks: Any) -> List[LeafSpec]:
        """The LeafSpecs of the leaves `marks` (a mask tree, or one bool per
        leaf in tree order: trainer.trainable_marks) marks, in tree order."""
        return [s for s, m in zip(_leaves(self.leaf_info), _leaves(marks)) if m]

    # --- forward ---------------------------------------------------------------------

    def _gather_blocks(self, t: torch.Tensor, dim: int, over_tensor: bool) -> torch.Tensor:
        if over_tensor:
            t = all_gather_dim(t, dim, self.tensor_group, self.tensor)
        return all_gather_dim(t, dim, self.fsdp_group, self.fsdp)

    def gather(self, t: torch.Tensor, spec: P, cast: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
        """A leaf for the forward: cast, and gathered over `fsdp` when this
        rank holds an fsdp block of it (over `tensor` too where both split
        one dim)."""
        dim = fsdp_dim(spec) if self.shards_params else None
        if dim is None:
            return cast(t)
        over_tensor = self.tensor > 1 and "tensor" in _axes(spec[dim])
        if torch.is_grad_enabled() and t.requires_grad:
            dtype = cast(t[:0]).dtype if t.is_floating_point() else t.dtype
            return _GatherShard.apply(t, dim, self, over_tensor, dtype)
        return self._gather_blocks(cast(t), dim, over_tensor)

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

    def optimizer_params(self, trainable: List[torch.Tensor], specs: List[LeafSpec]) -> List[torch.Tensor]:
        """The tensors AdamW updates: the trainable leaves (full-shard: this
        rank's blocks already), or under shard-grad-op this rank's fsdp
        block of each kept leaf (a view)."""
        if self.shards_params:
            return trainable
        out = []
        for t, leaf in zip(trainable, specs):
            dim = fsdp_dim(leaf.opt)
            if dim is None:
                out.append(t)
            else:
                start, n = shard_range(leaf.opt, dim, t.shape[dim], self.mesh)
                out.append(t.detach().narrow(dim, start, n))
        return out

    def sync_grads(self, grads: List[torch.Tensor], specs: List[LeafSpec]) -> List[torch.Tensor]:
        """Per-rank gradients of the trainable leaves -> the global batch's
        gradients of what AdamW updates (`optimizer_params`)."""
        out = list(grads)
        summed = [i for i, leaf in enumerate(specs) if leaf.tensor_sum]
        if summed:  # adapters used by block: each tensor rank holds its share
            _coalesced_all_reduce([out[i] for i in summed], self.tensor_group)
        sharded, replicated = [], []
        for i, (g, leaf) in enumerate(zip(grads, specs)):
            dim = fsdp_dim(leaf.opt)
            if dim is None:
                replicated.append(i)
                continue
            if not self.shards_params:  # shard-grad-op: a whole gradient -> this rank's block, summed over fsdp
                out[i] = reduce_scatter_dim(out[i].float(), dim, self.fsdp_group, self.fsdp).to(g.dtype)
            sharded.append(i)
        if sharded:
            _coalesced_all_reduce([out[i] for i in sharded], self.replica_group)
        if replicated:
            _coalesced_all_reduce([out[i] for i in replicated], self.data_group)
        return out

    def global_norm(self, grads: List[torch.Tensor], specs: List[LeafSpec]) -> torch.Tensor:
        """sqrt(sum of squares) of the global gradient as an fp32 scalar:
        fp64 squares of each tensor, each leaf's blocks counted once (a
        block on the ranks whose coordinate is 0 on each of fsdp and tensor
        that does not split it), all-reduced over `fsdp` and `tensor`. With
        fsdp = tensor = 1 every rank holds the whole summed gradients: the
        one-device `global_norm`, bit for bit."""
        if self.fsdp == 1 and self.tensor == 1:
            from bridgelang_tpu_torch.training.trainer import global_norm

            return global_norm(grads)
        dev = grads[0].device if grads else torch.device("cpu")
        sq = torch.zeros((), dtype=torch.float64, device=dev)
        for g, leaf in zip(grads, specs):
            axes = _flat_axes(leaf.opt)
            if ("fsdp" in axes or self.fsdp_rank == 0) and ("tensor" in axes or self.tensor_rank == 0):
                sq = sq + torch.linalg.vector_norm(g, dtype=torch.float64).square()
        if self.fsdp > 1:
            all_reduce_(sq, self.fsdp_group)
        if self.tensor > 1:
            all_reduce_(sq, self.tensor_group)
        return sq.sqrt().float()

    def after_update(self, trainable: List[torch.Tensor], specs: List[LeafSpec]) -> None:
        """shard-grad-op: gather the updated blocks back into the kept leaves."""
        if self.shards_params:
            return
        with torch.no_grad():
            for t, leaf in zip(trainable, specs):
                dim = fsdp_dim(leaf.opt)
                if dim is not None:
                    start, n = shard_range(leaf.opt, dim, t.shape[dim], self.mesh)
                    t.copy_(all_gather_dim(t.narrow(dim, start, n), dim, self.fsdp_group, self.fsdp))

    # --- loss and metrics ------------------------------------------------------------

    def sum_(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the data ranks (a copy; no gradient)."""
        return all_reduce_(x.detach().clone(), self.data_group)

    def concat_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every data rank's rows, in data-rank order (no gradient)."""
        return all_gather_dim(x.detach().contiguous(), 0, self.data_group, self.data_ranks)

    # --- checkpoints -----------------------------------------------------------------

    def dtensor(self, t: torch.Tensor, spec: P):
        """`t`, this rank's block under `spec`, as a DTensor over the mesh
        (sharing its storage)."""
        from torch.distributed.tensor import DTensor

        return DTensor.from_local(t, self.mesh, placements(spec, self.mesh.mesh_dim_names), run_check=False)

    def full(self, t: torch.Tensor, leaf: LeafSpec) -> torch.Tensor:
        """The whole leaf from this rank's kept block (every rank gets it):
        gathered over each axis that splits a dim, the innermost first."""
        t = t.detach()
        for d, e in enumerate(leaf.keep):
            for axis in reversed(_axes(e)):
                group = {"fsdp": self.fsdp_group, "tensor": self.tensor_group, "replica": self.replica_group}[axis]
                size = {"fsdp": self.fsdp, "tensor": self.tensor, "replica": self.replicas}[axis]
                if size > 1:
                    t = all_gather_dim(t, d, group, size)
        return t


def _flat_axes(spec: P) -> Tuple[str, ...]:
    return tuple(a for e in spec for a in _axes(e))


def _map_paths(fn, specs, prefix: str = ""):
    """fn(path, spec) over a spec tree (nested dicts / lists)."""
    if isinstance(specs, dict):
        return {k: _map_paths(fn, v, f"{prefix}/{k}" if prefix else str(k)) for k, v in specs.items()}
    if isinstance(specs, list):
        return [_map_paths(fn, v, f"{prefix}/{i}") for i, v in enumerate(specs)]
    return fn(prefix, specs)


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
    return tree_zip(mesh_training.full, params, mesh_training.leaf_info)


def mesh_strategy(train_strategy: Optional[str]) -> str:
    """The reference's strategy id -> MeshTraining's (ddp is full-shard over fsdp = 1)."""
    return "shard-grad-op" if train_strategy == "fsdp-shard-grad-op" else "full-shard"


def flat_state(prefix: str, tree: Any) -> List[Tuple[str, Any]]:
    """("a/b/0/c" key, leaf) pairs of a nested dict / list tree."""
    if isinstance(tree, (P, LeafSpec)):
        return [(prefix, tree)]
    if isinstance(tree, dict):
        return [kv for k, v in tree.items() for kv in flat_state(f"{prefix}/{k}" if prefix else str(k), v)]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in flat_state(f"{prefix}/{i}", v)]
    return [(prefix, tree)]
