"""Parameter / activation sharding rules by parameter path.

Counterpart of bridgelang_tpu/parallel/sharding.py. The rules are the JAX
package's, word for word: each JAX parameter path ("llm/layers/wq",
"vision/featurizer/blocks/qkv/kernel", "projector/fc1/kernel") maps to a
PartitionSpec over the ("replica", "fsdp", "tensor") mesh, in the JAX
layout. A port leaf ("llm/layers/3/wq", "vision/featurizer.blocks.3.qkv.weight",
"projector/fc1.weight") is first named by its JAX path (`jax_path_of`), then
its JAX spec is carried to the port's layout: the stacked layer axis is
dropped (the port keeps one tensor per layer) and the dimensions follow the
port's transposes (an nn.Linear [out, in] against the JAX [in, out] kernel,
OIHW against HWIO). `placements` turns a port spec into the DTensor
placements of each mesh axis (Shard(d) or Replicate()).

Where GSPMD inserts the collectives from these specs, the port runs them by
hand: the train step gathers a sharded leaf at use and reduce-scatters its
gradient (parallel/fsdp.py), and the tensor-parallel decoder all-reduces after
each row-parallel product and gathers the vocab-split logits
(parallel/collectives.py, models/llm/llama.py). `constrain`,
`constrain_batch` and `with_ambient_mesh` only steer GSPMD's propagation;
eager torch has nothing to steer, so they are kept as documented no-ops and
the callers read as in the JAX package.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from bridgelang_tpu_torch.ops.int4_matmul import int4_row_shardable
from bridgelang_tpu_torch.ops.quant import INT4_COLUMN_PARALLEL
from bridgelang_tpu_torch.parallel.mesh import MESH_AXES, mesh_coordinate, mesh_sizes


class PartitionSpec(tuple):
    """One entry per tensor dimension: None (replicated), a mesh axis name,
    or a tuple of axis names (major first). Equal to the JAX PartitionSpec's
    tuple of entries."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


P = PartitionSpec

# (path-regex, PartitionSpec) in the JAX layout; first match wins.
PARAM_RULES: List[Tuple[str, P]] = [
    # --- LLM stacked decoder layers [L, ...] ---
    (r"llm/layers/w[qkv]$", P(None, "fsdp", "tensor")),          # [L, D, H*hd]
    (r"llm/layers/wo$", P(None, "tensor", "fsdp")),              # [L, H*hd, D]
    (r"llm/layers/w_(gate|up)$", P(None, "fsdp", "tensor")),     # [L, D, I]
    (r"llm/layers/w_down$", P(None, "tensor", "fsdp")),          # [L, I, D]
    (r"llm/layers/b[qkv]$", P(None, "tensor")),
    (r"llm/layers/b_up$", P(None, "tensor")),
    (r"llm/layers/(bo|b_down)$", P(None, None)),
    (r"llm/layers/.*norm.*$", P(None, None)),                    # [L, D]
    # --- LLM embeddings / head --- (vocab-parallel embedding: rows over both model axes)
    (r"llm/embed$", P(("fsdp", "tensor"), None)),                # [V, D]
    (r"llm/lm_head$", P("fsdp", "tensor")),                      # [D, V]
    (r"llm/lm_head_bias$", P("tensor")),
    (r"llm/final_norm.*$", P(None)),
    # --- projector (small; shard big dims on fsdp only) ---
    (r"projector/.*/kernel$", P("fsdp", None)),
    (r"projector/.*/bias$", P(None)),
    # --- vision towers (scanned blocks have a leading layer dim) ---
    (r"vision/.*blocks/.*/kernel$", P(None, "fsdp", None)),      # [L, in, out]
    (r"vision/.*patch_embed/kernel$", P(None, None, None, "fsdp")),
    (r"vision/.*(pos_embed|cls_token|reg_tokens)$", P(None, None, None)),
    # fallback: replicate
    (r".*", P()),
]

# LoRA adapters: [.., in, r] / [.., r, out] — replicate (tiny).
LORA_RULE = (r".*lora_(a|b)$", P())

# Serving: Megatron tensor parallelism. Column-parallel wq/wk/wv, w_gate/w_up
# (heads split across devices; attention runs on the local heads);
# row-parallel wo, w_down with one all-reduce after each; the LM head splits
# the vocabulary. Embeddings, norms, the towers and the projector replicate.
# int8 `*_scale` leaves follow their matrix's output dim; row-parallel
# scales apply after the reduction and replicate. `replica` carries batches.
SERVING_RULES: List[Tuple[str, P]] = [
    (r"llm/layers/w[qkv]_scale$", P(None, None, "tensor")),      # [L, 1, out]
    (r"llm/layers/w_(gate|up)_scale$", P(None, None, "tensor")),
    (r"llm/layers/(wo|w_down)_scale$", P(None, None, None)),     # per-out (=D) after the reduction
    (r"llm/layers/w[qkv]$", P(None, None, "tensor")),            # [L, D, H*hd]
    (r"llm/layers/wo$", P(None, "tensor", None)),                # [L, H*hd, D]
    (r"llm/layers/w_(gate|up)$", P(None, None, "tensor")),       # [L, D, I]
    (r"llm/layers/w_down$", P(None, "tensor", None)),            # [L, I, D]
    (r"llm/layers/b[qkv]$", P(None, "tensor")),
    (r"llm/layers/b_up$", P(None, "tensor")),
    (r"llm/lm_head_scale$", P(None, "tensor")),                  # [1, V]
    (r"llm/lm_head$", P(None, "tensor")),                        # [D, V]
    (r"llm/lm_head_bias$", P("tensor")),
    (r".*", P()),  # embed(+scale), norms, biases, vision, projector: replicate
]

ACTIVATION_BATCH_AXES = ("replica", "fsdp")

# The bias that follows each column-parallel matrix (Phi).
_COLUMN_BIAS = {"wq": "bq", "wk": "bk", "wv": "bv", "w_up": "b_up"}
_LLM_LINEAR = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def spec_for_path(path: str, ndim: int, rules: Optional[List[Tuple[str, P]]] = None) -> P:
    """The JAX package's rule lookup: the first matching rule's spec,
    trimmed or padded with None to `ndim` (a JAX path and the JAX rank)."""
    for pattern, spec in (rules or PARAM_RULES):
        if re.search(pattern, path):
            entries = list(spec) + [None] * max(0, ndim - len(spec))
            return P(*entries[:ndim])
    return P()


# --- port leaf -> JAX path and layout ----------------------------------------------


def jax_path_of(path: str, leaf: torch.Tensor, siblings: Optional[Dict[str, Any]] = None
                ) -> Tuple[str, bool, Tuple[int, ...]]:
    """A port leaf's (JAX path, stacked, perm): `stacked` when the JAX leaf
    carries a leading layer axis the port drops; port dim i is JAX
    (unstacked) dim perm[i]. `siblings` is the leaf's own dict (a decoder
    layer), which tells a packed int4 leaf (with `<name>_scale4`) from an
    int8 or float one."""
    parts = path.split("/")
    nd = leaf.dim()
    ident = tuple(range(nd))
    rev = tuple(reversed(ident))
    top = parts[0]
    if top == "llm":
        if len(parts) >= 4 and parts[1] == "layers":
            name = parts[3]
            packed = name.endswith("_scale4") or (siblings is not None and name + "_scale4" in siblings)
            transposed = not packed and (name in _LLM_LINEAR or name.endswith(("_lora_a", "_lora_b", "_scale")))
            return f"llm/layers/{name}", True, rev if transposed else ident
        name = parts[1]
        return f"llm/{name}", False, rev if name in ("lm_head", "lm_head_scale") else ident
    if top == "projector":
        sub, _, kind = parts[1].rpartition(".")
        if kind == "weight":
            return f"projector/{sub}/kernel", False, rev
        return f"projector/{sub}/{kind}", False, ident
    if top == "vision":
        name = parts[1]
        m = re.match(r"^(?:(featurizer|fused_featurizer)\.)?(.*)$", name)
        prefix = f"vision/{m.group(1)}/" if m.group(1) else "vision/"
        rest = m.group(2)
        b = re.match(r"^blocks\.\d+\.(.*)$", rest)
        if b:
            sub = b.group(1)
            mod, _, kind = sub.rpartition(".")
            if not mod:  # ls1 / ls2
                return f"{prefix}blocks/{sub}", True, ident
            if kind == "weight":
                return (f"{prefix}blocks/{mod}/kernel", True, rev) if nd == 2 else (f"{prefix}blocks/{mod}/scale", True,
                                                                                    ident)
            return f"{prefix}blocks/{mod}/{kind}", True, ident
        if rest == "patch_embed.weight":
            return f"{prefix}patch_embed/kernel", False, (3, 2, 0, 1)  # OIHW <- HWIO
        mod, _, kind = rest.rpartition(".")
        if not mod:
            return f"{prefix}{rest}", False, ident
        if kind == "weight":
            return (f"{prefix}{mod}/kernel", False, rev) if nd == 2 else (f"{prefix}{mod}/scale", False, ident)
        return f"{prefix}{mod}/{kind}", False, ident
    return path, False, ident


def port_spec(path: str, leaf: torch.Tensor, rules: Optional[List[Tuple[str, P]]] = None,
              siblings: Optional[Dict[str, Any]] = None) -> P:
    """The spec of a port leaf in the port's layout: the JAX spec of its
    path, the stacked axis dropped, the dims permuted to the port's."""
    jpath, stacked, perm = jax_path_of(path, leaf, siblings)
    jspec = list(spec_for_path(jpath, leaf.dim() + int(stacked), rules))
    if stacked:
        jspec = jspec[1:]
    return P(*(jspec[j] for j in perm))


def _walk(tree, prefix: str = "", parent: Optional[Dict[str, Any]] = None):
    """(path, leaf, parent dict) over nested dicts / lists."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, f"{prefix}/{k}" if prefix else str(k), tree)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, f"{prefix}/{i}", None)
    else:
        yield prefix, tree, parent


def _map_with_path(fn, tree, prefix: str = "", parent=None):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, f"{prefix}/{k}" if prefix else str(k), tree) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_with_path(fn, v, f"{prefix}/{i}", None) for i, v in enumerate(tree)]
    return fn(prefix, tree, parent)


def path_str(path: Sequence[Any]) -> str:
    return "/".join(str(p) for p in path)


def param_pspecs(params: Any, rules: Optional[List[Tuple[str, P]]] = None) -> Any:
    """Tree of port-layout specs matching `params`."""
    return _map_with_path(lambda p, leaf, parent: port_spec(p, leaf, rules, parent), params)


def placements(spec: P, mesh_axes: Sequence[str] = MESH_AXES) -> tuple:
    """DTensor placements of a port spec: per mesh axis, Shard(d) where the
    axis names tensor dim d, else Replicate()."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for axis in mesh_axes:
        dims = [d for d, e in enumerate(spec) if e == axis or (isinstance(e, tuple) and axis in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def param_shardings(mesh, params: Any, rules: Optional[List[Tuple[str, P]]] = None) -> Any:
    """Tree of DTensor placements matching `params` on `mesh`."""
    return tree_map_specs(lambda s: placements(s, mesh.mesh_dim_names), param_pspecs(params, rules))


def tree_map_specs(fn, specs):
    if isinstance(specs, dict):
        return {k: tree_map_specs(fn, v) for k, v in specs.items()}
    if isinstance(specs, list):
        return [tree_map_specs(fn, v) for v in specs]
    return fn(specs)


# --- local shards ----------------------------------------------------------------------


def shard_range(spec: P, dim: int, size: int, mesh) -> Tuple[int, int]:
    """(start, length) of this rank's block of tensor dim `dim` (global
    length `size`) under `spec` on `mesh`. Several axes on one dim nest
    major first, as in the JAX package; the dim must divide evenly."""
    entry = spec[dim] if dim < len(spec) else None
    axes = () if entry is None else (entry if isinstance(entry, tuple) else (entry,))
    sizes, coord = mesh_sizes(mesh), mesh_coordinate(mesh)
    n, idx = 1, 0
    for a in axes:
        n, idx = n * sizes[a], idx * sizes[a] + coord[a]
    if size % n:
        raise ValueError(f"dim {dim} of length {size} does not split over {axes} ({n} ranks)")
    return idx * (size // n), size // n


def local_shard(t: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """This rank's block of the whole tensor `t` under `spec` (a copy when
    any dim is sharded, `t` itself otherwise)."""
    out = t
    for d in range(t.dim()):
        start, n = shard_range(spec, d, t.shape[d], mesh)
        if n != t.shape[d]:
            out = out.narrow(d, start, n)
    return out.contiguous().clone() if out is not t else t


def shard_params(mesh, params: Any, specs: Any) -> Any:
    """`params` (whole tensors on every rank) -> this rank's local blocks."""
    return tree_zip(lambda t, s: local_shard(t, s, mesh), params, specs)


def tree_zip(fn, tree, specs):
    """fn(leaf, spec) over a tree and its spec tree (nested dicts / lists)."""
    if isinstance(tree, dict):
        return {k: tree_zip(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_zip(fn, v, s) for v, s in zip(tree, specs)]
    return fn(tree, specs)


# --- serving -----------------------------------------------------------------------------


def serving_param_pspecs(mesh, params: Any, int4_shards: int = 1) -> Any:
    """Port specs of a (possibly int8/int4-quantized) serving tree, the JAX
    `serving_param_shardings`' choices:

    * SERVING_RULES for float and int8 leaves;
    * packed int4 (`<proj>_scale4` siblings): with `int4_shards` equal to the
      tensor size, column-parallel leaves shard on their packed output dim
      (each block of a shard-blocked pack is a plain v2 matrix over its own
      columns) and row-parallel ones on K when `int4_row_shardable`;
      everything else replicates. The JAX rule asks `int4_shards` > 1 as
      well; here tensor = 1 splits too (each block is the whole leaf), so a
      mesh of one card runs the tensor-parallel int4 route;
    * a column bias follows its matrix (a replicated matrix keeps a whole bias)."""
    specs = param_pspecs(params, SERVING_RULES)
    tensor = mesh_sizes(mesh).get("tensor", 1)
    layers = params.get("llm", {}).get("layers", []) if isinstance(params, dict) else []
    for lp, ls in zip(layers, specs["llm"]["layers"] if layers else []):
        for k in [k for k in lp if k.endswith("_scale4")]:
            base = k[: -len("_scale4")]
            if int4_shards == tensor and base in INT4_COLUMN_PARALLEL:
                ls[base] = ls[k] = P(None, "tensor")
            elif int4_shards == tensor and int4_row_shardable(lp[base].shape[0], lp[k].shape[0], tensor):
                ls[base] = ls[k] = P("tensor", None)
            else:
                ls[base] = ls[k] = P(None, None)
        for mat, bias in _COLUMN_BIAS.items():
            if bias in lp and mat in ls and "tensor" not in tuple(ls[mat]):
                ls[bias] = P(None)
    return specs


def serving_param_shardings(mesh, params: Any, int4_shards: int = 1) -> Any:
    """Tree of DTensor placements for serving (`serving_param_pspecs`)."""
    return tree_map_specs(lambda s: placements(s, mesh.mesh_dim_names), serving_param_pspecs(mesh, params, int4_shards))


def shard_params_for_serving(mesh, params: Any, int4_shards: int = 1) -> Any:
    """This rank's blocks of a serving tree. Pair with
    `OpenVLA.use_mesh`, which calls it. For int4, `int4_shards` must equal
    the pack-time shard count. LoRA adapters must be merged first
    (training/lora.merge_lora): a served adapter is not split."""
    if any(p.endswith(("_lora_a", "_lora_b")) for p, _, _ in _walk(params)):
        raise ValueError("merge the LoRA adapters (training.lora.merge_lora) before tensor-parallel serving")
    return shard_params(mesh, params, serving_param_pspecs(mesh, params, int4_shards))


# --- batches ------------------------------------------------------------------------------


def batch_pspec() -> P:
    return P(ACTIVATION_BATCH_AXES)


def batch_sharding(mesh) -> tuple:
    """DTensor placements of an input batch: its leading dim over both data axes."""
    return placements(batch_pspec(), mesh.mesh_dim_names)


def replicated(mesh) -> tuple:
    return placements(P(), mesh.mesh_dim_names)


def data_rank_and_count(mesh) -> Tuple[int, int]:
    """This rank's index among the data shards (replica major, fsdp minor)
    and their number."""
    sizes, coord = mesh_sizes(mesh), mesh_coordinate(mesh)
    return coord["replica"] * sizes["fsdp"] + coord["fsdp"], sizes["replica"] * sizes["fsdp"]


def shard_batch(mesh, batch: Dict[str, Any]) -> Dict[str, Any]:
    """A whole (global) host batch -> this rank's rows: the leading dim split
    over the data axes (replica x fsdp), as the JAX `batch_sharding`; the
    tensor axis gets the same rows on each of its ranks. Non-array entries
    pass through."""
    idx, n = data_rank_and_count(mesh)

    def rows(x):
        if not hasattr(x, "shape") or len(getattr(x, "shape", ())) == 0:
            return x
        if x.shape[0] % n:
            raise ValueError(f"batch of {x.shape[0]} rows does not split over {n} data shards")
        k = x.shape[0] // n
        return x[idx * k:(idx + 1) * k]

    return {k: rows(v) for k, v in batch.items()}


def make_array_from_process_local(mesh, local_batch: Dict[str, Any]) -> Dict[str, Any]:
    """Multi-process input: each rank already holds its own rows of the
    global batch (its pipeline reads its share by process index), which is
    the layout `shard_batch` gives; the local batch is returned as it is."""
    return dict(local_batch)


# --- activation constraints (GSPMD only) ---------------------------------------------------


def constrain(x, *entries):
    """The JAX `with_sharding_constraint` against the ambient mesh: a hint to
    GSPMD's propagation. Eager torch places every activation where the code
    computes it, so there is nothing to constrain: returns `x`."""
    return x


def constrain_batch(x):
    """Pin an activation's leading (batch) dim to the data axes: a no-op, as `constrain`."""
    return constrain(x, ACTIVATION_BATCH_AXES)


def with_ambient_mesh(mesh, fn):
    """The JAX wrapper sets the ambient mesh for `constrain`; here `fn` is returned as it is."""
    return fn
