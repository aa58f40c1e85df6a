"""The collectives that GSPMD inserts in the JAX package, written out.

* `TensorParallel`: the tensor axis of a serving mesh as the decoder sees it
  (its process group, size and rank, and which leaves are split). The
  decoder (models/llm/llama.py) runs each row-parallel product through
  `row_product` (the maximum of a row's absmax for a w8a8 / w4a8
  quantization, one all-reduce of the partial products before any scale),
  gathers a column-split activation where a replicated row leaf needs it,
  and gathers the vocab-split logits. Each op is
  differentiable in the Megatron way (`reduce`: all-reduce forward, identity
  backward; `copy`: identity forward, all-reduce backward; `gather`:
  all-gather forward, this rank's block backward). Outside autograd they
  run in place on the tensor they are given, so a CUDA graph captures one
  NCCL launch each.
* `all_gather_dim` / `reduce_scatter_dim`: a collective along any tensor
  dim (NCCL and gloo gather and scatter along dim 0).
* `Ring`: one mesh axis as a ring (size, this rank's index) whose `rotate`
  sends tensors to the next rank and receives the previous rank's in one
  `batch_isend_irecv` (ops/ring_attention.py, the JAX `ppermute`).
* `rows_to_time` / `time_to_rows`: the all-to-all over a mesh axis between
  the data layout, this rank's rows of the whole sequence [B, T, ...], and
  the ring's, every axis peer's rows of this rank's block of time
  [n B, T / n, ...]; each is the other's backward (GSPMD's reshard between
  the batch-sharded activations and the ring's `shard_map` spec).

Every op runs its collective even on a group of one rank (a copy there), so
a mesh of one device runs the same launches as a larger one. The eager
collectives of this module count themselves in `collective_launches.launches`
(a CUDA graph's replays are counted by the TensorParallel instead).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist

_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def collective_launches() -> int:
    """The collectives this module launched (`.launches`, as a kernel wrapper's)."""
    return collective_launches.launches


collective_launches.launches = 0


def all_gather_dim(x: torch.Tensor, dim: int, group, size: int) -> torch.Tensor:
    """Concatenate every rank's `x` along `dim` (rank order)."""
    collective_launches.launches += 1
    dim = dim % x.dim()
    src = x.movedim(dim, 0).contiguous()
    out = torch.empty((size * src.shape[0], *src.shape[1:]), dtype=x.dtype, device=x.device)
    _all_gather(out, src, group=group)
    return out.movedim(0, dim)


def reduce_scatter_dim(x: torch.Tensor, dim: int, group, size: int) -> torch.Tensor:
    """Sum `x` over the ranks and keep this rank's block of `dim`."""
    collective_launches.launches += 1
    dim = dim % x.dim()
    src = x.movedim(dim, 0).contiguous()
    out = torch.empty((src.shape[0] // size, *src.shape[1:]), dtype=x.dtype, device=x.device)
    _reduce_scatter(out, src, op=dist.ReduceOp.SUM, group=group)
    return out.movedim(0, dim)


def all_reduce_(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    collective_launches.launches += 1
    dist.all_reduce(x, op=op, group=group)
    return x


def _time_blocks(x: torch.Tensor, n: int) -> torch.Tensor:
    """[B, T, ...] -> [n, B, T / n, ...]: the n blocks of time, each contiguous."""
    b, t = x.shape[:2]
    return x.reshape(b, n, t // n, *x.shape[2:]).transpose(0, 1).contiguous()


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Chunk i of dim 0 to rank i; chunk i of the result from rank i."""
    collective_launches.launches += 1
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def _rows_to_time(x: torch.Tensor, group, n: int) -> torch.Tensor:
    y = _all_to_all(_time_blocks(x, n), group)  # [n (source rank), B, T / n, ...]
    return y.reshape(-1, *y.shape[2:])


def _time_to_rows(x: torch.Tensor, group, n: int) -> torch.Tensor:
    y = _all_to_all(x.reshape(n, x.shape[0] // n, *x.shape[1:]).contiguous(), group)  # [n (time block), B, ...]
    return y.transpose(0, 1).reshape(y.shape[1], -1, *y.shape[3:])


class _RowsToTime(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        return _rows_to_time(x, group, n)

    @staticmethod
    def backward(ctx, g):
        return _time_to_rows(g.contiguous(), ctx.group, ctx.n), None, None


class _TimeToRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        return _time_to_rows(x, group, n)

    @staticmethod
    def backward(ctx, g):
        return _rows_to_time(g.contiguous(), ctx.group, ctx.n), None, None


def rows_to_time(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """This rank's rows [B, T, ...] -> the rows of the n ranks of `group`
    (in rank order) over this rank's block of time [n B, T / n, ...]."""
    return _RowsToTime.apply(x, group, n) if _tracks_grad(x) else _rows_to_time(x, group, n)


def time_to_rows(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """The inverse of `rows_to_time`."""
    return _TimeToRows.apply(x, group, n) if _tracks_grad(x) else _time_to_rows(x, group, n)


class Ring:
    """An axis of ranks as a ring: `size`, this rank's `index`, and
    `start_rotate`, which sends tensors to rank index + 1 and receives rank
    index - 1's (modulo the size). The sends and receives of one rotate go
    out together (`batch_isend_irecv`), so that no rank waits on a send
    before it posts its receive, as a blocking send before a receive would
    on a ring. Each rotate counts once in `collective_launches`."""

    def __init__(self, group, size: int, index: int):
        self.group, self.size, self.index = group, size, index
        self._next = dist.get_global_rank(group, (index + 1) % size)
        self._prev = dist.get_global_rank(group, (index - 1) % size)

    @classmethod
    def of(cls, mesh, axis: str) -> "Ring":
        return cls(mesh.get_group(axis), mesh.size(mesh.mesh_dim_names.index(axis)), mesh.get_local_rank(axis))

    def start_rotate(self, tensors) -> Callable[[], list]:
        """Post the rotate of `tensors`; the returned function waits for it
        and gives the received tensors (the previous rank's, same shapes)."""
        collective_launches.launches += 1
        sends = [t.contiguous() for t in tensors]
        outs = [torch.empty_like(t) for t in sends]
        ops = []
        for t, o in zip(sends, outs):
            ops += [dist.P2POp(dist.isend, t, self._next, self.group),
                    dist.P2POp(dist.irecv, o, self._prev, self.group)]
        requests = dist.batch_isend_irecv(ops)

        def wait() -> list:
            for r in requests:
                r.wait()
            return outs

        return wait

    def rotate(self, tensors) -> list:
        return self.start_rotate(tensors)()


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, size, rank):
        ctx.dim, ctx.rank, ctx.n = dim, rank, x.shape[dim]
        return all_gather_dim(x, dim, group, size)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n).contiguous(), None, None, None, None


def _tracks_grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class TensorParallel:
    """The tensor axis of a mesh for the decoder: `group`, `size`, `rank`,
    and `split`: for each decoder leaf name ("wq", ..., "w_down") and
    "lm_head", whether its rank holds a block (a column block, a row block,
    or a vocab block) or the whole tensor. A model carries it in
    `cfg.llm.tp` (models/llm/llama.TensorParallelLLMConfig, set by
    OpenVLA.use_mesh)."""

    def __init__(self, group, size: int, rank: int, split: Dict[str, bool]):
        self.group, self.size, self.rank = group, size, rank
        self.split = dict(split)
        # Collectives launched, counted like a kernel wrapper's launches
        # (a CUDA graph's replays add the ones its capture recorded).
        self.launches = 0

    def _count(self) -> None:
        self.launches += 1

    def heads_split(self) -> bool:
        return self.split.get("wq", False)

    def local_kv_heads(self, n_kv_heads: int) -> int:
        return n_kv_heads // self.size if self.heads_split() else n_kv_heads

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the group (forward); identity backward."""
        self._count()
        if _tracks_grad(x):
            return _Reduce.apply(x, self.group)
        return all_reduce_(x, self.group)

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        """Identity forward; the gradient sums over the group (the input of
        column-parallel products). Outside autograd nothing runs."""
        return _Copy.apply(x, self.group) if _tracks_grad(x) else x

    def gather(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """Concatenate the group's blocks along `dim`."""
        self._count()
        if _tracks_grad(x):
            return _Gather.apply(x, dim % x.dim(), self.group, self.size, self.rank)
        return all_gather_dim(x, dim, self.group, self.size)

    def max_(self, x: torch.Tensor) -> torch.Tensor:
        """Element-wise maximum over the group, in place (no gradient)."""
        self._count()
        return all_reduce_(x, self.group, dist.ReduceOp.MAX)

    def row_product(self, x: torch.Tensor, product: Callable, quantize: Optional[Callable] = None):
        """A row-parallel product, the one policy for every weight kind: x
        is this rank's block of the contraction dim and `product` multiplies
        such a block by this rank's rows of the weight. The partial products
        are summed over the group before any per-column or per-token scale
        (the JAX psum of the shard-local product). With `quantize` ((x,
        absmax=None) -> (codes, token scale)) x is first quantized with the whole
        row's absmax, the group's maximum, so the codes are the unsharded
        ones and every rank holds the same token scale. Returns (the sum,
        the token scale or None)."""
        if quantize is None:
            return self.reduce(product(x)), None
        q, xs = quantize(x, self.max_(x.float().abs().amax(dim=-1, keepdim=True)))
        return self.reduce(product(q)), xs

    def block(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """This rank's block of a whole tensor along `dim`."""
        n = x.shape[dim] // self.size
        return x.narrow(dim, self.rank * n, n)


def row_product(tp: Optional[TensorParallel], x: torch.Tensor, product: Callable, quantize: Optional[Callable] = None):
    """`tp.row_product`, or on one device (tp None) the product of x (or of
    its codes, quantized with its own absmax). Returns (y, token scale or None)."""
    if tp is not None:
        return tp.row_product(x, product, quantize)
    if quantize is None:
        return product(x), None
    q, xs = quantize(x)
    return product(q), xs


def make_tensor_parallel(mesh, split: Dict[str, bool]) -> Optional[TensorParallel]:
    """The TensorParallel of `mesh`'s tensor axis."""
    return TensorParallel(mesh.get_group("tensor"), mesh.size(mesh.mesh_dim_names.index("tensor")),
                          mesh.get_local_rank("tensor"), split)
