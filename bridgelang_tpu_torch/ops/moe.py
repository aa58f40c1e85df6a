"""Routed experts: the router, a greedy top-k and the grouped expert products.

Replaces no TPU kernel: the JAX package has no mixture of experts. The
DeepSeek-V2 decoder (models/llm/deepseek_v2.py) calls `moe_experts` once per
MoE layer:

    x [M, D] (the normed activations), router [E, D], we_gate / we_up
    [E, I, D], we_down [E, D, I] (nn.Linear layouts, one slab per expert)
    -> [M, D] in x's dtype

* the router's logits in fp32 from the bf16 operands, their softmax, the
  top `top_k` experts of each token (greedy, in descending order), their
  weights renormalised (`norm_topk`) or scaled by `scaling`;
* each expert's SwiGLU over the tokens routed to it, in x's dtype (gate and
  up rounded, silu(gate) rounded, the product rounded, the down product
  rounded), as the published code runs an expert;
* each token's expert outputs weighted in fp32, summed in pick order and
  cast once.

`load` ([E] int32, or None) receives the picks of each expert.

A CUDA tensor runs csrc/moe_matmul.cu, five launches with no host sync, so a
CUDA graph can hold them (counted `moe:grouped`, `moe_experts.launches`):
`moe_route` (one block per token: logits, softmax, top-k), `moe_sort` (one
block: the picks counted per expert, exclusive offsets, each pick's slot in
the expert-sorted order, and the list of (expert, first row, rows) tiles of
at most BM rows), then `moe_grouped_gemm` twice, gated (gate and up, SiLU,
product) and plain (down), over the tiles, and `moe_combine`. The grouped
product reads the tile list from device memory; its grid is sized on the host
from M, top_k and E alone (the most tiles any routing can give), and blocks
past the tile count exit. A CPU tensor runs `moe_experts_plain`: one host loop
over the experts that have tokens (eager only, `moe:plain`). A CUDA tensor
never falls back to it.

Bound: bytes. At decode (M = 1) a layer reads top_k experts' weights, 6 x
17.3 MB for DeepSeek-V2-Lite, and at the 352-row prefill all 64 experts
(1.1 GB a layer), against ~33 rows an expert: 2 x 33 operations per weight
element, well under the card's ~295 per byte. The grouped product streams
each touched expert's weights once per tile of rows (one tile for up to
BM = 64 rows), through a 4-stage cp.async ring, on the tensor cores.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from bridgelang_tpu_torch.util import profiling

MAX_EXPERTS = 256  # the routing kernels' shared arrays
MAX_TOP_K = 16
BN = 64  # the grouped product's columns per block
BK = 64  # its k per pipeline stage
_C = ctypes.c_void_p


def route_plain(x: torch.Tensor, router: torch.Tensor, top_k: int, norm_topk: bool,
                scaling: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(weights [M, k] fp32, expert ids [M, k] int64): fp32 logits and
    softmax, the top k in descending order, renormalised or scaled."""
    scores = torch.softmax(F.linear(x.float(), router.float()), dim=-1)
    w, ids = torch.topk(scores, top_k, dim=-1)
    w = w / (w.sum(dim=-1, keepdim=True) + 1e-20) if norm_topk else w * scaling
    return w, ids


def expert_swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    """One expert over its rows, in x's dtype."""
    return F.linear(F.silu(F.linear(x, w_gate)) * F.linear(x, w_up), w_down)


def moe_experts_plain(x: torch.Tensor, router: torch.Tensor, we_gate: torch.Tensor, we_up: torch.Tensor,
                      we_down: torch.Tensor, top_k: int, norm_topk: bool, scaling: float,
                      load: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version: a host loop over the experts that have tokens."""
    w, ids = route_plain(x, router, top_k, norm_topk, scaling)
    counts = torch.bincount(ids.flatten(), minlength=router.shape[0])
    if load is not None:
        load.copy_(counts.to(load.dtype))
    ys = torch.zeros((*ids.shape, x.shape[1]), dtype=x.dtype, device=x.device)
    for e in counts.nonzero()[:, 0].tolist():
        tok, slot = (ids == e).nonzero(as_tuple=True)
        ys[tok, slot] = expert_swiglu(x[tok], we_gate[e], we_up[e], we_down[e])
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for k in range(top_k):  # pick order, as the kernel sums
        out += w[:, k:k + 1] * ys[:, k].float()
    return out.to(x.dtype)


# --- the kernels (CUDA tensors only) ----------------------------------------------------


def tile_rows(m: int, top_k: int, n_experts: int) -> int:
    """Rows per tile of the grouped product for M tokens: 16 (one warp row,
    a decode step's few picks) while an expert gets 16 rows on average, else
    64 (the prefill's ~33)."""
    return 16 if m * top_k <= 16 * n_experts else 64


def max_tiles(m: int, top_k: int, n_experts: int, bm: int) -> int:
    """The most (expert, rows) tiles a routing of M tokens can give: no
    more than one per pick, nor than ceil(picks / bm) + the experts."""
    picks = m * top_k
    return min(picks, math.ceil(picks / bm) + min(n_experts, picks))


def _check(name: str, t: torch.Tensor, shape, dtype: torch.dtype, device: torch.device) -> None:
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype or t.device != device or not t.is_contiguous() \
            or t.data_ptr() % 16:
        raise ValueError(f"moe_experts: {name} must be a contiguous, 16-byte aligned {dtype} {tuple(shape)} on "
                         f"{device}; got {t.dtype} {tuple(t.shape)} on {t.device}, strides {t.stride()}")


def _check_shapes(x, router, we_gate, we_up, we_down, top_k, load) -> None:
    m, d = x.shape
    e, i = we_gate.shape[:2]
    if not (1 <= e <= MAX_EXPERTS and 1 <= top_k <= min(MAX_TOP_K, e)) or d % BK or i % BK or d % BN or i % BN:
        raise ValueError(f"moe_experts kernels take at most {MAX_EXPERTS} experts, top_k <= {MAX_TOP_K}, and D and "
                         f"I multiples of {BK}; got E={e}, top_k={top_k}, D={d}, I={i}")
    dev = x.device
    _check("x", x, (m, d), torch.bfloat16, dev)
    _check("router", router, (e, d), torch.bfloat16, dev)
    _check("we_gate", we_gate, (e, i, d), torch.bfloat16, dev)
    _check("we_up", we_up, (e, i, d), torch.bfloat16, dev)
    _check("we_down", we_down, (e, d, i), torch.bfloat16, dev)
    if load is not None:
        _check("load", load, (e,), torch.int32, dev)


def run_kernels(function, stream, x, router, we_gate, we_up, we_down, top_k, norm_topk, scaling, load):
    """The five launches over checked operands on x's device; `function(symbol,
    argtypes)` gives csrc/moe_matmul.cu's C functions (the built library on
    the card; the tests pass an emulated one). Returns (out, the number of
    launches)."""
    m, d = x.shape
    e, i = we_gate.shape[:2]
    dev = x.device
    picks = m * top_k
    bm = tile_rows(m, top_k, e)
    n_tiles = max_tiles(m, top_k, e, bm)
    ints = lambda n: torch.empty(n, dtype=torch.int32, device=dev)  # noqa: E731
    ids, slots, rows, tiles, tile_count = ints(picks), ints(picks), ints(picks), ints(3 * n_tiles), ints(1)
    counts = load if load is not None else ints(e)
    weights = torch.empty(picks, dtype=torch.float32, device=dev)
    h = torch.empty((picks, i), dtype=torch.bfloat16, device=dev)
    y = torch.empty((picks, d), dtype=torch.bfloat16, device=dev)
    out = torch.empty((m, d), dtype=torch.bfloat16, device=dev)

    def call(symbol, n_ptr, n_int, *args, more=()):
        err = function(symbol, [_C] * n_ptr + [ctypes.c_int] * n_int + list(more) + [_C])(*args, stream)
        if err != 0:
            raise RuntimeError(f"{symbol} launch failed with CUDA error {err}")

    call("moe_route", 4, 5, x.data_ptr(), router.data_ptr(), ids.data_ptr(), weights.data_ptr(), m, d, e, top_k,
         int(norm_topk), float(scaling), more=[ctypes.c_float])
    call("moe_sort", 6, 4, ids.data_ptr(), counts.data_ptr(), rows.data_ptr(), slots.data_ptr(), tiles.data_ptr(),
         tile_count.data_ptr(), picks, e, top_k, bm)
    call("moe_grouped_gemm", 7, 5, x.data_ptr(), rows.data_ptr(), we_gate.data_ptr(), we_up.data_ptr(),
         tiles.data_ptr(), tile_count.data_ptr(), h.data_ptr(), i, d, bm, n_tiles, 1)
    call("moe_grouped_gemm", 7, 5, h.data_ptr(), None, we_down.data_ptr(), None, tiles.data_ptr(),
         tile_count.data_ptr(), y.data_ptr(), d, i, bm, n_tiles, 0)
    call("moe_combine", 4, 3, y.data_ptr(), slots.data_ptr(), weights.data_ptr(), out.data_ptr(), m, d, top_k)
    return out, 5


def moe_experts(x: torch.Tensor, router: torch.Tensor, we_gate: torch.Tensor, we_up: torch.Tensor,
                we_down: torch.Tensor, top_k: int, norm_topk: bool = False, scaling: float = 1.0,
                load: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The routed experts' output [M, D] for x [M, D] (module docstring):
    the kernels on a CUDA tensor (bf16), the plain version on a CPU tensor."""
    if x.device.type == "cpu":
        profiling.count("moe:plain")
        return moe_experts_plain(x, router, we_gate, we_up, we_down, top_k, norm_topk, scaling, load)
    if x.device.type != "cuda":
        raise RuntimeError(f"moe_experts runs on cuda or cpu tensors, got {x.device}")
    from bridgelang_tpu_torch.ops import _build

    profiling.count("moe:grouped")
    x = x.contiguous()
    _check_shapes(x, router, we_gate, we_up, we_down, top_k, load)
    if x.shape[0] == 0:
        return torch.empty_like(x)
    out, n = run_kernels(lambda symbol, types: _build.function("moe_matmul", symbol, types),
                         torch.cuda.current_stream(x.device).cuda_stream, x, router, we_gate, we_up, we_down, top_k,
                         norm_topk, scaling, load)
    moe_experts.launches += n
    return out


moe_experts.launches = 0
