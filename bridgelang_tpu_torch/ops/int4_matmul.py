"""Packed-int4 weight matmuls: the hand-written Hopper kernels and their plain versions.

Counterpart of bridgelang_tpu/ops/int4_matmul.py. Weights are the JAX
package's bytes (ops/quant.py): packed [K, N/2] int8 in the
`out-paired-lobias/v2` layout, scales [K/group, N] bf16.

* `int4_mm_a8(q, packed, scales)`: int8 activations [M, K] -> f32 [M, N]
  without the per-token scale. A CUDA tensor launches `int4_mm_a8` of
  csrc/int4_matmul.cu (the TPU `_kernel_a8`: a split-K streaming kernel at
  M <= 16, `wgmma` above), a CPU tensor runs `int4_matmul_a8_plain`.
* `quantize_a8(x)`: the w4a8 route's per-row int8 quantization. A CUDA
  tensor launches `quantize_a8` of the same library, a CPU tensor runs
  `quantize_activations_per_token`; the bits are the same.
* `int4_mm(x, packed, scales)`: bf16 or fp32 activations -> x's dtype. A
  CUDA tensor launches `int4_mm` (the TPU `_kernel`), a CPU tensor runs
  `int4_matmul_plain`.

Each counts its kernel launches in `.launches`. On a CUDA tensor every
product launches the kernel or raises: a shape the kernel cannot take
(`cuda_kernel_shape_ok` false: N/2 not a multiple of 64, or a group that is
not a multiple of 128) is refused, never routed to a library matmul. The
packed weights and scales may be column slices of a wider pack (row stride
of the whole pack, unit column stride): the kernels read them in place.

`matmul_int4` / `matmul_int4_a8` are the model-facing functions, each a
`torch.autograd.Function` with the JAX custom VJP (int4_matmul.py:703-816):
dx = g @ dequant(W)^T through a transient dequant in g's dtype, straight
through the activation quantization for the a8 one, and no gradient for the
packed bytes (zeros for the scales, which are frozen everywhere). On a CUDA
tensor the a8 forward is two launches: `quantize_a8`, then `int4_mm_a8` with
the token scale and the cast to x's dtype in its epilogue (one launch per
block of a shard-blocked pack). On a CPU
tensor they take the JAX package's route at each shape: the plain version
where its kernel is eligible (`int4_kernel_eligible`), dequantize-then-matmul
where it is not. `n_shards` > 1 declares a shard-blocked pack: each column
block is a plain v2 matrix over its own output columns (`_int4_route_blocked`;
on the card one launch per block, writing its columns of one output). Under
tensor parallelism a rank holds one column block (a plain pack, `n_shards` =
1 there) or K rows of a row-parallel leaf (`row_tp`: the partial products
meet in one all-reduce, `TensorParallel.row_product`); `int4_row_shardable` and
`int4_tp_fallback_matmuls` (the card's rule, not the TPU's) decide which.

Not ported, as TPU heuristics: the v5e tile chooser (`_choose_tiles`,
`_TUNED_DECODE_TILES`, `_tile_vmem_bytes`, the `_HBM_BPS`... cost
constants), the 8-row padding of short M, and the two TPU-memory escapes to
the fallback (outputs over 64 MB, and no tiling that fits VMEM). On the card
every shape the kernel takes launches it, the QLoRA `w_gate`/`w_up` products
(a 5632 x 11008 bf16 output) included. The SPMD wrappers (custom
partitioning) are GSPMD's: here the decoder holds local blocks and calls the
collectives itself (parallel/collectives.py).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from bridgelang_tpu_torch.ops.quant import dequant_int4, quantize_activations_per_token, unpack_int4

GROUP = 128  # the kernels' group granularity: a scale group spans a multiple of 128 input rows
BLOCK_N2 = 64  # packed columns per CUDA block: N/2 must be a multiple
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def int4_kernel_eligible(k: int, n: int, n_groups: int) -> bool:
    """The JAX package's rule (its TPU tiling): column halves tile by 128
    (N % 256 == 0) and the group, K / n_groups, is a multiple of 128. The CPU
    path follows it, so both packages take the same route at a shape."""
    if n % 256 != 0 or n_groups <= 0 or k % n_groups != 0:
        return False
    return (k // n_groups) % GROUP == 0


def cuda_kernel_shape_ok(k: int, n: int, n_groups: int) -> bool:
    """The CUDA kernels' own rule: N/2 a multiple of 64 and a group that is
    a multiple of 128 dividing K. Every JAX-eligible shape passes, and so do
    the 5504-wide column blocks of a 2-shard 7B `w_gate`/`w_up` pack."""
    if n % (2 * BLOCK_N2) != 0 or n_groups <= 0 or k % n_groups != 0:
        return False
    return (k // n_groups) % GROUP == 0


def int4_row_shardable(k: int, n_groups: int, n_devices: int) -> bool:
    """True when a [K, N//2] packed weight's rows AND its K//group scale
    groups split evenly over n_devices with group boundaries intact (the
    JAX package's rule)."""
    if k % n_devices or n_groups % n_devices:
        return False
    group = k // n_groups
    return (k // n_devices) % group == 0


def int4_tp_fallback_matmuls(cfg, group: int, tensor: int) -> list:
    """Projections whose shard-local geometry the card's kernels cannot take
    under a tensor=`tensor` mesh with a shard-blocked pack: the JAX audit
    with the CUDA rule (`cuda_kernel_shape_ok`: N/2 % 64, group % 128) in
    place of the TPU's (N % 256). Column-parallel leaves are checked on their
    N/`tensor` block; a row-parallel leaf on its K/`tensor` rows when
    `int4_row_shardable`, else whole (it is then replicated and its input
    gathered). The 7B passes at tensor=2 (w_gate N/2 = 2752 = 43 x 64) and
    fails w_gate/w_up at 4 (N/2 = 1376); the 13B passes at 4 (1728 = 27 x
    64), where the JAX audit passes it at 2 only. On a CUDA tensor a flagged
    product raises (no dequantizing fallback); deploy refuses the mesh."""
    head_dim = cfg.dim // cfg.n_heads
    col = {"wq": (cfg.dim, cfg.n_heads * head_dim), "wk": (cfg.dim, cfg.n_kv_heads * head_dim),
           "wv": (cfg.dim, cfg.n_kv_heads * head_dim), "w_gate": (cfg.dim, cfg.intermediate_size),
           "w_up": (cfg.dim, cfg.intermediate_size)}
    row = {"wo": (cfg.n_heads * head_dim, cfg.dim), "w_down": (cfg.intermediate_size, cfg.dim)}
    if cfg.arch == "phi":
        col.pop("w_gate")
    bad = []
    for name, (k, n) in col.items():
        if n % tensor or k % group or not cuda_kernel_shape_ok(k, n // tensor, k // group):
            bad.append(name)
    for name, (k, n) in row.items():
        groups = k // group if k % group == 0 else 0
        local_k = k // tensor if groups and int4_row_shardable(k, groups, tensor) else k
        if not groups or not cuda_kernel_shape_ok(local_k, n, local_k // group):
            bad.append(name)
    return bad


# --- plain versions (the CPU path, and what the kernels are held against) ---------


def _grouped_plain(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """The kernels' arithmetic group by group, in their order: unpack, the
    group's fp32 dot, then acc = acc + y * scale (product and sum rounded
    separately). TF32 must be off for the dot to be fp32."""
    k = x.shape[-1]
    n_groups = scales.shape[0]
    g = k // n_groups
    codes = unpack_int4(packed).float()
    xf = x.float()
    acc = torch.zeros((x.shape[0], codes.shape[1]), dtype=torch.float32, device=x.device)
    for gi in range(n_groups):
        rows = slice(gi * g, (gi + 1) * g)
        acc = acc + (xf[:, rows] @ codes[rows]) * scales[gi].float()
    return acc


def int4_matmul_a8_plain(q: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """int8 q [M, K] x packed -> f32 [M, N], token scale not applied. Each
    group's dot runs in fp32, which is exact: |sum| <= 127 * 8 * group < 2^24
    for groups up to 512, so it equals the kernel's int32 sums."""
    return _grouped_plain(q, packed, scales)


def int4_matmul_plain(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """bf16 or fp32 x [M, K] x packed -> x's dtype [M, N], fp32 sums."""
    return _grouped_plain(x, packed, scales).to(x.dtype)


# --- the kernels (CUDA tensors only) ---------------------------------------------


def _check_rows(name: str, t: torch.Tensor, device: torch.device, align: int) -> None:
    """A 2-D operand the kernels read or write row by row: unit column
    stride, and its start and row stride aligned to `align` bytes."""
    if t.device != device or t.device.type != "cuda":
        raise ValueError(f"{name} is on {t.device}; the kernels take tensors on one CUDA device")
    row_bytes = t.stride(0) * t.element_size()
    if t.stride(1) != 1 or t.data_ptr() % align or row_bytes % align:
        raise ValueError(f"{name} needs unit column stride and {align}-byte aligned rows, "
                         f"got strides {t.stride()} at offset {t.data_ptr() % align}")


_P, _I = ctypes.c_void_p, ctypes.c_int
# The C signatures of csrc/int4_matmul.cu.
_SIGNATURES = {
    "int4_mm_a8": [_P] * 7 + [_I] * 9 + [_P],
    "int4_mm": [_P] * 4 + [_I] * 8 + [_P],
    "quantize_a8": [_P, _I, _P, _P, _P, _I, _I, _P],
    "stream_capture_id": [_P],
}
_RESTYPES = {"stream_capture_id": ctypes.c_ulonglong}
A8_DECODE_M = 16  # int4_mm_a8's split-K kernel takes M <= 16; the wgmma kernel the rest
_tile_counters: Dict[Tuple[torch.device, int, bool], Tuple[int, torch.Tensor]] = {}


def _fn(symbol: str):
    from bridgelang_tpu_torch.ops import _build

    return _build.function("int4_matmul", symbol, _SIGNATURES[symbol], _RESTYPES.get(symbol, ctypes.c_int))


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """int32 zeros in which the split-K kernel counts each column tile's
    finished blocks. Two launches that may run at once must not share them.
    Every launch leaves them zero, so one buffer serves the launches of one
    stream outside a CUDA graph (they run in order), and one buffer, zeroed
    inside the graph, the launches that one capture records on that stream.
    A graph's replays then share counters with no eager launch and no other
    graph, whatever streams they run on. The buffer of the last capture on
    a stream stays referenced until the next capture there replaces it."""
    capture = _fn("stream_capture_id")(stream)  # 0 outside a capture
    key = (device, stream, capture != 0)
    made = _tile_counters.get(key)
    if made is None or made[0] != capture or made[1].numel() < n:
        made = _tile_counters[key] = (capture, torch.zeros(max(n, 256), dtype=torch.int32, device=device))
    return made[1]


def _operands(name: str, x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
              out: Optional[torch.Tensor], out_dtype: torch.dtype) -> torch.Tensor:
    """Check x [M, K] @ packed [K, N/2] with scales [K/group, N] against the
    kernels' rules; returns `out`, a fresh [M, N] of `out_dtype` when None."""
    if packed.dtype != torch.int8 or scales.dtype != torch.bfloat16:
        raise TypeError(f"{name} takes int8 packed weights and bf16 scales, got {packed.dtype}, {scales.dtype}")
    m, k = x.shape
    if packed.dim() != 2 or packed.shape[0] != k or scales.dim() != 2 or scales.shape[1] != 2 * packed.shape[1]:
        raise ValueError(f"shapes x {tuple(x.shape)}, packed {tuple(packed.shape)}, scales {tuple(scales.shape)} "
                         "do not form x [M, K] @ packed [K, N/2] with scales [K/group, N]")
    n2 = packed.shape[1]
    if not cuda_kernel_shape_ok(k, 2 * n2, scales.shape[0]):
        raise ValueError(f"{name}: K={k}, N={2 * n2}, {scales.shape[0]} groups is no kernel shape "
                         "(N/2 % 64 == 0 and a group that is a multiple of 128)")
    if out is None:
        out = torch.empty((m, 2 * n2), dtype=out_dtype, device=x.device)
    elif out.shape != (m, 2 * n2) or out.dtype != out_dtype:
        raise ValueError(f"{name}: out is {tuple(out.shape)} {out.dtype}, needs {(m, 2 * n2)} {out_dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous")
    _check_rows("x", x, x.device, 16)
    _check_rows("packed", packed, x.device, 16)
    _check_rows("scales", scales, x.device, 4)
    _check_rows("out", out, x.device, 2 * out.element_size())
    return out


def _launch_a8(q: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor, out: Optional[torch.Tensor] = None,
               xs: Optional[torch.Tensor] = None, out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """One launch of `int4_mm_a8` on q [M, K]: f32 without the token scale,
    or with `xs` (f32, one per row) acc * xs in `out_dtype` (f32 or bf16).
    Writes `out` (a fresh [M, N] when None, else a column slice of a wider
    one). At M <= 16 the wrapper hands the kernel its fp32 workspace."""
    if q.dtype != torch.int8:
        raise TypeError(f"int4_mm_a8 takes int8 activations, got {q.dtype}")
    if out_dtype not in _DTYPE_CODES or (xs is None and out_dtype != torch.float32):
        raise TypeError(f"int4_mm_a8 writes f32, or bf16 with the token scale; got {out_dtype}")
    out = _operands("int4_mm_a8", q, packed, scales, out, out_dtype)
    m, k = q.shape
    if xs is not None and (xs.dtype != torch.float32 or xs.numel() != m or not xs.is_contiguous()
                           or xs.device != q.device):
        raise ValueError(f"int4_mm_a8: xs must be {m} contiguous float32 row scales on {q.device}")
    if m == 0:
        return out
    n2, n_groups = packed.shape[1], scales.shape[0]
    stream = _stream(q)
    ws = counters = None
    if m <= A8_DECODE_M:
        ws = torch.empty((n_groups, m, 2 * n2), dtype=torch.float32, device=q.device)
        counters = _counters(q.device, stream, n2 // BLOCK_N2)
    err = _fn("int4_mm_a8")(
        q.data_ptr(), packed.data_ptr(), scales.data_ptr(), None if xs is None else xs.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(), None if counters is None else counters.data_ptr(),
        m, k, n2, k // n_groups, packed.stride(0), scales.stride(0), out.stride(0), _DTYPE_CODES[out_dtype],
        0, stream)  # split_groups 0: the kernel chooses its split
    if err != 0:
        raise RuntimeError(f"int4_mm_a8 launch failed with CUDA error {err}")
    int4_mm_a8.launches += 1
    return out


def _launch_float(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One launch of `int4_mm` on x [M, K] (bf16 or fp32) -> x's dtype."""
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"int4_mm takes float32 or bfloat16 activations, got {x.dtype}")
    out = _operands("int4_mm", x, packed, scales, out, x.dtype)
    m, k = x.shape
    if m == 0:
        return out
    n2 = packed.shape[1]
    err = _fn("int4_mm")(x.data_ptr(), packed.data_ptr(), scales.data_ptr(), out.data_ptr(), m, k, n2,
                         k // scales.shape[0], packed.stride(0), scales.stride(0), out.stride(0),
                         _DTYPE_CODES[x.dtype], _stream(x))
    if err != 0:
        raise RuntimeError(f"int4_mm launch failed with CUDA error {err}")
    int4_mm.launches += 1
    return out


def _on(x: torch.Tensor, name: str) -> str:
    if x.device.type not in ("cuda", "cpu"):
        raise RuntimeError(f"{name} runs on cuda or cpu tensors, got {x.device}")
    return x.device.type


def int4_mm_a8(q: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """int8 q [M, K] x packed -> f32 [M, N] (token scale not applied): the
    kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if _on(q, "int4_mm_a8") == "cpu":
        return int4_matmul_a8_plain(q, packed, scales)
    return _launch_a8(q, packed, scales)


def int4_mm(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """bf16 / fp32 x [M, K] x packed -> x's dtype [M, N]: the kernel on a
    CUDA tensor, the plain version on a CPU tensor."""
    if _on(x, "int4_mm") == "cpu":
        return int4_matmul_plain(x, packed, scales)
    return _launch_float(x, packed, scales)


def quantize_a8(x: torch.Tensor, absmax: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [M, K] (fp32 or bf16) -> (q int8 [M, K], scale f32 [M, 1]), the
    bits of `quantize_activations_per_token(x, absmax)`: its kernel on a
    CUDA tensor (contiguous x), the plain version on a CPU tensor. `absmax`
    (f32 [M, 1], contiguous) replaces each row's own: a row-parallel
    product quantizes its K shard with the whole row's."""
    if _on(x, "quantize_a8") == "cpu":
        return quantize_activations_per_token(x, absmax)
    if x.dtype not in _DTYPE_CODES or x.dim() != 2 or not x.is_contiguous():
        raise TypeError(f"quantize_a8 takes a contiguous 2-D float32 or bfloat16 tensor, got {x.dtype} "
                        f"{tuple(x.shape)} strides {x.stride()}")
    m, k = x.shape
    if absmax is not None and (absmax.dtype != torch.float32 or absmax.numel() != m or not absmax.is_contiguous()
                               or absmax.device != x.device):
        raise ValueError(f"quantize_a8: absmax must be {m} contiguous float32 row maxima on {x.device}")
    q = torch.empty((m, k), dtype=torch.int8, device=x.device)
    xs = torch.empty((m, 1), dtype=torch.float32, device=x.device)
    if m == 0 or k == 0:
        return q, xs.fill_(1.0)
    err = _fn("quantize_a8")(x.data_ptr(), _DTYPE_CODES[x.dtype], None if absmax is None else absmax.data_ptr(),
                             q.data_ptr(), xs.data_ptr(), m, k, _stream(x))
    if err != 0:
        raise RuntimeError(f"quantize_a8 launch failed with CUDA error {err}")
    quantize_a8.launches += 1
    return q, xs


int4_mm_a8.launches = 0
int4_mm.launches = 0
quantize_a8.launches = 0


# --- routing -------------------------------------------------------------------


def _launch(a8: bool, x2: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor, out=None, xs=None,
            out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    if a8:
        return _launch_a8(x2, packed, scales, out, xs, out_dtype)
    return _launch_float(x2, packed, scales, out)


def _int4_route(x2: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor, a8: bool, xs=None,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[M, K] @ packed. a8: x2 is int8 and the result f32 without the token
    scale, or, on the card with `xs`, scaled and in `out_dtype`. A CUDA
    tensor launches the kernel; on a CPU tensor, shapes the JAX kernel
    cannot take dequantize and matmul (the JAX fallback)."""
    if _on(x2, "int4 matmul") == "cuda":
        return _launch(a8, x2, packed, scales, xs=xs, out_dtype=out_dtype)
    if not int4_kernel_eligible(x2.shape[-1], 2 * packed.shape[-1], scales.shape[-2]):
        if a8:
            return x2.float() @ dequant_int4(packed, scales, dtype=torch.float32)
        return x2 @ dequant_int4(packed, scales, dtype=x2.dtype)
    return int4_matmul_a8_plain(x2, packed, scales) if a8 else int4_matmul_plain(x2, packed, scales)


def _int4_route_blocked(x2: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor, a8: bool,
                        n_shards: int, xs=None, out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A shard-blocked pack on one device: each of the `n_shards` column
    blocks is a plain v2 matrix over its own output columns. On the card
    each block's launch reads its columns in place and writes its columns of
    the one output (`xs`, `out_dtype`: as `_int4_route`); on the CPU the
    blocks' products are concatenated."""
    if n_shards == 1:
        return _int4_route(x2, packed, scales, a8, xs, out_dtype)
    w2 = packed.shape[-1] // n_shards
    ns = scales.shape[-1] // n_shards
    blocks = [(packed[:, d * w2:(d + 1) * w2], scales[:, d * ns:(d + 1) * ns]) for d in range(n_shards)]
    if _on(x2, "int4 matmul") == "cuda":
        out = torch.empty((x2.shape[0], scales.shape[-1]), dtype=out_dtype if a8 else x2.dtype,
                          device=x2.device)
        for d, (p, s) in enumerate(blocks):
            _launch(a8, x2, p, s, out[:, d * ns:(d + 1) * ns], xs, out_dtype)
        return out
    return torch.cat([_int4_route(x2, p, s, a8) for p, s in blocks], dim=-1)


def _backward(ctx, g: torch.Tensor):
    packed, scales = ctx.saved_tensors
    dx = None
    if ctx.needs_input_grad[0]:
        w = dequant_int4(packed, scales, dtype=g.dtype, n_shards=ctx.n_shards)  # [K, N], transient
        dx = g @ w.t()
    d_scales = torch.zeros_like(scales) if ctx.needs_input_grad[2] else None
    return dx, None, d_scales, None


class _MatmulInt4(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, packed, scales, n_shards):
        *lead, k = x.shape
        out = _int4_route_blocked(x.reshape(-1, k), packed, scales, False, n_shards)
        ctx.save_for_backward(packed, scales)
        ctx.n_shards = n_shards
        return out.reshape(*lead, out.shape[-1])

    backward = staticmethod(_backward)


class _MatmulInt4A8(torch.autograd.Function):
    """w4a8: `quantize_a8`, then the product. On one device and a CUDA
    tensor the product's epilogue applies the token scale and the cast.
    Row-parallel (`tp`, a parallel/collectives.TensorParallel) the policy
    is `tp.row_product`'s: the K shard quantized with the whole row's absmax,
    the f32 partials all-reduced, then the token scale and the cast (the
    JAX `_make_int4_spmd_rowsharded`: psum of the shard-local route)."""

    @staticmethod
    def forward(ctx, x, packed, scales, n_shards, tp):
        *lead, k = x.shape
        x2 = x.reshape(-1, k).contiguous()
        if tp is None and _on(x2, "matmul_int4_a8") == "cuda":  # two launches: quantize; product, scale, cast
            q, xs = quantize_a8(x2)
            out = _int4_route_blocked(q, packed, scales, True, n_shards, xs, x.dtype)
        else:
            product = functools.partial(_int4_route_blocked, packed=packed, scales=scales, a8=True, n_shards=n_shards)
            if tp is None:
                q, xs = quantize_a8(x2)
                acc = product(q)
            else:
                acc, xs = tp.row_product(x2, product, quantize_a8)
            out = (acc * xs).to(x.dtype)
        ctx.save_for_backward(packed, scales)
        ctx.n_shards = n_shards
        return out.reshape(*lead, out.shape[-1])

    @staticmethod
    def backward(ctx, g):
        return (*_backward(ctx, g), None)


def matmul_int4(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor, n_shards: int = 1,
                row_tp=None) -> torch.Tensor:
    """x [..., K] @ packed int4 weight -> [..., N] in x's dtype (bf16 or
    fp32 sums per group, as the JAX `_kernel`). Differentiable in x.

    Tensor parallelism (parallel/collectives.TensorParallel): a column block
    of a shard-blocked pack is a plain pack here (`n_shards` 1) and its
    product needs no collective; `row_tp` declares `packed` this rank's K
    rows (with their own scale groups) and x its K block: the partial
    products are summed over the group (the JAX `row_parallel=True`); the
    input gradient is this rank's K block of the whole one."""
    def product(x):
        return _MatmulInt4.apply(x, packed, scales, n_shards)

    return product(x) if row_tp is None else row_tp.row_product(x, product)[0]


def matmul_int4_a8(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor, n_shards: int = 1,
                   row_tp=None) -> torch.Tensor:
    """w4a8: x quantized per token to int8 (absmax/127), the int8 x int4
    product in exact per-group int32 sums, then scales and the token scale
    -> [..., N] in x's dtype. The backward is straight-through. `row_tp`:
    row-parallel, as `matmul_int4`."""
    return _MatmulInt4A8.apply(x, packed, scales, n_shards, row_tp)
