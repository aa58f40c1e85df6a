"""Packed-int4 weight matmuls: the hand-written Hopper kernels and their plain versions.

Counterpart of bridgelang_tpu/ops/int4_matmul.py. Weights are the JAX
package's bytes (ops/quant.py): packed [K, N/2] int8 in the
`out-paired-lobias/v2` layout, scales [K/group, N] bf16.

* `int4_mm_a8(q, packed, scales)`: int8 activations [M, K] -> f32 [M, N]
  without the per-token scale. A CUDA tensor launches `int4_mm_a8` of
  csrc/int4_matmul.cu (the TPU `_kernel_a8`), a CPU tensor runs
  `int4_matmul_a8_plain`.
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
packed bytes (zeros for the scales, which are frozen everywhere). On a CPU
tensor they take the JAX package's route at each shape: the plain version
where its kernel is eligible (`int4_kernel_eligible`), dequantize-then-matmul
where it is not. `n_shards` > 1 declares a shard-blocked pack: each column
block is a plain v2 matrix over its own output columns (`_int4_route_blocked`;
on the card one launch per block, writing its columns of one output). The
row-parallel declaration of the JAX functions waits for multi-GPU support: on
one device a row-parallel leaf is an unblocked pack, `n_shards` = 1.

Not ported, as TPU heuristics: the v5e tile chooser (`_choose_tiles`,
`_TUNED_DECODE_TILES`, `_tile_vmem_bytes`, the `_HBM_BPS`... cost
constants), the 8-row padding of short M, and the two TPU-memory escapes to
the fallback (outputs over 64 MB, and no tiling that fits VMEM). On the card
every shape the kernel takes launches it, the QLoRA `w_gate`/`w_up` products
(a 5632 x 11008 bf16 output) included. The SPMD wrappers, `int4_row_shardable`
and `int4_tp_fallback_matmuls` wait for multi-GPU support.
"""

from __future__ import annotations

import ctypes
from typing import Optional

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


def _launch(a8: bool, x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
            out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One launch of `int4_mm_a8` (a8) or `int4_mm` on x [M, K]; writes
    `out` (a fresh [M, N] when None, else a column slice of a wider one)."""
    name = "int4_mm_a8" if a8 else "int4_mm"
    if (x.dtype != torch.int8) if a8 else (x.dtype not in _DTYPE_CODES):
        raise TypeError(f"{name} takes {'int8' if a8 else 'float32 or bfloat16'} activations, got {x.dtype}")
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
    out_dtype = torch.float32 if a8 else x.dtype
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
    if m == 0:
        return out
    from bridgelang_tpu_torch.ops import _build

    fn = getattr(_build.load("int4_matmul"), name)
    n_ints = 7 if a8 else 8
    fn.argtypes, fn.restype = [ctypes.c_void_p] * 4 + [ctypes.c_int] * n_ints + [ctypes.c_void_p], ctypes.c_int
    ints = [m, k, n2, k // scales.shape[0], packed.stride(0), scales.stride(0), out.stride(0)]
    if not a8:
        ints.append(_DTYPE_CODES[x.dtype])
    err = fn(x.data_ptr(), packed.data_ptr(), scales.data_ptr(), out.data_ptr(), *ints,
             torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")
    (int4_mm_a8 if a8 else int4_mm).launches += 1
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
    return _launch(True, q, packed, scales)


def int4_mm(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """bf16 / fp32 x [M, K] x packed -> x's dtype [M, N]: the kernel on a
    CUDA tensor, the plain version on a CPU tensor."""
    if _on(x, "int4_mm") == "cpu":
        return int4_matmul_plain(x, packed, scales)
    return _launch(False, x, packed, scales)


int4_mm_a8.launches = 0
int4_mm.launches = 0


# --- routing -------------------------------------------------------------------


def _int4_route(x2: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor, a8: bool) -> torch.Tensor:
    """[M, K] @ packed. a8: x2 is int8 and the result f32 without the token
    scale. A CUDA tensor launches the kernel; on a CPU tensor, shapes the
    JAX kernel cannot take dequantize and matmul (the JAX fallback)."""
    if _on(x2, "int4 matmul") == "cuda":
        return _launch(a8, x2, packed, scales)
    if not int4_kernel_eligible(x2.shape[-1], 2 * packed.shape[-1], scales.shape[-2]):
        if a8:
            return x2.float() @ dequant_int4(packed, scales, dtype=torch.float32)
        return x2 @ dequant_int4(packed, scales, dtype=x2.dtype)
    return int4_matmul_a8_plain(x2, packed, scales) if a8 else int4_matmul_plain(x2, packed, scales)


def _int4_route_blocked(x2: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor, a8: bool,
                        n_shards: int) -> torch.Tensor:
    """A shard-blocked pack on one device: each of the `n_shards` column
    blocks is a plain v2 matrix over its own output columns. On the card
    each block's launch reads its columns in place and writes its columns of
    the one output; on the CPU the blocks' products are concatenated."""
    if n_shards == 1:
        return _int4_route(x2, packed, scales, a8)
    w2 = packed.shape[-1] // n_shards
    ns = scales.shape[-1] // n_shards
    blocks = [(packed[:, d * w2:(d + 1) * w2], scales[:, d * ns:(d + 1) * ns]) for d in range(n_shards)]
    if _on(x2, "int4 matmul") == "cuda":
        out = torch.empty((x2.shape[0], scales.shape[-1]), dtype=torch.float32 if a8 else x2.dtype,
                          device=x2.device)
        for d, (p, s) in enumerate(blocks):
            _launch(a8, x2, p, s, out[:, d * ns:(d + 1) * ns])
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
    @staticmethod
    def forward(ctx, x, packed, scales, n_shards):
        *lead, k = x.shape
        q, xs = quantize_activations_per_token(x.reshape(-1, k))
        out = _int4_route_blocked(q, packed, scales, True, n_shards)  # f32, token scale off
        ctx.save_for_backward(packed, scales)
        ctx.n_shards = n_shards
        return (out * xs).to(x.dtype).reshape(*lead, out.shape[-1])

    backward = staticmethod(_backward)


def matmul_int4(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor, n_shards: int = 1) -> torch.Tensor:
    """x [..., K] @ packed int4 weight -> [..., N] in x's dtype (bf16 or
    fp32 sums per group, as the JAX `_kernel`). Differentiable in x."""
    return _MatmulInt4.apply(x, packed, scales, n_shards)


def matmul_int4_a8(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor, n_shards: int = 1) -> torch.Tensor:
    """w4a8: x quantized per token to int8 (absmax/127), the int8 x int4
    product in exact per-group int32 sums, then scales and the token scale
    -> [..., N] in x's dtype. The backward is straight-through."""
    return _MatmulInt4A8.apply(x, packed, scales, n_shards)
