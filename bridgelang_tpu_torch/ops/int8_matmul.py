"""The int8 weight-only GEMV: bf16 activations times int8 weight codes, per-column scale.

Replaces no TPU kernel. The JAX package's int8 route (`_block.proj` and
`lm_logits` with w8a8 off or below its chunk gate) casts the codes to the
activation dtype inside one XLA fusion. Ported as it was, that cast ran on
the card as an elementwise copy of every weight to bf16 before cuBLAS read
the copy: ~35 GB moved per Mistral-7B decode token for 7.1 GB of codes.

* `int8_gemv(x, w, scale)`: x [..., K] bf16 times w [N, K] int8 (the port's
  [out, in] layout) -> [..., N] bf16, bf16(bf16(x w^T) * scale) with fp32
  sums, or bf16(x w^T) when `scale` is None (a tensor-parallel row block's
  partial, scaled after the reduce). A CUDA tensor launches `int8_gemv` of
  csrc/int8_matmul.cu, or raises: at most M_MAX rows, K a multiple of 16,
  bf16 x and scale. A CPU tensor runs `int8_gemv_plain`.
* `int8_gemv_plain`: the cast route's composition, F.linear(x,
  w.to(x.dtype)) * scale.to(x.dtype). Kernel and plain version round at the
  same two places; they differ in the fp32 order of the sums.

The kernel is bound by the bytes of the codes (at M <= 16 it does at most 32
operations per byte read, the card ~295): it reads each code byte once,
16 bytes a lane by cp.async into the lane's own ring slots two steps ahead
(no barrier in the loop), converts the codes to bf16 in registers and sums on
the tensor cores (mma.sync m16n8k16, x as the 16-row operand, read through
L1 a step ahead). Blocks split K among their warps and add the partial sums
in a fixed order, choosing the rows per block from M and N so that every
shape fills the card in one wave (csrc/int8_matmul.cu). `int8_gemv.launches`
counts the launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

M_MAX = 16  # the kernel's rows: the mma's 16-row operand
_SIGNATURE = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def int8_gemv_plain(x: torch.Tensor, w: torch.Tensor, scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [..., K] @ the codes w [N, K] cast to x's dtype, each column then
    scaled in x's dtype (`scale` [N]; none: the unscaled product)."""
    y = F.linear(x, w.to(x.dtype))
    return y if scale is None else y * scale.to(x.dtype)


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, device: torch.device, align: int) -> None:
    if t.dtype != dtype or t.device != device or not t.is_contiguous() or t.data_ptr() % align:
        raise ValueError(f"int8_gemv: {name} must be a contiguous {dtype} tensor on {device}, {align}-byte "
                         f"aligned; got {t.dtype} on {t.device}, strides {t.stride()}, offset {t.data_ptr() % align}")


def _launch(x2: torch.Tensor, w: torch.Tensor, scale: Optional[torch.Tensor]) -> torch.Tensor:
    from bridgelang_tpu_torch.ops import _build

    m, k = x2.shape
    n = w.shape[0]
    if not 1 <= m <= M_MAX or k % 16 or w.dim() != 2 or w.shape[1] != k:
        raise ValueError(f"int8_gemv takes x [M, K] with 1 <= M <= {M_MAX} and K % 16 == 0 against w [N, K]; "
                         f"got x {tuple(x2.shape)}, w {tuple(w.shape)}")
    _check("x", x2, torch.bfloat16, x2.device, 16)
    _check("w", w, torch.int8, x2.device, 16)
    if scale is not None:
        if scale.shape != (n,):
            raise ValueError(f"int8_gemv: scale must be [{n}], got {tuple(scale.shape)}")
        _check("scale", scale, torch.bfloat16, x2.device, 2)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x2.device)
    err = _build.function("int8_matmul", "int8_gemv", _SIGNATURE)(
        x2.data_ptr(), w.data_ptr(), None if scale is None else scale.data_ptr(), out.data_ptr(), m, n, k,
        torch.cuda.current_stream(x2.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"int8_gemv launch failed with CUDA error {err}")
    int8_gemv.launches += 1
    return out


def int8_gemv(x: torch.Tensor, w: torch.Tensor, scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [..., K] times the int8 codes w [N, K], each output column scaled
    by `scale` [N] (None: unscaled) -> [..., N] in x's dtype: the kernel on a
    CUDA tensor, the plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return int8_gemv_plain(x, w, scale)
    if x.device.type != "cuda":
        raise RuntimeError(f"int8_gemv runs on cuda or cpu tensors, got {x.device}")
    *lead, k = x.shape
    if x.numel() == 0:
        return x.new_empty((*lead, w.shape[0]))
    return _launch(x.reshape(-1, k).contiguous(), w, scale).view(*lead, w.shape[0])


int8_gemv.launches = 0
