"""Flash attention: the hand-written Hopper kernels and their plain versions.

Counterpart of bridgelang_tpu/ops/flash_attention.py, forward and backward.
`flash_attention` is one `torch.autograd.Function` for both devices:

* forward: a CUDA tensor launches csrc/flash_fwd.cu (counted in
  `flash_attention.launches`); a CPU tensor runs `flash_attention_plain`;
* backward: a CUDA tensor launches the two kernels of csrc/flash_bwd.cu
  (`flash_bwd_dq`, `flash_bwd_dkv`, each with its own `launches` count);
  a CPU tensor runs `flash_attention_bwd_plain`.

Any other device raises, and there is no fallback from a kernel to a plain
version.

Semantics (as the JAX API): q [B, T, H, D], k/v [B, S, Hkv, D] with S >= T
(queries sit at key slots 0..T-1), GQA with H % Hkv == 0, `lengths` [B] valid
keys per example (right padding), causal masking, and an optional sliding
window where row r attends keys in (r - window, r]. Returns `(o, lse)`: o in
q's dtype and layout, lse f32 [B, H, T]. Only `o` is differentiable (the JAX
`_flash` returns `o` alone). Rows at or past `lengths` are don't-care in the
forward; in the backward they enter dk/dv through the keys they attend,
exactly as in the JAX kernels. Key slots at or past `lengths` get zero
gradient.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

NEG_INF = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_HEAD_DIMS = (64, 128)


def _repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    if n_rep == 1:
        return x
    b, s, h, d = x.shape
    return x[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(b, s, h * n_rep, d)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q [B,T,H,D] and k/v [B,S,Hkv,D], got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, t, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree on batch or head dim")
    if h % k.shape[2]:
        raise ValueError(f"query heads ({h}) must be a multiple of KV heads ({k.shape[2]})")
    if k.shape[1] < t:
        raise ValueError(f"keys ({k.shape[1]}) must be at least as long as queries ({t}); queries sit at key positions 0..T-1")


def _lengths(lengths: Optional[torch.Tensor], b: int, s: int, device: torch.device) -> torch.Tensor:
    if lengths is None:
        return torch.full((b,), s, dtype=torch.int32, device=device)
    return torch.as_tensor(lengths).to(device=device, dtype=torch.int32).contiguous()


def _valid_mask(t: int, s: int, lengths: torch.Tensor, causal: bool, window: Optional[int]) -> torch.Tensor:
    """[B, T, S] bool: row r attends key c."""
    row = torch.arange(t, device=lengths.device)[:, None]
    col = torch.arange(s, device=lengths.device)[None, :]
    mask = col[None] < lengths[:, None, None]
    if causal:
        mask = mask & (col <= row)
    if window is not None:
        mask = mask & (col > row - window)
    return mask


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
    causal: bool = True,
    window: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward in plain torch (fp32 math): the CPU path, and the version
    the kernel is held against on the card."""
    _check(q, k, v)
    b, t, h, d = q.shape
    s = k.shape[1]
    lengths = _lengths(lengths, b, s, q.device)
    n_rep = h // k.shape[2]
    qf = q.float() * d ** -0.5
    kf = _repeat_kv(k.float(), n_rep)
    vf = _repeat_kv(v.float(), n_rep)
    logits = torch.einsum("bthd,bshd->bhts", qf, kf)
    mask = _valid_mask(t, s, lengths, causal, window)
    logits = torch.where(mask[:, None], logits, torch.full_like(logits, NEG_INF))
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l_sum = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l_sum == 0, torch.ones_like(l_sum), l_sum)
    o = torch.einsum("bhts,bshd->bthd", p, vf) / l_safe.permute(0, 2, 1, 3)
    lse = (m + torch.log(l_safe))[..., 0]
    return o.to(q.dtype), lse


def flash_attention_bwd_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
    causal: bool = True,
    window: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward in plain torch, as the JAX `_flash_bwd`: fp32 math, P
    recomputed from `lse` under the forward's mask, delta = rowsum(dO * O),
    GQA summed per KV head; dq in q's dtype, dk/dv in k's dtype. The CPU
    path, and the version the kernels are held against on the card."""
    _check(q, k, v)
    b, t, h, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    n_rep = h // hkv
    lengths = _lengths(lengths, b, s, q.device)
    scale = d ** -0.5
    qf = q.float() * scale
    kf = _repeat_kv(k.float(), n_rep)
    vf = _repeat_kv(v.float(), n_rep)
    dof = do.float()
    mask = _valid_mask(t, s, lengths, causal, window)[:, None]  # [B, 1, T, S]
    logits = torch.einsum("bthd,bshd->bhts", qf, kf)
    p = torch.where(mask, torch.exp(logits - lse.float()[..., None]), torch.zeros_like(logits))
    delta = (dof * o.float()).sum(dim=-1).permute(0, 2, 1)  # [B, H, T]
    dp = torch.einsum("bthd,bshd->bhts", dof, vf)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhts,bshd->bthd", ds, kf) * scale
    dk = torch.einsum("bhts,bthd->bshd", ds, qf).reshape(b, s, hkv, n_rep, d).sum(dim=3)
    dv = torch.einsum("bhts,bthd->bshd", p, dof).reshape(b, s, hkv, n_rep, d).sum(dim=3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# --- the kernels (CUDA tensors only) ---------------------------------------------


# The flash kernels' trailing C arguments: 9 dims (b, t, s, h, hkv, d, dtype,
# causal, window), the softmax scale and the stream.
_DIMS_SCALE_STREAM = [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p]


def _check_kernel_inputs(named, d: int) -> None:
    first = named[0][1]
    if first.dtype not in _DTYPE_CODES or any(x.dtype != first.dtype for _, x in named):
        raise TypeError(f"flash kernels take float32 or bfloat16 tensors of one dtype, got {[x.dtype for _, x in named]}")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash kernels support head dims {KERNEL_HEAD_DIMS}, got {d}")
    for name, x in named:
        if x.device != first.device or x.device.type != "cuda":
            raise ValueError(f"{name} is on {x.device}; the kernels take tensors on one CUDA device")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _launch(q, k, v, lengths, causal, window) -> Tuple[torch.Tensor, torch.Tensor]:
    from bridgelang_tpu_torch.ops import _build

    b, t, h, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    _check_kernel_inputs((("q", q), ("k", k), ("v", v)), d)
    o = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    if t == 0 or b == 0:
        return o, lse
    fn = _build.function("flash_fwd", "flash_fwd", [ctypes.c_void_p] * 6 + _DIMS_SCALE_STREAM)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(), o.data_ptr(), lse.data_ptr(),
        b, t, s, h, hkv, d, _DTYPE_CODES[q.dtype], int(causal), int(window or 0), d ** -0.5, stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_fwd launch failed with CUDA error {err}")
    flash_attention.launches += 1
    return o, lse


def _bwd_args(q, k, v, do, lse, delta, lengths, causal, window):
    b, t, h, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    _check_kernel_inputs((("q", q), ("k", k), ("v", v), ("do", do)), d)
    for name, x in (("lse", lse), ("delta", delta)):
        if x.dtype != torch.float32 or x.shape != (b, h, t) or not x.is_contiguous() or x.device != q.device:
            raise ValueError(f"{name} must be a contiguous float32 [B, H, T] tensor on q's device")
    ptrs = [x.data_ptr() for x in (q, k, v, do, lse, delta, lengths)]
    dims = [b, t, s, h, hkv, d, _DTYPE_CODES[q.dtype], int(causal), int(window or 0)]
    return ptrs, dims, d ** -0.5, torch.cuda.current_stream(q.device).cuda_stream


def flash_bwd_dq(q, k, v, do, lse, delta, lengths, causal=True, window=None) -> torch.Tensor:
    """dq from csrc/flash_bwd.cu (CUDA tensors only); counts its launch."""
    from bridgelang_tpu_torch.ops import _build

    ptrs, dims, scale, stream = _bwd_args(q, k, v, do, lse, delta, lengths, causal, window)
    dq = torch.empty_like(q)
    if q.numel() == 0:
        return dq
    fn = _build.function("flash_bwd", "flash_bwd_dq", [ctypes.c_void_p] * 8 + _DIMS_SCALE_STREAM)
    err = fn(*ptrs, dq.data_ptr(), *dims, scale, stream)
    if err != 0:
        raise RuntimeError(f"flash_bwd_dq launch failed with CUDA error {err}")
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, lengths, causal=True, window=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """dk, dv from csrc/flash_bwd.cu (CUDA tensors only), the GQA group sum
    folded in; counts its launch."""
    from bridgelang_tpu_torch.ops import _build

    ptrs, dims, scale, stream = _bwd_args(q, k, v, do, lse, delta, lengths, causal, window)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if k.numel() == 0:
        return dk, dv
    fn = _build.function("flash_bwd", "flash_bwd_dkv", [ctypes.c_void_p] * 9 + _DIMS_SCALE_STREAM)
    err = fn(*ptrs, dk.data_ptr(), dv.data_ptr(), *dims, scale, stream)
    if err != 0:
        raise RuntimeError(f"flash_bwd_dkv launch failed with CUDA error {err}")
    flash_bwd_dkv.launches += 1
    return dk, dv


def flash_attention_bwd(q, k, v, o, lse, do, lengths=None, causal=True, window=None):
    """(dq, dk, dv): the two kernels for CUDA tensors, the plain version for
    CPU tensors. delta = rowsum(dO * O) is plain torch, as in the JAX
    package (flash_attention.py:449)."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, lengths, causal, window)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention_bwd runs on cuda or cpu tensors, got {q.device}")
    lengths = _lengths(lengths, q.shape[0], k.shape[1], q.device)
    delta = (do.float() * o.float()).sum(dim=-1).transpose(1, 2).contiguous()  # [B, H, T]
    dq = flash_bwd_dq(q, k, v, do, lse, delta, lengths, causal, window)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, lengths, causal, window)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, lengths, causal, window):
        if q.device.type == "cuda":
            o, lse = _launch(q, k, v, lengths, causal, window)
        else:
            o, lse = flash_attention_plain(q, k, v, lengths, causal, window)
        ctx.save_for_backward(q, k, v, lengths, o, lse)
        ctx.causal, ctx.window = causal, window
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, lengths, o, lse = ctx.saved_tensors
        # Autograd may hand a strided gradient; the kernels read dO in place.
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(), lengths, ctx.causal, ctx.window)
        return dq, dk, dv, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
    causal: bool = True,
    window: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal flash attention over right-padded batches -> (o, lse), with a
    gradient for `o` through the backward kernels (CUDA) or the plain
    backward (CPU)."""
    _check(q, k, v)
    if q.device.type not in ("cuda", "cpu"):
        raise RuntimeError(f"flash_attention runs on cuda or cpu tensors, got {q.device}")
    if window is not None and window >= k.shape[1]:
        window = None  # the window never clips at this sequence length
    lengths = _lengths(lengths, q.shape[0], k.shape[1], q.device)
    return _FlashAttention.apply(q, k, v, lengths, causal, window)


flash_attention.launches = 0
flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0
