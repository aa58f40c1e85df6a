"""Flash-attention forward: the hand-written Hopper kernel and its plain version.

Counterpart of bridgelang_tpu/ops/flash_attention.py (forward only; the
backward kernels are still to port). `flash_attention` launches
csrc/flash_fwd.cu for a CUDA tensor and runs `flash_attention_plain` for a
CPU tensor; any other device raises. There is no fallback from the kernel to
the plain version.

Semantics (as the JAX API): q [B, T, H, D], k/v [B, S, Hkv, D] with S >= T
(queries sit at key slots 0..T-1), GQA with H % Hkv == 0, `lengths` [B] valid
keys per example (right padding), causal masking, and an optional sliding
window where row r attends keys in (r - window, r]. Returns `(o, lse)`: o in
q's dtype and layout, lse f32 [B, H, T]. Rows at or past `lengths` are
don't-care, as in the JAX kernel.
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


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
    causal: bool = True,
    window: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same function in plain torch (fp32 math): the CPU path, and the
    version the kernel is held against on the card."""
    _check(q, k, v)
    b, t, h, d = q.shape
    s = k.shape[1]
    lengths = _lengths(lengths, b, s, q.device)
    n_rep = h // k.shape[2]
    qf = q.float() * d ** -0.5
    kf = _repeat_kv(k.float(), n_rep)
    vf = _repeat_kv(v.float(), n_rep)
    logits = torch.einsum("bthd,bshd->bhts", qf, kf)
    row = torch.arange(t, device=q.device)[:, None]
    col = torch.arange(s, device=q.device)[None, :]
    mask = col[None] < lengths[:, None, None]  # [B, T, S]
    if causal:
        mask = mask & (col <= row)
    if window is not None:
        mask = mask & (col > row - window)
    logits = torch.where(mask[:, None], logits, torch.full_like(logits, NEG_INF))
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l_sum = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l_sum == 0, torch.ones_like(l_sum), l_sum)
    o = torch.einsum("bhts,bshd->bthd", p, vf) / l_safe.permute(0, 2, 1, 3)
    lse = (m + torch.log(l_safe))[..., 0]
    return o.to(q.dtype), lse


def _launch(q, k, v, lengths, causal, window) -> Tuple[torch.Tensor, torch.Tensor]:
    from bridgelang_tpu_torch.ops import _build

    b, t, h, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash kernel takes float32 or bfloat16 q/k/v of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash kernel supports head dims {KERNEL_HEAD_DIMS}, got {d}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    lengths = _lengths(lengths, b, s, q.device)
    o = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    if t == 0 or b == 0:
        return o, lse
    lib = _build.load("flash_fwd")
    fn = lib.flash_fwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(), o.data_ptr(), lse.data_ptr(),
        b, t, s, h, hkv, d, _DTYPE_CODES[q.dtype], int(causal), int(window or 0), d ** -0.5, stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_fwd launch failed with CUDA error {err}")
    flash_attention.launches += 1
    return o, lse


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
    causal: bool = True,
    window: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal flash attention over right-padded batches -> (o, lse).

    A CUDA tensor launches csrc/flash_fwd.cu (and counts the launch in
    `flash_attention.launches`); a CPU tensor runs `flash_attention_plain`.
    """
    _check(q, k, v)
    if window is not None and window >= k.shape[1]:
        window = None  # the window never clips at this sequence length
    if q.device.type == "cuda":
        return _launch(q, k, v, lengths, causal, window)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, lengths, causal, window)
    raise RuntimeError(f"flash_attention runs on cuda or cpu tensors, got {q.device}")


flash_attention.launches = 0
