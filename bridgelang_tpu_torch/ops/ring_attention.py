"""Ring attention: attention over a sequence split in time across a ring of ranks.

Counterpart of bridgelang_tpu/ops/ring_attention.py. Each rank holds one
block of time of q, k and v [B, T/n, H(kv), D]; the K/V blocks travel round
the ring (parallel/collectives.Ring, the JAX `ppermute`) while each rank
attends its queries to the block it holds, and the blocks' partial results
merge into the softmax over the whole sequence. Memory per rank stays
O(T/n).

The blocks go through the flash kernels (ops/flash_attention.py) with full
lengths, on CUDA tensors; on CPU tensors through their plain versions. The
JAX package computes each block as fp32 einsums, merges unnormalized sums
and casts once, at the end; here a block returns its normalized output in
fp32 (the kernels' `out_dtype`: bf16 inputs, fp32 o) and its log-sum-exp,
and the merge is

    lse = logsumexp_i lse_i,    o = sum_i exp(lse_i - lse) o_i

in fp32 (plain torch, elementwise work that the JAX package leaves to XLA);
o is cast to the inputs' dtype once, after the last block.
Under the causal mask, rank `idx` holding the block of rank `src` computes
a full (non-causal) block when src < idx and a causal diagonal block when
src == idx; a block with src > idx is fully masked: the JAX package
computes and discards it, the port skips its launch, so a ring pass
launches the forward kernel n (n + 1) / 2 times over the ring, not n^2.
Right padding needs no lengths: a pad key sits after every valid query and
so is masked by causality, as in the JAX package.

The backward (`_RingAttention`, a torch.autograd.Function; JAX gets it from
differentiating `ppermute`) computes delta = rowsum(dO * O) once from the
merged fp32 output, rotates K/V round the ring again, and runs both
backward kernels of each block with the global lse and delta, which makes
each block's P the global probabilities, so the block gradients (fp32 from
the kernels) sum to the true ones. dk and dv accumulators (fp32) travel
with their blocks and reach their owner after a last rotate; dq accumulates
in fp32 on the rank; each is cast to its input's dtype once, at the end, as
JAX casts its fp32 gradients. Only this rank's q, k, v, fp32 o and lse are
saved.

`block_forward`, `merge` and `block_backward` are the per-block steps;
`virtual_ring_forward` / `virtual_ring_backward` run them for n blocks of
one sequence on one device, the rotations replaced by indexing (the card
check of the per-block compute where there is one card).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from bridgelang_tpu_torch.ops.flash_attention import (
    _launch,
    _lengths,
    flash_attention_bwd_plain,
    flash_attention_plain,
    flash_bwd_dkv,
    flash_bwd_dq,
)

Merged = Tuple[torch.Tensor, torch.Tensor]  # (o fp32 [B, T, H, D], lse fp32 [B, H, T])


def _device(x: torch.Tensor) -> str:
    if x.device.type not in ("cuda", "cpu"):
        raise RuntimeError(f"ring attention runs on cuda or cpu tensors, got {x.device}")
    return x.device.type


def block_kind(idx: int, src: int, causal: bool) -> Optional[bool]:
    """How rank `idx`'s queries attend the keys of block `src`: None when
    the causal mask hides the whole block, else whether the block is causal
    (the diagonal one)."""
    if not causal:
        return False
    if src > idx:
        return None
    return src == idx


def block_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool) -> Merged:
    """(o fp32, lse) of one query block against one key block, every key
    valid: the flash forward kernel on CUDA, its plain version on the CPU."""
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if _device(q) == "cuda":
        return _launch(q, k, v, _lengths(None, q.shape[0], k.shape[1], q.device), causal, None,
                       out_dtype=torch.float32)
    return flash_attention_plain(q, k, v, causal=causal, out_dtype=torch.float32)


def merge(acc: Optional[Merged], o: torch.Tensor, lse: torch.Tensor) -> Merged:
    """Fold one block's (o, lse), o fp32, into the running (o, lse)."""
    if acc is None:
        return o, lse
    o_acc, lse_acc = acc
    new = torch.logaddexp(lse_acc, lse)
    w_acc = torch.exp(lse_acc - new).transpose(1, 2)[..., None]
    w_blk = torch.exp(lse - new).transpose(1, 2)[..., None]
    return o_acc * w_acc + o * w_blk, new


def row_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) as the backward kernels take it: fp32 [B, H, T]."""
    return (do.float() * o.float()).sum(dim=-1).transpose(1, 2).contiguous()


def block_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
                   do: torch.Tensor, delta: torch.Tensor, causal: bool):
    """(dq, dk, dv), fp32, of one query block against one key block given
    the whole sequence's `o`, `lse` and `delta` for these queries (so P is
    the global probabilities): both backward kernels on CUDA, the plain
    backward on the CPU (which forms delta from `o` and `do`, the same
    numbers)."""
    q, k, v, do = q.contiguous(), k.contiguous(), v.contiguous(), do.contiguous()
    f32 = torch.float32
    if _device(q) == "cuda":
        lengths = _lengths(None, q.shape[0], k.shape[1], q.device)
        dq = flash_bwd_dq(q, k, v, do, lse, delta, lengths, causal, out_dtype=f32)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, lengths, causal, out_dtype=f32)
        return dq, dk, dv
    return flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal, out_dtype=f32)


# --- the ring over ranks --------------------------------------------------------------


def ring_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, ring, causal: bool) -> Merged:
    """This rank's (o fp32, lse) over the whole sequence: n - 1 rotations of
    (k, v), each posted before the block it follows is computed."""
    n, idx = ring.size, ring.index
    acc, kb, vb = None, k, v
    for i in range(n):
        wait = ring.start_rotate([kb, vb]) if i < n - 1 else None
        kind = block_kind(idx, (idx - i) % n, causal)
        if kind is not None:
            acc = merge(acc, *block_forward(q, kb, vb, kind))
        if wait is not None:
            kb, vb = wait()
    return acc


def ring_backward(q, k, v, o, lse, do, ring, causal: bool):
    """(dq, dk, dv) of this rank's blocks, in the inputs' dtypes, given the
    fp32 `o`: (k, v) rotate as in the forward with their fp32 (dk, dv)
    accumulators, which a last rotate brings home."""
    n, idx = ring.size, ring.index
    delta = row_delta(o, do)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    kb, vb = k, v
    dkb = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dvb = torch.zeros_like(dkb)
    for i in range(n):
        wait = ring.start_rotate([kb, vb]) if i < n - 1 else None
        kind = block_kind(idx, (idx - i) % n, causal)
        if kind is not None:
            dq_i, dk_i, dv_i = block_backward(q, kb, vb, o, lse, do, delta, kind)
            dq += dq_i
            dkb += dk_i
            dvb += dv_i
        dkb, dvb = ring.rotate([dkb, dvb])  # after the n-th, each block's sums are at its owner
        if wait is not None:
            kb, vb = wait()
    return dq.to(q.dtype), dkb.to(k.dtype), dvb.to(v.dtype)


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, ring, causal):
        o, lse = ring_forward(q, k, v, ring, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.ring, ctx.causal = ring, causal
        return o.to(q.dtype)

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        return (*ring_backward(q, k, v, o, lse, do.contiguous(), ctx.ring, ctx.causal), None, None)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, ring, causal: bool = True) -> torch.Tensor:
    """Attention of this rank's block of time over the whole sequence.

    q [B, T/n, H, D], k/v [B, T/n, Hkv, D] (H % Hkv == 0; GQA in the
    kernels, no repeat): this rank's block of a sequence that is the
    concatenation of the ring's blocks in rank order; `ring` a
    parallel/collectives.Ring. Returns the output block [B, T/n, H, D] in
    q's dtype, differentiable in q, k and v."""
    return _RingAttention.apply(q, k, v, ring, causal)


def ring_attention_sharded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh, axis: str,
                           causal: bool = True) -> torch.Tensor:
    """Ring attention over `axis` of `mesh` for this rank's rows of whole
    sequences [B, T, H(kv), D]: an all-to-all over the axis's group turns
    the rows of the n ranks into their rows over this rank's block of time
    [n B, T/n], the ring runs, and the inverse all-to-all gives back this
    rank's rows [B, T, H, D] (JAX `ring_attention_sharded`, where the
    shard_map's spec and GSPMD do the same). T must be a multiple of n."""
    from bridgelang_tpu_torch.parallel.collectives import Ring, rows_to_time, time_to_rows

    ring = Ring.of(mesh, axis)
    if q.shape[1] % ring.size:
        raise ValueError(f"sequence length {q.shape[1]} must be a multiple of the {axis!r} axis size {ring.size} "
                         "for ring attention")
    qt, kt, vt = (rows_to_time(x.contiguous(), ring.group, ring.size) for x in (q, k, v))
    return time_to_rows(ring_attention(qt, kt, vt, ring, causal), ring.group, ring.size)


# --- n blocks of one sequence on one device ------------------------------------------------


def _blocks(x: torch.Tensor, n: int) -> List[torch.Tensor]:
    if x.shape[1] % n:
        raise ValueError(f"sequence length {x.shape[1]} does not split into {n} blocks")
    return [b.contiguous() for b in x.chunk(n, dim=1)]


def virtual_ring_forward(q, k, v, n: int, causal: bool = True) -> Merged:
    """The ring's forward for all n ranks of one sequence on one device:
    each rank's steps in ring order through `block_forward` and `merge`,
    the blocks indexed where the ring rotates them. Returns (o fp32
    [B, T, H, D], lse [B, H, T]), as `ring_forward` for each rank."""
    qs, ks, vs = _blocks(q, n), _blocks(k, n), _blocks(v, n)
    outs, lses = [], []
    for idx in range(n):
        acc = None
        for i in range(n):
            src = (idx - i) % n
            kind = block_kind(idx, src, causal)
            if kind is not None:
                acc = merge(acc, *block_forward(qs[idx], ks[src], vs[src], kind))
        outs.append(acc[0])
        lses.append(acc[1])
    return torch.cat(outs, dim=1), torch.cat(lses, dim=2)


def virtual_ring_backward(q, k, v, o, lse, do, n: int, causal: bool = True):
    """The ring's backward for all n ranks on one device through
    `block_backward` with each rank's global lse and delta (from `o`, fp32
    from `virtual_ring_forward`), the fp32 dk/dv accumulators summed per
    block in the order their travel visits the ranks. Returns (dq, dk, dv)
    in the inputs' dtypes, each cast once."""
    qs, ks, vs, os_, dos = (_blocks(x, n) for x in (q, k, v, o, do))
    lses = [x.contiguous() for x in lse.chunk(n, dim=2)]
    acc = tuple([torch.zeros(b.shape, dtype=torch.float32, device=b.device) for b in blocks] for blocks in (qs, ks, vs))
    deltas = [row_delta(o_i, do_i) for o_i, do_i in zip(os_, dos)]  # once per rank, as the ring
    for i in range(n):  # step i: rank idx holds block (idx - i) % n
        for idx in range(n):
            src = (idx - i) % n
            kind = block_kind(idx, src, causal)
            if kind is None:
                continue
            grads = block_backward(qs[idx], ks[src], vs[src], os_[idx], lses[idx], dos[idx], deltas[idx], kind)
            for j, (at, g) in enumerate(zip((idx, src, src), grads)):
                acc[j][at] += g
    return tuple(torch.cat(sums, dim=1).to(like.dtype) for sums, like in zip(acc, (q, k, v)))
