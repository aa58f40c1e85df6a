"""Port flash-attention gradients vs the JAX package's (Pallas backward kernels
in interpret mode on the CPU, as tests/test_flash_attention.py runs them).

The same numpy inputs and output cotangent go through the JAX
`flash_attention` (jax.vjp: `_bwd_dq_kernel`, `_bwd_dkv_kernel`) and the
port's `flash_attention` (torch autograd: the `_FlashAttention` Function,
whose CPU backward is `flash_attention_bwd_plain`). Tolerances:
* port vs JAX: fp32, atol/rtol 5e-4, the JAX package's own gradient tolerance
  against its reference (P recomputed from lse and the GQA group sum run in
  another order).
* `flash_attention_bwd_plain` vs torch autograd through `flash_attention_plain`:
  fp32, atol 1e-5 (one function differentiated two ways).

Every query row is in the cotangent, padded rows too: rows at or past
`lengths` attend the valid keys, so they enter dk/dv exactly as in the JAX
kernels. The CUDA kernels are held against the plain backward on the card by
tests/test_torch_kernels_gpu.py and chip_smoke.py, under chip_smoke.py's
per-element rule GRAD_TOL; the last test here shows on the CPU that the rule
passes a backward that only sums in another order and fails one that drops a
tile of the sum.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bridgelang_tpu.ops.flash_attention import flash_attention as jax_flash
from bridgelang_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd_plain,
    flash_attention_plain,
    flash_bwd_dkv,
    flash_bwd_dq,
)

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from chip_smoke import grad_tolerance_use  # noqa: E402

# (b, t, s, h, hkv, d, lengths, window, causal)
CASES = {
    "causal_ragged": (2, 160, 160, 4, 4, 64, [130, 97], None, True),
    "gqa": (2, 128, 128, 8, 2, 64, [128, 100], None, True),
    "keys_longer": (2, 48, 176, 4, 4, 64, [48, 31], None, True),
    "window": (1, 256, 256, 2, 2, 64, [230], 96, True),
}


def _inputs(b, t, s, h, hkv, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, t, h, d)).astype(np.float32)
    k = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    do = rng.normal(size=(b, t, h, d)).astype(np.float32)
    return q, k, v, do


def _torch_grads(q, k, v, do, lengths, causal, window):
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    o, lse = flash_attention(*leaves, lengths=torch.tensor(lengths), causal=causal, window=window)
    return o, lse, torch.autograd.grad(o, leaves, torch.from_numpy(do))


@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_gradients_match_jax(name):
    b, t, s, h, hkv, d, lengths, window, causal = CASES[name]
    q, k, v, do = _inputs(b, t, s, h, hkv, d, seed=20 + sorted(CASES).index(name))
    lens = jnp.asarray(lengths, jnp.int32)
    _, vjp = jax.vjp(lambda q_, k_, v_: jax_flash(q_, k_, v_, lengths=lens, causal=causal, window=window),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    j_grads = vjp(jnp.asarray(do))

    counts = (flash_attention.launches, flash_bwd_dq.launches, flash_bwd_dkv.launches)
    _, _, t_grads = _torch_grads(q, k, v, do, lengths, causal, window)
    assert (flash_attention.launches, flash_bwd_dq.launches, flash_bwd_dkv.launches) == counts  # CPU: no kernels
    for jg, tg, what in zip(j_grads, t_grads, ("dq", "dk", "dv")):
        assert tg.shape == jg.shape and tg.dtype == torch.float32
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=5e-4, rtol=5e-4, err_msg=what)
    for i, L in enumerate(lengths):  # key slots past the valid length take no gradient
        assert not t_grads[1][i, L:].any() and not t_grads[2][i, L:].any()


@pytest.mark.parametrize("name", sorted(CASES) + ["not_causal"])
def test_plain_backward_matches_autograd_of_plain_forward(name):
    b, t, s, h, hkv, d, lengths, window, causal = CASES.get(name, (1, 96, 96, 4, 2, 64, [70], None, False))
    q, k, v, do = _inputs(b, t, s, h, hkv, d, seed=40)
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    lens = torch.tensor(lengths)
    o, lse = flash_attention_plain(*leaves, lengths=lens, causal=causal, window=window)
    want = torch.autograd.grad(o, leaves, torch.from_numpy(do))
    got = flash_attention_bwd_plain(*(x.detach() for x in (*leaves, o, lse)), torch.from_numpy(do), lens, causal, window)
    for g, w, what in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5, rtol=0, err_msg=what)


def test_output_has_grad_fn_and_lse_takes_none():
    q, k, v, do = _inputs(1, 32, 32, 2, 2, 64, seed=50)
    o, lse, grads = _torch_grads(q, k, v, do, [30], True, None)
    assert o.grad_fn is not None and type(o.grad_fn).__name__ == "_FlashAttentionBackward"
    assert not lse.requires_grad
    assert all(torch.isfinite(g).all() for g in grads)
    # a strided cotangent (autograd may hand one) gives the same gradients
    strided = torch.from_numpy(np.ascontiguousarray(do.transpose(0, 2, 1, 3))).transpose(1, 2)
    assert not strided.is_contiguous()
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    o2, _ = flash_attention(*leaves, lengths=torch.tensor([30]))
    for a, b_ in zip(torch.autograd.grad(o2, leaves, strided), grads):
        assert torch.equal(a, b_)


def _bwd_float64(q, k, v, o, lse, do, lengths, keep):
    """The causal backward (no GQA) in float64, with dS and P kept only where
    `keep` [T, S] holds: a kernel that sums in another order (all kept) or
    skips part of the sum."""
    q, k, v, o, do = (x.double() for x in (q, k, v, o, do))
    t, s, d = q.shape[1], k.shape[1], q.shape[3]
    row, col = torch.arange(t)[:, None], torch.arange(s)[None, :]
    mask = ((col <= row) & keep)[None] & (col[None] < lengths[:, None, None])
    logits = torch.einsum("bthd,bshd->bhts", q * d ** -0.5, k)
    p = torch.where(mask[:, None], torch.exp(logits - lse.double()[..., None]), torch.zeros((), dtype=torch.float64))
    ds = p * (torch.einsum("bthd,bshd->bhts", do, v) - (do * o).sum(-1).transpose(1, 2)[..., None])
    return (torch.einsum("bhts,bshd->bthd", ds, k) * d ** -0.5, torch.einsum("bhts,bthd->bshd", ds, q) * d ** -0.5,
            torch.einsum("bhts,bthd->bshd", p, do))


@pytest.mark.parametrize("variant", ["other_order", "dropped_query_tile", "skipped_diagonal_key_tile"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_gradient_rule_separates_order_from_missing_tiles(dtype, variant):
    """chip_smoke.GRAD_TOL against the plain backward: a float64 backward
    rounded to `dtype` (another summation order) uses at most all of the
    tolerance; one that skips a 64-row query tile, or each query tile's
    diagonal 64-key tile (a tile bound off by one), exceeds it in dq, dk and dv."""
    t, tile = 192, 64
    q, k, v, do = (torch.from_numpy(x).to(dtype) for x in _inputs(1, t, t, 2, 2, 64, seed=60))
    lens = torch.tensor([180])
    o, lse = flash_attention_plain(q, k, v, lengths=lens)
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, lens)
    r, c = torch.arange(t)[:, None], torch.arange(t)[None, :]
    keep = {"other_order": torch.ones((t, t), dtype=torch.bool),
            "dropped_query_tile": (r // tile != 1).expand(t, t),
            "skipped_diagonal_key_tile": r // tile != c // tile}[variant]
    got = [g.to(dtype) for g in _bwd_float64(q, k, v, o, lse, do, lens, keep)]
    uses = [grad_tolerance_use(g, w) for g, w in zip(got, want)]
    if variant == "other_order":
        assert max(uses) <= 1.0, uses
    else:
        assert min(uses) > 1.0, uses


def _bwd_rounded(q, k, v, o, lse, do, lengths, rounding):
    """flash_attention_bwd_plain's fp32 math (causal, no GQA), with P and dS
    rounded before the dQ, dK and dV products: to bf16 once ("once"), or to a
    bf16 pair hi + lo with hi = bf16(x) and lo = bf16(x - hi) ("hi_lo")."""

    def rounded(x):
        hi = x.to(torch.bfloat16).float()
        return hi if rounding == "once" else hi + (x - hi).to(torch.bfloat16).float()

    t, s, d = q.shape[1], k.shape[1], q.shape[3]
    scale = d ** -0.5
    qf, kf, dof = q.float() * scale, k.float(), do.float()
    row, col = torch.arange(t)[:, None], torch.arange(s)[None, :]
    mask = ((col <= row)[None] & (col[None] < lengths[:, None, None]))[:, None]
    logits = torch.einsum("bthd,bshd->bhts", qf, kf)
    p = torch.where(mask, torch.exp(logits - lse.float()[..., None]), torch.zeros_like(logits))
    delta = (dof * o.float()).sum(-1).transpose(1, 2)
    ds = p * (torch.einsum("bthd,bshd->bhts", dof, v.float()) - delta[..., None])
    p, ds = rounded(p), rounded(ds)
    return ((torch.einsum("bhts,bshd->bthd", ds, kf) * scale).to(q.dtype),
            torch.einsum("bhts,bthd->bshd", ds, qf).to(k.dtype), torch.einsum("bhts,bthd->bshd", p, dof).to(v.dtype))


# (b, t, h, d, lengths): the gradient-rule test's shape, and the train shape's widths at B=2, H=8
ROUNDING_SHAPES = {"t192_d64": (1, 192, 2, 64, [180]), "t352_d128": (2, 352, 8, 128, [352, 300])}


@pytest.mark.parametrize("rounding", ["once", "hi_lo"])
@pytest.mark.parametrize("seed", [60, 61, 62])
@pytest.mark.parametrize("shape", sorted(ROUNDING_SHAPES))
def test_kernel_gradient_rule_needs_p_and_ds_as_bf16_pairs(shape, seed, rounding):
    """Why the bf16 backward kernels feed P and dS to the tensor cores as
    pairs hi + lo, two mma per product: at bf16 inputs, one bf16 rounding of
    P and dS before the dQ, dK and dV products (what FlashAttention-2 and
    SDPA do) moves every gradient past chip_smoke.GRAD_TOL against the plain
    fp32 backward (4.7-15 times the tolerance at t192_d64, 11-25 at
    t352_d128, over these seeds), while the pair carries ~16 bits and stays
    inside it (0.63-0.79 and 0.86-0.94). The rule is not loosened for the
    kernel: it is what separates a backward that sums in another order from
    one that drops a tile (the test above)."""
    b, t, h, d, lengths = ROUNDING_SHAPES[shape]
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16) for x in _inputs(b, t, t, h, h, d, seed=seed))
    lens = torch.tensor(lengths)
    o, lse = flash_attention_plain(q, k, v, lengths=lens)
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, lens)
    uses = [grad_tolerance_use(g, w) for g, w in zip(_bwd_rounded(q, k, v, o, lse, do, lens, rounding), want)]
    if rounding == "once":
        assert min(uses) > 1.0, uses
    else:
        assert max(uses) <= 1.0, uses
