"""The port's CUDA kernels against their plain torch versions, on the card.

Every test here carries the `gpu` marker and skips without a CUDA card (the
kernels have no CPU build). The file imports neither JAX nor the JAX package,
so it runs on a GPU machine without them:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_gpu.py -q

Tolerances: fp32 o atol 1e-4; bf16 o atol 2e-2 (kernel and plain both
accumulate in fp32 and round once to bf16, so they may sit one bf16 ulp
apart for |o| < 4); lse is fp32 in both, atol 1e-3. Backward: element by
element, |got - want| <= rtol |want| + atol rms(want) with chip_smoke.py's
GRAD_TOL (bf16: one bf16 ulp, 2^-7 |want|, plus 1e-3 rms for fp32 order
differences near zero; fp32: 1e-5 and 1e-5 rms, order differences only).
The int4 kernels: chip_smoke.py's INT4_TOL, per element as the backward (a8:
f32 before the token scale, order only; bf16: one bf16 ulp plus 1e-3 rms;
fp32: order only). The w4a8 kernels fold in the plain order, so their cases
also ask for bit equality, as do quantize_a8 against
quantize_activations_per_token and the w4a8 route against its plain
composition. The int8 weight-only GEMV: the unscaled product under
INT4_TOL's bf16 rule against int8_gemv_plain (the sums differ in fp32 order
only), the scaled one bit-equal to bf16(unscaled * scale). The routed
experts (ops/moe.py): chip_smoke.py's MOE_TOL per element against
moe_experts_plain, the expert load equal; the flash forward's (192, 128)
instance: FWD_ATOL as the other instances.
"""

import sys
from pathlib import Path

import pytest
import torch

from bridgelang_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_plain,
    flash_attention_plain,
    flash_bwd_dkv,
    flash_bwd_dq,
)

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from chip_smoke import (  # noqa: E402
    DSV2, FWD_ATOL, GRAD_TOL, INT4_SHAPES_7B, INT4_SHAPES_PHI, INT4_TOL, INT8_GEMV_SHAPES, MOE_TOL, grad_tolerance_use)

# (b, t, s, h, hkv, d, lengths, window, causal)
CASES = {
    "causal_ragged": (2, 160, 160, 4, 4, 64, [130, 97], None, True),
    "gqa": (2, 128, 128, 8, 2, 128, [128, 100], None, True),
    "keys_longer": (2, 48, 176, 4, 4, 64, [48, 31], None, True),
    "window": (2, 256, 256, 4, 4, 128, [256, 200], 100, True),
    "not_causal": (1, 128, 128, 2, 2, 64, [90], None, False),
    "serving_7b": (2, 352, 352, 32, 32, 128, [331, 300], None, True),
    "serving_phi_d80": (2, 352, 352, 32, 32, 80, [331, 300], None, True),
    "gqa_window_d80": (2, 200, 256, 8, 2, 80, [190, 77], 64, True),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash kernel has no CPU build")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_kernel_matches_plain(cuda_device, name, dtype, atol):
    b, t, s, h, hkv, d, lengths, window, causal = CASES[name]
    g = torch.Generator(device=cuda_device).manual_seed(3)
    q = torch.randn((b, t, h, d), generator=g, device=cuda_device, dtype=dtype)
    k = torch.randn((b, s, hkv, d), generator=g, device=cuda_device, dtype=dtype)
    v = torch.randn((b, s, hkv, d), generator=g, device=cuda_device, dtype=dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda_device)
    before = flash_attention.launches
    o, lse = flash_attention(q, k, v, lengths=lens, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    po, plse = flash_attention_plain(q, k, v, lengths=lens, causal=causal, window=window)
    for i, L in enumerate(lengths):
        rows = min(L, t)
        torch.testing.assert_close(o[i, :rows].float(), po[i, :rows].float(), atol=atol, rtol=0)
        torch.testing.assert_close(lse[i, :, :rows], plse[i, :, :rows], atol=1e-3, rtol=0)


# The bf16 tensor-core forward at its edges: (b, t, s, h, hkv, d, lengths, window).
# T at, under and over the 64-row tile; keys longer than queries with lengths
# under T (prefill into a preallocated cache, length 1 included); GQA; window.
BF16_FWD_CASES = {
    "t1": (2, 1, 1, 4, 4, 128, [1, 1], None),
    "t63_d64": (2, 63, 63, 4, 4, 64, [63, 40], None),
    "t64": (2, 64, 64, 4, 4, 128, [64, 64], None),
    "t65_d64": (2, 65, 65, 4, 4, 64, [65, 1], None),
    "t352": (1, 352, 352, 32, 32, 128, [352], None),
    "cache_s_gt_t": (3, 96, 160, 8, 8, 128, [70, 1, 96], None),
    "cache_s_gt_t_d64": (2, 65, 130, 4, 4, 64, [64, 1], None),
    "gqa_hkv8": (2, 352, 352, 32, 8, 128, [352, 300], None),
    "window100": (2, 304, 304, 8, 8, 128, [304, 250], 100),
    "window100_d64": (2, 200, 256, 4, 2, 64, [190, 77], 100),
    # Phi-2's head dim 80: 10 chunks of 16 bytes per row, the swizzle's tail
    "t63_d80": (2, 63, 63, 4, 4, 80, [63, 40], None),
    "t65_d80": (2, 65, 65, 4, 4, 80, [65, 1], None),
    "t352_d80": (1, 352, 352, 32, 32, 80, [352], None),
    "cache_s_gt_t_d80": (2, 65, 130, 4, 4, 80, [64, 1], None),
    "gqa_hkv8_d80": (2, 352, 352, 32, 8, 80, [352, 300], None),
    "window100_d80": (2, 200, 256, 4, 2, 80, [190, 77], 100),
}

# The bf16 tensor-core backward at the same edges, and each T at the other
# head dim. A causal query at T = 1 attends one key, so its dq and dk are
# exactly zero and both sides hold only rounding noise; the T = 1 cases run
# without the causal mask, over 70 keys. name: (b, t, s, h, hkv, d, lengths,
# window, causal)
BF16_BWD_CASES = {
    **{name: (*case, True) for name, case in BF16_FWD_CASES.items() if name != "t1"},
    "t1_not_causal": (2, 1, 70, 4, 4, 128, [70, 5], None, False),
    "t1_not_causal_d64": (2, 1, 70, 4, 4, 64, [70, 5], None, False),
    "t63": (2, 63, 63, 4, 4, 128, [63, 40], None, True),
    "t64_d64": (2, 64, 64, 4, 4, 64, [64, 64], None, True),
    "t65": (2, 65, 65, 4, 4, 128, [65, 1], None, True),
    "t1_not_causal_d80": (2, 1, 70, 4, 4, 80, [70, 5], None, False),
    "phi_train_b4_d80": (4, 352, 352, 32, 32, 80, [352, 330, 301, 266], None, True),
}


def _bf16_case(name, device, seed):
    b, t, s, h, hkv, d, lengths, window = (BF16_BWD_CASES.get(name) or BF16_FWD_CASES[name])[:8]
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn((b, t, h, d), generator=g, device=device, dtype=torch.bfloat16)
    k, v = (torch.randn((b, s, hkv, d), generator=g, device=device, dtype=torch.bfloat16) for _ in range(2))
    return q, k, v, torch.tensor(lengths, dtype=torch.int32, device=device), window


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(BF16_FWD_CASES))
def test_flash_bf16_kernel_matches_plain_at_the_edges(cuda_device, name):
    q, k, v, lens, window = _bf16_case(name, cuda_device, seed=13)
    before = flash_attention.launches
    o, lse = flash_attention(q, k, v, lengths=lens, causal=True, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    po, plse = flash_attention_plain(q, k, v, lengths=lens, causal=True, window=window)
    assert torch.isfinite(o).all()
    for i, L in enumerate(lens.tolist()):
        rows = min(L, q.shape[1])
        torch.testing.assert_close(o[i, :rows].float(), po[i, :rows].float(), atol=FWD_ATOL["bfloat16"], rtol=0)
        torch.testing.assert_close(lse[i, :, :rows], plse[i, :, :rows], atol=1e-3, rtol=0)


@pytest.mark.gpu
def test_flash_bf16_dead_cache_slots_holding_nan_stay_out(cuda_device):
    """Key slots at or past `lengths` hold NaN (a preallocated cache): the
    kernel never reads them, so every output row is finite and the valid rows
    equal the plain version on a copy with those slots zeroed."""
    q, k, v, lens, window = _bf16_case("cache_s_gt_t", cuda_device, seed=14)
    for i, L in enumerate(lens.tolist()):
        k[i, L:] = float("nan")
        v[i, L:] = float("nan")
    o, lse = flash_attention(q, k, v, lengths=lens, causal=True, window=window)
    torch.cuda.synchronize()
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    kz, vz = torch.nan_to_num(k), torch.nan_to_num(v)
    po, plse = flash_attention_plain(q, kz, vz, lengths=lens, causal=True, window=window)
    for i, L in enumerate(lens.tolist()):
        rows = min(L, q.shape[1])
        torch.testing.assert_close(o[i, :rows].float(), po[i, :rows].float(), atol=FWD_ATOL["bfloat16"], rtol=0)
        torch.testing.assert_close(lse[i, :, :rows], plse[i, :, :rows], atol=1e-3, rtol=0)


@pytest.mark.gpu
def test_flash_kernel_rejects_unsupported_head_dim(cuda_device):
    q = torch.randn((1, 8, 2, 32), device=cuda_device)
    with pytest.raises(ValueError):
        flash_attention(q, q, q)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_backward_kernels_match_plain(cuda_device, name, dtype):
    b, t, s, h, hkv, d, lengths, window, causal = CASES[name]
    g = torch.Generator(device=cuda_device).manual_seed(4)
    q, do = (torch.randn((b, t, h, d), generator=g, device=cuda_device, dtype=dtype) for _ in range(2))
    k, v = (torch.randn((b, s, hkv, d), generator=g, device=cuda_device, dtype=dtype) for _ in range(2))
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda_device)
    o, lse = flash_attention_plain(q, k, v, lengths=lens, causal=causal, window=window)
    before = (flash_bwd_dq.launches, flash_bwd_dkv.launches)
    got = flash_attention_bwd(q, k, v, o, lse, do, lens, causal, window)
    torch.cuda.synchronize()
    assert (flash_bwd_dq.launches, flash_bwd_dkv.launches) == (before[0] + 1, before[1] + 1)
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, lens, causal, window)
    rtol, atol = GRAD_TOL[str(dtype).replace("torch.", "")]
    for x, y, what in zip(got, want, ("dq", "dk", "dv")):
        assert x.dtype == y.dtype == dtype and x.shape == y.shape, what
        rms = float(y.float().square().mean().sqrt())
        torch.testing.assert_close(x.float(), y.float(), atol=atol * rms, rtol=rtol, msg=what)
    for i, L in enumerate(lengths):  # dead key slots take exactly zero gradient
        assert not got[1][i, L:].any() and not got[2][i, L:].any()


def _check_bf16_backward(got, want, lens):
    """dq, dk, dv against the plain backward under GRAD_TOL, finite, in bf16;
    dead key slots take exactly zero gradient."""
    for x, y, what in zip(got, want, ("dq", "dk", "dv")):
        assert x.dtype == y.dtype == torch.bfloat16 and x.shape == y.shape, what
        assert torch.isfinite(x).all(), what
        assert grad_tolerance_use(x, y) <= 1.0, what
    for i, L in enumerate(lens.tolist()):
        assert not got[1][i, L:].any() and not got[2][i, L:].any()


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(BF16_BWD_CASES))
def test_flash_bf16_backward_kernels_match_plain_at_the_edges(cuda_device, name):
    """The tensor-core dq and dk/dv kernels: T = 1 and under, at and over the
    64-row tile at both head dims, keys longer than queries with lengths
    down to 1, GQA and a window."""
    causal = BF16_BWD_CASES[name][8]
    q, k, v, lens, window = _bf16_case(name, cuda_device, seed=21)
    do = torch.randn(q.shape, generator=torch.Generator(device=cuda_device).manual_seed(22), device=cuda_device,
                     dtype=torch.bfloat16)
    o, lse = flash_attention_plain(q, k, v, lengths=lens, causal=causal, window=window)
    before = (flash_bwd_dq.launches, flash_bwd_dkv.launches)
    got = flash_attention_bwd(q, k, v, o, lse, do, lens, causal, window)
    torch.cuda.synchronize()
    assert (flash_bwd_dq.launches, flash_bwd_dkv.launches) == (before[0] + 1, before[1] + 1)
    _check_bf16_backward(got, flash_attention_bwd_plain(q, k, v, o, lse, do, lens, causal, window), lens)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["cache_s_gt_t", "cache_s_gt_t_d64"])
def test_flash_bf16_backward_dead_cache_slots_holding_nan_stay_out(cuda_device, name):
    """Key slots at or past `lengths` hold NaN: the kernels never read them,
    so dk/dv are exactly zero there, and dq, dk and dv equal the plain
    backward run on a copy with those slots zeroed."""
    q, k, v, lens, window = _bf16_case(name, cuda_device, seed=24)
    do = torch.randn(q.shape, generator=torch.Generator(device=cuda_device).manual_seed(25), device=cuda_device,
                     dtype=torch.bfloat16)
    for i, L in enumerate(lens.tolist()):
        k[i, L:] = float("nan")
        v[i, L:] = float("nan")
    o, lse = flash_attention(q, k, v, lengths=lens, causal=True, window=window)
    got = flash_attention_bwd(q, k, v, o, lse, do, lens, True, window)
    torch.cuda.synchronize()
    kz, vz = torch.nan_to_num(k), torch.nan_to_num(v)
    _check_bf16_backward(got, flash_attention_bwd_plain(q, kz, vz, o, lse, do, lens, True, window), lens)


@pytest.mark.gpu
def test_cuda_flash_output_has_grad_fn(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(5)
    q, k, v = (torch.randn((2, 96, 4, 64), generator=g, device=cuda_device).requires_grad_(True) for _ in range(3))
    counts = (flash_attention.launches, flash_bwd_dq.launches, flash_bwd_dkv.launches)
    o, lse = flash_attention(q, k, v, lengths=torch.tensor([96, 70], device=cuda_device))
    assert o.grad_fn is not None and not lse.requires_grad
    o.float().square().sum().backward()
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_bwd_dq.launches, flash_bwd_dkv.launches) == tuple(c + 1 for c in counts)
    assert all(x.grad is not None and torch.isfinite(x.grad).all() for x in (q, k, v))


@pytest.mark.gpu
def test_remat_policies_agree_through_the_kernels(cuda_device):
    """A 2-layer fp32 decoder with LoRA adapters on the card: no remat, "full"
    and "dots" give the same adapter gradients (atol 1e-5 of max |g|: the
    same kernels on the same inputs), and remat runs each layer's flash
    forward twice."""
    from bridgelang_tpu_torch.models.llm import llama
    from bridgelang_tpu_torch.training.lora import add_lora_params

    cfg = llama.LLMConfig(vocab_size=512, padded_vocab_size=576, dim=256, n_layers=2, n_heads=2, n_kv_heads=1,
                          intermediate_size=512)
    g = torch.Generator(device=cuda_device).manual_seed(6)
    params = add_lora_params(g, llama.init_llm_params(g, cfg, device=cuda_device), rank=8)
    for lp in params["layers"]:
        for k in (k for k in lp if k.endswith("_lora_b")):
            lp[k].normal_(0.0, 0.05, generator=g)
    adapters = [lp[k] for lp in params["layers"] for k in sorted(lp) if "_lora_" in k]
    for a in adapters:
        a.requires_grad_(True)
    b, t = 2, 96
    x = torch.randn((b, t, cfg.dim), generator=g, device=cuda_device)
    pos = torch.arange(t, device=cuda_device).expand(b, t)
    lens = torch.tensor([96, 70], device=cuda_device)
    col = torch.arange(t, device=cuda_device)
    mask = ((col[None, :] <= col[:, None])[None] & (col < lens[:, None, None]))[:, None]

    def grads(remat, policy):
        before = flash_attention.launches
        h, _ = llama.llm_forward(params, cfg, x, pos, mask, lengths=lens, remat=remat, remat_policy=policy)
        out = torch.autograd.grad(h.square().sum(), adapters)
        torch.cuda.synchronize()
        return out, flash_attention.launches - before

    ref, n_ref = grads(False, None)
    assert n_ref == cfg.n_layers
    for policy in ("full", "dots"):
        got, n = grads(True, policy)
        assert n == 2 * cfg.n_layers, policy
        for a, r in zip(got, ref):
            torch.testing.assert_close(a, r, atol=1e-5 * float(r.abs().max()), rtol=0, msg=policy)


# --- the packed-int4 matmul kernels -------------------------------------------------------

# (K, N, group): 7B's wq, w_gate and w_down at group 128, and w_gate at group 256;
# Phi-2's wq, w_up and w_down (20 and 80 groups of 128)
INT4_SHAPES = {**{name: (k, n, 128) for name, (k, n) in INT4_SHAPES_7B.items()},
               "w_gate_g256": (*INT4_SHAPES_7B["w_gate"], 256),
               **{name.replace(" ", "_"): (k, n, 128) for name, (k, n) in INT4_SHAPES_PHI.items()}}


def _int4_weights(k, n, group, device, seed):
    from bridgelang_tpu_torch.ops.quant import _quantize4_2d

    g = torch.Generator(device=device).manual_seed(seed)
    return _quantize4_2d(torch.randn((k, n), generator=g, device=device), group)


def _int4_tolerance_use(got, want, key):
    rtol, atol = INT4_TOL[key]
    w = want.float()
    allowed = (rtol * w.abs() + atol * w.square().mean().sqrt()).clamp_min(torch.finfo(torch.float32).tiny)
    return float(((got.float() - w).abs() / allowed).max())


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 37, 352])
@pytest.mark.parametrize("mode", ["a8", "bfloat16", "float32"])
@pytest.mark.parametrize("shape", sorted(INT4_SHAPES))
def test_int4_kernels_match_plain(cuda_device, shape, mode, m):
    from bridgelang_tpu_torch.ops import int4_matmul as im

    k, n, group = INT4_SHAPES[shape]
    packed, scales = _int4_weights(k, n, group, cuda_device, seed=7)
    g = torch.Generator(device=cuda_device).manual_seed(8)
    x = torch.randn((m, k), generator=g, device=cuda_device)
    before = (im.int4_mm.launches, im.int4_mm_a8.launches)
    if mode == "a8":
        q, _ = im.quantize_activations_per_token(x)
        got = im.int4_mm_a8(q, packed, scales)
        torch.cuda.synchronize()
        want = im.int4_matmul_a8_plain(q, packed, scales)
        assert (im.int4_mm.launches, im.int4_mm_a8.launches) == (before[0], before[1] + 1)
    else:
        x = x.to(getattr(torch, mode))
        got = im.int4_mm(x, packed, scales)
        torch.cuda.synchronize()
        want = im.int4_matmul_plain(x, packed, scales)
        assert (im.int4_mm.launches, im.int4_mm_a8.launches) == (before[0] + 1, before[1])
    assert got.shape == want.shape == (m, n) and got.dtype == want.dtype
    assert torch.isfinite(got).all()
    assert _int4_tolerance_use(got, want, mode) <= 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("m", [128, 129, 5632])
@pytest.mark.parametrize("shape", sorted(INT4_SHAPES))
def test_int4_bf16_pipelined_kernel_matches_plain(cuda_device, shape, m):
    """bf16 at M > 64 runs the pipelined kernel: one full 128-row tile, a
    ragged 129th row, and the QLoRA M (16 x 352)."""
    from bridgelang_tpu_torch.ops import int4_matmul as im

    k, n, group = INT4_SHAPES[shape]
    packed, scales = _int4_weights(k, n, group, cuda_device, seed=15)
    x = torch.randn((m, k), generator=torch.Generator(device=cuda_device).manual_seed(16), device=cuda_device,
                    dtype=torch.bfloat16)
    before = im.int4_mm.launches
    got = im.int4_mm(x, packed, scales)
    torch.cuda.synchronize()
    assert im.int4_mm.launches == before + 1
    want = im.int4_matmul_plain(x, packed, scales)
    assert got.shape == want.shape == (m, n) and got.dtype == torch.bfloat16
    assert torch.isfinite(got).all()
    assert _int4_tolerance_use(got, want, "bfloat16") <= 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("m", [129, 5632])
def test_int4_bf16_pipelined_kernel_reads_blocked_gate_in_place(cuda_device, m):
    """The 2752-wide column blocks of a 2-shard 7B w_gate pack (N/2 = 64 x 43,
    no multiple of 128) through the pipelined kernel, one launch per block."""
    from bridgelang_tpu_torch.ops import int4_matmul as im
    from bridgelang_tpu_torch.ops.quant import _quantize4_2d

    k, n = INT4_SHAPES_7B["w_gate"]
    g = torch.Generator(device=cuda_device).manual_seed(17)
    packed, scales = _quantize4_2d(torch.randn((k, n), generator=g, device=cuda_device), 128, n_shards=2)
    x = torch.randn((m, k), generator=g, device=cuda_device, dtype=torch.bfloat16)
    before = im.int4_mm.launches
    got = im.matmul_int4(x, packed, scales, n_shards=2)
    torch.cuda.synchronize()
    assert im.int4_mm.launches == before + 2 and got.shape == (m, n)
    w2, ns = packed.shape[1] // 2, n // 2
    want = torch.cat([im.int4_matmul_plain(x, packed[:, d * w2:(d + 1) * w2], scales[:, d * ns:(d + 1) * ns])
                      for d in range(2)], dim=1)
    assert _int4_tolerance_use(got, want, "bfloat16") <= 1.0


@pytest.mark.gpu
def test_cuda_int4_never_reaches_the_plain_version(cuda_device, monkeypatch):
    from bridgelang_tpu_torch.ops import int4_matmul as im

    packed, scales = _int4_weights(4096, 4096, 128, cuda_device, seed=9)
    x = torch.randn((5, 4096), device=cuda_device, dtype=torch.bfloat16)

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached a plain version")

    monkeypatch.setattr(im, "_grouped_plain", refuse)
    monkeypatch.setattr(im, "dequant_int4", refuse)
    im.matmul_int4(x, packed, scales)
    im.matmul_int4_a8(x, packed, scales)
    torch.cuda.synchronize()
    coarse = scales.float().repeat_interleave(2, dim=0).to(torch.bfloat16)  # 64 groups of 64 rows: no kernel shape
    assert not im.cuda_kernel_shape_ok(4096, 4096, 64)
    for fn in (im.matmul_int4, im.matmul_int4_a8):  # refused, not routed to a library matmul
        with pytest.raises(ValueError):
            fn(x, packed, coarse)


@pytest.mark.gpu
def test_cuda_int4_reads_a_column_slice_in_place(cuda_device):
    """A column block of a wider pack (row stride of the whole pack) launches
    on the slice itself and equals the kernel on a contiguous copy."""
    from bridgelang_tpu_torch.ops import int4_matmul as im

    packed, scales = _int4_weights(4096, 4096, 128, cuda_device, seed=11)
    x = torch.randn((37, 4096), device=cuda_device, dtype=torch.bfloat16)
    p_view, s_view = packed[:, 1024:], scales[:, 2048:]
    assert not p_view.is_contiguous()
    got = im.int4_mm(x, p_view, s_view)
    want = im.int4_mm(x, p_view.contiguous(), s_view.contiguous())
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("a8", [False, True])
def test_cuda_int4_blocked_7b_gate_launches_once_per_block(cuda_device, a8):
    """7B's w_gate packed for 2 shards: each 5504-wide column block is a
    kernel shape (N/2 = 2752 = 64 x 43) though not the JAX package's (its
    N % 256 rule), so it launches once per block and never falls back."""
    from bridgelang_tpu_torch.ops import int4_matmul as im
    from bridgelang_tpu_torch.ops.quant import _quantize4_2d

    k, n = INT4_SHAPES_7B["w_gate"]
    g = torch.Generator(device=cuda_device).manual_seed(12)
    packed, scales = _quantize4_2d(torch.randn((k, n), generator=g, device=cuda_device), 128, n_shards=2)
    assert im.cuda_kernel_shape_ok(k, n // 2, k // 128) and not im.int4_kernel_eligible(k, n // 2, k // 128)
    x = torch.randn((37, k), generator=g, device=cuda_device)
    x = x if a8 else x.to(torch.bfloat16)  # a8: fp32 x, so the output is the kernel's f32 times the token scale
    wrapper = im.int4_mm_a8 if a8 else im.int4_mm
    before = wrapper.launches
    got = (im.matmul_int4_a8 if a8 else im.matmul_int4)(x, packed, scales, n_shards=2)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 2 and got.shape == (37, n)
    w2 = packed.shape[1] // 2
    blocks = [(packed[:, d * w2:(d + 1) * w2], scales[:, d * (n // 2):(d + 1) * (n // 2)]) for d in range(2)]
    if a8:
        q, xs = im.quantize_activations_per_token(x)
        want = torch.cat([im.int4_matmul_a8_plain(q, p, s) for p, s in blocks], dim=1)
        use = _int4_tolerance_use(got.float() / xs, want, "float32")  # one fp32 rounding each way
    else:
        want = torch.cat([im.int4_matmul_plain(x, p, s) for p, s in blocks], dim=1)
        use = _int4_tolerance_use(got, want, "bfloat16")
    assert use <= 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("a8", [False, True])
def test_cuda_int4_output_has_grad_fn(cuda_device, a8):
    from bridgelang_tpu_torch.ops import int4_matmul as im
    from bridgelang_tpu_torch.ops.quant import dequant_int4

    packed, scales = _int4_weights(4096, 11008, 128, cuda_device, seed=10)
    x = torch.randn((2, 40, 4096), device=cuda_device, dtype=torch.bfloat16, requires_grad=True)
    before = im.int4_mm_a8.launches if a8 else im.int4_mm.launches
    y = (im.matmul_int4_a8 if a8 else im.matmul_int4)(x, packed, scales)
    assert y.grad_fn is not None and y.shape == (2, 40, 11008)
    g = torch.randn_like(y)
    (dx,) = torch.autograd.grad(y, x, g)
    torch.cuda.synchronize()
    assert (im.int4_mm_a8.launches if a8 else im.int4_mm.launches) == before + 1  # the backward launches none
    want = g.float() @ dequant_int4(packed, scales, torch.float32).t()
    torch.testing.assert_close(dx.float(), want, atol=2e-2 * float(want.abs().max()), rtol=2 ** -7)


# --- w4a8: the split-K decode kernel (M <= 16), the wgmma prefill kernel, quantize_a8 ------------

A8_M = [1, 2, 4, 16, 17, 37, 64, 65, 352, 1408]


@pytest.mark.gpu
@pytest.mark.parametrize("group", [128, 256, 512])
@pytest.mark.parametrize("m", A8_M)
def test_int4_a8_kernels_equal_plain(cuda_device, m, group):
    """int4_mm_a8 on 7B's w_gate at every M the two kernels split on:
    integer group sums folded in the plain order, so bit-equal (INT4_TOL
    "a8" use 0)."""
    from bridgelang_tpu_torch.ops import int4_matmul as im

    k, n = INT4_SHAPES_7B["w_gate"]
    packed, scales = _int4_weights(k, n, group, cuda_device, seed=20 + group)
    q = torch.randint(-127, 128, (m, k), device=cuda_device, dtype=torch.int8)
    got = im.int4_mm_a8(q, packed, scales)
    torch.cuda.synchronize()
    want = im.int4_matmul_a8_plain(q, packed, scales)
    assert _int4_tolerance_use(got, want, "a8") <= 1.0
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 16])
@pytest.mark.parametrize("shape", ["wq", "w_down"])
def test_int4_a8_decode_splits_equal_plain(cuda_device, shape, m):
    """The split-K kernel's own split: one that divides wq's 32 groups, and
    one that does not divide w_down's 86 (each column tile's last block
    holds fewer groups)."""
    import ctypes

    from bridgelang_tpu_torch.ops import _build
    from bridgelang_tpu_torch.ops import int4_matmul as im

    k, n = INT4_SHAPES_7B[shape]
    splits = _build.function("int4_matmul", "int4_mm_a8_splits", [ctypes.c_int] * 4)(k, n // 2, 128, 0)
    per_block = -(-(k // 128) // splits)
    assert ((k // 128) % per_block != 0) == (shape == "w_down")
    packed, scales = _int4_weights(k, n, 128, cuda_device, seed=30)
    q = torch.randint(-127, 128, (m, k), device=cuda_device, dtype=torch.int8)
    got = im.int4_mm_a8(q, packed, scales)
    torch.cuda.synchronize()
    assert torch.equal(got, im.int4_matmul_a8_plain(q, packed, scales))


@pytest.mark.gpu
def test_int4_a8_decode_on_two_streams_and_in_a_graph(cuda_device):
    """Split-K launches that run at once keep their tile counters apart:
    one stream's launches beside another's, and two graphs captured on one
    stream, replayed on two side streams beside eager launches on the
    default stream."""
    from bridgelang_tpu_torch.ops import int4_matmul as im

    k, n = INT4_SHAPES_7B["w_down"]
    weights = [_int4_weights(k, n, 128, cuda_device, seed=34 + i) for i in range(2)]
    qs = [torch.randint(-127, 128, (1, k), device=cuda_device, dtype=torch.int8) for _ in range(2)]
    wants = [im.int4_matmul_a8_plain(q, p, s) for q, (p, s) in zip(qs, weights)]
    side = torch.cuda.Stream(cuda_device)
    main = torch.cuda.current_stream(cuda_device)
    side.wait_stream(main)
    eager = []
    for _ in range(20):
        with torch.cuda.stream(side):
            eager.append((1, im.int4_mm_a8(qs[1], *weights[1])))
        eager.append((0, im.int4_mm_a8(qs[0], *weights[0])))
    main.wait_stream(side)
    torch.cuda.synchronize()
    assert all(torch.equal(got, wants[i]) for i, got in eager)

    graphs, captured = [torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()], []
    for i, graph in enumerate(graphs):
        with torch.cuda.graph(graph):
            captured.append(im.int4_mm_a8(qs[i], *weights[i]))
    replays = [torch.cuda.Stream(cuda_device) for _ in graphs]
    outs = []
    for _ in range(20):
        for i, (graph, stream) in enumerate(zip(graphs, replays)):
            stream.wait_stream(main)
            with torch.cuda.stream(stream):
                graph.replay()
                outs.append((i, captured[i].clone()))
        outs.append((0, im.int4_mm_a8(qs[0], *weights[0])))
    for stream in replays:
        main.wait_stream(stream)
    torch.cuda.synchronize()
    assert all(torch.equal(got, wants[i]) for i, got in outs)


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 4, 352])
def test_int4_a8_reads_blocked_gate_in_place(cuda_device, m):
    """The 2-shard w_gate pack: each 5504-wide block read in place (ldp,
    lds of the whole pack) and written into its columns of one output."""
    from bridgelang_tpu_torch.ops import int4_matmul as im
    from bridgelang_tpu_torch.ops.quant import _quantize4_2d

    k, n = INT4_SHAPES_7B["w_gate"]
    g = torch.Generator(device=cuda_device).manual_seed(31)
    packed, scales = _quantize4_2d(torch.randn((k, n), generator=g, device=cuda_device), 128, n_shards=2)
    q = torch.randint(-127, 128, (m, k), device=cuda_device, dtype=torch.int8)
    before = im.int4_mm_a8.launches
    got = im._int4_route_blocked(q, packed, scales, True, 2)
    torch.cuda.synchronize()
    assert im.int4_mm_a8.launches == before + 2
    w2, ns = packed.shape[1] // 2, n // 2
    want = torch.cat([im.int4_matmul_a8_plain(q, packed[:, d * w2:(d + 1) * w2], scales[:, d * ns:(d + 1) * ns])
                      for d in range(2)], dim=1)
    assert torch.equal(got, want)


def _tie_rows(device):
    """Rows on rounding ties: absmax 127 (scale 1) and 254 (scale 2), halves
    elsewhere; torch.round and rint both go to the even code."""
    row = torch.tensor([127.0, 2.5, -2.5, 3.5, 0.5, -0.5, 1.5, -1.5, 126.5, -126.5, 0.0, 64.5] * 341 + [0.0] * 4,
                       device=device)
    return torch.stack([row, 2 * row, -row])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("what", ["random", "zero_rows", "ties", "wide_k", "nan_rows"])
def test_quantize_a8_kernel_equals_plain(cuda_device, what, dtype):
    """Bit-equal codes and scales; a row holding a NaN gets a NaN scale in
    both (its codes are conversions of NaN, not compared)."""
    from bridgelang_tpu_torch.ops import int4_matmul as im
    from bridgelang_tpu_torch.ops.quant import quantize_activations_per_token

    g = torch.Generator(device=cuda_device).manual_seed(32)
    if what == "ties":
        x = _tie_rows(cuda_device)
    else:
        k = 11008 if what == "wide_k" else 4096
        x = torch.randn((352, k), generator=g, device=cuda_device) * torch.rand((352, 1), generator=g,
                                                                                device=cuda_device).mul(50)
        if what == "zero_rows":
            x[::3] = 0
        if what == "nan_rows":
            x[5, 0] = x[9, 4095] = x[11, 777] = float("nan")
    x = x.to(dtype)
    before = im.quantize_a8.launches
    q, xs = im.quantize_a8(x)
    torch.cuda.synchronize()
    assert im.quantize_a8.launches == before + 1
    want_q, want_xs = quantize_activations_per_token(x)
    ok = ~want_xs[:, 0].isnan()
    assert int((~ok).sum()) == (3 if what == "nan_rows" else 0)
    assert torch.equal(xs.isnan(), want_xs.isnan())
    assert torch.equal(q[ok], want_q[ok]) and torch.equal(xs[ok], want_xs[ok])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m", [1, 16, 17, 352])
def test_w4a8_route_is_two_launches_equal_to_plain(cuda_device, m, dtype):
    """matmul_int4_a8 on the card: quantize_a8, then int4_mm_a8 with the
    token scale and the cast in its epilogue, bit-equal to
    (int4_matmul_a8_plain(q) * xs).to(dtype)."""
    from bridgelang_tpu_torch.ops import int4_matmul as im
    from bridgelang_tpu_torch.ops.quant import quantize_activations_per_token

    k, n = INT4_SHAPES_7B["wq"]
    packed, scales = _int4_weights(k, n, 128, cuda_device, seed=33)
    x = torch.randn((m, k), device=cuda_device).to(dtype)
    before = (im.quantize_a8.launches, im.int4_mm_a8.launches)
    got = im.matmul_int4_a8(x, packed, scales)
    torch.cuda.synchronize()
    assert (im.quantize_a8.launches - before[0], im.int4_mm_a8.launches - before[1]) == (1, 1)
    q, xs = quantize_activations_per_token(x)
    assert got.dtype == dtype and torch.equal(got, (im.int4_matmul_a8_plain(q, packed, scales) * xs).to(dtype))


# --- the int8 weight-only GEMV ---------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 8])
@pytest.mark.parametrize("shape", sorted(INT8_GEMV_SHAPES))
def test_int8_gemv_matches_plain(cuda_device, shape, m):
    """Mistral-7B's projection shapes and its int8 head, at a decode token
    (M = 1) and a batch of 8: one launch each, the unscaled product within
    one bf16 ulp plus 1e-3 rms of the plain version, the scaled one its
    epilogue's bits."""
    from bridgelang_tpu_torch.ops.int8_matmul import int8_gemv, int8_gemv_plain

    k, n = INT8_GEMV_SHAPES[shape]
    g = torch.Generator(device=cuda_device).manual_seed(11)
    w = torch.randint(-128, 128, (n, k), generator=g, device=cuda_device, dtype=torch.int8)
    scale = (torch.rand((n,), generator=g, device=cuda_device) * 0.02 + 1e-3).to(torch.bfloat16)
    x = torch.randn((m, k), generator=g, device=cuda_device, dtype=torch.bfloat16)
    before = int8_gemv.launches
    raw, scaled = int8_gemv(x, w), int8_gemv(x[None], w, scale)[0]
    torch.cuda.synchronize()
    assert int8_gemv.launches == before + 2
    assert raw.dtype == scaled.dtype == torch.bfloat16 and raw.shape == (m, n)
    assert _int4_tolerance_use(raw, int8_gemv_plain(x, w), "bfloat16") <= 1.0
    assert torch.equal(scaled, (raw.float() * scale.float()).to(torch.bfloat16))


@pytest.mark.gpu
def test_int8_gemv_refuses_what_it_cannot_take(cuda_device):
    from bridgelang_tpu_torch.ops.int8_matmul import int8_gemv

    w = torch.zeros((64, 256), device=cuda_device, dtype=torch.int8)
    x = torch.zeros((17, 256), device=cuda_device, dtype=torch.bfloat16)
    for bad_x, bad_w in ((x, w), (x[:1].float(), w), (x[:1, :200], w[:, :200]), (x[:1], w.float())):
        with pytest.raises(ValueError):
            int8_gemv(bad_x, bad_w)


# --- predicts replayed as CUDA graphs (models/graphs.py) -----------------------------
# A depth-cut OpenVLA at a small width (2 decoder layers of 512, one 32 px tower)
# on the card: replayed graphs must give the eager path's ids exactly (the same
# kernels on the same inputs), and add to the launch counts what eager launches.

WEIGHT_KINDS = ("bf16", "int8", "int4")
SMALL_STATS = {"bridge_orig": {"action": {"q01": [-0.1] * 7, "q99": [0.1] * 7, "mask": [True] * 6 + [False]}}}
GRAPH_INSTRUCTIONS = ["pick up the red block", "open the drawer", "put the spoon on the towel", "move the cup"]


def _small_vla(kind):
    import dataclasses

    from bridgelang_tpu_torch.models.llm.llama import LLMConfig
    from bridgelang_tpu_torch.models.llm.tokenizer import ByteFallbackTokenizer
    from bridgelang_tpu_torch.models.vision.vit import ViTConfig
    from bridgelang_tpu_torch.models.vla import OpenVLA
    from bridgelang_tpu_torch.models.vlm import VLMConfig
    from bridgelang_tpu_torch.ops.image_ops import ImageTowerSpec, ImageTransformConfig
    from bridgelang_tpu_torch.ops.quant import quantize_llm_int4, quantize_llm_int8

    llm = LLMConfig(dim=512, n_layers=2, n_heads=4, n_kv_heads=4, intermediate_size=1024, w8a8=kind != "bf16")
    vit = ViTConfig(image_size=32, patch_size=8, width=64, depth=2, num_heads=4, mlp_dim=128)
    cfg = dataclasses.replace(VLMConfig(), llm=llm, vision_override=vit)
    model = OpenVLA(cfg, SMALL_STATS, tokenizer=ByteFallbackTokenizer(), dtype=torch.bfloat16, device="cuda")
    model.image_transform = ImageTransformConfig("resize-naive", (ImageTowerSpec(size=32),))
    params = model.init_params(torch.Generator(device="cuda").manual_seed(0))
    if kind == "int8":
        params = dict(params, llm=quantize_llm_int8(params["llm"]))
    elif kind == "int4":
        params = dict(params, llm=quantize_llm_int4(params["llm"], group=128))
    return model, params


def _small_frames(n, seed):
    import numpy as np

    return list(np.random.default_rng(seed).integers(0, 256, size=(n, 32, 32, 3), dtype=np.uint8))


def _counts():
    from bridgelang_tpu_torch.models.graphs import counted_wrappers

    return [fn.launches for fn in counted_wrappers()]


def _run(model, use_graphs, fn):
    """fn() with graphs on or off -> (its result, the launches it added)."""
    model.use_graphs = use_graphs
    before = _counts()
    out = fn()
    torch.cuda.synchronize()
    return out, [a - b for a, b in zip(_counts(), before)]


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("kind", WEIGHT_KINDS)
def test_graph_predict_ids_and_launches_equal_eager(cuda_device, kind, batch):
    import numpy as np

    model, params = _small_vla(kind)
    imgs, instr = _small_frames(batch, seed=1), GRAPH_INSTRUCTIONS[:batch]
    call = lambda: model.predict_action_batch(params, imgs, instr, return_tokens=True)  # noqa: E731
    (e_act, e_tok), e_launch = _run(model, False, call)
    _run(model, True, call)  # warm-up and capture
    (g_act, g_tok), g_launch = _run(model, True, call)
    np.testing.assert_array_equal(g_tok, e_tok)
    np.testing.assert_array_equal(g_act, e_act)
    assert g_launch == e_launch and g_launch[0] == 2  # flash_fwd: the prefill of each of 2 layers
    if kind == "int4":
        assert g_launch[3] == g_launch[5] == 7 * 2 * 7  # int4_mm_a8, quantize_a8: 7 x 2 layers x 7 passes
    # int8_gemv: int8, 6 decode steps of 7 x 2 projections and the head, and the prefill's head row; int4, the
    # int8 head of each of the 7 passes
    assert g_launch[6] == {"bf16": 0, "int8": 6 * (7 * 2 + 1) + 1, "int4": 7}[kind]
    assert len(model.graphs.entries) == 1


@pytest.mark.gpu
@pytest.mark.parametrize("draft_kind", ["perfect", "garbage", "partial", "mid_mismatch"])
@pytest.mark.parametrize("kind", WEIGHT_KINDS)
def test_graph_speculative_equals_eager(cuda_device, kind, draft_kind):
    import numpy as np

    model, params = _small_vla(kind)
    img = _small_frames(1, seed=2)[0]
    greedy = model.predict_action_batch(params, [img], [GRAPH_INSTRUCTIONS[0]], return_tokens=True)[1][0]
    draft = {"perfect": greedy.copy(), "garbage": np.full(7, 3, np.int32),
             "partial": np.concatenate([greedy[:4], [7, 7, 7]]).astype(np.int32),
             "mid_mismatch": np.where(np.arange(7) == 2, greedy + 1, greedy).astype(np.int32)}[draft_kind]
    call = lambda: model._host_predict("speculative", params, [img], [GRAPH_INSTRUCTIONS[0]], None,  # noqa: E731
                                       draft_tokens=draft, margin_threshold=0.0)
    eager, e_launch = _run(model, False, call)
    _run(model, True, call)
    graph, g_launch = _run(model, True, call)
    for g, e in zip(graph, eager):  # actions, ids, accepted counts
        np.testing.assert_array_equal(g, e)
    # flash_fwd runs the prefill only: the verify chunk and the fix-up steps attend through the cache. How
    # many drafted tokens a perfect draft keeps at margin 0 depends on bf16 ties between the T=7 chunk and
    # decode; graph and eager agree on it above.
    assert g_launch == e_launch and g_launch[0] == 2
    # at margin 0.25 the graph's ids stay the graph's greedy ids
    tokens = model.predict_action_speculative(params, img, GRAPH_INSTRUCTIONS[0], draft)[1]
    np.testing.assert_array_equal(tokens, greedy)


@pytest.mark.gpu
def test_graph_replays_read_the_new_inputs(cuda_device):
    """Two replays of one graph with different frames and instructions give
    each input's eager answer: the static buffers are rewritten."""
    import numpy as np

    model, params = _small_vla("bf16")
    a, b = _small_frames(2, seed=3)
    answers = {}
    for use_graphs in (False, True, True):
        model.use_graphs = use_graphs
        for name, img, instr in (("a", a, GRAPH_INSTRUCTIONS[0]), ("b", b, GRAPH_INSTRUCTIONS[2])):
            got = model.predict_action_batch(params, [img], [instr], return_tokens=True)[1]
            answers.setdefault(name, got)
            np.testing.assert_array_equal(got, answers[name])
    assert len(model.graphs.entries) == 1  # both prompts pad to one bucket: one graph
    assert not np.array_equal(answers["a"], answers["b"])


@pytest.mark.gpu
def test_graph_parallel_decode_equals_eager_without_flash(cuda_device):
    import numpy as np

    model, params = _small_vla("bf16")
    model.parallel_decode = True
    img = _small_frames(1, seed=4)[0]
    call = lambda: model.predict_action_chunk(params, img, GRAPH_INSTRUCTIONS[1], horizon=3)  # noqa: E731
    eager, e_launch = _run(model, False, call)
    _run(model, True, call)
    graph, g_launch = _run(model, True, call)
    assert graph.shape == (3, 7) and np.isfinite(graph).all()
    np.testing.assert_array_equal(graph, eager)
    assert g_launch == e_launch and g_launch[0] == 0  # the general mask never reaches flash_fwd


@pytest.mark.gpu
def test_graph_captured_by_an_ended_thread_stays_valid(cuda_device):
    """A server thread captures a key's graph on its first request and then
    ends; after another model's capture and a release of the allocator's
    cached memory, a replay from this thread still gives the eager ids. (The
    fault this guards against, a graph leaning on a cuBLAS workspace outside
    its pool, showed in the smoke's load-then-serve sequence at the 7B; this
    small model has not reproduced it.)"""
    import threading

    import numpy as np

    model, params = _small_vla("bf16")
    img = _small_frames(1, seed=6)[0]
    model.use_graphs = False
    eager = model.predict_action_batch(params, [img], [GRAPH_INSTRUCTIONS[0]], return_tokens=True)[1]
    model.use_graphs = True
    worker = threading.Thread(target=model.predict_action_batch, args=(params, [img], [GRAPH_INSTRUCTIONS[0]]))
    worker.start()
    worker.join(timeout=600)
    assert not worker.is_alive() and len(model.graphs.entries) == 1
    other, other_params = _small_vla("bf16")  # another model's capture in between
    other.predict_action(other_params, img, GRAPH_INSTRUCTIONS[1])
    other.graphs.clear()
    del other, other_params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    got = model.predict_action_batch(params, [img], [GRAPH_INSTRUCTIONS[0]], return_tokens=True)[1]
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got, eager)


@pytest.mark.gpu
def test_new_params_drop_the_graphs(cuda_device):
    model, params = _small_vla("bf16")
    img = _small_frames(1, seed=5)[0]
    model.predict_action(params, img, "x")
    assert len(model.graphs.entries) == 1 and model.graphs.params is params
    other = dict(params)
    model.predict_action(other, img, "x")
    assert len(model.graphs.entries) == 1 and model.graphs.params is other


# --- DeepSeek-V2: the routed experts and the flash forward's (192, 128) instance ---------------------------


def _moe_weights(e, d, i, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    router = (torch.randn((e, d), generator=g, device=device) * d ** -0.5).bfloat16()
    wg, wu = ((torch.randn((e, i, d), generator=g, device=device) * d ** -0.5).bfloat16() for _ in range(2))
    wd = (torch.randn((e, d, i), generator=g, device=device) * i ** -0.5).bfloat16()
    return router, wg, wu, wd


@pytest.mark.gpu
@pytest.mark.parametrize("m, norm", [(1, False), (5, True), (352, False)])
def test_moe_experts_match_plain(cuda_device, m, norm):
    from bridgelang_tpu_torch.ops.moe import moe_experts, moe_experts_plain

    e, k, d, i = DSV2["E"], DSV2["K"], DSV2["D"], DSV2["I"]
    router, wg, wu, wd = _moe_weights(e, d, i, cuda_device, seed=m)
    x = torch.randn((m, d), device=cuda_device).bfloat16()
    load, want_load = (torch.zeros(e, dtype=torch.int32, device=cuda_device) for _ in range(2))
    before = moe_experts.launches
    got = moe_experts(x, router, wg, wu, wd, k, norm, 1.0, load)
    want = moe_experts_plain(x, router, wg, wu, wd, k, norm, 1.0, want_load).float()
    assert moe_experts.launches == before + 5 and torch.equal(load, want_load) and int(load.sum()) == m * k
    rtol, atol = MOE_TOL
    allowed = rtol * want.abs() + atol * want.square().mean().sqrt()
    assert float(((got.float() - want).abs() / allowed).max()) <= 1.0


@pytest.mark.gpu
def test_moe_experts_replay_in_a_graph_without_the_plain_version(cuda_device, monkeypatch):
    from bridgelang_tpu_torch.ops import moe

    router, wg, wu, wd = _moe_weights(8, 128, 64, cuda_device, seed=3)
    x = torch.randn((40, 128), device=cuda_device).bfloat16()
    monkeypatch.setattr(moe, "moe_experts_plain", lambda *a, **k: pytest.fail("a CUDA tensor took the plain path"))
    load = torch.zeros(8, dtype=torch.int32, device=cuda_device)
    eager = moe.moe_experts(x, router, wg, wu, wd, 3, False, 1.0, load)
    graph, side = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.graph(graph, stream=side):
        replayed = moe.moe_experts(x, router, wg, wu, wd, 3, False, 1.0, load)
    load.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(replayed, eager) and int(load.sum()) == 120


@pytest.mark.gpu
def test_moe_experts_refuse_what_they_cannot_take(cuda_device):
    from bridgelang_tpu_torch.ops.moe import moe_experts

    router, wg, wu, wd = _moe_weights(8, 128, 64, cuda_device, seed=1)
    with pytest.raises(ValueError):
        moe_experts(torch.zeros((2, 128), device=cuda_device), router, wg, wu, wd, 3)  # fp32 x
    with pytest.raises(ValueError):
        moe_experts(torch.zeros((2, 96), device=cuda_device).bfloat16(), router[:, :96].contiguous(), wg, wu, wd, 3)


@pytest.mark.gpu
@pytest.mark.parametrize("b, t, lengths", [(1, 352, [331]), (2, 130, [130, 70])])
def test_flash_split_head_dims_match_plain(cuda_device, b, t, lengths):
    g = torch.Generator(device=cuda_device).manual_seed(t)
    q, k = (torch.randn((b, t, 16, 192), generator=g, device=cuda_device).bfloat16() for _ in range(2))
    v = torch.randn((b, t, 16, 128), generator=g, device=cuda_device).bfloat16()
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda_device)
    o, lse = flash_attention(q, k, v, lengths=lens, scale=DSV2["SCALE"])
    po, plse = flash_attention_plain(q, k, v, lengths=lens, scale=DSV2["SCALE"])
    assert o.shape == (b, t, 16, 128)
    for i, n in enumerate(lengths):
        torch.testing.assert_close(o[i, :n].float(), po[i, :n].float(), atol=FWD_ATOL["bfloat16"], rtol=0)
        torch.testing.assert_close(lse[i, :, :n], plse[i, :, :n], atol=1e-3, rtol=0)
    with pytest.raises(ValueError):  # (192, 64) is no instance
        flash_attention(q, k, v[..., :64].contiguous())
