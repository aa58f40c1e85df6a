"""The port's CUDA sources on the CPU: csrc/flash_fwd.cu, csrc/flash_bwd.cu
and csrc/int4_matmul.cu compiled with g++ against tests/cuda_emu/cuda_emu.h
(an emulation of the cp.async, ldmatrix, mma.sync, wgmma and warp
primitives they use) and held against their plain torch versions.

The kernels themselves run only on the card (tests/test_torch_kernels_gpu.py,
chip_smoke.py). This file checks their index math, masks and tile bounds
without one: the bf16 tensor-core kernels (the backward's P and dS as bf16
hi + lo pairs included) and the fp32 FMA kernels, at small shapes that cross
the 64-row tiles, GQA, keys longer than queries, lengths down to 1, a window,
no causal mask, and NaN in dead key slots, at head dims 64, 80 and 128. The emulated mma sums in another
order than the tensor cores, so the rules are the card's: the forward's o
within FWD_ATOL and lse within 1e-3 on valid rows; the backward per element
under GRAD_TOL (grad_tolerance_use <= 1), dead key slots exactly zero.
The bf16 kernels' fp32 outputs (`out_dtype`, what the ring launches): o,
dq, dk and dv written in fp32 at T = S = 72, GQA, head dims 64, 80 and 128,
full and causal, against the plain versions with the same out_dtype under
the bf16 inputs' rules. The ring attention's blocks (ops/ring_attention.py
with the emulated kernels behind its wrappers): a full block and a causal
diagonal block at T = S = 72, and a ring of two such blocks forward and
backward: o against the whole sequence's; the gradients given the whole
sequence's o and lse against the whole sequence's backward, and the ring's
own (from its fp32 o) against JAX's arithmetic, the plain whole-sequence
forward and backward on the inputs upcast to fp32, cast to bf16 once.

The w4a8 kernels of csrc/int4_matmul.cu (the split-K decode kernel and the
wgmma prefill kernel) and its activation quantization sum integers, so the
rule there is bit equality with int4_matmul_a8_plain and
quantize_activations_per_token: M from 1 to 130, groups 128 and 256, splits
that do not divide the group count (the C function's split_groups), a
column block of a wider pack written into a column block of a wider output,
the fused token scale in bf16 and f32, zero rows and rounding ties; a row
holding a NaN gets a NaN scale, as in the plain version; a K shard
quantized with a given (the whole row's) absmax.

The int8 weight-only GEMV (csrc/int8_matmul.cu) against int8_gemv_plain at
M of 1, 3, 8 and 16 (one and two 8-row halves of the mma's x operand), K of
16, 80 and 4112 (a partial 128-k step; 33 steps through a 6-slot ring), N
ragged against the 8-row groups and N = 1024, at each of the block shapes
the launcher picks (1, 2, 4 and 8 row groups, and blocks that walk several
units of rows): the unscaled product under INT4_TOL's
bf16 rule (one bf16 ulp plus 1e-3 rms; the sums differ in fp32 order only),
and the scaled one bit-equal to bf16(that product * scale), the epilogue's
arithmetic. Skips without g++.
"""

import contextlib
import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from bridgelang_tpu_torch.ops.flash_attention import flash_attention_bwd_plain, flash_attention_plain
from bridgelang_tpu_torch.ops.int4_matmul import _SIGNATURES, int4_matmul_a8_plain
from bridgelang_tpu_torch.ops.int8_matmul import _SIGNATURE as INT8_GEMV_SIGNATURE
from bridgelang_tpu_torch.ops.int8_matmul import int8_gemv_plain
from bridgelang_tpu_torch.ops.quant import pack_int4, quantize_activations_per_token

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from chip_smoke import FWD_ATOL, INT4_TOL, grad_tolerance_use, jax_arithmetic_ring_reference  # noqa: E402

CSRC = ROOT / "bridgelang_tpu_torch" / "csrc"
EMU = Path(__file__).resolve().parent / "cuda_emu"
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# name: (b, t, s, h, hkv, d, lengths, window, causal, dtype)
CASES = {
    "ragged_gqa": (2, 130, 130, 2, 1, 64, [130, 70], None, True, torch.bfloat16),
    "ragged_gqa_fp32": (2, 130, 130, 2, 1, 64, [130, 70], None, True, torch.float32),
    "t63": (2, 63, 63, 2, 2, 64, [63, 40], None, True, torch.bfloat16),
    "t64_d128": (1, 64, 64, 2, 2, 128, [64], None, True, torch.bfloat16),
    "keys_longer_len1": (2, 65, 130, 2, 2, 64, [64, 1], None, True, torch.bfloat16),
    "window100": (1, 200, 256, 2, 1, 64, [190], 100, True, torch.bfloat16),
    "t1_not_causal_d128": (2, 1, 70, 2, 2, 128, [70, 5], None, False, torch.bfloat16),
    "window30_not_causal_d128": (1, 140, 140, 2, 2, 128, [140], 30, False, torch.bfloat16),
    # Phi-2's head dim: 10 chunks of 16 bytes per row, the swizzle's tail chunks
    "ragged_d80": (2, 130, 130, 2, 2, 80, [130, 70], None, True, torch.bfloat16),
    "gqa_d80_fp32": (2, 70, 70, 4, 2, 80, [70, 33], None, True, torch.float32),
    "window20_keys_longer_gqa_d80": (1, 100, 140, 2, 1, 80, [120], 20, True, torch.bfloat16),
}


def _without_ptx(text: str) -> str:
    """`text` without its inline-PTX helpers (each blank-line-separated chunk
    holding `asm volatile`): cuda_emu.h defines their emulated twins."""
    return "\n\n".join(chunk for chunk in text.split("\n\n") if "asm volatile" not in chunk)


def _emulated_source(name: str) -> str:
    """csrc/<name>.cu with bf16_mma.cuh inlined, the inline-PTX helpers of
    both taken from cuda_emu.h, dynamic shared memory as the block's buffer
    and each launch run through emu_launch."""
    helpers = _without_ptx((CSRC / "bf16_mma.cuh").read_text()).replace("#pragma once\n", "")
    src = _without_ptx((CSRC / f"{name}.cu").read_text().replace('#include "bf16_mma.cuh"', helpers))
    src = src.replace("#include <cuda_bf16.h>\n#include <cuda_runtime.h>\n", '#include "cuda_emu.h"\n')
    src = re.sub(r"extern __shared__ (?:__align__\(\d+\) )?(\w+) (\w+)\[\];",
                 r"\1* \2 = reinterpret_cast<\1*>(emu_smem);", src)
    launches = src.count("<<<")
    src, n = re.subn(r"(\w+(?:<[^<>]*>)?)<<<([^,]+), ([\w:]+), ([\w:]+), \w+>>>\(((?:.|\n)*?)\);\n"
                     r"(\s*return (?:\(int\))?cudaGetLastError)",
                     r"emu_launch(\2, \3, \4, [&] { \1(\5); });\n\6", src)
    assert n == launches > 0, f"{name}: rewrote {n} of {launches} launches"
    return src


@pytest.fixture(scope="module")
def libraries(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the emulated kernels")
    out = tmp_path_factory.mktemp("cuda_emu")
    jobs = {}
    for name in ("flash_fwd", "flash_bwd", "int4_matmul", "int8_matmul"):
        cpp = out / f"{name}.cpp"
        cpp.write_text(_emulated_source(name))
        cmd = [gxx, "-std=c++20", "-O2", "-fno-strict-aliasing", "-shared", "-fPIC", "-w",
               "-I", str(EMU), "-o", str(out / f"{name}.so"), str(cpp)]
        jobs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, job in jobs.items():
        log, _ = job.communicate()
        assert job.returncode == 0, log
        libs[name] = ctypes.CDLL(str(out / f"{name}.so"))
    return libs


@pytest.fixture(scope="module")
def emulated(libraries):
    fwd, dq, dkv = libraries["flash_fwd"].flash_fwd, libraries["flash_bwd"].flash_bwd_dq, libraries["flash_bwd"].flash_bwd_dkv
    for fn, n_ptrs in ((fwd, 6), (dq, 8), (dkv, 9)):
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 10 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fwd, dq, dkv


def _case(name, seed):
    b, t, s, h, hkv, d, lengths, window, causal, dtype = CASES[name]
    g = torch.Generator().manual_seed(seed)
    q, do = (torch.randn((b, t, h, d), generator=g).to(dtype) for _ in range(2))
    k, v = (torch.randn((b, s, hkv, d), generator=g).to(dtype) for _ in range(2))
    dims = [b, t, s, h, hkv, d, DTYPE_CODES[dtype], DTYPE_CODES[dtype], int(causal), int(window or 0)]
    return q, k, v, do, torch.tensor(lengths, dtype=torch.int32), window, causal, dims


@pytest.mark.parametrize("name", sorted(CASES))
def test_emulated_flash_forward_matches_plain(emulated, name):
    fwd, _, _ = emulated
    q, k, v, _, lens, window, causal, dims = _case(name, seed=31)
    o = torch.full_like(q, float("nan"))
    lse = torch.full(q.shape[:1] + (q.shape[2], q.shape[1]), float("nan"))
    assert fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(), o.data_ptr(), lse.data_ptr(), *dims,
               q.shape[3] ** -0.5, None) == 0
    po, plse = flash_attention_plain(q, k, v, lengths=lens, causal=causal, window=window)
    for i, L in enumerate(lens.tolist()):
        rows = min(L, q.shape[1])
        torch.testing.assert_close(o[i, :rows].float(), po[i, :rows].float(), atol=FWD_ATOL[str(q.dtype)[6:]],
                                   rtol=0)
        torch.testing.assert_close(lse[i, :, :rows], plse[i, :, :rows], atol=1e-3, rtol=0)


@pytest.mark.parametrize("nan_in_dead_slots", [False, True])
@pytest.mark.parametrize("name", sorted(CASES))
def test_emulated_flash_backward_matches_plain(emulated, name, nan_in_dead_slots):
    _, dq_fn, dkv_fn = emulated
    q, k, v, do, lens, window, causal, dims = _case(name, seed=32)
    o, lse = flash_attention_plain(q, k, v, lengths=lens, causal=causal, window=window)
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, lens, causal, window)
    if nan_in_dead_slots:
        for i, L in enumerate(lens.tolist()):
            k[i, L:] = float("nan")
            v[i, L:] = float("nan")
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    dq, dk, dv = (torch.full_like(x, float("nan")) for x in (q, k, v))
    ptrs = [x.data_ptr() for x in (q, k, v, do, lse, delta, lens)]
    scale = q.shape[3] ** -0.5
    assert dq_fn(*ptrs, dq.data_ptr(), *dims, scale, None) == 0
    assert dkv_fn(*ptrs, dk.data_ptr(), dv.data_ptr(), *dims, scale, None) == 0
    for got, w, what in zip((dq, dk, dv), want, ("dq", "dk", "dv")):
        assert torch.isfinite(got).all(), what
        assert grad_tolerance_use(got, w) <= 1.0, what
    for i, L in enumerate(lens.tolist()):
        assert not dk[i, L:].any() and not dv[i, L:].any()


# --- the ring's blocks ----------------------------------------------------------------


@pytest.fixture
def emulated_ring(emulated):
    """A context in which ops/ring_attention.py runs the emulated kernels in
    place of the card's: its block functions take the CUDA route (every key
    valid, the wrappers' argument order) on CPU tensors."""
    from bridgelang_tpu_torch.ops import ring_attention as ra

    fwd, dq_fn, dkv_fn = emulated

    def dims(q, k, causal, out_dtype):
        b, t, h, d = q.shape
        return [b, t, k.shape[1], h, k.shape[2], d, DTYPE_CODES[q.dtype], DTYPE_CODES[out_dtype or q.dtype],
                int(causal), 0]

    def launch(q, k, v, lengths, causal, window, out_dtype=None):
        assert window is None
        o = torch.full_like(q, float("nan"), dtype=out_dtype or q.dtype)
        lse = torch.full((q.shape[0], q.shape[2], q.shape[1]), float("nan"))
        assert fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(), o.data_ptr(), lse.data_ptr(),
                   *dims(q, k, causal, out_dtype), q.shape[3] ** -0.5, None) == 0
        return o, lse

    def bwd_ptrs(q, k, v, do, lse, delta, lengths):
        assert lse.is_contiguous() and delta.is_contiguous() and delta.dtype == torch.float32
        return [x.data_ptr() for x in (q, k, v, do, lse, delta, lengths)]

    def dq(q, k, v, do, lse, delta, lengths, causal=True, window=None, out_dtype=None):
        out = torch.full_like(q, float("nan"), dtype=out_dtype or q.dtype)
        assert dq_fn(*bwd_ptrs(q, k, v, do, lse, delta, lengths), out.data_ptr(), *dims(q, k, causal, out_dtype),
                     q.shape[3] ** -0.5, None) == 0
        return out

    def dkv(q, k, v, do, lse, delta, lengths, causal=True, window=None, out_dtype=None):
        dk, dv = (torch.full_like(x, float("nan"), dtype=out_dtype or x.dtype) for x in (k, v))
        assert dkv_fn(*bwd_ptrs(q, k, v, do, lse, delta, lengths), dk.data_ptr(), dv.data_ptr(),
                      *dims(q, k, causal, out_dtype), q.shape[3] ** -0.5, None) == 0
        return dk, dv

    @contextlib.contextmanager
    def on():
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(ra, "_device", lambda x: "cuda")
            mp.setattr(ra, "_launch", launch)
            mp.setattr(ra, "flash_bwd_dq", dq)
            mp.setattr(ra, "flash_bwd_dkv", dkv)
            yield

    return on


@pytest.mark.parametrize("causal", [False, True], ids=["full_block", "diagonal_block"])
def test_emulated_ring_block_matches_plain(emulated_ring, causal):
    """One block at T = S = 72 (a ring of 144 tokens over 2 ranks): the full
    (non-causal) block and the causal diagonal block, against the plain
    forward."""
    from bridgelang_tpu_torch.ops import ring_attention as ra

    g = torch.Generator().manual_seed(41)
    q = torch.randn((2, 72, 4, 64), generator=g).to(torch.bfloat16)
    k, v = (torch.randn((2, 72, 2, 64), generator=g).to(torch.bfloat16) for _ in range(2))
    with emulated_ring():
        o, lse = ra.block_forward(q, k, v, causal)
    po, plse = flash_attention_plain(q, k, v, causal=causal, out_dtype=torch.float32)
    assert o.dtype == torch.float32
    torch.testing.assert_close(o, po, atol=FWD_ATOL["bfloat16"], rtol=0)
    torch.testing.assert_close(lse, plse, atol=1e-3, rtol=0)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "not_causal"])
def test_emulated_ring_matches_the_whole_sequence(emulated_ring, causal):
    """The virtual ring of 2 blocks of 72 through the emulated kernels (full
    and diagonal blocks forward with fp32 o, merged in fp32; both backward
    kernels of each block with fp32 outputs, given the whole sequence's lse
    and delta, not the block's own) against the whole sequence (GQA 4 over 2
    heads, bf16): o, cast once, within FWD_ATOL and lse 1e-3 of the whole
    sequence's; the gradients given the whole sequence's o and lse against
    the whole sequence's plain backward, and the ring's own (its fp32 o and
    lse) against JAX's arithmetic (chip_smoke.jax_arithmetic_ring_reference),
    each under GRAD_TOL per element."""
    from bridgelang_tpu_torch.ops import ring_attention as ra

    g = torch.Generator().manual_seed(42)
    q, do = (torch.randn((1, 144, 4, 64), generator=g).to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn((1, 144, 2, 64), generator=g).to(torch.bfloat16) for _ in range(2))
    po, plse = flash_attention_plain(q, k, v, causal=causal)
    with emulated_ring():
        o, lse = ra.virtual_ring_forward(q, k, v, 2, causal)
    torch.testing.assert_close(o.to(q.dtype).float(), po.float(), atol=FWD_ATOL["bfloat16"], rtol=0)
    torch.testing.assert_close(lse, plse, atol=1e-3, rtol=0)
    whole = flash_attention_bwd_plain(q, k, v, po, plse, do, causal=causal)
    jax_o, _, jax_grads = jax_arithmetic_ring_reference(q, k, v, do, causal)
    torch.testing.assert_close(o.to(q.dtype).float(), jax_o.float(), atol=FWD_ATOL["bfloat16"], rtol=0)
    for fo, flse, want in ((po, plse, whole), (o, lse, jax_grads)):
        with emulated_ring():
            got = ra.virtual_ring_backward(q, k, v, fo, flse, do, 2, causal)
        for a, w, what in zip(got, want, ("dq", "dk", "dv")):
            assert a.dtype == torch.bfloat16 and torch.isfinite(a).all(), what
            assert grad_tolerance_use(a, w) <= 1.0, what


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("d", [64, 80, 128])
def test_emulated_flash_fp32_outputs_match_plain(emulated_ring, d, causal):
    """The bf16 kernels with fp32 outputs (out_dtype, the ring's blocks) at
    T = S = 72, GQA 4 over 2 heads, against the plain versions with the
    same out_dtype: o within FWD_ATOL["bfloat16"], lse 1e-3, dq/dk/dv under
    GRAD_TOL's bf16 rule (the error is the bf16 operands', not the output's
    rounding)."""
    from bridgelang_tpu_torch.ops import ring_attention as ra

    g = torch.Generator().manual_seed(43 + d)
    q, do = (torch.randn((2, 72, 4, d), generator=g).to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn((2, 72, 2, d), generator=g).to(torch.bfloat16) for _ in range(2))
    f32 = torch.float32
    lengths = torch.full((2,), 72, dtype=torch.int32)
    po, plse = flash_attention_plain(q, k, v, causal=causal, out_dtype=f32)
    want = flash_attention_bwd_plain(q, k, v, po, plse, do, causal=causal, out_dtype=f32)
    with emulated_ring():
        o, lse = ra._launch(q, k, v, lengths, causal, None, out_dtype=f32)
        delta = ra.row_delta(po, do)
        got = (ra.flash_bwd_dq(q, k, v, do, plse, delta, lengths, causal, out_dtype=f32),
               *ra.flash_bwd_dkv(q, k, v, do, plse, delta, lengths, causal, out_dtype=f32))
    assert o.dtype == f32 and all(x.dtype == f32 for x in got)
    torch.testing.assert_close(o, po, atol=FWD_ATOL["bfloat16"], rtol=0)
    torch.testing.assert_close(lse, plse, atol=1e-3, rtol=0)
    for a, w, what in zip(got, want, ("dq", "dk", "dv")):
        assert torch.isfinite(a).all(), what
        assert grad_tolerance_use(a, w, rule="bfloat16") <= 1.0, what


# --- w4a8: int4_mm_a8 and quantize_a8 ------------------------------------------------

@pytest.fixture(scope="module")
def emulated_a8(libraries):
    lib = libraries["int4_matmul"]
    mm, qz, splits = lib.int4_mm_a8, lib.quantize_a8, lib.int4_mm_a8_splits
    mm.argtypes, qz.argtypes = _SIGNATURES["int4_mm_a8"], _SIGNATURES["quantize_a8"]
    splits.argtypes = [ctypes.c_int] * 4
    for fn in (mm, qz, splits):
        fn.restype = ctypes.c_int
    return mm, qz, splits


def _a8_operands(m, k, n2, group, seed, n_shards=1):
    """int8 q [M, K] and a v2 pack of random codes in [-8, 7] with bf16
    scales of both signs; with n_shards 2 a shard-blocked pack twice as wide."""
    rng = np.random.default_rng(seed)
    n = 2 * n2 * n_shards
    q = torch.from_numpy(rng.integers(-127, 128, size=(m, k)).astype(np.int8))
    packed = pack_int4(torch.from_numpy(rng.integers(-8, 8, size=(k, n)).astype(np.int8)), n_shards=n_shards)
    scales = torch.from_numpy(rng.normal(size=(k // group, n)).astype(np.float32) * 0.01).to(torch.bfloat16)
    return q, packed, scales


def _run_a8(mm, q, packed, scales, out, xs=None, split_groups=0):
    """One emulated int4_mm_a8 into `out` (possibly a column slice); checks
    that the tile counters come back zero."""
    m, k = q.shape
    n2, n_groups = packed.shape[1], scales.shape[0]
    ws = torch.full((n_groups, m, 2 * n2), float("nan"))
    counters = torch.zeros(n2 // 64, dtype=torch.int32)
    dtype = {torch.float32: 0, torch.bfloat16: 1}[out.dtype]
    err = mm(q.data_ptr(), packed.data_ptr(), scales.data_ptr(), None if xs is None else xs.data_ptr(), out.data_ptr(),
             ws.data_ptr(), counters.data_ptr(), m, k, n2, k // n_groups, packed.stride(0), scales.stride(0),
             out.stride(0), dtype, split_groups, None)
    assert err == 0
    assert not counters.any()


# (M, K, N/2, group, groups per split-K block (0: the kernel's choice)); M <= 16 is the split-K kernel
A8_CASES = {
    "decode_m1_mma_splits_2_2_1": (1, 640, 64, 128, 2),
    "decode_m1_g256": (1, 512, 64, 256, 1),
    "decode_m2_splits_2_2_1": (2, 640, 64, 128, 2),
    "decode_m4_g256_auto": (4, 512, 128, 256, 0),
    "decode_m9_auto": (9, 384, 64, 128, 0),
    "decode_m16_splits_3_2": (16, 640, 64, 128, 3),
    "prefill_m17": (17, 256, 64, 128, 0),
    "prefill_m20_six_stages": (20, 768, 64, 128, 0),
    "prefill_m37_odd_stages": (37, 640, 64, 128, 0),
    "prefill_m64_g256": (64, 512, 64, 256, 0),
    "prefill_m130": (130, 256, 128, 128, 0),
}


@pytest.mark.parametrize("name", sorted(A8_CASES))
def test_emulated_int4_a8_equals_plain(emulated_a8, name):
    mm, _, splits = emulated_a8
    m, k, n2, group, split_groups = A8_CASES[name]
    q, packed, scales = _a8_operands(m, k, n2, group, seed=m + k)
    out = torch.full((m, 2 * n2), float("nan"))
    _run_a8(mm, q, packed, scales, out, split_groups=split_groups)
    assert torch.equal(out, int4_matmul_a8_plain(q, packed, scales))
    if split_groups > 1:  # the split the case names: a last block with fewer groups
        assert (k // group) % split_groups and splits(k, n2, group, split_groups) == -(-(k // group) // split_groups)


@pytest.mark.parametrize("m", [1, 16, 37])
def test_emulated_int4_a8_reads_and_writes_column_blocks_in_place(emulated_a8, m):
    """Block 1 of a 2-shard pack (ldp, lds wider than the block) into block 1
    of the whole output (ldo wider); the rest of the output stays untouched."""
    mm, _, _ = emulated_a8
    k, n2, group = 384, 64, 128
    q, packed, scales = _a8_operands(m, k, n2, group, seed=3 * m, n_shards=2)
    out = torch.full((m, 4 * n2), float("nan"))
    block_p, block_s = packed[:, n2:], scales[:, 2 * n2:]
    _run_a8(mm, q, block_p, block_s, out[:, 2 * n2:], split_groups=2)
    assert torch.equal(out[:, 2 * n2:], int4_matmul_a8_plain(q, block_p, block_s))
    assert out[:, :2 * n2].isnan().all()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m", [1, 4, 37])
def test_emulated_int4_a8_token_scale_epilogue(emulated_a8, m, dtype):
    """With the row scales the kernel writes (acc * xs).to(dtype), the bits
    of the plain route, zero rows (scale 1) included."""
    mm, _, _ = emulated_a8
    k, n2, group = 384, 64, 128
    rng = np.random.default_rng(m)
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(dtype)
    x[m // 2] = 0
    q, xs = quantize_activations_per_token(x)
    _, packed, scales = _a8_operands(m, k, n2, group, seed=7 + m)
    out = torch.full((m, 2 * n2), float("nan")).to(dtype)
    _run_a8(mm, q, packed, scales, out, xs=xs)
    assert torch.equal(out, (int4_matmul_a8_plain(q, packed, scales) * xs).to(dtype))


def _tie_rows(dtype):
    """Rows whose quotients x / scale land on halves: absmax 127 (scale 1)
    and 254 (scale 2), so 2.5 -> 2, 3.5 -> 4, -0.5 -> -0, 5 / 2 -> 2."""
    ties = [127.0, 2.5, -2.5, 3.5, 0.5, -0.5, 1.5, -1.5, 126.5, -126.5, 0.0, 64.5]
    row = torch.tensor(ties * 8, dtype=torch.float32)
    return torch.stack([row, 2 * row, -row]).to(dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("what", ["random", "zero_rows", "ties", "wide", "nan_rows"])
def test_emulated_quantize_a8_equals_plain(emulated_a8, what, dtype):
    """Codes and scales bit-equal to the plain version; a row holding a NaN
    (at its start, and past the first thread's stride) gets a NaN scale in
    both, and the other rows their usual bits."""
    _, qz, _ = emulated_a8
    rng = np.random.default_rng(11)
    if what == "ties":
        x = _tie_rows(dtype)
    else:
        k = 4096 if what == "wide" else 300
        x = torch.from_numpy((rng.normal(size=(5, k)) * rng.uniform(0.01, 100, size=(5, 1))).astype(np.float32))
        x = x.to(dtype)
        if what == "zero_rows":
            x[1] = 0
            x[3] = 0
        if what == "nan_rows":
            x[1, 0] = float("nan")
            x[3, 299] = float("nan")
    m, k = x.shape
    q = torch.full((m, k), 99, dtype=torch.int8)
    xs = torch.full((m,), 7.0)
    assert qz(x.data_ptr(), {torch.float32: 0, torch.bfloat16: 1}[dtype], None, q.data_ptr(), xs.data_ptr(), m, k,
              None) == 0
    want_q, want_s = quantize_activations_per_token(x)
    nan_rows = want_s[:, 0].isnan()
    assert nan_rows.sum() == (2 if what == "nan_rows" else 0)
    assert torch.equal(xs.isnan(), nan_rows)
    assert torch.equal(q[~nan_rows], want_q[~nan_rows]) and torch.equal(xs[~nan_rows], want_s[~nan_rows, 0])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("what", ["random", "zero_rows", "ties"])
def test_emulated_quantize_a8_with_given_absmax_equals_plain(emulated_a8, what, dtype):
    """A row-parallel K shard quantized with the whole row's absmax (the
    kernel's absmax input): codes and scales bit-equal to
    quantize_activations_per_token(shard, absmax); a zero row keeps scale 1."""
    _, qz, _ = emulated_a8
    rng = np.random.default_rng(12)
    if what == "ties":
        x = _tie_rows(dtype)
    else:
        x = torch.from_numpy((rng.normal(size=(5, 600)) * rng.uniform(0.01, 100, size=(5, 1))).astype(np.float32))
        x = x.to(dtype)
        if what == "zero_rows":
            x[1] = 0
            x[3, :300] = 0  # zero in this shard only: the row's absmax comes from the other one
    shard = x[:, :x.shape[1] // 2].contiguous()
    absmax = x.float().abs().amax(dim=-1, keepdim=True)
    m, k = shard.shape
    q = torch.full((m, k), 99, dtype=torch.int8)
    xs = torch.full((m,), 7.0)
    assert qz(shard.data_ptr(), {torch.float32: 0, torch.bfloat16: 1}[dtype], absmax.data_ptr(), q.data_ptr(),
              xs.data_ptr(), m, k, None) == 0
    want_q, want_s = quantize_activations_per_token(shard, absmax)
    assert torch.equal(q, want_q) and torch.equal(xs, want_s[:, 0])


# --- the int8 weight-only GEMV -------------------------------------------------------


@pytest.fixture(scope="module")
def emulated_gemv(libraries):
    lib = libraries["int8_matmul"]
    gemv, groups, blocks = lib.int8_gemv, lib.int8_gemv_row_groups, lib.int8_gemv_blocks
    gemv.argtypes, groups.argtypes, blocks.argtypes = INT8_GEMV_SIGNATURE, [ctypes.c_int] * 2, [ctypes.c_int] * 2
    gemv.restype = groups.restype = blocks.restype = ctypes.c_int
    return gemv, groups, blocks


def _gemv_operands(m, k, n, seed):
    """bf16 x [M, K], int8 codes [N, K] over the whole range, bf16 scales of both signs."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rng.integers(-128, 128, size=(n, k)).astype(np.int8))
    scale = torch.from_numpy(rng.normal(size=n).astype(np.float32) * 0.02).to(torch.bfloat16)
    return x, w, scale


def _run_gemv(gemv, x, w, scale):
    out = torch.full((x.shape[0], w.shape[0]), float("nan"), dtype=torch.bfloat16)
    assert gemv(x.data_ptr(), w.data_ptr(), None if scale is None else scale.data_ptr(), out.data_ptr(),
                x.shape[0], w.shape[0], x.shape[1], None) == 0
    return out


def _int8_tolerance_use(got, want):
    rtol, atol = INT4_TOL["bfloat16"]
    w = want.float()
    allowed = (rtol * w.abs() + atol * w.square().mean().sqrt()).clamp_min(torch.finfo(torch.float32).tiny)
    return float(((got.float() - w).abs() / allowed).max())


def _check_gemv(gemv, m, k, n, seed):
    x, w, scale = _gemv_operands(m, k, n, seed)
    raw = _run_gemv(gemv, x, w, None)
    assert _int8_tolerance_use(raw, int8_gemv_plain(x, w)) <= 1.0
    scaled = _run_gemv(gemv, x, w, scale)
    assert torch.equal(scaled, (raw.float() * scale.float()).to(torch.bfloat16))
    # and the scaled product against the plain composition: the same rule on twice the ulp (a sum one ulp
    # apart may round the scaled value two ulps apart)
    want = int8_gemv_plain(x, w, scale).float()
    assert float(((scaled.float() - want).abs() / (2 * 2.0 ** -7 * want.abs() + 1e-3 * want.square().mean().sqrt()
                                                   ).clamp_min(1e-30)).max()) <= 1.0


@pytest.mark.parametrize("n", [61, 1024], ids=["n61_ragged", "n1024"])
@pytest.mark.parametrize("k", [16, 80, 4112])
@pytest.mark.parametrize("m", [1, 3, 8, 16])
def test_emulated_int8_gemv_matches_plain(emulated_gemv, m, k, n):
    gemv, groups, _ = emulated_gemv
    assert groups(m, n) == 1  # 8 or 128 groups of 8 rows: one group a block
    _check_gemv(gemv, m, k, n, seed=m * 10_000 + k + n)


# (M, N) -> the row groups a block takes (the emulation reports 4 resident blocks per SM: 528 on 132 SMs): at
# M <= 4 the smallest R of 1, 2, 4, 8 whose blocks all fit at once, above the largest that leaves >= 132
# blocks. GEMV_BLOCKS run (N ragged; the last, 529 units of 8 groups, on 265 blocks walking two units
# each); GEMV_CHOICES check the launcher's choice only.
GEMV_BLOCKS = {(8, 2115): 2, (9, 4227): 4, (16, 8451): 8, (1, 33800): 8}
GEMV_CHOICES = {(1, 4227): 2, (3, 8451): 4, (4, 16899): 8, (4, 8448): 2, (5, 8448): 8, (1, 1024): 1,
                (16, 1024): 1, (1, 14336): 4, (8, 14336): 8, (1, 32000): 8, (1, 4096): 1, (8, 4096): 2}


def test_emulated_int8_gemv_block_choice(emulated_gemv):
    _, groups, blocks = emulated_gemv
    assert {mn: groups(*mn) for mn in GEMV_CHOICES} == GEMV_CHOICES
    assert blocks(1, 4096) == 512 and blocks(1, 33800) == 265 and blocks(1, 51200) == 400  # 800 units, 2 each


@pytest.mark.parametrize("m, n, k", [(m, n, k) for m, n in sorted(GEMV_BLOCKS) for k in ((16,) if n > 9000 else (80, 528))],
                         ids=lambda v: str(v))
def test_emulated_int8_gemv_block_shapes(emulated_gemv, m, n, k):
    """The blocks of 2, 4 and 8 row groups (K split 4, 2 and 1 ways inside a
    block), their last unit ragged, at K = 80 (one partial 128-k step) and
    528 (5 steps: the ring's slots reused at 8 row groups); and blocks that
    walk two units, at K = 16."""
    gemv, groups, _ = emulated_gemv
    assert groups(m, n) == GEMV_BLOCKS[(m, n)]
    _check_gemv(gemv, m, k, n, seed=m + n + k)


def test_emulated_int8_gemv_refuses_other_shapes(emulated_gemv):
    gemv, _, _ = emulated_gemv
    x, w, _ = _gemv_operands(17, 32, 8, seed=1)
    out = torch.empty((17, 8), dtype=torch.bfloat16)
    for m, n, k in ((17, 8, 32), (0, 8, 32), (1, 8, 24), (1, 8, 0), (1, 0, 32)):
        assert gemv(x.data_ptr(), w.data_ptr(), None, out.data_ptr(), m, n, k, None) != 0
