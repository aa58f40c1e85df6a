"""The port's flash-attention CUDA sources on the CPU: csrc/flash_fwd.cu and
csrc/flash_bwd.cu compiled with g++ against tests/cuda_emu/cuda_emu.h (an
emulation of the cp.async, ldmatrix, mma.sync and warp primitives they use)
and held against their plain torch versions.

The kernels themselves run only on the card (tests/test_torch_kernels_gpu.py,
chip_smoke.py). This file checks their index math, masks and tile bounds
without one: the bf16 tensor-core kernels (the backward's P and dS as bf16
hi + lo pairs included) and the fp32 FMA kernels, at small shapes that cross
the 64-row tiles, GQA, keys longer than queries, lengths down to 1, a window,
no causal mask, and NaN in dead key slots. The emulated mma sums in another
order than the tensor cores, so the rules are the card's: the forward's o
within FWD_ATOL and lse within 1e-3 on valid rows; the backward per element
under GRAD_TOL (grad_tolerance_use <= 1), dead key slots exactly zero.
csrc/int4_matmul.cu (wgmma) is not emulated. Skips without g++.
"""

import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from bridgelang_tpu_torch.ops.flash_attention import flash_attention_bwd_plain, flash_attention_plain

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from chip_smoke import FWD_ATOL, grad_tolerance_use  # noqa: E402

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
}


def _emulated_source(name: str) -> str:
    """csrc/<name>.cu with bf16_mma.cuh inlined, its inline-PTX helpers taken
    from cuda_emu.h, dynamic shared memory as the block's buffer and each
    launch run through emu_launch."""
    helpers = (CSRC / "bf16_mma.cuh").read_text()
    helpers = "\n\n".join(chunk for chunk in helpers.split("\n\n") if "asm volatile" not in chunk)
    helpers = helpers.replace("#pragma once\n", "").replace(
        "#include <cuda_bf16.h>\n#include <cuda_runtime.h>\n", '#include "cuda_emu.h"\n')
    src = (CSRC / f"{name}.cu").read_text().replace('#include "bf16_mma.cuh"', helpers)
    src = re.sub(r"extern __shared__ (?:__align__\(\d+\) )?(\w+) (\w+)\[\];",
                 r"\1* \2 = reinterpret_cast<\1*>(emu_smem);", src)
    launches = src.count("<<<")
    src, n = re.subn(r"(\w+<[^<>]*>)<<<([^,]+), (\w+), (\w+), \w+>>>\(((?:.|\n)*?)\);\n(\s*return cudaGetLastError)",
                     r"emu_launch(\2, \3, \4, [&] { \1(\5); });\n\6", src)
    assert n == launches > 0, f"{name}: rewrote {n} of {launches} launches"
    return src


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the emulated kernels")
    out = tmp_path_factory.mktemp("cuda_emu")
    jobs = {}
    for name in ("flash_fwd", "flash_bwd"):
        cpp = out / f"{name}.cpp"
        cpp.write_text(_emulated_source(name))
        cmd = [gxx, "-std=c++20", "-O2", "-fno-strict-aliasing", "-pthread", "-shared", "-fPIC", "-w",
               "-I", str(EMU), "-o", str(out / f"{name}.so"), str(cpp)]
        jobs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, job in jobs.items():
        log, _ = job.communicate()
        assert job.returncode == 0, log
        libs[name] = ctypes.CDLL(str(out / f"{name}.so"))
    fwd, dq, dkv = libs["flash_fwd"].flash_fwd, libs["flash_bwd"].flash_bwd_dq, libs["flash_bwd"].flash_bwd_dkv
    for fn, n_ptrs in ((fwd, 6), (dq, 8), (dkv, 9)):
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fwd, dq, dkv


def _case(name, seed):
    b, t, s, h, hkv, d, lengths, window, causal, dtype = CASES[name]
    g = torch.Generator().manual_seed(seed)
    q, do = (torch.randn((b, t, h, d), generator=g).to(dtype) for _ in range(2))
    k, v = (torch.randn((b, s, hkv, d), generator=g).to(dtype) for _ in range(2))
    dims = [b, t, s, h, hkv, d, DTYPE_CODES[dtype], int(causal), int(window or 0)]
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
