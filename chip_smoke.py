#!/usr/bin/env python3
"""Smoke run of the torch port on one NVIDIA GPU (H100): `python3 chip_smoke.py`.

Run from the root of a checkout. Phases (`--phases`, all by default), each
of which fails the run:
  build    compile every bridgelang_tpu_torch/csrc/*.cu with nvcc (sm_90a),
           all sources in parallel; print the build seconds, the ptxas
           register report, and the card's name and power limit.
  kernels  the flash-attention forward kernel against its plain torch
           version at the serving path's shapes (bf16, H=32, D=128, ragged
           lengths, B in {1, 4}) and at GQA, S > T, window and fp32 cases;
           the two backward kernels (dQ, dK/dV) against the plain backward
           at the training shape (B=16, T=S=352, bf16, ragged lengths) and
           at the same four other cases, element by element (GRAD_TOL),
           with exactly zero gradient for dead key slots; the two int4
           kernels (int4_mm_a8, int4_mm) against their plain versions at
           the three 7B projection shapes (a8 at M 1, 352, 1408; bf16 at M
           1, 352, 5632), group 256, fp32 activations, a shard-blocked pack
           and a ragged M (INT4_TOL). Then each kernel, its plain version, a
           PyTorch yardstick (F.scaled_dot_product_attention with the
           equivalent boolean mask, forward or autograd backward, the
           backward pinned to the memory-efficient backend and timed as the
           median of 5 rounds interleaved with the kernels; F.linear over
           the int4 weight dequantized to bf16 ahead of time; the port never
           calls either) and the bound from bytes and operations, with each
           timed shape's share of the bound and its ratio to the yardstick.
  serve    OpenVLA-7B (prism-dinosiglip-224px+7b) at full width in bf16,
           random weights drawn on the card from a seed; the port's
           VLAServer answers POST /act: batch-1 requests, then one
           micro-batch of 4 concurrent requests. Kernel launch counts are
           zeroed before and read after: each model pass must launch the
           flash kernel once per decoder layer (32). Prefill and decode
           times come from generate_greedy with 1 and 7 new tokens; a
           torch.profiler pass over batch-1 predicts gives device time,
           idle share and the top kernels.
  train    LoRA fine-tuning of the same bf16 7B weights: r=32 fp32
           adapters on all seven projections, adapter-only AdamW (lr 5e-4,
           constant), batch 16 from DummyDataset through RLDSBatchTransform
           and the collator (96 tokens + 256 patches = 352), raw frames
           preprocessed in the step, full remat. One warm step, 6 timed
           steps: each must launch flash_fwd 64 times (32 layers, forward
           and recompute) and each backward kernel 32 times; losses finite
           and falling. One profiled step; then one warm and 2 timed
           steps under "dots" remat (scripts/finetune.py's default), with
           the same launch counts; then merge the adapters and predict one
           action through the merged weights.
  int4     the same decoder packed to int4 by quantize_llm_int4 (group
           128; int8 embedding and head) and the bf16 layers freed; with
           LLMConfig.w8a8 on, the same serving as `serve`: every decoder pass
           must launch int4_mm_a8 224 times (7 projections x 32 layers), 7
           passes per predict, and each predict flash_fwd 32 times (the
           prefill); generate timings, a profile, model and peak GB.
  qlora    r=32 fp32 adapters over that int4 base with w8a8 off, as `train`
           (batch 16, 352 tokens, full remat, one warm and 6 timed steps):
           each step launches int4_mm 448 times (forward and recompute) and
           the flash kernels 64/32/32; losses finite and falling; merge into
           the int4 base (dequantize, add, requantize) and predict one
           action through the merged int4 weights.
  parity   a depth-cut fp32 model with the same weights on the card
           (through the kernels) and on the CPU (plain versions): the
           action token ids must be equal, and one LoRA train step must
           give the same loss (1e-5 relative) and adapter gradients
           (1e-4 of max |g|); then the same cut packed to int4: equal ids
           with w8a8 on and off, and one QLoRA step under the same rule.
Then one line {"kernels": [...]}, the nvidia-smi line, and as the last line
{"ok": true, "device": {...}}. Without a CUDA card, or outside a checkout,
it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12         # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense bf16 tensor cores; fp32 outside them
N_LAYERS_7B = 32
SEED = 0                 # random weights are drawn on the card from this seed
N_SINGLE_REQUESTS = 5    # batch-1 /act requests in the serve phase
TRAIN_BATCH = 16         # scripts/finetune.py's per-device batch
TRAIN_MAX_LEN = 96       # collator bucket: 96 tokens + 256 patches = 352
TRAIN_STEPS = 6          # timed steps after one warm step
LORA_RANK = 32           # scripts/finetune.py: r=32, "all-linear"
LORA_LR = 5e-4
TRAIN_T = TRAIN_MAX_LEN + 256  # fused length of a training example
DOTS_STEPS = 2           # timed "dots"-remat steps after one warm step
BWD_ROUNDS = 5           # interleaved rounds of the backward timing (median)

# Attention cases that both the forward and the backward check run.
# name: (b, t, s, h, hkv, d, lengths, window, dtype)
ATTENTION_CASES = {
    "train_b16": (16, TRAIN_T, TRAIN_T, 32, 32, 128, [TRAIN_T - (37 * i) % 90 for i in range(16)], None,
                  "bfloat16"),  # ragged: 352 down to 266
    "gqa_hkv8": (2, 304, 304, 32, 8, 128, [304, 262], None, "bfloat16"),
    "keys_longer": (2, 304, 311, 32, 32, 128, [304, 250], None, "bfloat16"),
    "window100": (2, 304, 304, 32, 32, 128, [304, 280], 100, "bfloat16"),
    "fp32_d64": (2, 200, 200, 8, 8, 64, [200, 150], None, "float32"),
}
# Forward o, absolute: kernel and plain both accumulate in fp32 and round once
# (half a bf16 ulp is <= 0.008 for |o| < 4), so bf16 allows one ulp apart.
FWD_ATOL = {"bfloat16": 2e-2, "float32": 1e-4}
# Gradients, per element: |got - want| <= rtol * |want| + atol * rms(want).
# bf16: kernel and plain both sum in fp32 and round once, so they may sit one
# bf16 ulp apart, and an ulp is <= 2^-7 |want|; the rms term admits the fp32
# order differences of a sum that cancels near zero. fp32: order differences
# only. A kernel that drops a tile's share of a sum moves entries by about a
# typical entry, far past either term.
GRAD_TOL = {"bfloat16": (2.0 ** -7, 1e-3), "float32": (1e-5, 1e-5)}
# The int4 kernels against their plain versions, per element as GRAD_TOL.
# a8: the f32 output before the token scale; the group sums are exact
# integers on both sides, so only the fp32 order of the scale-accumulate may
# differ (the kernel follows the plain order, so 0 is expected). bf16: one
# bf16 ulp plus 1e-3 rms, as GRAD_TOL. fp32: order only.
INT4_TOL = {"a8": (1e-5, 1e-6), "bfloat16": (2.0 ** -7, 1e-3), "float32": (1e-5, 1e-5)}
INT4_GROUP = 128         # quantize_llm_int4's default group, the serving pack
INT4_SHAPES_7B = {"wq": (4096, 4096), "w_gate": (4096, 11008), "w_down": (11008, 4096)}  # (K, N) per projection
INT4_PER_PASS = 7 * N_LAYERS_7B   # int4 launches per decoder pass: 7 projections x 32 layers
ACTION_DIM = 7           # decoder passes per predict: the prefill and 6 decode steps
QLORA_STEPS = 6          # timed QLoRA steps after one warm step
PEAK_OPS = {"a8": 1979e12, "bfloat16": 989e12, "float32": 67e12}  # int8 and bf16 tensor cores; fp32 FMAs
KERNEL_NAMES = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "int4_mm_a8", "int4_mm")
# substrings of the kernels' names in a profiler trace
PROFILE_NAMES = {"flash_fwd": "flash_fwd", "flash_bwd_dq": "flash_bwd_dq", "flash_bwd_dkv": "flash_bwd_dkv",
                 "int4_mm_a8": "int4_mm_tc_kernel<true", "int4_mm bf16": "int4_mm_bf16_wgmma",
                 "int4_mm bf16 M<=64": "int4_mm_tc_kernel<false", "int4_mm fp32": "int4_mm_f32"}


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# --- phase 2: kernel against plain ------------------------------------------------


def attention_case(b, t, s, h, hkv, d, lengths, window, dtype, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, t, h, d), generator=g, device="cuda", dtype=dtype)
    k = torch.randn((b, s, hkv, d), generator=g, device="cuda", dtype=dtype)
    v = torch.randn((b, s, hkv, d), generator=g, device="cuda", dtype=dtype)
    return q, k, v, torch.tensor(lengths, dtype=torch.int32, device="cuda")


def valid_mask(t, s, lengths, window, device="cpu"):
    """[B, T, S] bool: key c is attended by row r (causal, length, window)."""
    import torch

    r = torch.arange(t, device=device)[:, None]
    c = torch.arange(s, device=device)[None, :]
    m = (c <= r)[None] & (c[None] < torch.as_tensor(lengths, device=device)[:, None, None])
    if window is not None and window < s:
        m = m & (c > r - window)[None]
    return m


def bound_ms(q, k, v, lengths, window):
    """Least time for the function: max(bytes moved / HBM rate, FLOPs / peak).
    Bytes: q, k, v, lengths read once; o and lse written once. FLOPs: 4*D per
    attended (row, key) pair (QK^T and PV), counted from this run's lengths."""
    b, t, h, d = q.shape
    s = k.shape[1]
    n_bytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size() + 4 * b * h * t + 4 * b
    pairs = int(valid_mask(t, s, lengths.cpu().tolist(), window).sum()) * h
    flops = 4.0 * d * pairs
    peak = PEAK_FLOPS[str(q.dtype).replace("torch.", "")]
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def bwd_bound_ms(q, k, lengths, window, which):
    """Least time for one backward kernel's function: max(bytes / HBM rate,
    FLOPs / peak). Bytes: q, k, v, dO, lengths read once, lse and delta
    (f32 [B, H, T]) read once, the outputs (dq; or dk and dv) written once.
    FLOPs per attended (row, key) pair: dq needs S, dP and dS.K (6 D); dk/dv
    need S, dP, P^T.dO and dS^T.Q (8 D); the whole backward 10 D."""
    b, t, h, d = q.shape
    s = k.shape[1]
    e = q.element_size()
    inputs = (2 * q.numel() + 2 * k.numel()) * e + 2 * 4 * b * h * t + 4 * b
    outputs = {"dq": q.numel() * e, "dkv": 2 * k.numel() * e, "both": (q.numel() + 2 * k.numel()) * e}[which]
    pairs = int(valid_mask(t, s, lengths.cpu().tolist(), window).sum()) * h
    flops = {"dq": 6, "dkv": 8, "both": 10}[which] * d * pairs
    peak = PEAK_FLOPS[str(q.dtype).replace("torch.", "")]
    t_bytes, t_ops = (inputs + outputs) / HBM_BYTES_PER_S, flops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def grad_tolerance_use(got, want) -> float:
    """The share of GRAD_TOL that `got` uses against `want`: the max over
    elements of |got - want| / (rtol |want| + atol rms(want)). Above 1 fails."""
    import torch

    rtol, atol = GRAD_TOL[str(want.dtype).replace("torch.", "")]
    w = want.float()
    allowed = (rtol * w.abs() + atol * w.square().mean().sqrt()).clamp_min(torch.finfo(torch.float32).tiny)
    return float(((got.float() - w).abs() / allowed).max())


def check_backward_kernels():
    """dq, dk, dv from the kernels against flash_attention_bwd_plain under
    GRAD_TOL, then timings at the training shape."""
    import torch

    from bridgelang_tpu_torch.ops.flash_attention import (
        flash_attention_bwd_plain, flash_attention_plain, flash_bwd_dkv, flash_bwd_dq)

    worst = {"dq": 0.0, "dkv": 0.0}
    readings, timing = {}, None
    for i, (name, (b, t, s, h, hkv, d, lengths, window, dtype_name)) in enumerate(ATTENTION_CASES.items()):
        dtype = getattr(torch, dtype_name)
        q, k, v, lens = attention_case(b, t, s, h, hkv, d, lengths, window, dtype, seed=200 + i)
        do = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(300 + i), device="cuda",
                         dtype=dtype)
        o, lse = flash_attention_plain(q, k, v, lengths=lens, causal=True, window=window)
        delta = (do.float() * o.float()).sum(dim=-1).transpose(1, 2).contiguous()
        dq = flash_bwd_dq(q, k, v, do, lse, delta, lens, True, window)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, lens, True, window)
        torch.cuda.synchronize()
        pdq, pdk, pdv = flash_attention_bwd_plain(q, k, v, o, lse, do, lens, True, window)
        r = {}
        for what, got, want in (("dq", dq, pdq), ("dk", dk, pdk), ("dv", dv, pdv)):
            if not torch.isfinite(got).all():
                fail(f"backward case {name}: non-finite {what}")
            w = want.float()
            r[what] = dict(err=(got.float() - w).abs().max().item(), use=grad_tolerance_use(got, want),
                           max=w.abs().max().item(), rms=w.square().mean().sqrt().item())
        dead = max(max(dk[bi, L:].abs().max().item(), dv[bi, L:].abs().max().item()) if L < s else 0.0
                   for bi, L in enumerate(lengths))
        ok = all(x["use"] <= 1.0 for x in r.values()) and dead == 0.0
        log(f"kernel bwd {name}: B={b} T={t} S={s} H={h} Hkv={hkv} D={d} {dtype_name} window={window} "
            f"rule |err| <= {GRAD_TOL[dtype_name][0]:.3g}|g| + {GRAD_TOL[dtype_name][1]:g} rms(g); "
            + "; ".join(f"{w} max|err| {x['err']:.3e} tolerance use {x['use']:.3g} (max|g| {x['max']:.4g}, "
                        f"rms {x['rms']:.4g})" for w, x in r.items())
            + f"; dead-key dk/dv {dead} {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"flash backward kernels disagree with the plain backward in case {name}")
        readings[name] = r
        worst["dq"] = max(worst["dq"], r["dq"]["err"])
        worst["dkv"] = max(worst["dkv"], r["dk"]["err"], r["dv"]["err"])

        if name == "train_b16":
            timing = time_backward(name, q, k, v, do, o, lse, delta, lens, window)
    return timing, worst, readings


def time_backward(name, q, k, v, do, o, lse, delta, lens, window) -> dict:
    """The backward kernels against the yardstick at one shape: each the
    median of BWD_ROUNDS rounds, kernels and SDPA's backward interleaved
    (kernels, SDPA, SDPA, kernels, ...). SDPA runs pinned to the
    memory-efficient backend (it takes the boolean mask), so the yardstick
    is the same kernel in every run; the log names the backward it ran."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from bridgelang_tpu_torch.ops.flash_attention import flash_attention_bwd_plain, flash_bwd_dkv, flash_bwd_dq

    b, t, h, d = q.shape
    s = k.shape[1]
    lengths = lens.tolist()
    mask = valid_mask(t, s, lengths, window, device="cuda")[:, None]
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
    dot = do.transpose(1, 2)
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
    backend = type(out.grad_fn).__name__

    def sdpa_ms():
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return cuda_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True), 20)

    readings = {"dq": [], "dkv": [], "sdpa": []}
    for r in range(BWD_ROUNDS):
        for what in (("kernels", "sdpa") if r % 2 == 0 else ("sdpa", "kernels")):
            if what == "sdpa":
                readings["sdpa"].append(sdpa_ms())
            else:
                readings["dq"].append(cuda_ms(lambda: flash_bwd_dq(q, k, v, do, lse, delta, lens, True, window), 20))
                readings["dkv"].append(cuda_ms(lambda: flash_bwd_dkv(q, k, v, do, lse, delta, lens, True, window), 20))
    dq_ms, dkv_ms, library_ms = (statistics.median(readings[w]) for w in ("dq", "dkv", "sdpa"))
    plain_ms = cuda_ms(lambda: flash_attention_bwd_plain(q, k, v, o, lse, do, lens, True, window), 5)
    # For the record only: the backend SDPA picks unpinned, and its backward's time.
    out_default = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
    default_ms = cuda_ms(lambda: torch.autograd.grad(out_default, (qt, kt, vt), dot, retain_graph=True), 20)
    default_backend = type(out_default.grad_fn).__name__
    bounds = {w: bwd_bound_ms(q, k, lens, window, w) for w in ("dq", "dkv", "both")}
    log(f"timing bwd {name}: median of {BWD_ROUNDS} interleaved rounds: dq {dq_ms:.4f} ms (bound "
        f"{bounds['dq'][0]:.4f} ms, {bounds['dq'][1]}), dk/dv {dkv_ms:.4f} ms (bound {bounds['dkv'][0]:.4f} ms, "
        f"{bounds['dkv'][1]}), pair {dq_ms + dkv_ms:.4f} ms; sdpa backward (yardstick, backend "
        f"EFFICIENT_ATTENTION, grad_fn {backend}) {library_ms:.4f} ms (unpinned: grad_fn {default_backend}, "
        f"{default_ms:.4f} ms); plain backward {plain_ms:.4f} ms; "
        f"whole-backward bound {bounds['both'][0]:.4f} ms ({bounds['both'][1]}); readings "
        + json.dumps({w: [round(x, 4) for x in xs] for w, xs in readings.items()}))
    return dict(shape=f"B={b} T={t} S={s} H={h} D={d} bf16 (lengths {min(lengths)}-{max(lengths)})",
                dq_ms=dq_ms, dkv_ms=dkv_ms, plain_ms=plain_ms, library_ms=library_ms, library_backend=backend,
                unpinned=dict(backend=default_backend, ms=default_ms), bounds=bounds, readings=readings)


def check_kernels(serve_t: int):
    import torch
    import torch.nn.functional as F

    from bridgelang_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain

    T = serve_t
    cases = {
        # name: (b, t, s, h, hkv, d, lengths, window, dtype)
        "serve_b1": (1, T, T, 32, 32, 128, [T - 21], None, "bfloat16"),
        "serve_b4": (4, T, T, 32, 32, 128, [T - 21, T - 9, T - 40, T - 77], None, "bfloat16"),
        "t304_b1": (1, 304, 304, 32, 32, 128, [290], None, "bfloat16"),
        "t304_b4": (4, 304, 304, 32, 32, 128, [304, 290, 271, 256], None, "bfloat16"),
        **ATTENTION_CASES,
    }
    # lse is fp32 in both: only the summation order differs (atol 1e-3).
    rows, worst = [], {}
    for i, (name, (b, t, s, h, hkv, d, lengths, window, dtype_name)) in enumerate(cases.items()):
        dtype, tol = getattr(torch, dtype_name), FWD_ATOL[dtype_name]
        q, k, v, lens = attention_case(b, t, s, h, hkv, d, lengths, window, dtype, seed=100 + i)
        o, lse = flash_attention(q, k, v, lengths=lens, causal=True, window=window)
        torch.cuda.synchronize()
        po, plse = flash_attention_plain(q, k, v, lengths=lens, causal=True, window=window)
        err_o = err_lse = 0.0
        for bi, L in enumerate(lengths):
            n = min(L, t)
            if not torch.isfinite(o[bi, :n]).all():
                fail(f"kernel case {name}: non-finite output")
            err_o = max(err_o, (o[bi, :n].float() - po[bi, :n].float()).abs().max().item())
            err_lse = max(err_lse, (lse[bi, :, :n] - plse[bi, :, :n]).abs().max().item())
        ok = err_o <= tol and err_lse <= 1e-3
        log(f"kernel {name}: B={b} T={t} S={s} H={h} Hkv={hkv} D={d} {dtype_name} window={window} "
            f"max|o-plain|={err_o:.3e} (tol {tol}) max|lse-plain|={err_lse:.3e} (tol 1e-3) {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"flash kernel disagrees with its plain version in case {name}")
        worst[name] = err_o

        if name in ("serve_b1", "serve_b4", "t304_b1", "train_b16"):
            kernel_ms = cuda_ms(lambda: flash_attention(q, k, v, lengths=lens, causal=True, window=window), 100)
            plain_ms = cuda_ms(lambda: flash_attention_plain(q, k, v, lengths=lens, causal=True, window=window), 20)
            mask = valid_mask(t, s, lengths, window, device="cuda")[:, None]
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask), 100)
            b_ms, b_by = bound_ms(q, k, v, lens, window)
            rows.append(dict(case=name, shape=f"B={b} T={t} S={s} H={h} D={d} bf16", kernel_ms=kernel_ms,
                             plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms, bound_by=b_by,
                             bound_share=b_ms / kernel_ms, vs_library=kernel_ms / library_ms, max_abs_err=err_o))
            log(f"timing {name}: kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"sdpa (yardstick) {library_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}); "
                f"share of bound {b_ms / kernel_ms:.3f}, kernel / sdpa {kernel_ms / library_ms:.2f}")
    return rows, max(worst.values())


def int4_bound_ms(m: int, k: int, n: int, group: int, mode: str):
    """Least time for one int4 product: max(bytes / HBM rate, 2 M K N / peak).
    Bytes: x (int8, bf16 or fp32) and the packed weights and bf16 scales read
    once, the output (f32 for a8, else x's type) written once."""
    x_b = {"a8": 1, "bfloat16": 2, "float32": 4}[mode]
    out_b = 4 if mode == "a8" else x_b
    n_bytes = m * k * x_b + k * n // 2 + (k // group) * n * 2 + m * n * out_b
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, 2.0 * m * k * n / PEAK_OPS[mode]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_int4_kernels() -> dict:
    """Both int4 kernels against their plain versions at the 7B shapes (a8 at
    the serving M: decode 1, prefill 352, micro-batch 1408; bf16 at the QLoRA
    M: 1, 352, 5632), plus group 256, fp32 activations, a shard-blocked pack
    and a ragged M, element by element under INT4_TOL; then kernel, plain,
    yardstick (F.linear over the weight dequantized to bf16 ahead of time;
    the port never calls it) and bound at the path's shapes."""
    import torch
    import torch.nn.functional as F

    from bridgelang_tpu_torch.ops import int4_matmul as im
    from bridgelang_tpu_torch.ops.quant import _quantize4_2d, dequant_int4, quantize_activations_per_token

    weights = {}

    def packed_weights(shape, group, n_shards=1):
        key = (shape, group, n_shards)
        if key not in weights:
            k, n = INT4_SHAPES_7B[shape]
            g = torch.Generator(device="cuda").manual_seed(400 + len(weights))
            w = torch.randn((k, n), generator=g, device="cuda").mul_(k ** -0.5)
            weights[key] = _quantize4_2d(w, group, n_shards=n_shards)
        return weights[key]

    def use(got, want, mode):
        rtol, atol = INT4_TOL[mode]
        w = want.float()
        allowed = (rtol * w.abs() + atol * w.square().mean().sqrt()).clamp_min(torch.finfo(torch.float32).tiny)
        return float(((got.float() - w).abs() / allowed).max()), float((got.float() - w).abs().max())

    # (shape, mode, M, group, n_shards)
    cases = [(sh, "a8", m, INT4_GROUP, 1) for sh in INT4_SHAPES_7B for m in (1, 352, 1408)]
    cases += [(sh, "bfloat16", m, INT4_GROUP, 1) for sh in INT4_SHAPES_7B for m in (1, 352, 5632)]
    cases += [("w_gate", "a8", 352, 256, 1), ("w_down", "bfloat16", 352, 256, 1), ("w_gate", "float32", 352, 128, 1),
              ("wq", "float32", 37, 256, 1), ("w_down", "a8", 37, 128, 1), ("w_gate", "bfloat16", 37, 128, 1),
              ("w_gate", "bfloat16", 37, 128, 2), ("w_gate", "a8", 352, 128, 2)]  # 5504-wide blocks
    timed = {("wq", "a8", 1), ("w_gate", "a8", 1), ("w_down", "a8", 1), ("wq", "a8", 352), ("w_gate", "a8", 352),
             ("w_down", "a8", 352), ("wq", "bfloat16", 5632), ("w_gate", "bfloat16", 5632),
             ("w_down", "bfloat16", 5632)}
    worst = {"a8": (0.0, 0.0), "float": (0.0, 0.0)}
    rows, blocked = [], []
    for i, (shape, mode, m, group, n_shards) in enumerate(cases):
        k, n = INT4_SHAPES_7B[shape]
        packed, scales = packed_weights(shape, group, n_shards)
        g = torch.Generator(device="cuda").manual_seed(500 + i)
        x = torch.randn((m, k), generator=g, device="cuda")
        name = f"{shape} {mode} M={m} group={group}" + (f" n_shards={n_shards}" if n_shards > 1 else "")
        if n_shards > 1:  # the blocked route through the model-facing function, against its plain twin
            xin = x.to(torch.bfloat16) if mode != "a8" else x
            fn = im.matmul_int4_a8 if mode == "a8" else im.matmul_int4
            wrapper = im.int4_mm_a8 if mode == "a8" else im.int4_mm
            before = wrapper.launches
            got = fn(xin, packed, scales, n_shards)
            torch.cuda.synchronize()
            if wrapper.launches != before + n_shards:
                fail(f"int4 case {name}: expected one kernel launch per shard block")
            w2, ns = packed.shape[1] // n_shards, n // n_shards
            if mode == "a8":
                q, xs = quantize_activations_per_token(xin)
                want = torch.cat([im.int4_matmul_a8_plain(q, packed[:, d * w2:(d + 1) * w2], scales[:, d * ns:(d + 1) * ns])
                                  for d in range(n_shards)], dim=1)
                got = got.float() / xs  # back to the kernel's output before the token scale
                tol_mode = "float32"  # one fp32 rounding each way around the token scale
            else:
                want = torch.cat([im.int4_matmul_plain(xin, packed[:, d * w2:(d + 1) * w2], scales[:, d * ns:(d + 1) * ns])
                                  for d in range(n_shards)], dim=1)
                tol_mode = mode
            # the blocked route (one launch per block, read in place) against one launch over a whole pack
            xk = quantize_activations_per_token(xin)[0] if mode == "a8" else xin
            whole_p, whole_s = packed_weights(shape, group)
            blocked_ms = cuda_ms(lambda: im._int4_route_blocked(xk, packed, scales, mode == "a8", n_shards), 20)
            whole_ms = cuda_ms(lambda: im._int4_route(xk, whole_p, whole_s, mode == "a8"), 20)
            blocked.append(dict(case=name, blocked_ms=blocked_ms, whole_ms=whole_ms))
            log(f"timing int4 {name}: blocked route {blocked_ms:.4f} ms, one launch over the unblocked pack "
                f"{whole_ms:.4f} ms")
        elif mode == "a8":
            xin, _ = quantize_activations_per_token(x)
            got = im.int4_mm_a8(xin, packed, scales)
            torch.cuda.synchronize()
            want = im.int4_matmul_a8_plain(xin, packed, scales)
            tol_mode = "a8"
        else:
            xin = x.to(getattr(torch, mode))
            got = im.int4_mm(xin, packed, scales)
            torch.cuda.synchronize()
            want = im.int4_matmul_plain(xin, packed, scales)
            tol_mode = mode
        if got.shape != (m, n) or not torch.isfinite(got).all():
            fail(f"int4 kernel case {name}: shape {tuple(got.shape)} or non-finite output")
        share, err = use(got, want, tol_mode)
        rtol, atol = INT4_TOL[tol_mode]
        log(f"kernel int4 {name}: max|err| {err:.3e} (max|want| {float(want.float().abs().max()):.4g}), "
            f"rule |err| <= {rtol:.3g}|want| + {atol:g} rms(want), tolerance use {share:.3g} "
            f"{'ok' if share <= 1.0 else 'FAIL'}")
        if share > 1.0:
            fail(f"int4 kernel disagrees with its plain version in case {name}")
        key = "a8" if mode == "a8" else "float"
        worst[key] = (max(worst[key][0], err), max(worst[key][1], share))

        if (shape, mode, m) in timed and group == INT4_GROUP and n_shards == 1:
            kfn = (lambda: im.int4_mm_a8(xin, packed, scales)) if mode == "a8" else (lambda: im.int4_mm(xin, packed, scales))
            pfn = ((lambda: im.int4_matmul_a8_plain(xin, packed, scales)) if mode == "a8"
                   else (lambda: im.int4_matmul_plain(xin, packed, scales)))
            kernel_ms = cuda_ms(kfn, 50 if m < 5632 else 10)
            plain_ms = cuda_ms(pfn, 3, warmup=1)
            w_bf = dequant_int4(packed, scales, torch.bfloat16).t().contiguous()  # [N, K], ahead of time
            x_bf = x.to(torch.bfloat16)
            library_ms = cuda_ms(lambda: F.linear(x_bf, w_bf), 50 if m < 5632 else 10)
            del w_bf
            b_ms, b_by = int4_bound_ms(m, k, n, group, mode)
            rows.append(dict(case=name, mode=mode, shape=f"M={m} K={k} N={n} group={group}", m=m, k=k, n=n,
                             kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms,
                             bound_by=b_by, bound_share=b_ms / kernel_ms, vs_library=kernel_ms / library_ms,
                             max_abs_err=err, tolerance_use=share))
            log(f"timing int4 {name}: kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"F.linear over bf16 weights (yardstick) {library_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}); "
                f"share of bound {b_ms / kernel_ms:.3f}, kernel / F.linear {kernel_ms / library_ms:.2f}")
        del x, xin, got, want
    weights.clear()
    torch.cuda.empty_cache()
    return dict(rows=rows, worst=worst, blocked=blocked)


# --- phase 3: full-width serving --------------------------------------------------

STATS = {"bridge_orig": {"action": {
    "q01": [-0.03, -0.05, -0.06, -0.13, -0.12, -0.43, 0.0],
    "q99": [0.03, 0.04, 0.06, 0.13, 0.12, 0.43, 1.0],
    "mask": [True, True, True, True, True, True, False],
}}}
INSTRUCTIONS = ["pick up the red block", "open the drawer", "put the spoon on the towel",
                "move the blue cup to the left side"]


def build_7b(seed: int):
    import torch

    from bridgelang_tpu_torch.models.llm.tokenizer import ByteFallbackTokenizer
    from bridgelang_tpu_torch.models.vla import OpenVLA
    from bridgelang_tpu_torch.models.vlm import VLMConfig

    cfg = VLMConfig()  # prism-dinosiglip-224px+7b: DINOv2-L + SigLIP-So400m, Llama-2 7B
    model = OpenVLA(cfg, STATS, tokenizer=ByteFallbackTokenizer(), dtype=torch.bfloat16, device="cuda")
    t0 = time.perf_counter()
    params = model.init_params(torch.Generator(device="cuda").manual_seed(seed))
    torch.cuda.synchronize()
    n = sum(p.numel() for p in params["vision"].values()) + sum(p.numel() for p in params["projector"].values())
    n += sum(p.numel() for lp in params["llm"]["layers"] for p in lp.values())
    n += sum(params["llm"][k].numel() for k in ("embed", "final_norm", "lm_head"))
    log(f"OpenVLA-7B random bf16 weights on the card: {n / 1e9:.3f} B params in {time.perf_counter() - t0:.1f} s")
    return model, params


def frames(n: int, seed: int):
    import numpy as np

    return list(np.random.default_rng(seed).integers(0, 256, size=(n, 224, 224, 3), dtype=np.uint8))


def time_generate(model, params, frame, instruction, max_new_tokens: int, reps: int = 5) -> float:
    import torch

    from bridgelang_tpu_torch.ops.image_ops import frames_to_tensor, preprocess_batch

    ids, mask = model.pad_prompt([model.prepare_prompt_ids(instruction)])
    ids_t = torch.as_tensor(ids, device="cuda")
    mask_t = torch.as_tensor(mask, device="cuda")
    pix = preprocess_batch(frames_to_tensor(frame[None], model.device), model.image_transform, dtype=model.dtype)
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.generate_greedy(params, ids_t, mask_t, pix, max_new_tokens=max_new_tokens)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def first_token(model, params, frame, instruction) -> int:
    import torch

    from bridgelang_tpu_torch.ops.image_ops import frames_to_tensor, preprocess_batch

    ids, mask = model.pad_prompt([model.prepare_prompt_ids(instruction)])
    pix = preprocess_batch(frames_to_tensor(frame[None], model.device), model.image_transform, dtype=model.dtype)
    tok = model.generate_greedy(params, torch.as_tensor(ids, device="cuda"), torch.as_tensor(mask, device="cuda"),
                                pix, max_new_tokens=1)
    return int(tok[0, 0])


def profile_device(label: str, fn, reps: int) -> dict:
    """torch.profiler over `reps` calls of `fn` (warmed up by the caller):
    wall ms per call, device kernel ms per call (sum of kernel durations on
    the one stream), the device's idle share, launches per call, the port's
    kernels' share and the top kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / reps
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        log(f"profile ({label}): wall {wall_ms:.2f} ms/call; device time not measured (no CUDA events traced)")
        return {"wall_ms": wall_ms}
    by_name: dict = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / reps
    busy_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    flash = {k: sum(v for n, v in by_name.items() if sub in n) for k, sub in PROFILE_NAMES.items()}
    log(f"profile ({label}, {reps} calls): wall {wall_ms:.2f} ms, device kernels {busy_ms:.2f} ms "
        f"({len(kernels) / reps:.0f} launches), device idle {100 * (1 - busy_ms / wall_ms):.1f}%, "
        + ", ".join(f"{k} {v:.3f} ms ({100 * v / busy_ms:.1f}%)" for k, v in flash.items() if v))
    for name, ms in top:
        log(f"  {ms:8.3f} ms  {100 * ms / busy_ms:5.1f}%  {name[:110]}")
    return {"wall_ms": wall_ms, "device_ms": busy_ms, "idle_share": 1 - busy_ms / wall_ms,
            "launches_per_call": len(kernels) / reps, "flash_ms": flash,
            "top": [(name[:80], ms) for name, ms in top[:6]]}


def profile_predict(model, params, reps: int = 3) -> dict:
    """The profile over batch-1 predict_action calls."""
    img = frames(1, seed=5)[0]
    model.predict_action(params, img, INSTRUCTIONS[0])  # warm
    return profile_device("B=1 predict_action", lambda: model.predict_action(params, img, INSTRUCTIONS[0]), reps)


def check_action(action, what: str) -> None:
    import numpy as np

    a = np.asarray(action)
    if a.shape != (7,) or not np.isfinite(a).all():
        fail(f"{what}: expected 7 finite floats, got {a!r}")


def serve(model, params, n_single: int, per_pass: dict) -> dict:
    """VLAServer /act: `n_single` batch-1 requests, then a micro-batch of 4
    concurrent ones. Launch counts are zeroed before each and read after;
    each of the server's model passes (one predict: the prefill and the
    decode steps) must launch each kernel `per_pass[name]` times (the others
    never)."""
    import torch

    from bridgelang_tpu_torch.serving.server import VLAServer, client_act

    imgs = frames(4, seed=7)
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()

    single = VLAServer(model, params, max_batch=1, device=model.device)
    httpd = single.serve_background(port=0)
    lat = []
    try:
        port = httpd.server_address[1]
        for i in range(n_single):
            t0 = time.perf_counter()
            action = client_act("127.0.0.1", port, imgs[i % 4], INSTRUCTIONS[i % 4], timeout=300)
            lat.append(1e3 * (time.perf_counter() - t0))
            check_action(action, f"batch-1 request {i}")
        passes_single = single.stats()["model_passes"]
    finally:
        httpd.shutdown()
        httpd.server_close()
        single.close()
    counts_single = launch_counts()
    log(f"batch-1: {n_single} x HTTP 200 with 7 floats; latency ms {[round(x, 1) for x in lat]}; "
        f"model passes {passes_single}; launches {counts_single}")
    if passes_single != n_single:
        fail(f"expected {n_single} model passes, got {passes_single}")
    expect_counts(counts_single, {k: v * passes_single for k, v in per_pass.items()}, "batch-1 serving")

    reset_launch_counts()
    batched = VLAServer(model, params, max_batch=4, batch_window_ms=2000.0, device=model.device)
    httpd = batched.serve_background(port=0)
    results, errors = [None] * 4, []
    try:
        port = httpd.server_address[1]

        def one(i):
            try:
                results[i] = client_act("127.0.0.1", port, imgs[i], INSTRUCTIONS[i], timeout=300)
            except Exception as e:  # noqa: BLE001 - reported below, fails the run
                errors.append(f"request {i}: {e!r}")

        threads = [threading.Thread(target=one, args=(i,)) for i in range(4)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        batch_ms = 1e3 * (time.perf_counter() - t0)
        passes_batched = batched.stats()["model_passes"]
    finally:
        httpd.shutdown()
        httpd.server_close()
        batched.close()
    if errors or any(th.is_alive() for th in threads):
        fail(f"micro-batched requests failed: {errors}")
    for i, action in enumerate(results):
        check_action(action, f"micro-batched request {i}")
    counts_batched = launch_counts()
    log(f"micro-batch of 4 (instruction lengths {[len(s) for s in INSTRUCTIONS]}): 4 x HTTP 200 with 7 floats "
        f"in {batch_ms:.1f} ms; model passes {passes_batched}; launches {counts_batched}")
    if passes_batched < 1:
        fail("the micro-batch ran no model pass")
    expect_counts(counts_batched, {k: v * passes_batched for k, v in per_pass.items()}, "micro-batched serving")
    return dict(latencies_ms=lat, median_ms=statistics.median(lat[1:] if len(lat) > 1 else lat),
                batch4_ms=batch_ms, batch4_passes=passes_batched,
                launches={k: counts_single[k] + counts_batched[k] for k in KERNEL_NAMES},
                passes=passes_single + passes_batched, max_memory_gb=torch.cuda.max_memory_allocated() / 1e9)


# --- phase 4: LoRA fine-tuning ------------------------------------------------------


def kernel_wrappers() -> dict:
    """Each kernel's wrapper, which counts its launches in `.launches`."""
    from bridgelang_tpu_torch.ops.flash_attention import flash_attention, flash_bwd_dkv, flash_bwd_dq
    from bridgelang_tpu_torch.ops.int4_matmul import int4_mm, int4_mm_a8

    return dict(zip(KERNEL_NAMES, (flash_attention, flash_bwd_dq, flash_bwd_dkv, int4_mm_a8, int4_mm)))


def reset_launch_counts() -> None:
    for fn in kernel_wrappers().values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


def expect_counts(counts: dict, want: dict, what: str) -> None:
    """Fail unless each kernel launched exactly as `want` says (0 when not named)."""
    full = {name: want.get(name, 0) for name in KERNEL_NAMES}
    if counts != full:
        fail(f"{what}: expected launches {full}, got {counts}")


def lora_batch(model, batch_size: int, seed: int) -> dict:
    """DummyDataset(seed) -> RLDSBatchTransform -> collator, on the model's device."""
    import torch

    from bridgelang_tpu_torch.vla.action_tokenizer import ActionTokenizer
    from bridgelang_tpu_torch.vla.datasets.datasets import (
        DummyDataset, PaddedCollatorForActionPrediction, RLDSBatchTransform)

    tok = model.tokenizer
    transform = RLDSBatchTransform(ActionTokenizer(tok), tok, llm_family=model.cfg.llm_family)
    collate = PaddedCollatorForActionPrediction(max_length=TRAIN_MAX_LEN, pad_token_id=model.cfg.llm.pad_token_id)
    batch = collate(list(DummyDataset(transform, n=batch_size, seed=seed)))
    return {k: torch.as_tensor(v, device=model.device) for k, v in batch.items() if k != "dataset_names"}


def with_lora(params: dict, device, seed: int, b_std: float = 0.0) -> dict:
    """`params` with r=32 fp32 adapters on all seven projections (shared base
    tensors). B is zero, as in training, unless `b_std` draws it too."""
    import torch

    from bridgelang_tpu_torch.training.lora import add_lora_params

    g = torch.Generator(device=device).manual_seed(seed)
    llm = add_lora_params(g, params["llm"], rank=LORA_RANK)
    if b_std:
        for lp in llm["layers"]:
            for k in (k for k in lp if k.endswith("_lora_b")):
                lp[k].normal_(0.0, b_std, generator=g)
    return dict(params, llm=llm)


def base_param_count(llm: dict) -> int:
    """Decoder parameters without adapters, a packed int4 byte counting as
    its two weights."""
    n = sum(llm[k].numel() for k in ("embed", "final_norm", "lm_head"))
    for lp in llm["layers"]:
        for k, t in lp.items():
            if "_lora_" not in k and not k.endswith("_scale4"):
                n += t.numel() * (2 if k + "_scale4" in lp else 1)
    return n


def train_adapters(model, params, seed: int, label: str, steps: int, per_step: dict,
                   serve_model=None, dots_steps: int = 0) -> dict:
    """Full-depth fine-tuning of r=32 adapters over `params` on the card
    (`label`: "train" for the bf16 base, "qlora" for the int4 one): one warm
    step and `steps` timed ones, each launching each kernel `per_step[name]`
    times; a profiled step; `dots_steps` more under "dots" remat; then the
    adapters merged into the base and one action predicted through it with
    `serve_model`."""
    import numpy as np
    import torch

    from bridgelang_tpu_torch.training.lora import lora_trainable_mask, merge_lora
    from bridgelang_tpu_torch.training.trainer import (
        OptimConfig, init_train_state, make_optimizer, make_vla_train_step, tree_leaves)

    lora_params = with_lora(params, model.device, seed + 1)
    mask = lora_trainable_mask(lora_params)
    optimizer = make_optimizer(OptimConfig(learning_rate=LORA_LR, lr_scheduler_type="constant"), lora_params,
                               trainable_mask=mask)
    state = init_train_state(lora_params, optimizer, trainable_mask=mask)
    step = make_vla_train_step(model, optimizer, trainable_mask=mask, compute_dtype=torch.bfloat16,
                               image_transform=model.image_transform, remat=True, remat_policy="full")
    batch = lora_batch(model, TRAIN_BATCH, seed)
    b, f = batch["input_ids"].shape[0], batch["input_ids"].shape[1] + model.num_patches
    tokens = b * f
    n_lora = sum(t.numel() for lp in lora_params["llm"]["layers"] for k, t in lp.items() if "_lora_" in k)
    n_base = base_param_count(lora_params["llm"])
    n_vis = sum(t.numel() for part in ("vision", "projector") for t in tree_leaves(params[part]))
    vis_tokens = b * (model.num_patches + 5)  # bench.py's count: DINOv2's 256 patches + class + 4 registers
    flops = 4.0 * n_base * tokens + 6.0 * n_lora * tokens + 2.0 * n_vis * vis_tokens
    base_kind = "packed-int4 (group 128)" if label == "qlora" else "bf16"
    log(f"{label}: OpenVLA-7B {base_kind} base ({n_base / 1e9:.3f} B LLM params) + r={LORA_RANK} fp32 adapters "
        f"({n_lora / 1e6:.1f} M params), batch {b} x {f} fused tokens, full remat, AdamW lr {LORA_LR}; "
        f"useful FLOPs per step {flops:.4g}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times, totals = [], [], dict.fromkeys(KERNEL_NAMES, 0)
    for i in range(1 + steps):
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        counts = launch_counts()
        totals = {k: totals[k] + counts[k] for k in KERNEL_NAMES}
        losses.append(loss)
        log(f"{label} step {i}{' (warm)' if i == 0 else ''}: loss {loss:.4f}, grad_norm {float(m['grad_norm']):.4f}, "
            f"action_accuracy {float(m['action_accuracy']):.3f}, l1 {float(m['l1_loss']):.4f}, "
            f"{times[-1]:.1f} ms; launches {counts}")
        if not np.isfinite(loss):
            fail(f"{label} step {i}: non-finite loss {loss}")
        expect_counts(counts, per_step, f"{label} step {i}")
    if float(np.mean(losses[-3:])) >= losses[0]:
        fail(f"{label}: the mean of the last 3 losses does not fall below the first on a fixed batch: {losses}")
    step_ms = statistics.median(times[1:])
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    share = flops / (step_ms / 1e3) / PEAK_FLOPS["bfloat16"]
    log(f"{label}: median step {step_ms:.1f} ms over {steps} steps ({[round(t, 1) for t in times[1:]]}), "
        f"{tokens / (step_ms / 1e3):.1f} tokens/s, useful-FLOP share {100 * share:.2f}% of 989 TFLOP/s, "
        f"peak memory {peak_gb:.2f} GB; losses {[round(x, 4) for x in losses]}")
    prof = profile_device(f"{label} step B={b}", lambda: step(state, batch), 1)

    dots = None
    if dots_steps:
        # scripts/finetune.py's default policy, "dots": matmul outputs are saved
        # and the rest recomputed. The flash launch is no aten op, so it reruns.
        dots_step = make_vla_train_step(model, optimizer, trainable_mask=mask, compute_dtype=torch.bfloat16,
                                        image_transform=model.image_transform, remat=True, remat_policy="dots")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        dots_times = []
        for i in range(1 + dots_steps):
            reset_launch_counts()
            t0 = time.perf_counter()
            state, m = dots_step(state, batch)
            loss = float(m["loss"])
            torch.cuda.synchronize()
            dots_times.append(1e3 * (time.perf_counter() - t0))
            counts = launch_counts()
            log(f"{label} step dots {i}{' (warm)' if i == 0 else ''}: loss {loss:.4f}, {dots_times[-1]:.1f} ms; "
                f"launches {counts}")
            if not np.isfinite(loss):
                fail(f"{label} dots step {i}: non-finite loss {loss}")
            expect_counts(counts, per_step, f"{label} dots step {i}")
        dots_ms = statistics.median(dots_times[1:])
        dots = dict(step_ms=dots_ms, step_times_ms=dots_times[1:], warm_ms=dots_times[0],
                    tokens_per_s=tokens / (dots_ms / 1e3), flop_share=flops / (dots_ms / 1e3) / PEAK_FLOPS["bfloat16"],
                    peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
        log(f"{label} dots remat: median step {dots_ms:.1f} ms over {dots_steps} steps, "
            f"{dots['tokens_per_s']:.1f} tokens/s, useful-FLOP share {100 * dots['flop_share']:.2f}%, "
            f"peak memory {dots['peak_memory_gb']:.2f} GB")
        del dots_step

    trained = state.params
    del state, optimizer, step
    merged = dict(params, llm=merge_lora(trained["llm"]))
    del trained
    action = (serve_model or model).predict_action(merged, frames(1, seed=9)[0], INSTRUCTIONS[0])
    check_action(action, f"{label}: predict_action through the merged weights")
    log(f"{label}: merged weights ({base_kind}): predict_action -> {np.round(action, 4).tolist()}")
    del merged
    torch.cuda.empty_cache()
    return dict(step_ms=step_ms, step_times_ms=times[1:], warm_ms=times[0], tokens_per_step=tokens,
                tokens_per_s=tokens / (step_ms / 1e3), useful_flops=flops, flop_share=share, peak_memory_gb=peak_gb,
                losses=losses, profile=prof, launches=totals, steps=1 + steps, dots=dots)


# --- phase int4: w4a8 serving over the packed-int4 decoder ---------------------------


def int4_model(model, w8a8: bool):
    """The same OpenVLA with `LLMConfig.w8a8` set (the weights travel apart)."""
    import dataclasses

    from bridgelang_tpu_torch.models.vla import OpenVLA

    cfg = dataclasses.replace(model.cfg, llm=dataclasses.replace(model.cfg.llm, w8a8=w8a8))
    out = OpenVLA(cfg, model.norm_stats, tokenizer=model.tokenizer, dtype=model.dtype, device=model.device)
    out.image_transform = model.image_transform
    return out


def tensor_gb(tree) -> float:
    from bridgelang_tpu_torch.training.trainer import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)) / 1e9


def serve_int4(model4, params4) -> dict:
    """w4a8 /act over the packed-int4 7B: generate timings, a profile, then
    the server: 224 int4_mm_a8 launches per decoder pass, 7 decoder passes
    per predict (1568), and 32 flash_fwd launches per predict (the prefill's)."""
    import torch

    imgs = frames(2, seed=3)
    tok_a = first_token(model4, params4, imgs[0], INSTRUCTIONS[0])
    tok_b = first_token(model4, params4, imgs[1], INSTRUCTIONS[0])
    log(f"int4: prefill argmax: frame A -> {tok_a}, frame B -> {tok_b}")
    if tok_a == tok_b:
        fail("int4: prefill argmax is the same for two different frames: inputs do not flow")
    t1 = time_generate(model4, params4, imgs[0], INSTRUCTIONS[0], 1)
    t7 = time_generate(model4, params4, imgs[0], INSTRUCTIONS[0], 7)
    log(f"int4 generate_greedy B=1: 1 token {t1:.2f} ms (vision + prefill + LM head), 7 tokens {t7:.2f} ms, "
        f"decode {(t7 - t1) / 6:.2f} ms/token")
    prof = profile_predict(model4, params4)
    served = serve(model4, params4, N_SINGLE_REQUESTS,
                   {"flash_fwd": N_LAYERS_7B, "int4_mm_a8": ACTION_DIM * INT4_PER_PASS})
    served.update(prefill_ms=t1, decode_ms_per_token=(t7 - t1) / 6, profile=prof, model_gb=tensor_gb(params4),
                  llm_gb=tensor_gb(params4["llm"]))
    log(f"int4 serve: median batch-1 /act {served['median_ms']:.1f} ms; micro-batch of 4 {served['batch4_ms']:.1f} ms; "
        f"model {served['model_gb']:.2f} GB (decoder + embedding + head {served['llm_gb']:.2f} GB); "
        f"peak memory {served['max_memory_gb']:.2f} GB")
    torch.cuda.empty_cache()
    return served


# --- phase 5: card vs CPU ----------------------------------------------------------


class GradRecorder:
    """An optimizer that keeps a copy of the gradients it is handed."""

    def __init__(self, optimizer):
        self.optimizer, self.grads = optimizer, None

    def update(self, grads, state, params):
        self.grads = [g.detach().clone() for g in grads]
        self.optimizer.update(grads, state, params)


def parity_card_vs_cpu(seed: int) -> dict:
    """Card against CPU on a full-width, depth-cut fp32 model: float weights,
    then the same decoder packed to int4 (w8a8 on and off)."""
    import dataclasses

    import torch

    from bridgelang_tpu_torch.models.llm.tokenizer import ByteFallbackTokenizer
    from bridgelang_tpu_torch.models.vision.vit import VIT_CONFIGS
    from bridgelang_tpu_torch.models.vla import OpenVLA
    from bridgelang_tpu_torch.models.vlm import VLMConfig

    base = VLMConfig()
    # Full widths, depth cut: 2 decoder layers, 3-block towers (tap after block 1).
    cfg = dataclasses.replace(
        base, llm=dataclasses.replace(base.llm, n_layers=2),
        vision_override=(dataclasses.replace(VIT_CONFIGS["dinov2-vit-l"], depth=3),
                         dataclasses.replace(VIT_CONFIGS["siglip-vit-so400m"], depth=3)),
    )
    gpu = OpenVLA(cfg, STATS, tokenizer=ByteFallbackTokenizer(), dtype=torch.float32, device="cuda")
    cpu = OpenVLA(cfg, STATS, tokenizer=ByteFallbackTokenizer(), dtype=torch.float32, device="cpu")
    p_gpu = gpu.init_params(torch.Generator(device="cuda").manual_seed(seed))
    p_cpu = {
        "vision": {k: v.cpu() for k, v in p_gpu["vision"].items()},
        "projector": {k: v.cpu() for k, v in p_gpu["projector"].items()},
        "llm": {k: ([{n: t.cpu() for n, t in lp.items()} for lp in v] if k == "layers" else v.cpu())
                for k, v in p_gpu["llm"].items()},
    }
    results = {"float": parity_pair(gpu, cpu, p_gpu, p_cpu, seed, "fp32", {"flash_fwd": 2}, {})}

    # The same cut with its decoder packed to int4 on the card (one pack,
    # copied to the CPU): w4a8 and bf16-path tokens, and a QLoRA step.
    from bridgelang_tpu_torch.ops.quant import quantize_llm_int4
    from bridgelang_tpu_torch.training.trainer import tree_map

    llm4 = quantize_llm_int4(p_gpu["llm"], group=INT4_GROUP)
    p4_gpu = dict(p_gpu, llm=llm4)
    p4_cpu = dict(p_cpu, llm=tree_map(lambda t: t.cpu(), llm4))
    n_int4 = 7 * cfg.llm.n_layers  # per model pass
    for w8a8 in (True, False):
        kernel = "int4_mm_a8" if w8a8 else "int4_mm"
        results[f"int4_w8a8_{w8a8}"] = parity_pair(
            int4_model(gpu, w8a8), int4_model(cpu, w8a8), p4_gpu, p4_cpu, seed, f"int4 w8a8={w8a8}",
            {"flash_fwd": 2, kernel: 7 * n_int4}, {kernel: 2 * n_int4}, train=not w8a8)
    return results


def parity_pair(gpu, cpu, p_gpu, p_cpu, seed: int, label: str, gen_counts: dict, train_counts: dict,
                train: bool = True) -> dict:
    """Card (kernels) against CPU (plain versions) on one depth-cut model:
    7 greedy tokens for two prompts must be equal, with the card launching
    `gen_counts` and the CPU nothing; then (`train`) one adapter train step
    must give the same loss (1e-5 relative) and adapter gradients (1e-4 of
    max |g|), the card launching the flash kernels (4, 2, 2) times plus
    `train_counts`."""
    import numpy as np
    import torch

    from bridgelang_tpu_torch.ops.image_ops import frames_to_tensor, preprocess_batch

    imgs = frames(2, seed=11)
    ids, mask = gpu.pad_prompt([gpu.prepare_prompt_ids(t) for t in INSTRUCTIONS[:2]])
    out = {}
    for name, model, params in (("cuda", gpu, p_gpu), ("cpu", cpu, p_cpu)):
        dev = model.device
        pix = preprocess_batch(frames_to_tensor(np.stack(imgs), dev), model.image_transform)
        reset_launch_counts()
        tok = model.generate_greedy(params, torch.as_tensor(ids, device=dev), torch.as_tensor(mask, device=dev),
                                    pix, max_new_tokens=7)
        out[name] = (tok.cpu(), launch_counts())
    log(f"parity ({label}): depth-cut model, tokens cuda {out['cuda'][0].tolist()} (launches {out['cuda'][1]}), "
        f"cpu {out['cpu'][0].tolist()}")
    expect_counts(out["cuda"][1], gen_counts, f"parity ({label}) card generate")
    expect_counts(out["cpu"][1], {}, f"parity ({label}) CPU generate")
    if not torch.equal(out["cuda"][0], out["cpu"][0]):
        fail(f"parity ({label}): action token ids differ between the card (kernels) and the CPU (plain versions)")
    result = {"tokens": out["cuda"][0].tolist()}
    if not train:
        return result

    # One adapter train step on each side, the same adapters (B drawn too, so
    # that every adapter has a gradient) and the same batch.
    from bridgelang_tpu_torch.training.lora import lora_trainable_mask
    from bridgelang_tpu_torch.training.trainer import (
        OptimConfig, init_train_state, make_optimizer, make_vla_train_step, tree_map)

    lp_gpu = with_lora(p_gpu, "cuda", seed + 2, b_std=0.01)
    lp_cpu = dict(p_cpu, llm=tree_map(lambda t: t.detach().cpu(), lp_gpu["llm"]))
    step_out = {}
    for name, model, params in (("cuda", gpu, lp_gpu), ("cpu", cpu, lp_cpu)):
        mask = lora_trainable_mask(params)
        opt = make_optimizer(OptimConfig(learning_rate=LORA_LR), params, trainable_mask=mask)
        state = init_train_state(params, opt, trainable_mask=mask)
        recorder = GradRecorder(opt)
        step = make_vla_train_step(model, recorder, trainable_mask=mask, compute_dtype=torch.float32,
                                   image_transform=model.image_transform, remat=True)
        reset_launch_counts()
        _, m = step(state, lora_batch(model, 2, seed))
        step_out[name] = (float(m["loss"]), [g.cpu() for g in recorder.grads], launch_counts())
    (l_gpu, g_gpu, n_gpu), (l_cpu, g_cpu, n_cpu) = step_out["cuda"], step_out["cpu"]
    g_max = max(float(g.abs().max()) for g in g_cpu)
    g_err = max(float((a - b).abs().max()) for a, b in zip(g_gpu, g_cpu))
    log(f"parity ({label}): one adapter train step, loss cuda {l_gpu:.7f} cpu {l_cpu:.7f} "
        f"(rel {abs(l_gpu - l_cpu) / abs(l_cpu):.2e}, tol 1e-5); adapter grads max|cuda-cpu| {g_err:.3e} vs "
        f"max|g| {g_max:.3e} (tol 1e-4 x max|g|); launches cuda {n_gpu}")
    expect_counts(n_gpu, {"flash_fwd": 4, "flash_bwd_dq": 2, "flash_bwd_dkv": 2, **train_counts},
                  f"parity ({label}) card train step")
    expect_counts(n_cpu, {}, f"parity ({label}) CPU train step")
    if abs(l_gpu - l_cpu) > 1e-5 * abs(l_cpu) or g_err > 1e-4 * g_max:
        fail(f"parity ({label}): the train step disagrees between the card (kernels) and the CPU (plain versions)")
    return dict(result, loss_rel_err=abs(l_gpu - l_cpu) / abs(l_cpu), grad_err=g_err, grad_max=g_max)


def report_build(logs: dict) -> None:
    """Each kernel's ptxas report (registers, spills, static shared memory)
    and the dynamic shared memory its launcher asks for."""
    import ctypes
    import re

    from bridgelang_tpu_torch.ops import _build

    for source, text in logs.items():
        fn = "?"
        for line in text.splitlines():
            found = re.search(r"(?:entry function|Function properties for) '?(\w+)", line)
            if found:
                short = re.search(r"(?:flash|int4)\w*?kernel(?:IL?[^E]*E)?", found.group(1))
                fn = short.group(0) if short else found.group(1)[:60]
            if "registers" in line or "spill" in line or "(C7" in line or "error" in line.lower():
                log(f"  {source}: {fn}: {line.strip()}")
    smem = ctypes.c_int
    flash = _build.load("flash_fwd").flash_fwd_smem_bytes
    bwd = _build.load("flash_bwd").flash_bwd_smem_bytes
    int4 = _build.load("int4_matmul").int4_mm_smem_bytes
    flash.argtypes, bwd.argtypes, int4.argtypes = [smem, smem], [smem, smem, smem], [smem, smem]
    log("dynamic shared memory per block: flash_fwd bf16 D=128 {} B, D=64 {} B, fp32 D=128 {} B; "
        "flash_bwd_dq bf16 D=128 {} B, fp32 {} B; flash_bwd_dkv bf16 D=128 {} B, fp32 {} B; "
        "int4_mm bf16 M>64 {} B, M<=64 {} B".format(flash(128, 1), flash(64, 1), flash(128, 0), bwd(0, 128, 1),
                                                    bwd(0, 128, 0), bwd(1, 128, 1), bwd(1, 128, 0), int4(5632, 1),
                                                    int4(64, 1)))


def kernel_entry(name: str, source: str, replaces: str, launches: dict, timing: dict, **extra) -> dict:
    """One kernel's object in the {"kernels": [...]} line; `launches` is its
    count on each main path's run."""
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(launches.values()), "launches_by_path": launches, **{k: timing[k] for k in keys}, **extra}


def main() -> None:
    ap = argparse.ArgumentParser(description="torch port smoke run on one GPU")
    ap.add_argument("--phases", default="build,kernels,serve,train,int4,qlora,parity",
                    help="comma-separated subset, for bring-up; the full run is the default")
    args = ap.parse_args()
    phases = set(args.phases.split(","))

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a CUDA card")
    sys.path.insert(0, ROOT)
    try:
        from bridgelang_tpu_torch.ops import _build
    except ImportError as e:
        fail(f"run from the root of a checkout of the repository ({e})")
    # Full fp32 matmuls and convolutions, so the parity phase compares fp32
    # with fp32 and the int4 plain versions' group dots stay exact.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = nvidia_smi_line()
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; card: {smi}")

    t0 = time.perf_counter()
    logs = _build.build_all()
    log(f"build: {len(logs)} source(s) in {time.perf_counter() - t0:.1f} s")
    report_build(logs)

    model = params = None
    serve_t = 352
    if phases & {"serve", "train", "int4", "qlora"}:
        model, params = build_7b(SEED)
        ids, _ = model.pad_prompt([model.prepare_prompt_ids(INSTRUCTIONS[0])])
        serve_t = ids.shape[1] + model.num_patches
        log(f"serving prefill length: {ids.shape[1]}-token prompt bucket + {model.num_patches} patches = {serve_t}")
    timing_rows, max_err, bwd_timing, bwd_err, bwd_readings, int4_checks = [], None, None, None, None, None
    if "kernels" in phases:
        timing_rows, max_err = check_kernels(serve_t)
        bwd_timing, bwd_err, bwd_readings = check_backward_kernels()
        int4_checks = check_int4_kernels()

    served = None
    if "serve" in phases:
        imgs = frames(2, seed=3)
        tok_a = first_token(model, params, imgs[0], INSTRUCTIONS[0])
        tok_b = first_token(model, params, imgs[1], INSTRUCTIONS[0])
        log(f"prefill argmax: frame A -> {tok_a}, frame B -> {tok_b}")
        if tok_a == tok_b:
            fail("prefill argmax is the same for two different frames: inputs do not flow")
        t1 = time_generate(model, params, imgs[0], INSTRUCTIONS[0], 1)
        t7 = time_generate(model, params, imgs[0], INSTRUCTIONS[0], 7)
        log(f"generate_greedy B=1: 1 token {t1:.2f} ms (vision + prefill + LM head), 7 tokens {t7:.2f} ms, "
            f"decode {(t7 - t1) / 6:.2f} ms/token")
        prof = profile_predict(model, params)
        served = serve(model, params, N_SINGLE_REQUESTS, {"flash_fwd": N_LAYERS_7B})
        served.update(prefill_ms=t1, decode_ms_per_token=(t7 - t1) / 6, profile=prof)
        log(f"serve: median batch-1 /act {served['median_ms']:.1f} ms; micro-batch of 4 {served['batch4_ms']:.1f} ms; "
            f"peak memory {served['max_memory_gb']:.2f} GB")

    trained = None
    if "train" in phases:
        trained = train_adapters(model, params, SEED, "train", TRAIN_STEPS,
                                 {"flash_fwd": 2 * N_LAYERS_7B, "flash_bwd_dq": N_LAYERS_7B,
                                  "flash_bwd_dkv": N_LAYERS_7B}, dots_steps=DOTS_STEPS)

    served4 = qlora = None
    if phases & {"int4", "qlora"}:
        from bridgelang_tpu_torch.ops.quant import quantize_llm_int4

        # The bf16 decoder packed one matrix at a time; the bf16 leaves go with `params`.
        t0 = time.perf_counter()
        params = dict(params, llm=quantize_llm_int4(params["llm"], group=INT4_GROUP))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        log(f"int4: decoder packed (group {INT4_GROUP}) in {time.perf_counter() - t0:.1f} s; decoder + int8 "
            f"embedding and head {tensor_gb(params['llm']):.2f} GB, card holds {torch.cuda.memory_allocated() / 1e9:.2f} GB")
        model4 = int4_model(model, w8a8=True)
        if "int4" in phases:
            served4 = serve_int4(model4, params)
        if "qlora" in phases:
            qlora = train_adapters(int4_model(model, w8a8=False), params, SEED, "qlora", QLORA_STEPS,
                                   {"flash_fwd": 2 * N_LAYERS_7B, "flash_bwd_dq": N_LAYERS_7B,
                                    "flash_bwd_dkv": N_LAYERS_7B, "int4_mm": 2 * INT4_PER_PASS},
                                   serve_model=model4)
        del model4
    del model, params
    torch.cuda.empty_cache()

    parity = parity_card_vs_cpu(SEED) if "parity" in phases else None

    if timing_rows:
        zero = dict.fromkeys(KERNEL_NAMES, 0)
        by_path = {"serve": (served or {}).get("launches", zero), "train": (trained or {}).get("launches", zero),
                   "int4_serve": (served4 or {}).get("launches", zero), "qlora": (qlora or {}).get("launches", zero)}

        def launches(name):
            return {path: counts[name] for path, counts in by_path.items()}

        row = dict(timing_rows[0], ms=timing_rows[0]["kernel_ms"], max_abs_err=max_err)  # serving shape, B=1
        entry = kernel_entry("flash_fwd", "bridgelang_tpu_torch/csrc/flash_fwd.cu",
                             "bridgelang_tpu/ops/flash_attention.py:59", launches("flash_fwd"), row,
                             shape=row["shape"], timings=timing_rows)
        if served:
            entry["serve"] = {k: served[k] for k in ("median_ms", "prefill_ms", "decode_ms_per_token", "batch4_ms",
                                                      "batch4_passes", "passes", "max_memory_gb", "profile")}
        if trained:
            entry["train"] = trained
        if parity:
            entry["parity"] = parity
        entries = [entry]
        for name, line, ms_key, err in (("flash_bwd_dq", "bridgelang_tpu/ops/flash_attention.py:116", "dq_ms", "dq"),
                                        ("flash_bwd_dkv", "bridgelang_tpu/ops/flash_attention.py:156", "dkv_ms", "dkv")):
            bound, bound_by = bwd_timing["bounds"][err]
            timing = dict(max_abs_err=bwd_err[err], ms=bwd_timing[ms_key], plain_ms=bwd_timing["plain_ms"],
                          bound_ms=bound, bound_by=bound_by, library_ms=bwd_timing["library_ms"])
            entries.append(kernel_entry(
                name, "bridgelang_tpu_torch/csrc/flash_bwd.cu", line, launches(name), timing,
                tolerance_use=max(r[w]["use"] for r in bwd_readings.values()
                                  for w in ({"dq": ("dq",), "dkv": ("dk", "dv")}[err])),
                shape=bwd_timing["shape"], library_backend=bwd_timing["library_backend"],
                library_unpinned=bwd_timing["unpinned"],
                readings=bwd_timing["readings"][err if err == "dq" else "dkv"] + bwd_timing["readings"]["sdpa"],
                note=f"ms and library_ms: medians of {BWD_ROUNDS} interleaved rounds (readings: the kernel's, then "
                     "SDPA's); plain_ms and library_ms compute dq, dk and dv together"))
        # headline shapes: w_gate at decode (the most launched a8 shape) and at the QLoRA M
        for name, line, mode, m, key in (("int4_mm_a8", "bridgelang_tpu/ops/int4_matmul.py:114", "a8", 1, "a8"),
                                         ("int4_mm", "bridgelang_tpu/ops/int4_matmul.py:60", "bfloat16", 5632, "float")):
            rows = [r for r in int4_checks["rows"] if r["mode"] == mode]
            head = next(r for r in rows if r["m"] == m and r["n"] == 11008)
            timing = dict(head, ms=head["kernel_ms"], max_abs_err=int4_checks["worst"][key][0])
            extra = {"tolerance_use": int4_checks["worst"][key][1], "shape": head["shape"], "timings": rows,
                     "blocked": [b for b in int4_checks["blocked"] if (" a8 " in b["case"]) == (mode == "a8")]}
            if name == "int4_mm_a8" and served4:
                extra["int4_serve"] = {k: served4[k] for k in ("median_ms", "prefill_ms", "decode_ms_per_token",
                                                                "batch4_ms", "batch4_passes", "passes", "max_memory_gb",
                                                                "model_gb", "llm_gb", "profile")}
            if name == "int4_mm" and qlora:
                extra["qlora"] = qlora
            entries.append(kernel_entry(name, "bridgelang_tpu_torch/csrc/int4_matmul.cu", line, launches(name),
                                        timing, **extra))
        print(json.dumps({"kernels": entries}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
