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
           1, 352, 5632), groups 256 and 512, fp32 activations, shard-blocked
           packs, ragged M and the a8 kernels' edges (M 4, 16, 17, 65;
           w_down's split-K split does not divide its 86 groups), element
           by element (INT4_TOL); the quantize_a8 kernel bit-equal to
           quantize_activations_per_token (zero rows, rounding ties; a row
           holding a NaN gets a NaN scale in both) and the w4a8 route (quantize_a8, then int4_mm_a8
           with the token scale in its epilogue) bit-equal to its plain
           composition. Then each kernel, its plain version, a PyTorch
           yardstick (F.scaled_dot_product_attention with the equivalent
           boolean mask, forward or autograd backward, the backward pinned to
           the memory-efficient backend and timed as the median of 5 rounds
           interleaved with the kernels; F.linear over the int4 weight
           dequantized to bf16 ahead of time; the port never calls either)
           and the bound from bytes and operations, with each timed shape's
           share of the bound and its ratio to the yardstick. The timings
           are CUDA events around back-to-back wrapper calls (the earlier
           series), and for int4_mm_a8 (M=1, 352), its F.linear yardstick,
           quantize_a8 and flash_fwd (B=1) also device-side: a captured CUDA
           graph of launches, the int4 weights rotated over >= 100 MB of
           copies so that every launch reads them cold, as a decode pass does.
  load     right after the 7B's random weights are drawn: write them in the
           published HF layout (bf16, three shards with an index,
           config.json, dataset_statistics.json; plus the source-only tensors
           a published file carries: each tower's final norm and SigLIP's
           attention-pooling head) through the port's safetensors writer, the
           core keys and shapes equal to tests/golden/hf_export_manifest_
           openvla7b.json; then load_vla onto the card, cold (the files'
           pages dropped first) and page-cache warm: bf16 leaves bit-equal to
           the in-memory params; quantize_int8 and quantize_int4 on load
           bit-equal to quantize_llm_int8 / quantize_llm_int4 of them, with
           equal batch-1 ids. Seconds, GB/s, host peak RSS and device peak of
           each load; the first /act of the loaded model. Then a subprocess
           `python -m bridgelang_tpu_torch.deploy --checkpoint <dir>
           --quantize_int4 true` answers 3 /act equal to the in-process int4
           predict_action (time to listen, /act median). Every later phase
           serves and trains the bf16 weights this phase loaded.
  cold     only those device-side timings (not in the default run); with
           --package-root DIR they time another checkout's kernels (an
           earlier commit unpacked with git archive), for before-and-after
           on one card.
  serve    OpenVLA-7B (prism-dinosiglip-224px+7b) at full width in bf16,
           random weights drawn on the card from a seed, served through
           replayed CUDA graphs (models/graphs.py) and, for comparison,
           eagerly. The prefill argmax must differ between two frames; the
           graphs of the batch buckets 1, 2 and 4 are captured first (peak
           GB after each); replayed ids must equal eager generate_greedy ids
           at B=1 and B=4. Prefill and decode times, graph and eager; a CUDA
           event reading of one replay; a torch.profiler pass over batch-1
           predicts of each (device time, idle share, launches, top kernels).
           The port's VLAServer (greedy) answers POST /act: batch-1
           requests, then one micro-batch of 4 concurrent requests, through
           the graphs and then eagerly. Kernel launch counts are zeroed
           before and read after: each model pass must launch the flash
           kernel once per decoder layer (32), replays counting what their
           capture recorded.
  spec     batch-1 speculative decoding through the graph pair (verify,
           then fix-up steps) on the bf16, the int8 and the int4 7B:
           garbage, perfect and partial drafts give greedy's ids at the
           0.25 margin (accept counts printed); calibrate_speculative_margin
           on 4 frames; the server's default mode (drafts from its own
           history) over 8 ticks of slowly drifting frames, against a greedy
           server on the same ticks: /act medians, accept counts, ids equal
           on every tick, 32 flash_fwd per predict (and for int4 whole
           decoder passes of 224 int4_mm_a8 and quantize_a8). In the parity
           phase: the depth-cut fp32 model with an fp32 KV cache gives
           greedy's ids exactly for four draft kinds.
  parallel parallel_decode on the bf16 7B: POST /act with horizon=8 answers
           an [8, 7] chunk of finite floats from one masked forward that
           launches no flash_fwd; its /act beside greedy's.
  train    LoRA fine-tuning of the same bf16 7B weights: r=32 fp32
           adapters on all seven projections, adapter-only AdamW (lr 5e-4,
           constant), batch 16 from DummyDataset through RLDSBatchTransform
           and the collator (96 tokens + 256 patches = 352), raw frames
           preprocessed in the step, full remat. One warm step, 6 timed
           steps: each must launch flash_fwd 64 times (32 layers, forward
           and recompute) and each backward kernel 32 times; losses finite
           and falling. One profiled step; then one warm and 2 timed
           steps under "dots" remat (scripts/finetune.py's default), with
           the same launch counts; then CheckpointManager.save of the LoRA
           state (frozen base dropped), restore into a fresh state, and one
           step from each of the restored and the uninterrupted state (bit-
           equal, else 1e-6 relative); then merge the adapters and predict
           one action through the merged weights.
  int8     the same decoder quantized by quantize_llm_int8 (int8 embedding
           and head), LLMConfig.w8a8 on, served as `serve`: model and peak
           GB; every projection of the prefill (T=352) must take the int8 x
           int8 product (torch._int_mm) and every decode projection the
           weight cast; the device time of one decode step's casts and their
           share of a predict's device time.
  int4     the same decoder packed to int4 by quantize_llm_int4 (group
           128; int8 embedding and head) and the bf16 layers freed; with
           LLMConfig.w8a8 on, served as `serve`: every decoder pass must
           launch int4_mm_a8 and quantize_a8 224 times each (7 projections
           x 32 layers), 7 passes per predict, and each predict flash_fwd 32
           times (the prefill); model and peak GB.
  qlora    r=32 fp32 adapters over that int4 base with w8a8 off, as `train`
           (batch 16, 352 tokens, full remat, one warm and 6 timed steps):
           each step launches int4_mm 448 times (forward and recompute) and
           the flash kernels 64/32/32; losses finite and falling; merge into
           the int4 base (dequantize, add, requantize) and predict one
           action through the merged int4 weights.
  finetune the port's entry points over a native episode store that the
           phase writes (LIBERO's layout: 24 episodes x 50 steps, 256x256
           frames from two cameras, 7-D actions, 8-D states), read through
           the TF-free pipeline by the dataset's worker processes:
           finetune.main on the load phase's published-layout 7B (bf16 LoRA
           r=32, batch 16, image_aug, 8 steps, the bf16 HF export loaded
           back and serving one action under the store's statistics), int8
           QLoRA (4 steps, no int8 code moves, the merge against the plain
           formula), the parallel objective (--action_chunk 8, full remat: no
           flash launch, peak under the train phase's dots peak; an [8, 7]
           chunk from the trained weights), and train.main at full width with
           2 decoder layers (5 steps; resumed from the step-4 checkpoint, the
           5th step bit-equal). The entry points run unchanged; the phase
           times their steps, batches, saves and exports from outside, and
           profiles steps 3-8.
  parity   a depth-cut fp32 model with the same weights on the card
           (through the kernels) and on the CPU (plain versions): the
           action token ids must be equal, and one LoRA train step must
           give the same loss (1e-5 relative) and adapter gradients
           (1e-4 of max |g|); then the same cut packed to int4: equal ids
           with w8a8 on and off, and one QLoRA step under the same rule; the
           cut quantized to int8: equal ids with w8a8 off, and with it on
           teacher-forced logits within 0.05 max|logit| (argmax equal where
           the CPU's top-2 margin clears twice that). The fp32 cut is also
           exported (export_checkpoint) and loaded back with load_vla on the
           card: leaves bit-equal, batch-2 ids equal.
Then one line {"kernels": [...]}, the nvidia-smi line, and as the last line
{"ok": true, "device": {...}}. Without a CUDA card, or outside a checkout,
it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import math
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
KERNEL_NAMES = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "int4_mm_a8", "int4_mm", "quantize_a8")
# substrings of the kernels' names in a profiler trace ("int4_mm_a8_": the split-K and the wgmma kernel)
PROFILE_NAMES = {"flash_fwd": "flash_fwd", "flash_bwd_dq": "flash_bwd_dq", "flash_bwd_dkv": "flash_bwd_dkv",
                 "int4_mm_a8": "int4_mm_a8_", "quantize_a8": "quantize_a8_kernel",
                 "int4_mm bf16": "int4_mm_bf16_wgmma", "int4_mm bf16 M<=64": "int4_mm_tc_kernel",
                 "int4_mm fp32": "int4_mm_f32"}
COLD_BYTES = 100e6       # weight copies rotated per timed launch: twice the 50 MB L2, so each launch reads cold
GRAPH_LAUNCHES = 60      # launches per captured graph in the device-side timings
SPEC_TICKS = 8           # server ticks of one instruction in the spec phase
HORIZON = 8              # the parallel phase's chunk length


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
              ("w_gate", "bfloat16", 37, 128, 2), ("w_gate", "a8", 352, 128, 2),  # 5504-wide blocks
              ("w_gate", "a8", 4, 128, 1), ("w_down", "a8", 16, 128, 1), ("wq", "a8", 17, 128, 1),
              ("w_gate", "a8", 65, 128, 1), ("wq", "a8", 1, 512, 1), ("w_down", "a8", 1, 256, 1),
              ("w_gate", "a8", 1, 128, 2), ("w_gate", "a8", 4, 128, 2)]
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


_WARM_STREAM = []  # one side stream for every capture's warm-up: cuBLAS keeps a workspace per stream


def graph_ms(fns, launches: int = GRAPH_LAUNCHES, replays: int = 3) -> float:
    """Device time per launch, the host's path through the wrappers outside
    the window: `launches` calls cycling over `fns`, captured in one CUDA
    graph, replayed once warm and then `replays` times between two events;
    the median per launch."""
    import torch

    if not _WARM_STREAM:
        _WARM_STREAM.append(torch.cuda.Stream())
    side = _WARM_STREAM[0]
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns:  # builds, configures and allocates what a launch needs before the capture
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(launches):
            fns[i % len(fns)]()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(replays):
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    del graph
    torch.cuda.empty_cache()
    return statistics.median(times)


def rotated(tensors, n_bytes_each: int):
    """The tensors and enough clones of them that one pass over all copies
    moves COLD_BYTES: each launch of a rotation finds its weights out of L2."""
    n = max(2, -(-int(COLD_BYTES) // max(1, n_bytes_each)))
    return [tensors] + [tuple(t.clone() for t in tensors) for _ in range(n - 1)]


def cold_timings(label: str) -> dict:
    """Device-side times, cold L2 (weights rotated over COLD_BYTES of
    copies): int4_mm_a8 at M=1 and M=352 at the three 7B shapes, F.linear
    over the weight dequantized to bf16 (the yardstick), and flash_fwd at the
    serving shape B=1 (its inputs warm, as the prefill writes them just
    before); each beside its CUDA-event reading around back-to-back wrapper
    calls, the series the earlier PRs report. Where the package has it, the
    quantize_a8 kernel. Runs on any checkout's package (--package-root)."""
    import torch
    import torch.nn.functional as F

    from bridgelang_tpu_torch.ops import int4_matmul as im
    from bridgelang_tpu_torch.ops.flash_attention import flash_attention
    from bridgelang_tpu_torch.ops.quant import _quantize4_2d, dequant_int4, quantize_activations_per_token

    new = hasattr(im, "quantize_a8")
    rows = {}
    for shape, (k, n) in INT4_SHAPES_7B.items():
        g = torch.Generator(device="cuda").manual_seed(700)
        packed, scales = _quantize4_2d(torch.randn((k, n), generator=g, device="cuda").mul_(k ** -0.5), INT4_GROUP)
        copies = rotated((packed, scales), packed.numel() + 2 * scales.numel())
        w_bf = dequant_int4(packed, scales, torch.bfloat16).t().contiguous()
        w_copies = rotated((w_bf,), 2 * w_bf.numel())
        for m in (1, 352):
            x = torch.randn((m, k), generator=g, device="cuda")
            q, _ = quantize_activations_per_token(x)
            x_bf = x.to(torch.bfloat16)
            r = dict(shape=f"M={m} K={k} N={n} group={INT4_GROUP}", copies=len(copies), library_copies=len(w_copies))
            r["device_ms"] = graph_ms([lambda p=p, s=s: im.int4_mm_a8(q, p, s) for p, s in copies])
            r["event_ms"] = cuda_ms(lambda: im.int4_mm_a8(q, packed, scales), 50)
            r["library_device_ms"] = graph_ms([lambda w=w: F.linear(x_bf, w) for (w,) in w_copies])
            r["library_event_ms"] = cuda_ms(lambda: F.linear(x_bf, w_bf), 50)
            r["bound_ms"], r["bound_by"] = int4_bound_ms(m, k, n, INT4_GROUP, "a8")
            rows[(shape, m)] = r
            log(f"cold int4_mm_a8 ({label}) {shape} {r['shape']}: device {r['device_ms']:.5f} ms over {len(copies)} "
                f"rotated weight copies (event window {r['event_ms']:.4f} ms); F.linear device "
                f"{r['library_device_ms']:.5f} ms (event {r['library_event_ms']:.4f} ms); bound {r['bound_ms']:.5f} ms "
                f"({r['bound_by']}), share {r['bound_ms'] / r['device_ms']:.3f}, kernel / F.linear "
                f"{r['device_ms'] / r['library_device_ms']:.2f}")
        del copies, w_copies, w_bf
        torch.cuda.empty_cache()

    t = 352
    q_, k_, v_, lens = attention_case(1, t, t, 32, 32, 128, [t - 21], None, torch.bfloat16, seed=100)
    mask = valid_mask(t, t, [t - 21], None, device="cuda")[:, None]
    qt, kt, vt = (x.transpose(1, 2) for x in (q_, k_, v_))
    flash = dict(shape=f"B=1 T={t} S={t} H=32 D=128 bf16",
                 device_ms=graph_ms([lambda: flash_attention(q_, k_, v_, lengths=lens, causal=True)]),
                 event_ms=cuda_ms(lambda: flash_attention(q_, k_, v_, lengths=lens, causal=True), 100),
                 library_device_ms=graph_ms([lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)]))
    log(f"device-side flash_fwd ({label}) {flash['shape']}: {flash['device_ms']:.5f} ms (event window "
        f"{flash['event_ms']:.4f} ms); sdpa (yardstick) device {flash['library_device_ms']:.5f} ms")
    out = {"int4_mm_a8": rows, "flash_fwd": flash}
    if new:
        out["quantize_a8"] = time_quantize(label)
    del q_, k_, v_, lens, qt, kt, vt, mask
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)  # a CUDA build's; its workspaces per stream
    if clear is not None:  # would otherwise count in every later phase's peak memory
        clear()
    torch.cuda.empty_cache()
    log(f"after the device-side timings the card holds {torch.cuda.memory_allocated() / 1e9:.3f} GB")
    return out


def time_quantize(label: str) -> dict:
    """quantize_a8 at the serving shapes (bf16 x, K=4096; M=1 and 352):
    device time (graph), event time, the plain version's, and the bound:
    M K 2 bytes read, M K + 4 M written."""
    import torch

    from bridgelang_tpu_torch.ops.int4_matmul import quantize_a8
    from bridgelang_tpu_torch.ops.quant import quantize_activations_per_token

    rows = {}
    for m in (1, 352):
        k = INT4_SHAPES_7B["wq"][0]
        x = torch.randn((m, k), generator=torch.Generator(device="cuda").manual_seed(800 + m), device="cuda",
                        dtype=torch.bfloat16)
        n_bytes = 2 * m * k + m * k + 4 * m
        r = dict(shape=f"M={m} K={k} bf16", device_ms=graph_ms([lambda: quantize_a8(x)]),
                 event_ms=cuda_ms(lambda: quantize_a8(x), 100),
                 plain_ms=cuda_ms(lambda: quantize_activations_per_token(x), 100),
                 plain_device_ms=graph_ms([lambda: quantize_activations_per_token(x)]),
                 bound_ms=1e3 * n_bytes / HBM_BYTES_PER_S, bound_by="bytes")
        rows[m] = r
        log(f"timing quantize_a8 ({label}) {r['shape']}: device {r['device_ms']:.5f} ms (event {r['event_ms']:.4f} ms); "
            f"plain (torch ops) device {r['plain_device_ms']:.5f} ms (event {r['plain_ms']:.4f} ms); bound "
            f"{r['bound_ms']:.6f} ms (bytes)")
    return rows


def check_quantize_and_route() -> dict:
    """The quantize_a8 kernel bit-equal to quantize_activations_per_token
    (bf16 and fp32 rows, zero rows, rows on rounding ties; rows holding a
    NaN get a NaN scale in both, their codes not compared), and the w4a8
    route on the card (quantize_a8, then int4_mm_a8 with the token scale and
    the cast in its epilogue: two launches) bit-equal to the plain
    composition (int4_matmul_a8_plain(q) * xs).to(x's dtype). Returns the
    largest |q - plain q|, |scale - plain scale| and route error read."""
    import torch

    from bridgelang_tpu_torch.ops import int4_matmul as im
    from bridgelang_tpu_torch.ops.quant import _quantize4_2d, quantize_activations_per_token

    g = torch.Generator(device="cuda").manual_seed(900)
    ties = torch.tensor([127.0, 2.5, -2.5, 3.5, 0.5, -0.5, 1.5, -1.5, 126.5, -126.5, 0.0, 64.5] * 341 + [0.0] * 4,
                        device="cuda")
    cases = {"bf16_m352": torch.randn((352, 4096), generator=g, device="cuda").to(torch.bfloat16),
             "fp32_m37_k11008": torch.randn((37, 11008), generator=g, device="cuda") * 3.0,
             "zero_rows": torch.cat([torch.zeros((2, 4096), device="cuda"),
                                     torch.randn((2, 4096), generator=g, device="cuda")]).to(torch.bfloat16),
             "ties_bf16": torch.stack([ties, 2 * ties, -ties]).to(torch.bfloat16),
             "ties_fp32": torch.stack([ties, 2 * ties, -ties]),
             "nan_rows_bf16": torch.randn((6, 4096), generator=g, device="cuda").to(torch.bfloat16)}
    cases["nan_rows_bf16"][1, 0] = cases["nan_rows_bf16"][4, 4095] = float("nan")
    errs = {"codes": 0.0, "scales": 0.0, "route": 0.0}
    for name, x in cases.items():
        q, xs = im.quantize_a8(x)
        torch.cuda.synchronize()
        pq, pxs = quantize_activations_per_token(x)
        rows = ~pxs[:, 0].isnan()  # a NaN row's codes are conversions of NaN: only its NaN scale is compared
        nan_rows = int((~rows).sum())
        code_err = float((q[rows].int() - pq[rows].int()).abs().max())
        scale_err = float((xs[rows] - pxs[rows]).abs().max())
        errs["codes"], errs["scales"] = max(errs["codes"], code_err), max(errs["scales"], scale_err)
        ok = (torch.equal(q[rows], pq[rows]) and torch.equal(xs[rows], pxs[rows])
              and torch.equal(xs.isnan(), pxs.isnan()) and nan_rows == (2 if name.startswith("nan") else 0))
        log(f"kernel quantize_a8 {name} {tuple(x.shape)} {x.dtype}: max|codes err| {code_err:g}, max|scales err| "
            f"{scale_err:g}, rows with a NaN scale (kernel, plain) ({int(xs.isnan().sum())}, {nan_rows}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"quantize_a8 differs from quantize_activations_per_token in case {name}")
    k, n = INT4_SHAPES_7B["w_gate"]
    packed, scales = _quantize4_2d(torch.randn((k, n), generator=g, device="cuda").mul_(k ** -0.5), INT4_GROUP)
    for m, dtype in ((1, torch.bfloat16), (4, torch.bfloat16), (352, torch.bfloat16), (37, torch.float32)):
        x = torch.randn((m, k), generator=g, device="cuda").to(dtype)
        before = (im.quantize_a8.launches, im.int4_mm_a8.launches)
        got = im.matmul_int4_a8(x, packed, scales)
        torch.cuda.synchronize()
        launched = (im.quantize_a8.launches - before[0], im.int4_mm_a8.launches - before[1])
        pq, pxs = quantize_activations_per_token(x)
        want = (im.int4_matmul_a8_plain(pq, packed, scales) * pxs).to(dtype)
        ok = torch.equal(got, want) and launched == (1, 1)
        err = float((got.float() - want.float()).abs().max())
        errs["route"] = max(errs["route"], err)
        log(f"w4a8 route w_gate M={m} {dtype}: launches (quantize_a8, int4_mm_a8) {launched}, max|err| "
            f"{err:.3e} {'bit-equal ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"the w4a8 route on the card differs from its plain composition at M={m} {dtype}")
    return errs


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
    # dtype conversions (an int8 weight cast to bf16 among them) run ATen's direct_copy kernel
    copy_ms = sum(v for n, v in by_name.items() if "direct_copy_kernel" in n)
    return {"wall_ms": wall_ms, "device_ms": busy_ms, "idle_share": 1 - busy_ms / wall_ms,
            "launches_per_call": len(kernels) / reps, "flash_ms": flash, "direct_copy_ms": copy_ms,
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
    """VLAServer /act with greedy decoding (the speculative default off; the
    spec phase serves it): `n_single` batch-1 requests, then a micro-batch of
    4 concurrent ones. Launch counts are zeroed before each and read after;
    each of the server's model passes (one predict: the prefill and the
    decode steps) must launch each kernel `per_pass[name]` times (the others
    never). A CUDA model with `use_graphs` answers through replayed graphs,
    whose replays add the launches their capture recorded."""
    import torch

    from bridgelang_tpu_torch.serving.server import VLAServer, client_act

    imgs = frames(4, seed=7)
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()

    single = VLAServer(model, params, max_batch=1, speculative_default=False, device=model.device)
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
    batched = VLAServer(model, params, max_batch=4, batch_window_ms=2000.0, speculative_default=False,
                        device=model.device)
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


# --- phase 3b: the published checkpoint layout, written and loaded ---------------------

CKPT_SHARDS = 3           # the published openvla-7b's model-0000{1,2,3}-of-00003.safetensors
CKPT_FREE_BYTES = 17e9    # the bf16 7B checkpoint (15.05 GB) and its headroom
GOLDEN_MANIFEST = os.path.join(ROOT, "tests", "golden", "hf_export_manifest_openvla7b.json")
N_DEPLOY_REQUESTS = 3     # /act requests to the deploy --checkpoint subprocess
DEPLOY_LISTEN_S = 600     # its load, graph warm-up and listen must fit in this


def source_only_tensors(params) -> dict:
    """The tensors a published OpenVLA checkpoint carries that the port never
    runs, so the loader must skip them: each tower's final `norm` and
    SigLIP's attention-pooling head (bridgelang_tpu/extern/timm_shim.py:155-181
    shapes), random bf16 drawn on the card when written."""
    import torch

    from bridgelang_tpu_torch.util.safetensors_io import Lazy

    g = torch.Generator(device="cuda").manual_seed(SEED + 7)
    shapes = {}
    for tower in ("featurizer", "fused_featurizer"):
        w = params["vision"][f"{tower}.patch_embed.weight"].shape[0]
        shapes[f"vision_backbone.{tower}.norm.weight"] = (w,)
        shapes[f"vision_backbone.{tower}.norm.bias"] = (w,)
    w, hidden = params["vision"]["fused_featurizer.patch_embed.weight"].shape[0], \
        params["vision"]["fused_featurizer.blocks.0.mlp_fc1.weight"].shape[0]
    pool = {"latent": (1, 1, w), "q.weight": (w, w), "q.bias": (w,), "kv.weight": (2 * w, w), "kv.bias": (2 * w,),
            "proj.weight": (w, w), "proj.bias": (w,), "norm.weight": (w,), "norm.bias": (w,),
            "mlp.fc1.weight": (hidden, w), "mlp.fc1.bias": (hidden,), "mlp.fc2.weight": (w, hidden),
            "mlp.fc2.bias": (w,)}
    shapes.update({f"vision_backbone.fused_featurizer.attn_pool.{k}": v for k, v in pool.items()})
    return {k: Lazy(torch.bfloat16, v, lambda v=v: torch.randn(v, generator=g, device="cuda", dtype=torch.bfloat16)
                    .mul_(0.02)) for k, v in shapes.items()}


def write_published_checkpoint(model, params, out_dir) -> dict:
    """The 7B in the published layout: bf16, three shards with an index,
    config.json and dataset_statistics.json, through the port's writer and
    the exporter's key mapping; the core keys and shapes held to the golden
    manifest. Timed to the end of an fsync of every file."""
    import math

    import torch

    from bridgelang_tpu_torch.extern.hf_export import export_state_dict, write_sidecars
    from bridgelang_tpu_torch.util.safetensors_io import save_sharded, tensor_nbytes

    core = export_state_dict(params, dtype=torch.bfloat16)
    with open(GOLDEN_MANIFEST) as f:
        golden = json.load(f)
    got = {k: list(v.shape) for k, v in core.items()}
    if got != golden:
        fail(f"load: the written core keys differ from the golden manifest: "
             f"{sorted(set(got) ^ set(golden))[:6] or [k for k in got if got[k] != golden.get(k)][:6]}")
    extra = source_only_tensors(params)
    tensors = {**core, **extra}
    n_core = sum(math.prod(v.shape) for v in core.values())
    n_bytes = sum(tensor_nbytes(v) for v in tensors.values())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    files = save_sharded(tensors, out_dir, CKPT_SHARDS, metadata={"format": "pt"})
    write_sidecars(model, out_dir)
    for f in files:
        fd = os.open(f, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    dt = time.perf_counter() - t0
    log(f"load: wrote {len(tensors)} tensors ({len(core)} core = the golden manifest, {n_core / 1e9:.3f} B params; "
        f"{len(extra)} source-only), {n_bytes / 1e9:.2f} GB bf16 in {CKPT_SHARDS} shards in {dt:.1f} s "
        f"({n_bytes / 1e9 / dt:.2f} GB/s, fsync included)")
    return dict(tensors=len(tensors), core_tensors=len(core), core_params=n_core, bytes=n_bytes, seconds=dt,
                gb_per_s=n_bytes / 1e9 / dt, files=[os.path.basename(f) for f in files])


def drop_page_cache(ckpt_dir) -> bool:
    """Ask the kernel to drop the checkpoint's clean pages (fadvise
    DONTNEED), so the next read comes from the disk."""
    for name in sorted(os.listdir(ckpt_dir)):
        fd = os.open(os.path.join(ckpt_dir, name), os.O_RDONLY)
        try:
            os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
        finally:
            os.close(fd)
    return True


def host_memory_kb() -> dict:
    with open("/proc/self/status") as f:
        return {k: int(v.split()[0]) for k, v in (line.split(":", 1) for line in f) if k in ("VmRSS", "VmHWM")}


class HostPeak:
    """The process's peak RSS over a block, above its RSS at the start:
    VmHWM after resetting it through /proc/self/clear_refs where the kernel
    allows that, else the largest VmRSS read every 2 ms by a thread (`how`
    says which)."""

    def __enter__(self):
        self.rss0 = host_memory_kb()["VmRSS"]
        try:
            with open("/proc/self/clear_refs", "w") as f:
                f.write("5")
            self.how, self.thread = "VmHWM after clear_refs", None
        except OSError as e:
            self.how = f"VmRSS sampled every 2 ms (clear_refs: {e.strerror})"
            self.peak, self.stop = self.rss0, threading.Event()
            self.thread = threading.Thread(target=self._sample, daemon=True)
            self.thread.start()
        return self

    def _sample(self):
        while not self.stop.is_set():
            self.peak = max(self.peak, host_memory_kb()["VmRSS"])
            self.stop.wait(0.002)

    def __exit__(self, *exc):
        if self.thread is None:
            self.peak = host_memory_kb()["VmHWM"]
        else:
            self.stop.set()
            self.thread.join()
            self.peak = max(self.peak, host_memory_kb()["VmRSS"])
        self.gb = (self.peak - self.rss0) * 1024 / 1e9
        return False


def timed_load(path: str, label: str, n_bytes: int, cold: bool, **kw):
    """load_vla onto the card, timed, with the host's peak RSS above its RSS
    before (HostPeak) and the device peak above what the card held before."""
    import torch

    from bridgelang_tpu_torch.models.load import load_vla

    if cold:
        drop_page_cache(path)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with HostPeak() as host:
        t0 = time.perf_counter()
        model, params = load_vla(path, **kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    r = dict(seconds=dt, gb_per_s=n_bytes / 1e9 / dt, cold=cold, host_peak_gb=host.gb, host_peak_how=host.how,
             device_peak_gb=(torch.cuda.max_memory_allocated() - base) / 1e9,
             model_gb=(torch.cuda.memory_allocated() - base) / 1e9)
    log(f"load ({label}, {'cold' if cold else 'page-cache warm'}): {dt:.2f} s, {r['gb_per_s']:.2f} GB/s of file; "
        f"host peak RSS +{host.gb:.3f} GB over the load ({host.how}); device peak +{r['device_peak_gb']:.2f} GB, "
        f"holds +{r['model_gb']:.2f} GB after")
    return model, params, r


def bits(t):
    import torch

    return t.view({1: torch.int8, 2: torch.int16, 4: torch.int32}[t.element_size()]) if t.is_floating_point() else t


def assert_params_bit_equal(got, want, what: str) -> int:
    """Every leaf of two port params trees equal in dtype, shape and bits."""
    import torch

    def named(p):
        out = {f"vision.{k}": v for k, v in p["vision"].items()}
        out.update({f"projector.{k}": v for k, v in p["projector"].items()})
        out.update({f"llm.{k}": v for k, v in p["llm"].items() if k != "layers"})
        out.update({f"llm.{i}.{k}": v for i, lp in enumerate(p["llm"]["layers"]) for k, v in lp.items()})
        return out

    g, w = named(got), named(want)
    if set(g) != set(w):
        fail(f"{what}: leaves differ: {sorted(set(g) ^ set(w))[:6]}")
    bad = [k for k in w if g[k].dtype != w[k].dtype or g[k].shape != w[k].shape or not torch.equal(bits(g[k]), bits(w[k]))]
    if bad:
        fail(f"{what}: {len(bad)} of {len(w)} leaves not bit-equal, e.g. {bad[:4]}")
    return len(w)


def counted_ids(model, params, img, instruction, per_pass: dict, what: str):
    """One batch-1 predict's ids through the graphs (captured by a first
    predict), its launches counted: `per_pass` times each kernel."""
    model.predict_action_batch(params, [img], [instruction], return_tokens=True)
    reset_launch_counts()
    _, ids = model.predict_action_batch(params, [img], [instruction], return_tokens=True)
    counts = launch_counts()
    expect_counts(counts, per_pass, what)
    return ids[0].tolist(), counts


def deploy_subprocess(ckpt_dir: str, model4, params4) -> dict:
    """`python -m bridgelang_tpu_torch.deploy --checkpoint <dir> --quantize_int4
    true` in its own process: time to listen (the load and graph warm-up
    included), then N_DEPLOY_REQUESTS /act, each equal to the in-process
    greedy predict_action of the int4-loaded model; the process is stopped."""
    import http.client
    import socket

    import numpy as np

    from bridgelang_tpu_torch.serving.server import client_act

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    log_path = os.path.join(os.path.dirname(ckpt_dir), "deploy_subprocess.log")
    cmd = [sys.executable, "-m", "bridgelang_tpu_torch.deploy", "--checkpoint", ckpt_dir, "--quantize_int4", "true",
           "--speculative_default", "false", "--host", "127.0.0.1", "--port", str(port)]
    imgs = frames(N_DEPLOY_REQUESTS, seed=13)
    with open(log_path, "w") as out:
        t0 = time.perf_counter()
        proc = subprocess.Popen(cmd, cwd=ROOT, stdout=out, stderr=subprocess.STDOUT)
        try:
            listen_s = None
            while time.perf_counter() - t0 < DEPLOY_LISTEN_S and proc.poll() is None:
                try:
                    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
                    conn.request("GET", "/healthz")
                    if conn.getresponse().status == 200:
                        listen_s = time.perf_counter() - t0
                        break
                except OSError:
                    time.sleep(0.5)
                finally:
                    conn.close()
            if listen_s is None:
                raise RuntimeError(f"deploy did not listen within {DEPLOY_LISTEN_S} s (exit code {proc.poll()})")
            lat, equal = [], []
            for i, img in enumerate(imgs):
                t1 = time.perf_counter()
                got = np.asarray(client_act("127.0.0.1", port, img, INSTRUCTIONS[i], timeout=300), np.float32)
                lat.append(1e3 * (time.perf_counter() - t1))
                want = model4.predict_action(params4, img, INSTRUCTIONS[i])
                equal.append(bool(np.array_equal(got, want)))
                if not equal[-1]:
                    raise RuntimeError(f"/act {i} from deploy {got.tolist()} != in-process predict {want.tolist()}")
        except (RuntimeError, OSError, ValueError) as e:
            with open(log_path) as f:
                tail = f.read()[-3000:]
            fail(f"deploy --checkpoint subprocess: {e}\n{tail}")
        finally:
            proc.terminate()
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
    log(f"load: deploy --checkpoint --quantize_int4 true subprocess listened after {listen_s:.1f} s (its load and "
        f"graph warm-up included); {N_DEPLOY_REQUESTS} x /act equal to the in-process int4 predict_action, latency "
        f"ms {[round(x, 1) for x in lat]} (median {statistics.median(lat):.1f}); stopped")
    return dict(listen_s=listen_s, act_ms=lat, act_median_ms=statistics.median(lat))


def load_phase(model, params, keep_ckpt: bool = False):
    """The 7B written in the published layout and loaded back through
    load_vla (bf16, then quantized on load to int8 and int4), each held to
    its in-memory twin bit for bit with equal batch-1 ids; the first /act of
    the loaded bf16 model; a deploy --checkpoint subprocess. Returns the
    loaded bf16 (model, params), which the later phases serve and train, and
    the phase's numbers. With `keep_ckpt` the written checkpoint stays (its
    path in the numbers, "ckpt_dir") for the finetune phase."""
    import shutil
    import tempfile

    from bridgelang_tpu_torch.models.llm.tokenizer import ByteFallbackTokenizer
    from bridgelang_tpu_torch.ops.quant import quantize_llm_int4, quantize_llm_int8
    from bridgelang_tpu_torch.serving.server import VLAServer, client_act

    t_phase = time.perf_counter()
    parent = os.path.join(ROOT, "build")
    os.makedirs(parent, exist_ok=True)
    free = shutil.disk_usage(parent).free
    log(f"load: {free / 1e9:.1f} GB free under {parent}")
    if free < CKPT_FREE_BYTES:
        fail(f"load: {free / 1e9:.1f} GB free on the checkout's disk; the bf16 7B checkpoint needs "
             f"{CKPT_FREE_BYTES / 1e9:.0f} GB")
    ckpt = tempfile.mkdtemp(prefix="smoke_ckpt_", dir=parent)
    result = {"launches": dict.fromkeys(KERNEL_NAMES, 0)}
    try:
        result["write"] = write_published_checkpoint(model, params, ckpt)
        n_bytes = result["write"]["bytes"]
        img = frames(1, seed=17)[0]

        loaded, lparams, result["bf16"] = timed_load(ckpt, "bf16", n_bytes, cold=True)
        n = assert_params_bit_equal(lparams, params, "load bf16")
        if loaded.norm_stats != STATS:
            fail(f"load: norm_stats {loaded.norm_stats} != {STATS}")
        loaded.tokenizer = ByteFallbackTokenizer()
        _, _, result["bf16_warm"] = timed_load(ckpt, "bf16", n_bytes, cold=False)
        release_memory()
        server = VLAServer(loaded, lparams, max_batch=1, speculative_default=False, device=loaded.device)
        httpd = server.serve_background(port=0)
        try:
            t0 = time.perf_counter()
            check_action(client_act("127.0.0.1", httpd.server_address[1], img, INSTRUCTIONS[0], timeout=300),
                         "load: the first /act of the loaded model")
            result["first_act_ms"] = 1e3 * (time.perf_counter() - t0)
        finally:
            httpd.shutdown()
            httpd.server_close()
            server.close()
        ids_mem, _ = counted_ids(model, params, img, INSTRUCTIONS[0], {"flash_fwd": N_LAYERS_7B}, "load: in-memory bf16")
        ids_bf16, counts = counted_ids(loaded, lparams, img, INSTRUCTIONS[0], {"flash_fwd": N_LAYERS_7B},
                                       "load: loaded bf16")
        result["launches"] = {k: result["launches"][k] + counts[k] for k in KERNEL_NAMES}
        if ids_bf16 != ids_mem:
            fail(f"load: loaded bf16 ids {ids_bf16} != in-memory {ids_mem}")
        log(f"load: bf16 leaves bit-equal ({n} tensors), norm_stats equal, batch-1 ids {ids_bf16} equal; the first "
            f"/act after the load {result['first_act_ms']:.1f} ms (its graph capture included)")
        model.graphs.clear()
        del model, params
        release_memory()

        for kind, quantize, per_pass in (
                ("int8", lambda llm: quantize_llm_int8(llm), {"flash_fwd": N_LAYERS_7B}),
                ("int4", lambda llm: quantize_llm_int4(llm, group=INT4_GROUP),
                 {"flash_fwd": N_LAYERS_7B, "int4_mm_a8": ACTION_DIM * INT4_PER_PASS,
                  "quantize_a8": ACTION_DIM * INT4_PER_PASS})):
            qmodel, qparams, result[kind] = timed_load(ckpt, kind, n_bytes, cold=True, **{f"quantize_{kind}": True})
            mem = dict(lparams, llm=quantize(lparams["llm"]))
            n = assert_params_bit_equal(qparams, mem, f"load {kind}")
            qmodel.tokenizer = loaded.tokenizer
            twin = w8a8_model(loaded, w8a8=True)
            ids_mem, _ = counted_ids(twin, mem, img, INSTRUCTIONS[0], per_pass, f"load: in-memory {kind}")
            ids_q, counts = counted_ids(qmodel, qparams, img, INSTRUCTIONS[0], per_pass, f"load: loaded {kind}")
            result["launches"] = {k: result["launches"][k] + counts[k] for k in KERNEL_NAMES}
            if ids_q != ids_mem:
                fail(f"load: {kind}-loaded ids {ids_q} != quantized in memory {ids_mem}")
            log(f"load: {kind} leaves bit-equal to quantize_llm_{kind} of the bf16 params ({n} tensors), batch-1 "
                f"ids {ids_q} equal")
            twin.graphs.clear()
            del twin, mem
            release_memory()
            _, _, result[f"{kind}_warm"] = timed_load(ckpt, kind, n_bytes, cold=False, **{f"quantize_{kind}": True})
            release_memory()
            if kind == "int4":
                result["deploy"] = deploy_subprocess(ckpt, qmodel, qparams)
            qmodel.graphs.clear()
            del qmodel, qparams
            release_memory()
    finally:
        if not keep_ckpt:
            shutil.rmtree(ckpt, ignore_errors=True)
    if keep_ckpt:
        result["ckpt_dir"] = ckpt
    result["phase_s"] = time.perf_counter() - t_phase
    log(f"load phase: {result['phase_s']:.1f} s")
    return loaded, lparams, result


# --- phase 4: LoRA fine-tuning ------------------------------------------------------


def kernel_wrappers() -> dict:
    """Each kernel's wrapper, which counts its launches in `.launches`."""
    from bridgelang_tpu_torch.models.graphs import counted_wrappers

    return dict(zip(KERNEL_NAMES, counted_wrappers()))


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
                   serve_model=None, dots_steps: int = 0, resume_check: bool = False) -> dict:
    """Full-depth fine-tuning of r=32 adapters over `params` on the card
    (`label`: "train" for the bf16 base, "qlora" for the int4 one): one warm
    step and `steps` timed ones, each launching each kernel `per_step[name]`
    times; a profiled step; `dots_steps` more under "dots" remat; then the
    adapters merged into the base and one action predicted through it with
    `serve_model`. With `resume_check`, the adapters are checkpointed and
    resumed (checkpoint_resume) before the merge."""
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

    resume = checkpoint_resume(model, params, state, mask, batch, seed, losses[-1]) if resume_check else None

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
                losses=losses, profile=prof, launches=totals, steps=1 + steps, dots=dots, resume=resume)


def checkpoint_resume(model, params, state, mask, batch, seed: int, loss: float) -> dict:
    """CheckpointManager.save of the LoRA state with the frozen base dropped
    (`only_trainable_mask`), restored into a fresh init_train_state (other
    adapters, zero moments); then one step from the restored state and one
    from the uninterrupted one on the same batch. Losses and adapters must be
    bit-equal, or else within 1e-6 relative; the rule that held is reported."""
    import shutil
    import tempfile

    import torch

    from bridgelang_tpu_torch.training.checkpointing import STATE_FILE, CheckpointManager
    from bridgelang_tpu_torch.training.lora import lora_trainable_mask
    from bridgelang_tpu_torch.training.trainer import (
        OptimConfig, init_train_state, make_optimizer, make_vla_train_step, trainable_tensors)

    def stepper(p, m):
        opt = make_optimizer(OptimConfig(learning_rate=LORA_LR, lr_scheduler_type="constant"), p, trainable_mask=m)
        return opt, make_vla_train_step(model, opt, trainable_mask=m, compute_dtype=torch.bfloat16,
                                        image_transform=model.image_transform, remat=True, remat_policy="full")

    run = tempfile.mkdtemp(prefix="smoke_run_", dir=os.path.join(ROOT, "build"))
    try:
        mgr = CheckpointManager(run, keep=2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = mgr.save(state, step=state.step, epoch=0, loss=loss, only_trainable_mask=mask)
        save_s = time.perf_counter() - t0
        n_bytes = os.path.getsize(os.path.join(path, STATE_FILE))
        fresh_params = with_lora(params, model.device, seed + 3)
        fresh_mask = lora_trainable_mask(fresh_params)
        opt_b, step_b = stepper(fresh_params, fresh_mask)
        fresh = init_train_state(fresh_params, opt_b, trainable_mask=fresh_mask)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restored = mgr.restore(path, fresh)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(run, ignore_errors=True)
    _, step_a = stepper(state.params, mask)
    state, m_a = step_a(state, batch)
    restored, m_b = step_b(restored, batch)
    loss_a, loss_b = float(m_a["loss"]), float(m_b["loss"])
    ta, tb = trainable_tensors(state.params, mask), trainable_tensors(restored.params, fresh_mask)
    if loss_a == loss_b and all(torch.equal(x, y) for x, y in zip(ta, tb)):
        rule, loss_rel, w_rel = "bit-equal", 0.0, 0.0
    else:
        rule = "within 1e-6 relative"
        loss_rel = abs(loss_a - loss_b) / abs(loss_a)
        w_rel = max(float((x - y).abs().max()) / max(float(x.abs().max()), 1e-30) for x, y in zip(ta, tb))
        if loss_rel > 1e-6 or w_rel > 1e-6:
            fail(f"train resume: one step from the restored state differs from the uninterrupted one: loss "
                 f"{loss_b} vs {loss_a} (rel {loss_rel:.2e}), adapters rel {w_rel:.2e}")
    log(f"train resume: checkpoint of the adapters and AdamW moments {n_bytes / 1e6:.1f} MB (the frozen base "
        f"dropped), save {save_s:.2f} s, restore {restore_s:.2f} s; one step from the restored state and from the "
        f"uninterrupted one: loss {loss_b:.6f} vs {loss_a:.6f}, adapters {rule}")
    del restored
    return dict(bytes=n_bytes, save_s=save_s, restore_s=restore_s, rule=rule, loss=[loss_a, loss_b],
                loss_rel_err=loss_rel, adapter_rel_err=w_rel)


# --- serving through graphs: bf16, int8 (w8a8) and int4 (w4a8) -------------------------


def w8a8_model(model, w8a8: bool):
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


def graph_inputs(model, imgs, instructions, n: int) -> dict:
    """A greedy predict's inputs for `model.graphs.run` decoding `n` tokens
    (the stats cut or tiled to n dims)."""
    import numpy as np

    stats = model.get_action_stats()
    reps = -(-n // len(stats["q01"]))
    ids, mask = model.pad_prompt([model.prepare_prompt_ids(t) for t in instructions])
    return {"ids": ids, "mask": mask, "frames": np.ascontiguousarray(np.stack(imgs)),
            "q01": np.tile(np.asarray(stats["q01"], np.float32), reps)[:n],
            "q99": np.tile(np.asarray(stats["q99"], np.float32), reps)[:n],
            "stat_mask": np.tile(np.asarray(stats["mask"], bool), reps)[:n]}


def time_graph_generate(model, params, frame, instruction, n: int, reps: int = 5) -> float:
    """Host-clock ms of a replayed batch-1 greedy predict of `n` tokens:
    input copies, the replay and the one device-to-host copy (captured on
    the first call, outside the timing)."""
    import torch

    inputs = graph_inputs(model, [frame], [instruction], n)
    model.graphs.run("greedy", params, dict(inputs), n).cpu()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.graphs.run("greedy", params, dict(inputs), n).cpu()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def replay_event_ms(model, params, frame, instruction, reps: int = 5) -> float:
    """Device-side ms of one replayed batch-1 predict: CUDA events around
    the replay of its captured graph."""
    import torch

    inputs = graph_inputs(model, [frame], [instruction], ACTION_DIM)
    model.graphs.run("greedy", params, dict(inputs), ACTION_DIM)
    entry = model.graphs.entries[model.graphs.key("greedy", inputs, ACTION_DIM)]
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        start.record()
        entry.graphs[0].graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def serve_kind(model, params, label: str, per_pass: dict) -> dict:
    """One weight kind served through replayed graphs and eagerly: the inputs
    flow (the prefill argmax differs between two frames); the graphs of the
    batch buckets 1, 2 and 4 captured before any request, with the peak
    memory after each; replayed ids equal to eager ids at B=1 and B=4;
    prefill and decode ms (graph and eager); a profile of each; the server's
    batch-1 requests and micro-batch of 4, graph then eager, under the
    per-pass launch counts."""
    import numpy as np
    import torch

    imgs = frames(4, seed=3)
    tok_a = first_token(model, params, imgs[0], INSTRUCTIONS[0])
    tok_b = first_token(model, params, imgs[1], INSTRUCTIONS[0])
    log(f"{label}: prefill argmax: frame A -> {tok_a}, frame B -> {tok_b}")
    if tok_a == tok_b:
        fail(f"{label}: prefill argmax is the same for two different frames: inputs do not flow")
    model.use_graphs = True
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    peaks = {}
    t0 = time.perf_counter()
    for b in (1, 2, 4):
        model.predict_action_batch(params, imgs[:b], INSTRUCTIONS[:b])
        torch.cuda.synchronize()
        peaks[b] = torch.cuda.max_memory_allocated() / 1e9
    capture_s = time.perf_counter() - t0
    log(f"{label}: graphs of batch buckets 1, 2, 4 captured in {capture_s:.1f} s; peak GB after each "
        f"{ {b: round(g, 3) for b, g in peaks.items()} }; {len(model.graphs.entries)} graph keys")
    ids = {}
    for use_graphs in (False, True):
        model.use_graphs = use_graphs
        for b in (1, 4):
            ids[(use_graphs, b)] = model.predict_action_batch(params, imgs[:b], INSTRUCTIONS[:b], return_tokens=True)[1]
    for b in (1, 4):
        same = np.array_equal(ids[(True, b)], ids[(False, b)])
        log(f"{label}: B={b} token ids, graph {ids[(True, b)].tolist()} eager {ids[(False, b)].tolist()} "
            f"{'equal' if same else 'DIFFER'}")
        if not same:
            fail(f"{label}: replayed graph ids differ from eager generate ids at B={b}")
    model.use_graphs = False
    e1 = time_generate(model, params, imgs[0], INSTRUCTIONS[0], 1)
    e7 = time_generate(model, params, imgs[0], INSTRUCTIONS[0], 7)
    prof_eager = profile_predict(model, params)
    model.use_graphs = True
    g1 = time_graph_generate(model, params, imgs[0], INSTRUCTIONS[0], 1)
    g7 = time_graph_generate(model, params, imgs[0], INSTRUCTIONS[0], 7)
    replay_ms = replay_event_ms(model, params, imgs[0], INSTRUCTIONS[0])
    prof_graph = profile_predict(model, params)
    log(f"{label}: B=1 1 token / 7 tokens / decode per token, eager generate_greedy {e1:.2f} / {e7:.2f} / "
        f"{(e7 - e1) / 6:.2f} ms; replayed graph {g1:.2f} / {g7:.2f} / {(g7 - g1) / 6:.2f} ms; one replay of the "
        f"7-token predict between CUDA events {replay_ms:.2f} ms")
    graph = serve(model, params, N_SINGLE_REQUESTS, per_pass)
    model.use_graphs = False
    eager = serve(model, params, N_SINGLE_REQUESTS, per_pass)
    model.use_graphs = True
    log(f"{label} serve: median batch-1 /act graph {graph['median_ms']:.1f} ms, eager {eager['median_ms']:.1f} ms; "
        f"micro-batch of 4 graph {graph['batch4_ms']:.1f} ms, eager {eager['batch4_ms']:.1f} ms; peak memory "
        f"{max(peaks.values()):.2f} GB after the warm-up")
    torch.cuda.empty_cache()
    return dict(graph, eager=dict(eager, prefill_ms=e1, decode_ms_per_token=(e7 - e1) / 6, profile=prof_eager),
                prefill_ms=g1, decode_ms_per_token=(g7 - g1) / 6, profile=prof_graph, replay_event_ms=replay_ms,
                warmup_peak_gb=peaks, capture_s=capture_s, model_gb=tensor_gb(params), llm_gb=tensor_gb(params["llm"]))


def int8_routes(model8, params8) -> dict:
    """Which route each int8 projection of one eager 7-token predict takes:
    the w8a8 int8 x int8 product (torch._int_mm) must run the prefill's 224
    projections (T = 352 >= W8A8_MIN_CHUNK) and nothing else; the decode's
    6 x 224 cast the weight. Then the device time of what one decode step
    casts (224 weights and the head), from a captured graph of the casts."""
    import torch

    from bridgelang_tpu_torch.models.llm import llama
    from bridgelang_tpu_torch.ops.image_ops import frames_to_tensor, preprocess_batch

    counts = {"proj": 0, "int8_product": 0}
    real_proj, real_product = llama.proj, llama._int8_product

    def proj(*a, **k):
        counts["proj"] += 1
        return real_proj(*a, **k)

    def product(*a, **k):
        counts["int8_product"] += 1
        return real_product(*a, **k)

    ids, mask = model8.pad_prompt([model8.prepare_prompt_ids(INSTRUCTIONS[0])])
    pix = preprocess_batch(frames_to_tensor(frames(1, seed=3)[0][None], model8.device), model8.image_transform,
                           dtype=model8.dtype)
    llama.proj, llama._int8_product = proj, product
    try:
        model8.generate_greedy(params8, torch.as_tensor(ids, device="cuda"), torch.as_tensor(mask, device="cuda"),
                               pix, max_new_tokens=ACTION_DIM)
        torch.cuda.synchronize()
    finally:
        llama.proj, llama._int8_product = real_proj, real_product
    want = {"proj": ACTION_DIM * 7 * N_LAYERS_7B, "int8_product": 7 * N_LAYERS_7B}
    log(f"int8 routes over one 7-token predict: {counts} (want {want}: the prefill's projections on torch._int_mm, "
        f"the {ACTION_DIM - 1} decode steps' {(ACTION_DIM - 1) * 7 * N_LAYERS_7B} on the weight cast)")
    if counts != want:
        fail(f"int8: projection routes {counts}, expected {want}")
    weights = [lp[k] for lp in params8["llm"]["layers"] for k in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")]
    weights.append(params8["llm"]["lm_head"])
    cast_ms = graph_ms([lambda w=w: w.to(torch.bfloat16) for w in weights], launches=len(weights), replays=3) * len(weights)
    log(f"int8: casting one decode step's weights to bf16 ({len(weights)} tensors, "
        f"{sum(w.numel() for w in weights) / 1e9:.3f} G codes) takes {cast_ms:.3f} ms on the device")
    return dict(counts, decode_cast_ms_per_step=cast_ms)


def spec_phase(model, params, label: str, int4: bool) -> dict:
    """Batch-1 speculative serving through the graph pair: garbage, perfect
    and partial drafts equal greedy ids at margin 0.25 (accept counts
    printed); calibrate_speculative_margin on 4 frames; the server's default
    mode over SPEC_TICKS ticks of one instruction on slowly perturbed frames
    against a greedy server on the same ticks (median /act, mean accept
    count, launch counts: the prefill's 32 flash_fwd per predict; for int4,
    224 int4_mm_a8 and quantize_a8 per decoder pass, 2 to 8 passes)."""
    import numpy as np
    import torch

    from bridgelang_tpu_torch.serving.server import VLAServer, client_act, draft_from_history
    from bridgelang_tpu_torch.util.compile_cache import warmup_predict

    model.use_graphs = True
    warm_s = warmup_predict(model, params, speculative=True, instruction=INSTRUCTIONS[0])
    img = frames(1, seed=21)[0]
    instr = INSTRUCTIONS[0]
    greedy = model.predict_action_batch(params, [img], [instr], return_tokens=True)[1][0]
    drafts = {"garbage": np.full(ACTION_DIM, 3, np.int32), "perfect": greedy.astype(np.int32),
              "partial": np.concatenate([greedy[:4], [3] * (ACTION_DIM - 4)]).astype(np.int32)}
    accepts = {}
    for kind, draft in drafts.items():
        _, tokens, acc = model._host_predict("speculative", params, [img], [instr], None, draft_tokens=draft)
        accepts[kind] = int(acc[0])
        log(f"spec ({label}) {kind} draft at margin 0.25: ids {tokens[0].tolist()}, greedy {greedy.tolist()}, "
            f"accepted {accepts[kind]} of {ACTION_DIM}")
        if not np.array_equal(tokens[0], greedy):
            fail(f"spec ({label}): the {kind} draft's ids differ from greedy at margin 0.25")
    calib = model.calibrate_speculative_margin(params, frames(4, seed=22), instr)
    log(f"spec ({label}): calibrate_speculative_margin over 4 frames -> {calib}")
    # Random weights leave near-tie logits that the 0.25 gate rejects. At margin 0
    # every exact argmax match is accepted: what a fully accepted draft costs.
    # A measurement, not the contract (bf16 verify-vs-decode noise may flip a tie).
    full = {}
    for kind, draft, margin in (("greedy", None, None), ("perfect, margin 0", drafts["perfect"], 0.0)):
        times = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if draft is None:
                _, tokens, acc = model._host_predict("greedy", params, [img], [instr], None)
            else:
                _, tokens, acc = model._host_predict("speculative", params, [img], [instr], None, draft_tokens=draft,
                                                     margin_threshold=margin)
            times.append(1e3 * (time.perf_counter() - t0))
        full[kind] = dict(ms=statistics.median(times[1:]), accepted=int(acc[0]),
                          ids_equal=bool(np.array_equal(tokens[0], greedy)))
    log(f"spec ({label}): batch-1 predict, greedy {full['greedy']['ms']:.2f} ms; perfect draft at margin 0 "
        f"{full['perfect, margin 0']['ms']:.2f} ms, accepted {full['perfect, margin 0']['accepted']} of {ACTION_DIM}, "
        f"ids {'equal to' if full['perfect, margin 0']['ids_equal'] else 'DIFFERENT from'} greedy (host clock, "
        f"median of 5)")

    rng = np.random.default_rng(23)
    ticks, cur = [], img.astype(np.int16)
    for _ in range(SPEC_TICKS):  # a slow drift: +-2 levels per pixel per tick
        cur = np.clip(cur + rng.integers(-2, 3, size=cur.shape), 0, 255)
        ticks.append(cur.astype(np.uint8))
    out = {}
    for mode in ("speculative", "greedy"):
        server = VLAServer(model, params, speculative_default=mode == "speculative", device=model.device)
        httpd = server.serve_background(port=0)
        reset_launch_counts()
        lat, toks = [], []
        try:
            for frame in ticks:
                t0 = time.perf_counter()
                action, tokens = client_act("127.0.0.1", httpd.server_address[1], frame, instr, return_tokens=True,
                                            timeout=300)
                lat.append(1e3 * (time.perf_counter() - t0))
                check_action(action, f"spec ({label}) {mode} tick")
                toks.append(tokens)
        finally:
            httpd.shutdown()
            httpd.server_close()
        out[mode] = dict(latencies_ms=lat, median_ms=statistics.median(lat[1:]), launches=launch_counts(), tokens=toks)
    counts = out["speculative"]["launches"]
    # the ticks' drafts, as the server made them, for their accept counts
    tick_accepts, prev2, prev1 = [], None, None
    greedy_ticks = [model.predict_action_batch(params, [f], [instr], return_tokens=True)[1][0] for f in ticks]
    for frame, tokens in zip(ticks, out["speculative"]["tokens"]):
        draft = np.zeros(ACTION_DIM, np.int32) if prev1 is None else draft_from_history(
            prev2, prev1, model.cfg.llm.vocab_size)
        _, again, acc = model._host_predict("speculative", params, [frame], [instr], None, draft_tokens=draft)
        tick_accepts.append(int(acc[0]))
        if not np.array_equal(again[0], tokens):
            fail(f"spec ({label}): a tick's ids differ between the server and the same draft's predict")
        prev2, prev1 = prev1, np.asarray(tokens, np.int32)
    same = all(np.array_equal(t, g) for t, g in zip(out["speculative"]["tokens"], greedy_ticks))
    log(f"spec ({label}) server default over {SPEC_TICKS} ticks: /act ms {[round(x, 1) for x in out['speculative']['latencies_ms']]} "
        f"(median of ticks 2+ {out['speculative']['median_ms']:.1f}); greedy server on the same ticks "
        f"{[round(x, 1) for x in out['greedy']['latencies_ms']]} (median {out['greedy']['median_ms']:.1f}); accept counts "
        f"{tick_accepts} (mean {np.mean(tick_accepts):.2f}); ids {'equal' if same else 'DIFFER'} to greedy on every tick; "
        f"launches {counts}")
    if not same:
        fail(f"spec ({label}): the speculative default's ids differ from greedy on some tick")
    if counts["flash_fwd"] != N_LAYERS_7B * SPEC_TICKS:
        fail(f"spec ({label}): expected {N_LAYERS_7B * SPEC_TICKS} flash_fwd launches (the prefills), got {counts}")
    passes = counts["int4_mm_a8"] / INT4_PER_PASS
    if int4 and (counts["quantize_a8"] != counts["int4_mm_a8"] or passes != int(passes)
                 or not 2 * SPEC_TICKS <= passes <= (ACTION_DIM + 1) * SPEC_TICKS):
        fail(f"spec ({label}): int4 launches {counts} are no whole number of decoder passes per tick")
    if not int4 and (counts["int4_mm_a8"] or counts["quantize_a8"] or counts["int4_mm"]):
        fail(f"spec ({label}): unexpected int4 launches {counts}")
    return dict(accepts=accepts, calibrated_margin=calib, warmup_s=warm_s, tick_accepts=tick_accepts, margin0=full,
                median_ms=out["speculative"]["median_ms"], latencies_ms=out["speculative"]["latencies_ms"],
                greedy_median_ms=out["greedy"]["median_ms"], greedy_latencies_ms=out["greedy"]["latencies_ms"],
                launches=counts, decoder_passes=passes if int4 else None)


def parallel_phase(model, params, greedy_median_ms: float) -> dict:
    """parallel_decode on: POST /act with horizon=HORIZON answers an
    [HORIZON, 7] chunk of finite floats from one masked forward that
    launches no flash_fwd; its /act median beside greedy's."""
    import numpy as np

    from bridgelang_tpu_torch.serving.server import VLAServer, client_act

    model.parallel_decode = True
    server = VLAServer(model, params, device=model.device)
    httpd = server.serve_background(port=0)
    img = frames(1, seed=31)[0]
    try:
        port = httpd.server_address[1]
        client_act("127.0.0.1", port, img, INSTRUCTIONS[0], horizon=HORIZON, timeout=300)  # captures its graph
        reset_launch_counts()
        lat = []
        for i in range(N_SINGLE_REQUESTS):
            t0 = time.perf_counter()
            chunk = client_act("127.0.0.1", port, frames(1, seed=32 + i)[0], INSTRUCTIONS[0], horizon=HORIZON,
                               timeout=300)
            lat.append(1e3 * (time.perf_counter() - t0))
            if chunk.shape != (HORIZON, ACTION_DIM) or not np.isfinite(chunk).all():
                fail(f"parallel: horizon={HORIZON} answered {chunk.shape}, finite {np.isfinite(chunk).all()}")
        counts = launch_counts()
    finally:
        httpd.shutdown()
        httpd.server_close()
        model.parallel_decode = False
    log(f"parallel: horizon={HORIZON}: {N_SINGLE_REQUESTS} x [{HORIZON}, {ACTION_DIM}] finite chunks; /act ms "
        f"{[round(x, 1) for x in lat]} (median {statistics.median(lat):.1f}; greedy batch-1 {greedy_median_ms:.1f}); "
        f"launches {counts}; speculative default {server.speculative_default}")
    expect_counts(counts, {}, "parallel decode (general mask: no flash_fwd)")
    return dict(latencies_ms=lat, median_ms=statistics.median(lat), launches=counts, chunk_shape=[HORIZON, ACTION_DIM])


# --- phase 5: card vs CPU ----------------------------------------------------------


class GradRecorder:
    """An optimizer that keeps a copy of the gradients it is handed."""

    def __init__(self, optimizer):
        self.optimizer, self.grads = optimizer, None

    def update(self, grads, state, params):
        self.grads = [g.detach().clone() for g in grads]
        self.optimizer.update(grads, state, params)


def parity_card_vs_cpu(seed: int, spec: bool) -> dict:
    """Card against CPU on a full-width, depth-cut fp32 model: float weights,
    then the same decoder packed to int4 (w8a8 on and off) and quantized to
    int8 (w8a8 off: ids; on: teacher-forced logits); with `spec`, the
    speculative graphs' exactness on the card in fp32."""
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
    results["export"] = export_round_trip(gpu, p_gpu)

    # The same cut with its decoder packed to int4 on the card (one pack,
    # copied to the CPU): w4a8 and bf16-path tokens, and a QLoRA step.
    from bridgelang_tpu_torch.ops.quant import quantize_llm_int4
    from bridgelang_tpu_torch.training.trainer import tree_map

    llm4 = quantize_llm_int4(p_gpu["llm"], group=INT4_GROUP)
    p4_gpu = dict(p_gpu, llm=llm4)
    p4_cpu = dict(p_cpu, llm=tree_map(lambda t: t.cpu(), llm4))
    n_int4 = 7 * cfg.llm.n_layers  # per model pass
    for w8a8 in (True, False):
        kernels = ("int4_mm_a8", "quantize_a8") if w8a8 else ("int4_mm",)
        results[f"int4_w8a8_{w8a8}"] = parity_pair(
            w8a8_model(gpu, w8a8), w8a8_model(cpu, w8a8), p4_gpu, p4_cpu, seed, f"int4 w8a8={w8a8}",
            {"flash_fwd": 2, **{kernel: 7 * n_int4 for kernel in kernels}}, {kernels[0]: 2 * n_int4}, train=not w8a8)
    results["int4_w8a8_True"].update(parity_logits(w8a8_model(gpu, True), w8a8_model(cpu, True), p4_gpu, p4_cpu,
                                                   "int4 w8a8=True"))
    del llm4, p4_gpu, p4_cpu

    # The same cut quantized to int8 on the card (one quantization, copied to
    # the CPU): equal ids with w8a8 off; with it on, the w4a8 rule on the
    # teacher-forced logits (activation codes on a rounding tie may differ).
    from bridgelang_tpu_torch.ops.quant import quantize_llm_int8

    llm8 = quantize_llm_int8(p_gpu["llm"])
    p8_gpu, p8_cpu = dict(p_gpu, llm=llm8), dict(p_cpu, llm=tree_map(lambda t: t.cpu(), llm8))
    results["int8_w8a8_False"] = parity_pair(w8a8_model(gpu, False), w8a8_model(cpu, False), p8_gpu, p8_cpu, seed,
                                             "int8 w8a8=False", {"flash_fwd": 2}, {}, train=False)
    results["int8_w8a8_True"] = parity_logits(w8a8_model(gpu, True), w8a8_model(cpu, True), p8_gpu, p8_cpu,
                                              "int8 w8a8=True")
    del llm8, p8_gpu, p8_cpu
    if spec:
        results["spec_fp32"] = spec_exact_fp32(gpu, p_gpu)
    return results


def export_round_trip(gpu, p_gpu) -> dict:
    """export_checkpoint of the depth-cut fp32 model (the JAX exporter's
    contract: fp32 model.safetensors, config.json, dataset_statistics.json),
    then load_vla(..., dtype=torch.float32) onto the card: leaves bit-equal
    and batch-2 action ids equal to the in-memory cut's. The cut's configs
    stand in the registries under the real ids meanwhile, as the tests
    patch them."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from bridgelang_tpu_torch.extern.hf_export import export_checkpoint
    from bridgelang_tpu_torch.models.llm import llama
    from bridgelang_tpu_torch.models.load import load_vla
    from bridgelang_tpu_torch.models.vision import vit

    cut_a, cut_b = gpu.cfg.vision_override
    patches = [(llama.LLM_CONFIGS, "llama2-7b-pure", gpu.cfg.llm), (vit.VIT_CONFIGS, "dinov2-vit-l", cut_a),
               (vit.VIT_CONFIGS, "siglip-vit-so400m", cut_b)]
    saved = [(reg, key, reg[key]) for reg, key, _ in patches]
    out = tempfile.mkdtemp(prefix="smoke_export_", dir=os.path.join(ROOT, "build"))
    try:
        for reg, key, value in patches:
            reg[key] = value
        t0 = time.perf_counter()
        export_checkpoint(gpu, p_gpu, out)
        export_s = time.perf_counter() - t0
        n_bytes = os.path.getsize(os.path.join(out, "model.safetensors"))
        model, params = load_vla(out, dtype=torch.float32)
        model.tokenizer = gpu.tokenizer
        n = assert_params_bit_equal(params, p_gpu, "parity export round trip")
        imgs = frames(2, seed=19)
        _, want = gpu.predict_action_batch(p_gpu, imgs, INSTRUCTIONS[:2], return_tokens=True)
        _, got = model.predict_action_batch(params, imgs, INSTRUCTIONS[:2], return_tokens=True)
        if not np.array_equal(got, want):
            fail(f"parity export round trip: loaded ids {got.tolist()} != in-memory {want.tolist()}")
        model.graphs.clear()
        gpu.graphs.clear()
    finally:
        for reg, key, value in saved:
            reg[key] = value
        shutil.rmtree(out, ignore_errors=True)
    log(f"parity: export_checkpoint of the fp32 depth-cut model ({n_bytes / 1e9:.2f} GB fp32, {export_s:.1f} s), "
        f"load_vla on the card: {n} leaves bit-equal, batch-2 ids {got.tolist()} equal")
    return dict(bytes=n_bytes, export_s=export_s, leaves=n, tokens=got.tolist())


def parity_logits(gpu, cpu, p_gpu, p_cpu, label: str) -> dict:
    """The card's greedy ids teacher-forced through both sides (the prefill,
    then the 6 ids as one cached chunk): logits within 0.05 max|logit| of
    the CPU's, and equal argmax wherever the CPU's top-2 margin clears twice
    that (the w4a8 token-id rule of tests/test_torch_int4.py)."""
    import numpy as np
    import torch

    from bridgelang_tpu_torch.models.llm.llama import lm_logits
    from bridgelang_tpu_torch.ops.image_ops import frames_to_tensor, preprocess_batch

    imgs = frames(2, seed=11)
    ids, mask = gpu.pad_prompt([gpu.prepare_prompt_ids(t) for t in INSTRUCTIONS[:2]])
    tokens = None
    logits = {}
    with torch.inference_mode():
        for name, model, params in (("cuda", gpu, p_gpu), ("cpu", cpu, p_cpu)):
            dev = model.device
            pix = preprocess_batch(frames_to_tensor(np.stack(imgs), dev), model.image_transform)
            args = (torch.as_tensor(ids, device=dev), torch.as_tensor(mask, device=dev), pix)
            if tokens is None:
                tokens = model.generate_greedy(params, *args, max_new_tokens=ACTION_DIM)
            toks = tokens.to(dev)
            last_hidden, cache, true_len = model._prefill(params, *args, ACTION_DIM, torch.float32)
            pos = true_len[:, None] + torch.arange(ACTION_DIM - 1, device=dev)[None, :]
            rest = model._decode_logits(params, model.cfg.llm, toks[:, :-1], pos, cache)
            logits[name] = torch.cat([lm_logits(params["llm"], last_hidden, model.cfg.llm), rest], dim=1).float().cpu()
    g, c = logits["cuda"], logits["cpu"]
    tol = 0.05 * float(c.abs().max())
    err = float((g - c).abs().max())
    top2 = c.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 2 * tol
    agree = (g.argmax(-1) == c.argmax(-1)) | ~clear
    log(f"parity ({label}): teacher-forced logits max|cuda-cpu| {err:.4g} (tol {tol:.4g} = 0.05 max|logit|); argmax "
        f"equal at all {int(clear.sum())} of {clear.numel()} positions whose CPU margin clears {2 * tol:.4g}; "
        f"card ids {tokens.cpu().tolist()}")
    if err > tol or not bool(agree.all()):
        fail(f"parity ({label}): the teacher-forced logits break the w4a8 rule between the card and the CPU")
    return dict(logit_err=err, tol=tol, positions_checked=int(clear.sum()), tokens=tokens.cpu().tolist())


def spec_exact_fp32(gpu, p_gpu) -> dict:
    """The depth-cut fp32 model with an fp32 KV cache on the card, through
    the speculative graphs: ids exactly greedy's for the perfect, garbage,
    partial and mid-mismatch drafts (the exact contract of the JAX
    tests/test_vlm.py:249)."""
    import numpy as np
    import torch

    gpu.cache_dtype = torch.float32
    img = frames(1, seed=41)[0]
    greedy = gpu.predict_action_batch(p_gpu, [img], [INSTRUCTIONS[0]], return_tokens=True)[1][0].astype(np.int32)
    mid = greedy.copy()
    mid[2] = (mid[2] + 1) % 500
    drafts = {"perfect": greedy, "garbage": np.full(ACTION_DIM, 3, np.int32),
              "partial": np.concatenate([greedy[:4], [7] * (ACTION_DIM - 4)]).astype(np.int32), "mid_mismatch": mid}
    accepts, margin0 = {}, {}
    for kind, draft in drafts.items():
        _, tokens, acc = gpu._host_predict("speculative", p_gpu, [img], [INSTRUCTIONS[0]], None, draft_tokens=draft)
        accepts[kind] = int(acc[0])
        if not np.array_equal(tokens[0], greedy):
            fail(f"spec fp32: the {kind} draft's ids {tokens[0].tolist()} differ from greedy {greedy.tolist()}")
        # margin 0 accepts every exact argmax match (a measurement: cuBLAS may tile the verify chunk apart from decode)
        _, tokens0, acc0 = gpu._host_predict("speculative", p_gpu, [img], [INSTRUCTIONS[0]], None, draft_tokens=draft,
                                             margin_threshold=0.0)
        margin0[kind] = dict(accepted=int(acc0[0]), ids_equal=bool(np.array_equal(tokens0[0], greedy)))
    log(f"spec fp32 (depth-cut model, fp32 cache, graphs): ids equal to greedy {greedy.tolist()} for every draft at "
        f"margin 0.25, accepted {accepts}; at margin 0: {margin0}")
    gpu.graphs.clear()
    return dict(accepts=accepts, tokens=greedy.tolist(), margin0=margin0)


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


# --- phase: fine-tuning through the port's entry points ------------------------------

FT_DATASET = "libero_spatial_no_noops"
FT_EPISODES = 24         # the native store: LIBERO's layout, 256x256 frames, 7-D actions, 8-D states
FT_EPISODE_STEPS = 50
FT_FRAME = 256
FT_SHARDS = 4            # store files, written in parallel
FT_STEPS = 8             # finetune.main's bf16 LoRA run
FT_SHORT_STEPS = 4       # the int8-QLoRA and parallel-objective runs
FT_TIMED = (2, 8)        # steps 3-8: the median step, the data wait and the profiled idle share
FT_SHUFFLE = 1000        # shuffle-buffer frames: the finetune default of 100_000 holds 19.7 GB of 256x256 frames
                         # in the one reader process, and filling it would read this 1200-frame store 83 times
FT_CHUNK = 8             # --action_chunk of the parallel-objective run
FT_CUT_LAYERS = 2        # train.main: full width, the decoder cut to 2 layers
FT_TRAIN_STEPS = 5       # train.main steps of the uninterrupted run (saved at step 4, resumed for step 5)
TRAIN_DOTS_PEAK_GB = 49.44  # the train phase's "dots" peak on an H100 (PERF.md), when that phase does not run


def write_native_store(root: str) -> dict:
    """FT_EPISODES episodes of FT_EPISODE_STEPS steps in LIBERO's native layout
    under <root>/FT_DATASET, written with the port's writer, FT_SHARDS files
    in parallel. Frames are gradients that drift over the episode plus
    integer noise; actions a smooth random walk in [-1, 1] with the gripper
    at +-1; states 8-D. Returns the raw actions and the bytes and seconds."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from bridgelang_tpu_torch import native
    from bridgelang_tpu_torch.vla.datasets.native_loader import write_episode

    out = os.path.join(root, FT_DATASET)
    os.makedirs(out)
    t, hw = FT_EPISODE_STEPS, FT_FRAME
    yy, xx = np.mgrid[0:hw, 0:hw].astype(np.float32)

    def episode(ep: int) -> dict:
        rng = np.random.default_rng(1000 + ep)
        phase = rng.uniform(0, 6, 3).astype(np.float32)
        base = np.stack([128 + 80 * np.sin(xx / (23 + 5 * c) + phase[c]) * np.cos(yy / (31 + 3 * c)) for c in range(3)],
                        -1)
        drift = np.arange(t, dtype=np.float32)[:, None, None, None]
        noise = rng.integers(-3, 4, (t, hw, hw, 3), dtype=np.int16)
        images = np.clip(base[None] + drift + noise, 0, 255).astype(np.uint8)
        wrist = np.clip(255 - base[None] + drift + noise, 0, 255).astype(np.uint8)
        move = np.clip(np.cumsum(rng.normal(0, 0.1, (t, 6)), axis=0), -1, 1)
        grip = np.where(np.sin(np.arange(t) / 7.0 + ep) > 0, 1.0, -1.0)[:, None]
        return dict(images=images, wrist_images=wrist, actions=np.concatenate([move, grip], 1).astype(np.float32),
                    states=rng.normal(size=(t, 8)).astype(np.float32), language=INSTRUCTIONS[ep % len(INSTRUCTIONS)])

    def shard(i: int) -> list:
        acts = []
        with native.TFRecordWriter(os.path.join(out, f"episodes-{i:05d}.tfrecord")) as w:
            for ep in range(i, FT_EPISODES, FT_SHARDS):
                e = episode(ep)
                write_episode(w, **e)
                acts.append((ep, e["actions"]))
        return acts

    t0 = time.perf_counter()
    with ThreadPoolExecutor(FT_SHARDS) as pool:
        acts = [a for part in pool.map(shard, range(FT_SHARDS)) for a in part]
    dt = time.perf_counter() - t0
    n_bytes = sum(os.path.getsize(os.path.join(out, f)) for f in os.listdir(out))
    raw = FT_EPISODES * t * 2 * hw * hw * 3
    log(f"finetune: native store {FT_EPISODES} episodes x {t} steps ({FT_EPISODES * t} frames, 2 cameras "
        f"{hw}x{hw}), {n_bytes / 1e6:.1f} MB in {FT_SHARDS} files ({raw / 1e6:.0f} MB of raw frames) written in "
        f"{dt:.1f} s")
    return dict(bytes=n_bytes, raw_frame_bytes=raw, seconds=dt,
                actions=np.concatenate([a for _, a in sorted(acts, key=lambda x: x[0])]))


class EntryPointProbe:
    """Watches an entry point run without changing it: while installed, the
    trainer's `make_vla_train_step` hands out a wrapped step (per step: wall
    ms to the end of the device's work, the host's wait for the batch,
    launches, loss; torch.profiler with CUDA activity only over steps
    `profile` = [a, b) (None: none); it keeps the model, optimizer, mask, last state and
    batch), the dataset's batches are timed as they come, and checkpoint
    saves and HF exports are timed. `per_step`: the launches every step must
    make (else the run fails)."""

    def __init__(self, label: str, per_step: dict, profile=FT_TIMED, on_first_step=None):
        self.label, self.per_step, self.profile, self.on_first_step = label, per_step, profile, on_first_step
        self.steps, self.waits, self.saves, self.exports = [], [], [], []
        self.model = self.optimizer = self.mask = self.state = self.batch = self.dataset = None
        self.profile_result, self.step_peak_gb, self.reader_rss_gb = None, 0.0, None
        self._patches = []

    def _patch(self, obj, name, value):
        self._patches.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def __enter__(self):
        import torch

        from bridgelang_tpu_torch.extern import hf_export
        from bridgelang_tpu_torch.training import checkpointing, trainer
        from bridgelang_tpu_torch.vla import materialize

        probe = self
        make_step, get_dataset = trainer.make_vla_train_step, materialize.get_vla_dataset_and_collator
        save, export = checkpointing.CheckpointManager.save, hf_export.export_checkpoint

        class TimedBatches:
            def __init__(self, it):
                self.it = it

            def __getattr__(self, name):
                return getattr(self.it, name)

            def __iter__(self):
                return self

            def __next__(self):
                t0 = time.perf_counter()
                batch = next(self.it)
                probe.waits.append(1e3 * (time.perf_counter() - t0))
                if len(probe.waits) == 1 and self.it._procs:  # the reader (its shuffle buffer full), a worker
                    probe.reader_rss_gb = [vm_rss_gb(p.pid) for p in self.it._procs[:2]]
                return batch

        class TimedDataset:
            def __init__(self, ds):
                self.ds = ds

            def __getattr__(self, name):
                return getattr(self.ds, name)

            def __iter__(self):
                return TimedBatches(iter(self.ds))

            def batches(self, state=None):
                return TimedBatches(self.ds.batches(state))

        def get_dataset_timed(*a, **k):
            ds, tok, coll = get_dataset(*a, **k)
            probe.dataset = ds
            return TimedDataset(ds), tok, coll

        def make_step_probed(model, optimizer, *a, **k):
            step = make_step(model, optimizer, *a, **k)
            probe.model, probe.optimizer, probe.mask = model, optimizer, k.get("trainable_mask")

            def run(state, batch):
                i = len(probe.steps)
                if i == 0:
                    if probe.on_first_step is not None:
                        probe.on_first_step(state)
                    torch.cuda.reset_peak_memory_stats()
                prof = None
                if probe.profile and i == probe.profile[0]:
                    from torch.profiler import ProfilerActivity, profile

                    probe._prof = prof = profile(activities=[ProfilerActivity.CUDA])
                    prof.__enter__()
                    probe._prof_t0 = time.perf_counter()
                torch.cuda.synchronize()
                before = launch_counts()
                t0 = time.perf_counter()
                state, m = step(state, batch)
                loss = float(m["loss"])
                torch.cuda.synchronize()
                ms = 1e3 * (time.perf_counter() - t0)
                counts = {k2: v - before[k2] for k2, v in launch_counts().items()}
                probe.steps.append(dict(ms=ms, loss=loss, launches=counts))
                probe.step_peak_gb = max(probe.step_peak_gb, torch.cuda.max_memory_allocated() / 1e9)
                if probe.profile and i == probe.profile[1] - 1 and getattr(probe, "_prof", None) is not None:
                    probe._finish_profile()
                if not math.isfinite(loss):
                    fail(f"{probe.label} step {i + 1}: non-finite loss {loss}")
                expect_counts(counts, probe.per_step, f"{probe.label} step {i + 1}")
                probe.state, probe.batch = state, batch
                return state, m

            return run

        def save_timed(mgr, state, step, *a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            path = save(mgr, state, step, *a, **k)
            file = os.path.join(path, "state.pt")
            probe.saves.append(dict(step=step, seconds=time.perf_counter() - t0, bytes=os.path.getsize(file),
                                    path=str(path)))
            return path

        def export_timed(model, params, out_dir, *a, **k):
            t0 = time.perf_counter()
            out = export(model, params, out_dir, *a, **k)
            n = sum(os.path.getsize(os.path.join(out, f)) for f in os.listdir(out))
            probe.exports.append(dict(seconds=time.perf_counter() - t0, bytes=n, path=str(out)))
            return out

        self._patch(trainer, "make_vla_train_step", make_step_probed)
        self._patch(materialize, "get_vla_dataset_and_collator", get_dataset_timed)
        self._patch(checkpointing.CheckpointManager, "save", save_timed)
        self._patch(hf_export, "export_checkpoint", export_timed)
        self._t0 = time.perf_counter()
        return self

    def _finish_profile(self):
        from torch.autograd import DeviceType

        wall_ms = 1e3 * (time.perf_counter() - self._prof_t0)
        self._prof.__exit__(None, None, None)
        kernels = [e for e in self._prof.events() if e.device_type == DeviceType.CUDA]
        n = self.profile[1] - self.profile[0]
        busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
        self.profile_result = (dict(steps=n, wall_ms=wall_ms, device_ms=busy_ms, idle_share=1 - busy_ms / wall_ms,
                                    launches_per_step=len(kernels) / n) if kernels else None)
        self._prof = None

    def __exit__(self, *exc):
        self.wall_s = time.perf_counter() - self._t0
        for obj, name, value in reversed(self._patches):
            setattr(obj, name, value)
        self._patches.clear()
        if getattr(self, "_prof", None) is not None:
            self._prof.__exit__(None, None, None)
            self._prof = None

    def summary(self) -> dict:
        a, b = self.profile or (min(1, len(self.steps) - 1), len(self.steps))
        timed = self.steps[a:b]
        waits = self.waits[:len(self.steps)]  # the loop takes one batch more before it stops
        r = dict(wall_s=self.wall_s, steps=len(self.steps), losses=[s["loss"] for s in self.steps],
                 step_ms=[s["ms"] for s in self.steps], data_wait_ms=waits,
                 median_step_ms=statistics.median(s["ms"] for s in timed) if timed else None,
                 median_data_wait_ms=statistics.median(waits[a:b]) if waits[a:b] else None,
                 step_peak_gb=self.step_peak_gb, reader_rss_gb=self.reader_rss_gb, profile=self.profile_result,
                 saves=self.saves, exports=self.exports,
                 launches={k: sum(s["launches"][k] for s in self.steps) for k in KERNEL_NAMES})
        idle = (self.profile_result or {}).get("idle_share")
        log(f"{self.label}: {self.wall_s:.1f} s in the entry point, {len(self.steps)} steps, losses {[round(x, 4) for x in r['losses']]}; step ms "
            f"{[round(x, 1) for x in r['step_ms']]} (median of steps {a + 1}-{b}: "
            f"{r['median_step_ms'] if r['median_step_ms'] is None else round(r['median_step_ms'], 1)}); host wait "
            f"for each batch ms {[round(x, 1) for x in waits]}; device idle over steps {a + 1}-{b}: "
            f"{'not measured' if idle is None else f'{100 * idle:.1f}%'}; peak {self.step_peak_gb:.2f} GB; resident "
            f"memory at the first batch (the frame reader, a batch worker): "
            f"{[x if x is None else round(x, 3) for x in self.reader_rss_gb or []] or 'not measured'} GB; "
            f"saves "
            f"{[(s['step'], round(s['seconds'], 2), round(s['bytes'] / 1e9, 2)) for s in self.saves]} (step, s, GB); "
            f"exports {[(round(e['seconds'], 2), round(e['bytes'] / 1e9, 2)) for e in self.exports]} (s, GB)")
        return r


def vm_rss_gb(pid: int):
    """A process's resident memory (VmRSS), or None if it has gone."""
    try:
        with open(f"/proc/{pid}/status") as f:
            return next(int(line.split()[1]) * 1024 / 1e9 for line in f if line.startswith("VmRSS:"))
    except (OSError, StopIteration):
        return None


def disk_free_gb(path: str) -> float:
    import shutil

    return shutil.disk_usage(path).free / 1e9


def plain_int8_merge(codes, scale, a, b):
    """The int8 merge written out: dequantize, add B A, requantize per output
    column with the scale absmax x fp32(1/127)."""
    import torch

    w32 = codes.float() * scale.float() + b.float() @ a.float()
    absmax = w32.abs().amax(dim=1, keepdim=True)
    new_scale = torch.where(absmax == 0, torch.ones_like(absmax), absmax * torch.full_like(absmax, 1.0 / 127.0))
    return torch.clamp(torch.round(w32 / new_scale), -127, 127).to(torch.int8), new_scale.to(torch.bfloat16)


def finetune_phase(ckpt_dir: str, dots_peak_gb: float) -> dict:
    """The port's `finetune` and `train` entry points on the card, fed by the
    port's TF-free pipeline from a native store (write_native_store):
    1. finetune.main, bf16 LoRA r=32 on the published-layout 7B of `ckpt_dir`
       (batch 16, image_aug, FT_STEPS steps, the save of the trainable state
       and the bf16 HF export of the merged model); the export loaded with
       load_vla predicts one action under the store's statistics, inside its
       [q01, q99];
    2. int8 QLoRA (4 steps): no int8 code moves, and merge_lora of one
       layer's trained adapters into the int8 base equals plain_int8_merge;
    3. the parallel objective (--action_chunk 8, "full" remat, 4 steps): no
       flash launch, peak under the train phase's "dots" peak; one more
       step under "dots" for its peak; an [8, 7] chunk from the trained
       weights through generate_parallel;
    4. train.main at full width with the decoder cut to FT_CUT_LAYERS layers:
       FT_TRAIN_STEPS steps saved at step 4, then resumed from that
       checkpoint for one step, bit-equal to the uninterrupted run.
    Each run's directory goes once its checks pass, so that the phase's disk
    footprint peaks at the source checkpoint plus one export (~31 GB)."""
    import dataclasses
    import glob
    import shutil
    import tempfile

    import numpy as np
    import torch

    from bridgelang_tpu_torch import finetune, train
    from bridgelang_tpu_torch.conf import parse_cli
    from bridgelang_tpu_torch.models.llm import llama
    from bridgelang_tpu_torch.models.llm.tokenizer import ByteFallbackTokenizer
    from bridgelang_tpu_torch.models.load import load_vla
    from bridgelang_tpu_torch.training.lora import merge_lora
    from bridgelang_tpu_torch.training.trainer import tree_leaves

    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="smoke_ft_", dir=os.path.join(ROOT, "build"))
    result = {"disk_free_gb_before": disk_free_gb(work)}
    log(f"finetune: {result['disk_free_gb_before']:.1f} GB free under {work}")
    reset_launch_counts()
    try:
        data = os.path.join(work, "data")
        store = write_native_store(data)
        result["store"] = {k: v for k, v in store.items() if k != "actions"}
        runs = os.path.join(work, "runs")
        common = ["--vla_path", ckpt_dir, "--data_root_dir", data, "--dataset_name", FT_DATASET, "--run_root_dir", runs,
                  "--batch_size", str(TRAIN_BATCH), "--shuffle_buffer_size", str(FT_SHUFFLE), "--save_steps", "1000",
                  "--lora_rank", str(LORA_RANK)]
        lora_step = {"flash_fwd": 2 * N_LAYERS_7B, "flash_bwd_dq": N_LAYERS_7B, "flash_bwd_dkv": N_LAYERS_7B}

        # 1. bf16 LoRA, saved merged and exported
        with EntryPointProbe("finetune bf16 LoRA", lora_step) as probe:
            run = finetune.main(parse_cli(finetune.FinetuneConfig, common + [
                "--max_steps", str(FT_STEPS), "--image_aug", "true", "--export_hf", "true"]))
        lora = probe.summary()
        stats = json.loads((run / "dataset_statistics.json").read_text())
        if stats != finetune.jsonable(probe.dataset.dataset_statistics):
            fail("finetune: the run's dataset_statistics.json differs from the pipeline's statistics")
        acts = store["actions"].copy()
        acts[:, -1] = 1.0 - np.clip(acts[:, -1], 0, 1)  # the libero standardization's gripper
        q = stats[FT_DATASET]["action"]
        for key, quantile in (("q01", 0.01), ("q99", 0.99)):
            want = np.quantile(acts, quantile, axis=0)
            if not np.allclose(q[key], want, rtol=1e-6, atol=1e-7):
                fail(f"finetune: statistics {key} {q[key]} != numpy's over the written actions {want.tolist()}")
        del probe
        release_memory()
        export = run / "hf_export"
        t0 = time.perf_counter()
        served, sparams = load_vla(str(export))
        load_s = time.perf_counter() - t0
        served.tokenizer = ByteFallbackTokenizer()
        action = served.predict_action(sparams, frames(1, seed=41)[0], INSTRUCTIONS[0], unnorm_key=FT_DATASET)
        check_action(action, "finetune: predict_action of the loaded export")
        # unnormalized dims lie in [q01, q99]; the gripper (mask off) keeps its bin value in [-1, 1]
        lo = np.where(q["mask"], q["q01"], -1.0)
        hi = np.where(q["mask"], q["q99"], 1.0)
        if not ((action >= lo - 1e-6) & (action <= hi + 1e-6)).all():
            fail(f"finetune: action {action.tolist()} outside [{lo.tolist()}, {hi.tolist()}] (q01/q99 where the "
                 "statistics' mask is on, [-1, 1] where off)")
        log(f"finetune: the export loads in {load_s:.1f} s and predicts {np.round(action, 4).tolist()} under "
            f"unnorm_key={FT_DATASET} (inside [q01, q99], the gripper in [-1, 1]); statistics equal the pipeline's "
            "and numpy's quantiles")
        served.graphs.clear()
        del served, sparams
        release_memory()
        lora.update(export_load_s=load_s, action=action.tolist())
        result["lora"] = lora
        shutil.rmtree(run)
        result["disk_free_gb_after_lora"] = disk_free_gb(work)

        # 2. int8 QLoRA: frozen codes, and the merge against the plain formula
        snap = {}

        def snapshot(state):
            for i, lp in enumerate(state.params["llm"]["layers"]):
                for k, t in lp.items():
                    if t.dtype == torch.int8:
                        snap[(i, k)] = t.detach().cpu()

        with EntryPointProbe("finetune int8 QLoRA", lora_step, profile=(1, FT_SHORT_STEPS),
                             on_first_step=snapshot) as probe:
            run = finetune.main(parse_cli(finetune.FinetuneConfig, common + [
                "--max_steps", str(FT_SHORT_STEPS), "--use_quantization", "true", "--quantization_bits", "8",
                "--export_hf", "false"]))
        q8 = probe.summary()
        layers = probe.state.params["llm"]["layers"]
        moved = [key for key, t in snap.items() if not torch.equal(t, layers[key[0]][key[1]].cpu())]
        if not snap or moved:
            fail(f"finetune int8: {len(moved)} of {len(snap)} int8 code tensors changed during training: {moved[:4]}")
        li = N_LAYERS_7B // 2
        lp = layers[li]
        merged = merge_lora({"layers": [lp]})["layers"][0]
        want_q, want_s = plain_int8_merge(lp["w_up"], lp["w_up_scale"], lp["w_up_lora_a"].detach(),
                                          lp["w_up_lora_b"].detach())
        if not (torch.equal(merged["w_up"], want_q) and torch.equal(merged["w_up_scale"], want_s)):
            fail(f"finetune int8: layer {li} w_up merged codes differ from dequantize + B A + requantize in "
                 f"{int((merged['w_up'] != want_q).sum())} places")
        n_moved = int((merged["w_up"] != lp["w_up"]).sum())
        log(f"finetune int8: {len(snap)} int8 code tensors unchanged over {q8['steps']} steps; merge_lora of layer "
            f"{li}'s trained adapters into its int8 w_up ({tuple(merged['w_up'].shape)} codes, {n_moved} moved) "
            "equals dequantize + B A + requantize")
        del merged, lp, layers, probe, snap
        release_memory()
        result["int8_qlora"] = q8
        shutil.rmtree(run)

        # 3. the parallel objective: masked attention, no flash launch
        with EntryPointProbe("finetune parallel objective", {}, profile=(1, FT_SHORT_STEPS)) as probe:
            run = finetune.main(parse_cli(finetune.FinetuneConfig, common + [
                "--max_steps", str(FT_SHORT_STEPS), "--parallel_decode", "true", "--action_chunk", str(FT_CHUNK),
                "--remat_policy", "full", "--export_hf", "false"]))
        par = probe.summary()
        if par["step_peak_gb"] >= dots_peak_gb:
            fail(f"finetune parallel: peak {par['step_peak_gb']:.2f} GB under full remat, not under the train "
                 f"phase's dots peak {dots_peak_gb:.2f} GB")
        from bridgelang_tpu_torch.training.trainer import make_vla_train_step

        dots = make_vla_train_step(probe.model, probe.optimizer, trainable_mask=probe.mask,
                                   image_transform=probe.model.image_transform, remat_policy="dots",
                                   parallel_decode_objective=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, m = dots(probe.state, probe.batch)
        float(m["loss"])
        dots_ms = [1e3 * (time.perf_counter() - t0)]
        par["dots"] = dict(step_ms=dots_ms, peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        model = probe.model
        model.tokenizer = ByteFallbackTokenizer()
        mparams = dict(state.params, llm=merge_lora(state.params["llm"]))
        chunk = model.predict_action_chunk(mparams, frames(1, seed=43)[0], INSTRUCTIONS[0], horizon=FT_CHUNK,
                                           unnorm_key=FT_DATASET)
        if chunk.shape != (FT_CHUNK, ACTION_DIM) or not np.isfinite(chunk).all():
            fail(f"finetune parallel: generate_parallel gave {chunk.shape}, finite {np.isfinite(chunk).all()}")
        log(f"finetune parallel: peak {par['step_peak_gb']:.2f} GB under full remat (train phase's dots "
            f"{dots_peak_gb:.2f} GB); under dots {par['dots']['peak_gb']:.2f} GB, steps "
            f"{[round(x, 1) for x in dots_ms]} ms; generate_parallel on the trained weights: a "
            f"[{FT_CHUNK}, {ACTION_DIM}] chunk of finite actions")
        model.graphs.clear()
        del model, mparams, state, dots, probe
        release_memory()
        result["parallel"] = par
        shutil.rmtree(run)
        shutil.rmtree(ckpt_dir, ignore_errors=True)  # the published 7B: train.main draws its own weights

        # 4. train.main, depth cut, saved, resumed for one step
        full_llm = llama.LLM_CONFIGS["llama2-7b-pure"]
        llama.LLM_CONFIGS["llama2-7b-pure"] = dataclasses.replace(full_llm, n_layers=FT_CUT_LAYERS)
        try:
            targs = ["--vla.type", "prism-dinosiglip-224px+mx-bridge", "--vla.data_mix", FT_DATASET,
                     "--vla.global_batch_size", str(TRAIN_BATCH), "--vla.per_device_batch_size", str(TRAIN_BATCH),
                     "--vla.expected_device_count", "1", "--vla.shuffle_buffer_size", str(FT_SHUFFLE),
                     "--vla.freeze_vision_backbone", "true", "--vla.save_interval", str(FT_TRAIN_STEPS - 1),
                     "--max_steps_override", str(FT_TRAIN_STEPS), "--data_root_dir", data, "--run_root_dir", runs]
            cut_step = {"flash_fwd": 2 * FT_CUT_LAYERS, "flash_bwd_dq": FT_CUT_LAYERS, "flash_bwd_dkv": FT_CUT_LAYERS}
            # profiled: steps 2-4, before the save that follows step 4
            with EntryPointProbe("train (2 layers)", cut_step, profile=(1, FT_TRAIN_STEPS - 1)) as probe_a:
                state_a = train.main(parse_cli(train.TrainConfig, targs + ["--run_id", "a"]))
            tr = probe_a.summary()
            ckpt4 = glob.glob(os.path.join(runs, "a", "checkpoints", f"step-{FT_TRAIN_STEPS - 1:06d}-*"))
            ckpt5 = glob.glob(os.path.join(runs, "a", "checkpoints", f"step-{FT_TRAIN_STEPS:06d}-*"))
            if len(ckpt4) != 1 or len(ckpt5) != 1:
                fail(f"train: expected one step-{FT_TRAIN_STEPS - 1} and one step-{FT_TRAIN_STEPS} checkpoint, "
                     f"found {ckpt4}, {ckpt5}")
            shutil.rmtree(ckpt5[0])  # the run's state stays in memory; the disk holds one save less
            with EntryPointProbe("train resumed", cut_step, profile=None) as probe_b:
                state_b = train.main(parse_cli(train.TrainConfig, targs + [
                    "--run_id", "b", "--pretrained_checkpoint", ckpt4[0], "--resume_step", str(FT_TRAIN_STEPS - 1)]))
            res = probe_b.summary()
        finally:
            llama.LLM_CONFIGS["llama2-7b-pure"] = full_llm
        la, lb = tr["losses"][-1], res["losses"][0]
        leaves_equal = all(torch.equal(x, y) for x, y in zip(tree_leaves(state_a.params), tree_leaves(state_b.params)))
        moments_equal = all(not isinstance(x, torch.Tensor) or torch.equal(x, y)
                            for x, y in zip(tree_leaves(state_a.opt_state), tree_leaves(state_b.opt_state)))
        n_params = sum(t.numel() for t in tree_leaves(state_a.params))
        if la != lb or not leaves_equal or not moments_equal or state_a.step != state_b.step:
            fail(f"train resume: step {FT_TRAIN_STEPS} from the checkpoint differs from the uninterrupted one: loss "
                 f"{lb} vs {la}, parameters equal {leaves_equal}, moments equal {moments_equal}")
        log(f"train: OpenVLA at full width, {FT_CUT_LAYERS} decoder layers ({n_params / 1e9:.3f} B fp32 params, vision "
            f"frozen), {FT_TRAIN_STEPS} steps, saved at step {FT_TRAIN_STEPS - 1}; resumed from that checkpoint, "
            f"step {FT_TRAIN_STEPS}: loss {lb!r} == {la!r}, parameters and moments bit-equal")
        tr.update(resume=dict(loss=[la, lb], bit_equal=True, saves=res["saves"], step_ms=res["step_ms"]),
                  params=n_params)
        result["train"] = tr
        del state_a, state_b, probe_a, probe_b
        release_memory()
    finally:
        shutil.rmtree(work, ignore_errors=True)
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    result["launches"] = launch_counts()
    result["disk_free_gb_after"] = disk_free_gb(os.path.join(ROOT, "build"))
    result["phase_s"] = time.perf_counter() - t_phase
    log(f"finetune phase: {result['phase_s']:.1f} s; launches {result['launches']}; disk free "
        f"{result['disk_free_gb_before']:.1f} GB before, {result['disk_free_gb_after']:.1f} GB after")
    return result


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
    lib = _build.load("int4_matmul")
    if hasattr(lib, "int4_mm_a8_smem_bytes"):  # absent from an earlier checkout timed with --package-root
        a8, splits = lib.int4_mm_a8_smem_bytes, lib.int4_mm_a8_splits
        a8.argtypes, splits.argtypes = [smem], [smem] * 4
        log(f"int4_mm_a8: split-K kernel (M<=16) {a8(1)} B, wgmma kernel (M>16) {a8(352)} B of dynamic shared memory; "
            "split-K blocks per column tile at M<=16: " + ", ".join(
                f"{sh} {splits(k, n // 2, INT4_GROUP, 0)}" for sh, (k, n) in INT4_SHAPES_7B.items()))


def kernel_entry(name: str, source: str, replaces: str, launches: dict, timing: dict, **extra) -> dict:
    """One kernel's object in the {"kernels": [...]} line; `launches` is its
    count on each main path's run."""
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(launches.values()), "launches_by_path": launches, **{k: timing[k] for k in keys}, **extra}


def release_memory() -> None:
    """Free what a finished phase dropped: a served model's weights stay
    referenced from its HTTP handler class, a reference cycle that only the
    cyclic garbage collector breaks, until then counting in later peaks."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def main() -> None:
    ap = argparse.ArgumentParser(description="torch port smoke run on one GPU")
    ap.add_argument("--phases",
                    default="build,load,kernels,serve,spec,parallel,train,int8,int4,qlora,finetune,parity",
                    help="comma-separated subset, for bring-up; the full run is the default; `cold` (not in "
                         "the default) runs only the device-side cold-L2 timings of the kernels phase")
    ap.add_argument("--package-root", default=ROOT,
                    help="import bridgelang_tpu_torch from this checkout (e.g. an earlier commit unpacked with "
                         "git archive) to time its kernels with --phases build,cold")
    args = ap.parse_args()
    phases = set(args.phases.split(","))

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a CUDA card")
    sys.path.insert(0, os.path.abspath(args.package_root))
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
    loaded = None
    ft_ckpt = None
    if phases & {"load", "serve", "spec", "parallel", "train", "int8", "int4", "qlora", "finetune"}:
        model, params = build_7b(SEED)
        if "load" in phases:  # every later phase serves and trains the weights loaded through load_vla
            model, params, loaded = load_phase(model, params, keep_ckpt="finetune" in phases)
            ft_ckpt = loaded.pop("ckpt_dir", None)
        elif "finetune" in phases:
            import tempfile

            ft_ckpt = tempfile.mkdtemp(prefix="smoke_ckpt_", dir=os.path.join(ROOT, "build"))
            write_published_checkpoint(model, params, ft_ckpt)
        ids, _ = model.pad_prompt([model.prepare_prompt_ids(INSTRUCTIONS[0])])
        serve_t = ids.shape[1] + model.num_patches
        log(f"serving prefill length: {ids.shape[1]}-token prompt bucket + {model.num_patches} patches = {serve_t}")
    timing_rows, max_err, bwd_timing, bwd_err, bwd_readings, int4_checks, cold = [], None, None, None, None, None, None
    quantize_errs = None
    if "kernels" in phases:
        timing_rows, max_err = check_kernels(serve_t)
        bwd_timing, bwd_err, bwd_readings = check_backward_kernels()
        int4_checks = check_int4_kernels()
        quantize_errs = check_quantize_and_route()
    if phases & {"kernels", "cold"}:
        cold = cold_timings("this checkout" if os.path.abspath(args.package_root) == ROOT else args.package_root)

    served = parallel = None
    spec = {}
    if "serve" in phases:
        served = serve_kind(model, params, "bf16", {"flash_fwd": N_LAYERS_7B})
    if "spec" in phases:
        spec["bf16"] = spec_phase(model, params, "bf16", int4=False)
    if "parallel" in phases:
        parallel = parallel_phase(model, params, (served or {}).get("median_ms", float("nan")))
    if model is not None:
        model.graphs.clear()
        release_memory()

    trained = None
    if "train" in phases:
        trained = train_adapters(model, params, SEED, "train", TRAIN_STEPS,
                                 {"flash_fwd": 2 * N_LAYERS_7B, "flash_bwd_dq": N_LAYERS_7B,
                                  "flash_bwd_dkv": N_LAYERS_7B}, dots_steps=DOTS_STEPS, resume_check=True)
        model.graphs.clear()  # the merged weights' predict captured its own
        release_memory()

    served8 = None
    if "int8" in phases:
        from bridgelang_tpu_torch.ops.quant import quantize_llm_int8

        from bridgelang_tpu_torch.training.trainer import tree_map

        # The bf16 decoder quantized one matrix at a time, then parked in host
        # memory for this phase, so that the card holds what int8 serving holds.
        t0 = time.perf_counter()
        params8 = dict(params, llm=quantize_llm_int8(params["llm"]))
        torch.cuda.synchronize()
        log(f"int8: decoder quantized in {time.perf_counter() - t0:.1f} s; decoder + embedding + head "
            f"{tensor_gb(params8['llm']):.2f} GB (bf16: {tensor_gb(params['llm']):.2f} GB)")
        params = dict(params, llm=tree_map(lambda t: t.cpu(), params["llm"]))
        release_memory()
        model8 = w8a8_model(model, w8a8=True)
        served8 = serve_kind(model8, params8, "int8", {"flash_fwd": N_LAYERS_7B})
        served8.update(int8_routes(model8, params8))
        prof = served8["profile"]
        share = (ACTION_DIM - 1) * served8["decode_cast_ms_per_step"] / prof["device_ms"]
        served8["decode_cast_share"] = share
        served8["direct_copy_share"] = prof["direct_copy_ms"] / prof["device_ms"]
        log(f"int8 serve: model {served8['model_gb']:.2f} GB (decoder + embedding + head {served8['llm_gb']:.2f} GB), "
            f"peak {max(served8['warmup_peak_gb'].values()):.2f} GB after the warm-up; the decode's weight casts, "
            f"timed alone, {(ACTION_DIM - 1) * served8['decode_cast_ms_per_step']:.2f} ms of a predict's "
            f"{prof['device_ms']:.2f} ms of device time ({100 * share:.1f}%); in the profile ATen's direct_copy "
            f"kernels take {prof['direct_copy_ms']:.2f} ms ({100 * served8['direct_copy_share']:.1f}%; bf16: "
            f"{(served or {}).get('profile', {}).get('direct_copy_ms', float('nan')):.2f} ms)")
        if "spec" in phases:
            spec["int8"] = spec_phase(model8, params8, "int8", int4=False)
        model8.graphs.clear()
        del model8, params8
        release_memory()
        params = dict(params, llm=tree_map(lambda t: t.to("cuda"), params["llm"]))

    served4 = qlora = None
    if phases & {"int4", "qlora"}:
        from bridgelang_tpu_torch.ops.quant import quantize_llm_int4

        # The bf16 decoder packed one matrix at a time; the bf16 leaves go with `params`.
        t0 = time.perf_counter()
        params = dict(params, llm=quantize_llm_int4(params["llm"], group=INT4_GROUP))
        torch.cuda.synchronize()
        release_memory()
        log(f"int4: decoder packed (group {INT4_GROUP}) in {time.perf_counter() - t0:.1f} s; decoder + int8 "
            f"embedding and head {tensor_gb(params['llm']):.2f} GB, card holds {torch.cuda.memory_allocated() / 1e9:.2f} GB")
        model4 = w8a8_model(model, w8a8=True)
        if "int4" in phases:
            served4 = serve_kind(model4, params, "int4", {"flash_fwd": N_LAYERS_7B,
                                                         "int4_mm_a8": ACTION_DIM * INT4_PER_PASS,
                                                         "quantize_a8": ACTION_DIM * INT4_PER_PASS})
            if "spec" in phases:
                spec["int4"] = spec_phase(model4, params, "int4", int4=True)
            model4.graphs.clear()
            release_memory()
        if "qlora" in phases:
            qlora = train_adapters(w8a8_model(model, w8a8=False), params, SEED, "qlora", QLORA_STEPS,
                                   {"flash_fwd": 2 * N_LAYERS_7B, "flash_bwd_dq": N_LAYERS_7B,
                                    "flash_bwd_dkv": N_LAYERS_7B, "int4_mm": 2 * INT4_PER_PASS},
                                   serve_model=model4)
        model4.graphs.clear()
        del model4
    del model, params
    release_memory()

    tuned = None
    if "finetune" in phases:
        tuned = finetune_phase(ft_ckpt, (trained or {}).get("dots", {}).get("peak_memory_gb", TRAIN_DOTS_PEAK_GB))

    parity = parity_card_vs_cpu(SEED, spec="spec" in phases) if "parity" in phases else None

    if timing_rows:
        zero = dict.fromkeys(KERNEL_NAMES, 0)
        by_path = {"serve": (served or {}).get("launches", zero), "train": (trained or {}).get("launches", zero),
                   "int8_serve": (served8 or {}).get("launches", zero),
                   "int4_serve": (served4 or {}).get("launches", zero), "qlora": (qlora or {}).get("launches", zero),
                   "parallel": (parallel or {}).get("launches", zero), "load": (loaded or {}).get("launches", zero),
                   "finetune": (tuned or {}).get("launches", zero),
                   **{f"spec_{kind}": result["launches"] for kind, result in spec.items()}}

        def launches(name):
            return {path: counts[name] for path, counts in by_path.items()}

        # serving shape, B=1: the device-side time (a captured graph), the event window beside it
        row = dict(timing_rows[0], ms=cold["flash_fwd"]["device_ms"], library_ms=cold["flash_fwd"]["library_device_ms"],
                   max_abs_err=max_err)
        entry = kernel_entry("flash_fwd", "bridgelang_tpu_torch/csrc/flash_fwd.cu",
                             "bridgelang_tpu/ops/flash_attention.py:59", launches("flash_fwd"), row,
                             shape=row["shape"], event_ms=row["kernel_ms"], library_event_ms=timing_rows[0]["library_ms"],
                             timings=timing_rows,
                             note="ms and library_ms: device time per launch from a captured CUDA graph of "
                                  "back-to-back launches (inputs warm in L2, as the prefill leaves them); event_ms, "
                                  "library_event_ms and the timings: CUDA events around calls, the earlier series")
        serve_keys = ("median_ms", "prefill_ms", "decode_ms_per_token", "batch4_ms", "batch4_passes", "passes",
                      "max_memory_gb", "profile", "eager", "replay_event_ms", "warmup_peak_gb", "capture_s")
        if served:
            entry["serve"] = {k: served[k] for k in serve_keys}
        if served8:
            entry["int8_serve"] = {k: served8[k] for k in serve_keys + (
                "model_gb", "llm_gb", "proj", "int8_product", "decode_cast_ms_per_step", "decode_cast_share")}
        if spec:
            entry["spec"] = spec
        if parallel:
            entry["parallel"] = parallel
        if trained:
            entry["train"] = trained
        if parity:
            entry["parity"] = parity
        if loaded:
            entry["load"] = {k: v for k, v in loaded.items() if k != "launches"}
        if tuned:
            entry["finetune"] = {k: v for k, v in tuned.items() if k != "launches"}
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
        a8_cold = {f"{sh} M={m}": r for (sh, m), r in cold["int4_mm_a8"].items()}
        for name, line, mode, m, key in (("int4_mm_a8", "bridgelang_tpu/ops/int4_matmul.py:114", "a8", 1, "a8"),
                                         ("int4_mm", "bridgelang_tpu/ops/int4_matmul.py:60", "bfloat16", 5632, "float")):
            rows = [r for r in int4_checks["rows"] if r["mode"] == mode]
            head = next(r for r in rows if r["m"] == m and r["n"] == 11008)
            timing = dict(head, ms=head["kernel_ms"], max_abs_err=int4_checks["worst"][key][0])
            extra = {"tolerance_use": int4_checks["worst"][key][1], "shape": head["shape"], "timings": rows,
                     "blocked": [b for b in int4_checks["blocked"] if (" a8 " in b["case"]) == (mode == "a8")]}
            if name == "int4_mm_a8":
                c = a8_cold[f"w_gate M={m}"]
                timing.update(ms=c["device_ms"], library_ms=c["library_device_ms"])
                extra.update(event_ms=head["kernel_ms"], library_event_ms=head["library_ms"], cold=a8_cold,
                             note="ms and library_ms: device time per launch, cold L2: a captured CUDA graph of "
                                  "launches rotating over weight copies of 100 MB or more in all (cold); event_ms, "
                                  "library_event_ms and the timings' kernel_ms: CUDA events around back-to-back "
                                  "wrapper calls on one weight, the earlier series")
            if name == "int4_mm_a8" and served4:
                extra["int4_serve"] = {k: served4[k] for k in serve_keys + ("model_gb", "llm_gb")}
            if name == "int4_mm" and qlora:
                extra["qlora"] = qlora
            entries.append(kernel_entry(name, "bridgelang_tpu_torch/csrc/int4_matmul.cu", line, launches(name),
                                        timing, **extra))
        qz = cold["quantize_a8"]
        entries.append(kernel_entry(
            "quantize_a8", "bridgelang_tpu_torch/csrc/int4_matmul.cu",
            "bridgelang_tpu/ops/int4_matmul.py:114 (helper of int4_mm_a8, no TPU kernel of its own: XLA fuses "
            "bridgelang_tpu/ops/quant.py quantize_activations_per_token into the jitted program)",
            launches("quantize_a8"),
            dict(qz[1], ms=qz[1]["device_ms"], plain_ms=qz[1]["plain_device_ms"], library_ms=None,
                 max_abs_err=max(quantize_errs["codes"], quantize_errs["scales"])),
            shape=qz[1]["shape"], event_ms=qz[1]["event_ms"], plain_event_ms=qz[1]["plain_ms"], timings=qz,
            codes_max_abs_err=quantize_errs["codes"], scales_max_abs_err=quantize_errs["scales"],
            route_max_abs_err=quantize_errs["route"],
            note="max_abs_err: the larger of max|codes err| and max|scales err| against "
                 "quantize_activations_per_token (random, zero, tie and NaN rows, bf16 and fp32); route_max_abs_err: "
                 "the w4a8 route against its plain composition; ms, plain_ms: device time per launch (captured CUDA graph); bound: M K 2 bytes read, M K + 4 M "
                 "written"))
        print(json.dumps({"kernels": entries}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
