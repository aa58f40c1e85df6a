#!/usr/bin/env python3
"""Smoke run of the torch port on one NVIDIA GPU (H100): `python3 chip_smoke.py`.

Run from the root of a checkout. Phases, each of which fails the run:
  1. build    compile every bridgelang_tpu_torch/csrc/*.cu with nvcc (sm_90a),
              all sources in parallel; print the build seconds, the ptxas
              register report, and the card's name and power limit.
  2. kernels  the flash-attention forward kernel against its plain torch
              version at the serving path's shapes (bf16, H=32, D=128, ragged
              lengths, B in {1, 4}) and at GQA, S > T, window and fp32 cases;
              the two backward kernels (dQ, dK/dV) against the plain backward
              at the training shape (B=16, T=S=352, bf16, ragged lengths) and
              at the same four other cases, element by element (GRAD_TOL),
              with exactly zero gradient for dead key slots. Then time each
              kernel, its plain version and a PyTorch yardstick
              (F.scaled_dot_product_attention with the equivalent boolean
              mask, forward or autograd backward; the port never calls it),
              beside the bound from bytes and FLOPs.
  3. serve    OpenVLA-7B (prism-dinosiglip-224px+7b) at full width in bf16,
              random weights drawn on the card from a seed; the port's
              VLAServer answers POST /act: batch-1 requests, then one
              micro-batch of 4 concurrent requests. Kernel launch counts are
              zeroed before and read after: each model pass must launch the
              flash kernel once per decoder layer (32). Prefill and decode
              times come from generate_greedy with 1 and 7 new tokens; a
              torch.profiler pass over batch-1 predicts gives device time,
              idle share and the top kernels.
  4. train    LoRA fine-tuning of the same bf16 7B weights: r=32 fp32
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
  5. parity   a depth-cut fp32 model with the same weights on the card
              (through the kernels) and on the CPU (plain versions): the
              action token ids must be equal, and one LoRA train step must
              give the same loss (1e-5 relative) and adapter gradients
              (1e-4 of max |g|).
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
    import torch.nn.functional as F

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
            dq_ms = cuda_ms(lambda: flash_bwd_dq(q, k, v, do, lse, delta, lens, True, window), 20)
            dkv_ms = cuda_ms(lambda: flash_bwd_dkv(q, k, v, do, lse, delta, lens, True, window), 20)
            plain_ms = cuda_ms(lambda: flash_attention_bwd_plain(q, k, v, o, lse, do, lens, True, window), 5)
            mask = valid_mask(t, s, lengths, window, device="cuda")[:, None]
            qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
            out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
            dot = do.transpose(1, 2)
            library_ms = cuda_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True), 20)
            bounds = {w: bwd_bound_ms(q, k, lens, window, w) for w in ("dq", "dkv", "both")}
            timing = dict(shape=f"B={b} T={t} S={s} H={h} D={d} bf16 (lengths {min(lengths)}-{max(lengths)})",
                          dq_ms=dq_ms, dkv_ms=dkv_ms, plain_ms=plain_ms, library_ms=library_ms, bounds=bounds)
            log(f"timing bwd {name}: dq {dq_ms:.4f} ms (bound {bounds['dq'][0]:.4f} ms, {bounds['dq'][1]}), "
                f"dk/dv {dkv_ms:.4f} ms (bound {bounds['dkv'][0]:.4f} ms, {bounds['dkv'][1]}), "
                f"plain backward {plain_ms:.4f} ms, sdpa backward (yardstick) {library_ms:.4f} ms, "
                f"whole-backward bound {bounds['both'][0]:.4f} ms ({bounds['both'][1]})")
            del out, qt, kt, vt
    return timing, worst, readings


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
                             max_abs_err=err_o))
            log(f"timing {name}: kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"sdpa (yardstick) {library_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by})")
    return rows, max(worst.values())


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
    the one stream), the device's idle share, launches per call, the flash
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
    flash = {k: sum(v for n, v in by_name.items() if k in n) for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
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


def serve(model, params, n_single: int):
    import torch

    from bridgelang_tpu_torch.ops.flash_attention import flash_attention
    from bridgelang_tpu_torch.serving.server import VLAServer, client_act

    imgs = frames(4, seed=7)
    flash_attention.launches = 0
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
    launches_single = flash_attention.launches
    log(f"batch-1: {n_single} x HTTP 200 with 7 floats; latency ms {[round(x, 1) for x in lat]}; "
        f"model passes {passes_single}; flash launches {launches_single}")
    if passes_single != n_single or launches_single != N_LAYERS_7B * passes_single:
        fail(f"expected {N_LAYERS_7B} flash launches per model pass, got {launches_single} over {passes_single}")

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
    launches_batched = flash_attention.launches - launches_single
    log(f"micro-batch of 4 (instruction lengths {[len(s) for s in INSTRUCTIONS]}): 4 x HTTP 200 with 7 floats "
        f"in {batch_ms:.1f} ms; model passes {passes_batched}; flash launches {launches_batched}")
    if passes_batched < 1 or launches_batched != N_LAYERS_7B * passes_batched:
        fail(f"expected {N_LAYERS_7B} flash launches per model pass, got {launches_batched} over {passes_batched}")
    return dict(latencies_ms=lat, median_ms=statistics.median(lat[1:] if len(lat) > 1 else lat),
                batch4_ms=batch_ms, batch4_passes=passes_batched,
                launches=flash_attention.launches, passes=passes_single + passes_batched,
                max_memory_gb=torch.cuda.max_memory_allocated() / 1e9)


# --- phase 4: LoRA fine-tuning ------------------------------------------------------


def reset_launch_counts() -> None:
    from bridgelang_tpu_torch.ops.flash_attention import flash_attention, flash_bwd_dkv, flash_bwd_dq

    flash_attention.launches = flash_bwd_dq.launches = flash_bwd_dkv.launches = 0


def launch_counts() -> tuple:
    from bridgelang_tpu_torch.ops.flash_attention import flash_attention, flash_bwd_dkv, flash_bwd_dq

    return flash_attention.launches, flash_bwd_dq.launches, flash_bwd_dkv.launches


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


def train_lora(model, params, seed: int) -> dict:
    """Full-depth LoRA fine-tuning on the card; returns its numbers."""
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
    llm_leaves = [(k, t) for lp in lora_params["llm"]["layers"] for k, t in lp.items()]
    n_lora = sum(t.numel() for k, t in llm_leaves if "_lora_" in k)
    n_base = sum(t.numel() for k, t in llm_leaves if "_lora_" not in k)
    n_base += sum(lora_params["llm"][k].numel() for k in ("embed", "final_norm", "lm_head"))
    n_vis = sum(t.numel() for part in ("vision", "projector") for t in tree_leaves(params[part]))
    vis_tokens = b * (model.num_patches + 5)  # bench.py's count: DINOv2's 256 patches + class + 4 registers
    flops = 4.0 * n_base * tokens + 6.0 * n_lora * tokens + 2.0 * n_vis * vis_tokens
    log(f"train: OpenVLA-7B bf16 base ({n_base / 1e9:.3f} B LLM params) + r={LORA_RANK} fp32 adapters "
        f"({n_lora / 1e6:.1f} M params), batch {b} x {f} fused tokens, full remat, AdamW lr {LORA_LR}; "
        f"useful FLOPs per step {flops:.4g}")

    torch.cuda.reset_peak_memory_stats()
    losses, times, totals = [], [], [0, 0, 0]
    for i in range(1 + TRAIN_STEPS):
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        counts = launch_counts()
        totals = [a + c for a, c in zip(totals, counts)]
        losses.append(loss)
        log(f"train step {i}{' (warm)' if i == 0 else ''}: loss {loss:.4f}, grad_norm {float(m['grad_norm']):.4f}, "
            f"action_accuracy {float(m['action_accuracy']):.3f}, l1 {float(m['l1_loss']):.4f}, "
            f"{times[-1]:.1f} ms; launches flash_fwd {counts[0]}, dq {counts[1]}, dkv {counts[2]}")
        if not np.isfinite(loss):
            fail(f"train step {i}: non-finite loss {loss}")
        if counts != (2 * N_LAYERS_7B, N_LAYERS_7B, N_LAYERS_7B):
            fail(f"train step {i}: expected launches (64, 32, 32) of (flash_fwd, dq, dkv), got {counts}")
    if float(np.mean(losses[-3:])) >= losses[0]:
        fail(f"the mean of the last 3 losses does not fall below the first on a fixed batch: {losses}")
    step_ms = statistics.median(times[1:])
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    share = flops / (step_ms / 1e3) / PEAK_FLOPS["bfloat16"]
    log(f"train: median step {step_ms:.1f} ms over {TRAIN_STEPS} steps ({[round(t, 1) for t in times[1:]]}), "
        f"{tokens / (step_ms / 1e3):.1f} tokens/s, useful-FLOP share {100 * share:.2f}% of 989 TFLOP/s, "
        f"peak memory {peak_gb:.2f} GB; losses {[round(x, 4) for x in losses]}")
    prof = profile_device("LoRA train step B=16", lambda: step(state, batch), 1)

    # scripts/finetune.py's default policy, "dots": matmul outputs are saved
    # and the rest recomputed. The flash launch is no aten op, so it reruns.
    dots_step = make_vla_train_step(model, optimizer, trainable_mask=mask, compute_dtype=torch.bfloat16,
                                    image_transform=model.image_transform, remat=True, remat_policy="dots")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dots_times = []
    for i in range(1 + DOTS_STEPS):
        reset_launch_counts()
        t0 = time.perf_counter()
        state, m = dots_step(state, batch)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        dots_times.append(1e3 * (time.perf_counter() - t0))
        counts = launch_counts()
        log(f"train step dots {i}{' (warm)' if i == 0 else ''}: loss {loss:.4f}, {dots_times[-1]:.1f} ms; "
            f"launches flash_fwd {counts[0]}, dq {counts[1]}, dkv {counts[2]}")
        if not np.isfinite(loss):
            fail(f"dots train step {i}: non-finite loss {loss}")
        if counts != (2 * N_LAYERS_7B, N_LAYERS_7B, N_LAYERS_7B):
            fail(f"dots train step {i}: expected launches (64, 32, 32) of (flash_fwd, dq, dkv), got {counts}")
    dots_ms = statistics.median(dots_times[1:])
    dots = dict(step_ms=dots_ms, step_times_ms=dots_times[1:], warm_ms=dots_times[0],
                tokens_per_s=tokens / (dots_ms / 1e3), flop_share=flops / (dots_ms / 1e3) / PEAK_FLOPS["bfloat16"],
                peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f"train dots remat: median step {dots_ms:.1f} ms over {DOTS_STEPS} steps, {dots['tokens_per_s']:.1f} tokens/s, "
        f"useful-FLOP share {100 * dots['flop_share']:.2f}%, peak memory {dots['peak_memory_gb']:.2f} GB")

    trained = state.params
    del state, optimizer, step, dots_step
    merged = dict(params, llm=merge_lora(trained["llm"]))
    del trained
    action = model.predict_action(merged, frames(1, seed=9)[0], INSTRUCTIONS[0])
    check_action(action, "predict_action through the merged weights")
    log(f"merged LoRA weights: predict_action -> {np.round(action, 4).tolist()}")
    del merged
    torch.cuda.empty_cache()
    return dict(step_ms=step_ms, step_times_ms=times[1:], warm_ms=times[0], tokens_per_step=tokens,
                tokens_per_s=tokens / (step_ms / 1e3), useful_flops=flops, flop_share=share, peak_memory_gb=peak_gb,
                losses=losses, profile=prof, launches=dict(zip(("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"), totals)),
                steps=1 + TRAIN_STEPS, dots=dots)


# --- phase 5: card vs CPU ----------------------------------------------------------


class GradRecorder:
    """An optimizer that keeps a copy of the gradients it is handed."""

    def __init__(self, optimizer):
        self.optimizer, self.grads = optimizer, None

    def update(self, grads, state, params):
        self.grads = [g.detach().clone() for g in grads]
        self.optimizer.update(grads, state, params)


def parity_card_vs_cpu(seed: int):
    import dataclasses

    import numpy as np
    import torch

    from bridgelang_tpu_torch.models.llm.tokenizer import ByteFallbackTokenizer
    from bridgelang_tpu_torch.models.vision.vit import VIT_CONFIGS
    from bridgelang_tpu_torch.models.vla import OpenVLA
    from bridgelang_tpu_torch.models.vlm import VLMConfig
    from bridgelang_tpu_torch.ops.flash_attention import flash_attention
    from bridgelang_tpu_torch.ops.image_ops import frames_to_tensor, preprocess_batch

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
    imgs = frames(2, seed=11)
    ids, mask = gpu.pad_prompt([gpu.prepare_prompt_ids(t) for t in INSTRUCTIONS[:2]])
    out = {}
    for name, model, params in (("cuda", gpu, p_gpu), ("cpu", cpu, p_cpu)):
        dev = model.device
        pix = preprocess_batch(frames_to_tensor(np.stack(imgs), dev), model.image_transform)
        before = flash_attention.launches
        tok = model.generate_greedy(params, torch.as_tensor(ids, device=dev), torch.as_tensor(mask, device=dev),
                                    pix, max_new_tokens=7)
        out[name] = (tok.cpu(), flash_attention.launches - before)
    log(f"parity: depth-cut fp32 model, tokens cuda {out['cuda'][0].tolist()} (flash launches {out['cuda'][1]}), "
        f"cpu {out['cpu'][0].tolist()} (flash launches {out['cpu'][1]})")
    if out["cuda"][1] != 2 or out["cpu"][1] != 0:
        fail("the card run must launch the kernel once per layer and the CPU run never")
    if not torch.equal(out["cuda"][0], out["cpu"][0]):
        fail("action token ids differ between the card (kernel) and the CPU (plain version)")

    # One LoRA train step on each side, the same adapters (B drawn too, so
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
    log(f"parity: one LoRA train step, loss cuda {l_gpu:.7f} cpu {l_cpu:.7f} (rel {abs(l_gpu - l_cpu) / abs(l_cpu):.2e}, "
        f"tol 1e-5); adapter grads max|cuda-cpu| {g_err:.3e} vs max|g| {g_max:.3e} (tol 1e-4 x max|g|); "
        f"launches cuda {n_gpu} cpu {n_cpu}")
    if n_gpu != (4, 2, 2) or n_cpu != (0, 0, 0):
        fail("the card's train step must launch (flash_fwd, dq, dkv) (4, 2, 2) times on 2 layers, the CPU's never")
    if abs(l_gpu - l_cpu) > 1e-5 * abs(l_cpu) or g_err > 1e-4 * g_max:
        fail("the LoRA train step disagrees between the card (kernels) and the CPU (plain versions)")
    return dict(loss_rel_err=abs(l_gpu - l_cpu) / abs(l_cpu), grad_err=g_err, grad_max=g_max)


def main() -> None:
    ap = argparse.ArgumentParser(description="torch port smoke run on one GPU")
    ap.add_argument("--phases", default="build,kernels,serve,train,parity",
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
    # Full fp32 matmuls and convolutions, so phase 5 compares fp32 with fp32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = nvidia_smi_line()
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; card: {smi}")

    t0 = time.perf_counter()
    logs = _build.build_all()
    log(f"build: {len(logs)} source(s) in {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                log(f"  {name}: {line.strip()}")

    model = params = None
    serve_t = 352
    if phases & {"serve", "train"}:
        model, params = build_7b(SEED)
        ids, _ = model.pad_prompt([model.prepare_prompt_ids(INSTRUCTIONS[0])])
        serve_t = ids.shape[1] + model.num_patches
        log(f"serving prefill length: {ids.shape[1]}-token prompt bucket + {model.num_patches} patches = {serve_t}")
    timing_rows, max_err, bwd_timing, bwd_err, bwd_readings = [], None, None, None, None
    if "kernels" in phases:
        timing_rows, max_err = check_kernels(serve_t)
        bwd_timing, bwd_err, bwd_readings = check_backward_kernels()

    served = None
    if "serve" in phases:
        from bridgelang_tpu_torch.ops.flash_attention import flash_attention

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
        served = serve(model, params, N_SINGLE_REQUESTS)
        served.update(prefill_ms=t1, decode_ms_per_token=(t7 - t1) / 6, profile=prof)
        log(f"serve: median batch-1 /act {served['median_ms']:.1f} ms; micro-batch of 4 {served['batch4_ms']:.1f} ms; "
            f"peak memory {served['max_memory_gb']:.2f} GB")
        flash_attention.launches = 0

    trained = None
    if "train" in phases:
        trained = train_lora(model, params, SEED)
    del model, params
    torch.cuda.empty_cache()

    parity = parity_card_vs_cpu(SEED) if "parity" in phases else None

    if timing_rows:
        row = timing_rows[0]  # the serving shape at batch 1
        serve_launches = served["launches"] if served else 0
        train_launches = trained["launches"] if trained else {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
        entry = {
            "name": "flash_fwd", "route": "cuda", "source": "bridgelang_tpu_torch/csrc/flash_fwd.cu",
            "replaces": "bridgelang_tpu/ops/flash_attention.py:59",
            "launches": serve_launches + train_launches["flash_fwd"],
            "launches_by_path": {"serve": serve_launches, "train": train_launches["flash_fwd"]},
            "launches_per_predict": served["launches"] / served["passes"] if served else 0,
            "max_abs_err": max_err, "ms": row["kernel_ms"], "kernel_ms": row["kernel_ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "shape": row["shape"], "timings": timing_rows,
        }
        if served:
            entry["serve"] = {k: served[k] for k in ("median_ms", "prefill_ms", "decode_ms_per_token",
                                                      "batch4_ms", "batch4_passes", "passes", "max_memory_gb",
                                                      "profile")}
        if trained:
            entry["train"] = trained
        if parity:
            entry["train_parity"] = parity
        entries = [entry]
        for name, line, ms_key, err in (("flash_bwd_dq", "bridgelang_tpu/ops/flash_attention.py:116", "dq_ms", "dq"),
                                        ("flash_bwd_dkv", "bridgelang_tpu/ops/flash_attention.py:156", "dkv_ms", "dkv")):
            bound, bound_by = bwd_timing["bounds"][err]
            entries.append({
                "name": name, "route": "cuda", "source": "bridgelang_tpu_torch/csrc/flash_bwd.cu", "replaces": line,
                "launches": train_launches[name],
                "launches_per_train_step": train_launches[name] / trained["steps"] if trained else 0,
                "max_abs_err": bwd_err[err], "ms": bwd_timing[ms_key], "plain_ms": bwd_timing["plain_ms"],
                "tolerance_use": max(r[w]["use"] for r in bwd_readings.values()
                                     for w in ({"dq": ("dq",), "dkv": ("dk", "dv")}[err])),
                "bound_ms": bound, "bound_by": bound_by, "library_ms": bwd_timing["library_ms"],
                "shape": bwd_timing["shape"],
                "note": "plain_ms and library_ms compute dq, dk and dv together",
            })
        print(json.dumps({"kernels": entries}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
