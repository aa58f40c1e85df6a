#!/usr/bin/env python3
"""Smoke run of the torch port on one NVIDIA GPU (H100): `python3 chip_smoke.py`.

Run from the root of a checkout. Phases, each of which fails the run:
  1. build    compile every bridgelang_tpu_torch/csrc/*.cu with nvcc (sm_90a),
              all sources in parallel; print the build seconds, the ptxas
              register report, and the card's name and power limit.
  2. kernels  the flash-attention kernel against its plain torch version at
              the serving path's shapes (bf16, H=32, D=128, ragged lengths,
              B in {1, 4}) and at GQA, S > T, window and fp32 cases; then
              time kernel, plain version, and F.scaled_dot_product_attention
              with the equivalent boolean mask (a yardstick only: the port
              never calls it), beside the bound from bytes and FLOPs.
  3. serve    OpenVLA-7B (prism-dinosiglip-224px+7b) at full width in bf16,
              random weights drawn on the card from a seed; the port's
              VLAServer answers POST /act: batch-1 requests, then one
              micro-batch of 4 concurrent requests. Kernel launch counts are
              zeroed before and read after: each model pass must launch the
              flash kernel once per decoder layer (32). Prefill and decode
              times come from generate_greedy with 1 and 7 new tokens; a
              torch.profiler pass over batch-1 predicts gives device time,
              idle share and the top kernels.
  4. parity   a depth-cut fp32 model with the same weights on the card
              (through the kernel) and on the CPU (plain version): the
              action token ids must be equal.
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


def check_kernels(serve_t: int):
    import torch
    import torch.nn.functional as F

    from bridgelang_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain

    bf16, f32 = torch.bfloat16, torch.float32
    T = serve_t
    cases = {
        # name: (b, t, s, h, hkv, d, lengths, window, dtype, o tolerance)
        "serve_b1": (1, T, T, 32, 32, 128, [T - 21], None, bf16, 2e-2),
        "serve_b4": (4, T, T, 32, 32, 128, [T - 21, T - 9, T - 40, T - 77], None, bf16, 2e-2),
        "t304_b1": (1, 304, 304, 32, 32, 128, [290], None, bf16, 2e-2),
        "t304_b4": (4, 304, 304, 32, 32, 128, [304, 290, 271, 256], None, bf16, 2e-2),
        "gqa_hkv8": (2, 304, 304, 32, 8, 128, [304, 262], None, bf16, 2e-2),
        "keys_longer": (2, 304, 311, 32, 32, 128, [304, 250], None, bf16, 2e-2),
        "window100": (2, 304, 304, 32, 32, 128, [304, 280], 100, bf16, 2e-2),
        "fp32_d64": (2, 200, 200, 8, 8, 64, [200, 150], None, f32, 1e-4),
    }
    # bf16 outputs: kernel and plain both accumulate in fp32 and round once to
    # bf16 (half an ulp is <= 0.008 for |o| < 4), so 2e-2 allows one ulp apart.
    # lse is fp32 in both: only the summation order differs (atol 1e-3).
    rows, worst = [], {}
    for i, (name, (b, t, s, h, hkv, d, lengths, window, dtype, tol)) in enumerate(cases.items()):
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
        log(f"kernel {name}: B={b} T={t} S={s} H={h} Hkv={hkv} D={d} {str(dtype)[6:]} window={window} "
            f"max|o-plain|={err_o:.3e} (tol {tol}) max|lse-plain|={err_lse:.3e} (tol 1e-3) {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"flash kernel disagrees with its plain version in case {name}")
        worst[name] = err_o

        if name in ("serve_b1", "serve_b4", "t304_b1"):
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


def profile_predict(model, params, reps: int = 3) -> dict:
    """torch.profiler over `reps` batch-1 predict_action calls: wall ms per
    call, device kernel ms per call (sum of kernel durations on the one
    stream), the device's idle share, launches per call and the top kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    img = frames(1, seed=5)[0]
    model.predict_action(params, img, INSTRUCTIONS[0])  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            model.predict_action(params, img, INSTRUCTIONS[0])
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / reps
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        log(f"profile: wall {wall_ms:.2f} ms/predict; device time not measured (no CUDA events traced)")
        return {"wall_ms": wall_ms}
    by_name: dict = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / reps
    busy_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    flash_ms = sum(v for k, v in by_name.items() if "flash_fwd" in k)
    log(f"profile (B=1 predict_action, {reps} calls): wall {wall_ms:.2f} ms, device kernels {busy_ms:.2f} ms "
        f"({len(kernels) / reps:.0f} launches), device idle {100 * (1 - busy_ms / wall_ms):.1f}%, "
        f"flash_fwd {flash_ms:.3f} ms ({100 * flash_ms / busy_ms:.1f}% of device time)")
    for name, ms in top:
        log(f"  {ms:8.3f} ms  {100 * ms / busy_ms:5.1f}%  {name[:110]}")
    return {"wall_ms": wall_ms, "device_ms": busy_ms, "idle_share": 1 - busy_ms / wall_ms,
            "launches_per_predict": len(kernels) / reps, "flash_ms": flash_ms}


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


# --- phase 4: card vs CPU ----------------------------------------------------------


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


def main() -> None:
    ap = argparse.ArgumentParser(description="torch port smoke run on one GPU")
    ap.add_argument("--phases", default="build,kernels,serve,parity",
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
    # Full fp32 matmuls and convolutions, so phase 4 compares fp32 with fp32.
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
    if phases & {"kernels", "serve"}:
        if "serve" in phases:
            model, params = build_7b(SEED)
            ids, _ = model.pad_prompt([model.prepare_prompt_ids(INSTRUCTIONS[0])])
            serve_t = ids.shape[1] + model.num_patches
            log(f"serving prefill length: {ids.shape[1]}-token prompt bucket + {model.num_patches} patches = {serve_t}")
    timing_rows, max_err = [], None
    if "kernels" in phases:
        timing_rows, max_err = check_kernels(serve_t)

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
        del model, params
        torch.cuda.empty_cache()
        flash_attention.launches = 0

    if "parity" in phases:
        parity_card_vs_cpu(SEED)

    if timing_rows:
        row = timing_rows[0]  # the serving shape at batch 1
        entry = {
            "name": "flash_fwd", "route": "cuda", "source": "bridgelang_tpu_torch/csrc/flash_fwd.cu",
            "replaces": "bridgelang_tpu/ops/flash_attention.py:59",
            "launches": served["launches"] if served else 0,
            "launches_per_predict": served["launches"] / served["passes"] if served else 0,
            "max_abs_err": max_err, "ms": row["kernel_ms"], "kernel_ms": row["kernel_ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "shape": row["shape"], "timings": timing_rows,
        }
        if served:
            entry["serve"] = {k: served[k] for k in ("median_ms", "prefill_ms", "decode_ms_per_token",
                                                      "batch4_ms", "batch4_passes", "passes", "max_memory_gb",
                                                      "profile")}
        print(json.dumps({"kernels": [entry]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
