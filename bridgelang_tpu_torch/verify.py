"""Inference smoke, latency check and golden-trajectory parity kit.

    python -m bridgelang_tpu_torch.verify [--checkpoint /ckpts/openvla-7b] [--calls 100] [--device cuda]

Counterpart of scripts/verify.py (the reference's
vla-scripts/extern/verify_openvla.py:30-89): load a checkpoint (or build a
random-init, depth-trimmed flagship), run `--calls` predicts on random
frames, print per-call latency and check the actions' shape and finiteness.
Every field of the JAX script's `VerifyConfig` under its name and default,
plus `--device` (CUDA unless `--device cpu`; no fallback).

Golden-trajectory kit. A golden `.npz` bundles model inputs with the
outputs one implementation gave: either `frames` [N, H, W, 3] uint8 +
`instructions` [N] str, or pre-tokenized `pixel_values` [N, C, H, W] f32 +
`input_ids` / `attention_mask` [N, T] i32; plus `expected_tokens` [N, A]
i32, `expected_actions` [N, A] f32, `unnorm_key`, and `numerics` (the
decoder's weight kind, "bf16" for any float tree, "int8" or "int4", with
"+w8a8"). The format is the JAX script's: a bundle recorded by either
package replays in the other. Replay asserts token equality and action
closeness (`--golden_atol`).

    python -m bridgelang_tpu_torch.verify --checkpoint /ckpts/openvla-7b --golden_record golden.npz --calls 16
    python -m bridgelang_tpu_torch.verify --checkpoint /ckpts/openvla-7b --golden golden.npz

`--speculative_stream` runs a control-loop tick sequence with server-style
drafts (`serving.server.draft_from_history`) and prints the accept counts
the margin gate gave, from the bundle's frames with `--golden` or else a
slowly drifting synthetic camera. `--reference_twin` (the reference's own HF
modeling file) is refused: that tree is not in this repository.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np

from bridgelang_tpu_torch.conf import parse_cli

# The statistics of the random-init flagship (the JAX package's
# __graft_entry__._flagship_model).
FLAGSHIP_STATS = {
    "bridge_orig": {
        "action": {
            "q01": [-0.03, -0.05, -0.06, -0.13, -0.12, -0.43, 0.0],
            "q99": [0.03, 0.04, 0.06, 0.13, 0.12, 0.43, 1.0],
            "mask": [True, True, True, True, True, True, False],
        }
    }
}
TRIM_LLM_LAYERS = 8  # of Llama-2 7B's 32: the random-init path is a timing smoke, not the full model
TRIM_VIT_DEPTH = 8


@dataclass
class VerifyConfig:
    checkpoint: Optional[str] = None  # None -> random-init, depth-trimmed flagship
    tokenizer_path: Optional[str] = None
    calls: int = 100
    quantize_int8: bool = True
    quantize_int4: bool = False  # w4a8; overrides int8
    int4_group: int = 128  # scale-group rows
    parallel_decode: bool = False
    golden: Optional[str] = None  # replay a golden .npz -> parity verdict
    golden_record: Optional[str] = None  # record a golden .npz from this model
    golden_atol: float = 1e-5  # action tolerance on replay (tokens are exact)
    # Accept counts on a frame stream at the margin gate, drafting as the
    # server's default mode does (draft_from_history).
    speculative_stream: bool = False
    margin_threshold: float = 0.25
    # The reference's own HF modeling file as a twin: not in this repository.
    reference_twin: Optional[str] = None
    twin_calls: int = 4
    device: Optional[str] = None  # cuda (default) | cpu


def _action_stats(model, unnorm_key: Optional[str]):
    """(q01, q99, mask) as numpy arrays for `unnorm_key`."""
    stats = model.get_action_stats(unnorm_key)
    n = len(stats["q01"])
    return (np.asarray(stats["q01"], np.float32), np.asarray(stats["q99"], np.float32),
            np.asarray(stats.get("mask", [True] * n), bool))


def _golden_predict(model, params, rec) -> tuple:
    """(tokens [N, A] int32, actions [N, A] float32) for one bundle's inputs,
    all N records in one greedy predict."""
    from bridgelang_tpu_torch.models.graphs import unpack_outputs

    unnorm_key = str(rec["unnorm_key"]) if "unnorm_key" in rec else None
    q01, q99, smask = _action_stats(model, unnorm_key)
    inputs = {"q01": q01, "q99": q99, "stat_mask": smask}
    if "pixel_values" in rec:
        inputs["ids"] = np.asarray(rec["input_ids"], np.int32)
        inputs["mask"] = np.asarray(rec["attention_mask"], np.int32)
        inputs["pixels"] = np.asarray(rec["pixel_values"], np.float32)
    else:
        instructions = [str(s) for s in rec["instructions"]]
        inputs["ids"], inputs["mask"] = model.pad_prompt([model.prepare_prompt_ids(t) for t in instructions])
        inputs["frames"] = np.ascontiguousarray(rec["frames"], dtype=np.uint8)
    actions, tokens, _ = unpack_outputs(model._predict("greedy", params, inputs, len(q01)).cpu().numpy())
    return tokens.astype(np.int32), actions.astype(np.float32)


def _numerics_tag(model, params) -> str:
    """The decoder's serving numerics, recorded into golden bundles so that
    a replay under another mode explains its mismatches: "int4", "int8" or
    "bf16" (any float tree, the JAX tag), with "+w8a8"."""
    first = params["llm"]["layers"][0]
    kind = ("int4" if any(k.endswith("_scale4") for k in first)
            else "int8" if any(k.endswith("_scale") for k in first) else "bf16")
    return f"{kind}+w8a8" if getattr(model.cfg.llm, "w8a8", False) else kind


def replay_golden(model, params, golden_path, atol: float = 1e-5):
    """Replay a golden bundle -> (n_pass, n_total, failure messages)."""
    rec = np.load(golden_path, allow_pickle=False)
    if "numerics" in rec:
        recorded, live = str(rec["numerics"]), _numerics_tag(model, params)
        if recorded != live:
            print(f"[verify] WARNING: golden bundle was recorded under numerics {recorded!r} but this model "
                  f"runs {live!r}: token mismatches below are expected; re-record or match the --quantize_* "
                  "flags (load_vla turns w8a8 on for quantized loads)")
    tokens, actions = _golden_predict(model, params, rec)
    exp_tokens = np.asarray(rec["expected_tokens"], np.int32)
    exp_actions = np.asarray(rec["expected_actions"], np.float32)

    failures = []
    for i in range(tokens.shape[0]):
        if not np.array_equal(tokens[i], exp_tokens[i]):
            failures.append(f"record {i}: tokens {tokens[i].tolist()} != expected {exp_tokens[i].tolist()}")
        elif not np.allclose(actions[i], exp_actions[i], atol=atol):
            failures.append(f"record {i}: max action delta "
                            f"{np.max(np.abs(actions[i] - exp_actions[i])):.2e} > atol={atol}")
    return tokens.shape[0] - len(failures), tokens.shape[0], failures


def record_golden(model, params, out_path, calls: int, unnorm_key: Optional[str], seed: int = 0):
    """Record a golden bundle from this model on seeded random frames (the
    first tower's size) and canned instructions."""
    rng = np.random.default_rng(seed)
    size = model.image_transform.towers[0].size
    frames = rng.integers(0, 255, size=(calls, size, size, 3), dtype=np.uint8)
    instructions = np.asarray([f"pick up the object {i}" for i in range(calls)])
    key = unnorm_key or next(iter(model.norm_stats))
    rec = {"frames": frames, "instructions": instructions, "unnorm_key": np.asarray(key)}
    tokens, actions = _golden_predict(model, params, rec)
    np.savez(out_path, **rec, expected_tokens=tokens, expected_actions=actions,
             numerics=np.asarray(_numerics_tag(model, params)))
    return out_path


def speculative_stream(model, params, frames, instruction: str, unnorm_key: Optional[str],
                       margin_threshold: float = 0.25):
    """Speculative predicts over `frames` in order, each drafted from the
    ids of the two before it as the server drafts -> (accept counts [N - 1],
    latencies in s [N - 1]); tick 0 (graph capture, a cold draft) is left
    out. The counts are the margin gate's own
    (`predict_from_frames_device_speculative(..., return_accept_count=True)`)."""
    from bridgelang_tpu_torch.serving.server import draft_from_history

    q01, q99, smask = _action_stats(model, unnorm_key)
    action_dim = len(q01)
    ids, mask = model.pad_prompt([model.prepare_prompt_ids(instruction)])
    vocab = model.cfg.llm.vocab_size
    prev2 = prev1 = None
    accepts, lat = [], []
    for i, frame in enumerate(frames):
        draft = (np.zeros(action_dim, np.int32) if prev1 is None
                 else draft_from_history(prev2, prev1, vocab, n_bins=getattr(model, "n_action_bins", 256)))
        t0 = time.perf_counter()
        _, toks, acc = model.predict_from_frames_device_speculative(
            params, ids, mask, np.asarray(frame, np.uint8)[None], q01, q99, smask, draft[None],
            margin_threshold=margin_threshold, return_accept_count=True)
        toks, acc = toks.cpu().numpy(), acc.cpu().numpy()  # the host reads: control-loop timing
        dt = time.perf_counter() - t0
        prev2, prev1 = prev1, toks[0].astype(np.int32)
        if i > 0:
            accepts.append(int(acc[0]))
            lat.append(dt)
    return np.asarray(accepts), np.asarray(lat)


def flagship_model(device, llm_layers: int = TRIM_LLM_LAYERS, vit_depth: int = TRIM_VIT_DEPTH, dtype=None):
    """The openvla-7b architecture (DINOv2-L + SigLIP-So400m at 224 px, the
    fused GELU-MLP projector, Llama-2 7B) at full width, its decoder cut to
    `llm_layers` and each tower to `vit_depth` blocks, with the bridge_orig
    statistics (the JAX package's `_flagship_model`)."""
    import dataclasses

    import torch

    from bridgelang_tpu_torch.models.vision.vit import VIT_CONFIGS
    from bridgelang_tpu_torch.models.vla import OpenVLA
    from bridgelang_tpu_torch.models.vlm import VLMConfig

    cfg = VLMConfig.from_ids(model_id="prism-dinosiglip-224px+7b", vision_backbone_id="dinosiglip-vit-so-224px",
                             llm_backbone_id="llama2-7b-pure", arch_specifier="no-align+fused-gelu-mlp",
                             image_resize_strategy="resize-naive", llm_overrides={"n_layers": llm_layers})
    towers = tuple(dataclasses.replace(VIT_CONFIGS[i], depth=vit_depth) for i in ("dinov2-vit-l", "siglip-vit-so400m"))
    cfg = dataclasses.replace(cfg, vision_override=towers)
    return OpenVLA(cfg, FLAGSHIP_STATS, dtype=dtype or torch.bfloat16, device=device)


def _build_model(cfg: VerifyConfig):
    """(model, params): the checkpoint loaded through `load_vla`, or the
    random-init trimmed flagship quantized as the flags say."""
    import dataclasses

    import torch

    from bridgelang_tpu_torch._device import resolve_device
    from bridgelang_tpu_torch.models.llm.tokenizer import get_tokenizer

    device = resolve_device(cfg.device)
    if cfg.checkpoint:
        from bridgelang_tpu_torch.models.load import load_vla

        model, params = load_vla(cfg.checkpoint, quantize_int8=cfg.quantize_int8 and not cfg.quantize_int4,
                                 quantize_int4=cfg.quantize_int4, int4_group=cfg.int4_group, device=device)
        model.tokenizer = get_tokenizer(cfg.tokenizer_path)
        return model, params
    print(f"[verify] no checkpoint; random-init DEPTH-TRIMMED flagship ({TRIM_LLM_LAYERS}/32 decoder layers, "
          f"towers of {TRIM_VIT_DEPTH} blocks: a timing smoke, not the full model)")
    model = flagship_model(device)
    model.tokenizer = get_tokenizer(cfg.tokenizer_path)
    if cfg.quantize_int8 or cfg.quantize_int4:
        # The quantized serving posture on this path too (w8a8 activations),
        # as load_vla sets it for a quantized load.
        from bridgelang_tpu_torch.models.vla import OpenVLA

        llm_cfg = dataclasses.replace(model.cfg.llm, w8a8=True)
        model = OpenVLA(dataclasses.replace(model.cfg, llm=llm_cfg), model.norm_stats, tokenizer=model.tokenizer,
                        dtype=model.dtype, device=device)
    params = model.init_params(torch.Generator(device=device).manual_seed(0))
    if cfg.quantize_int4:
        from bridgelang_tpu_torch.ops.quant import quantize_llm_int4

        params["llm"] = quantize_llm_int4(params["llm"], group=cfg.int4_group)
    elif cfg.quantize_int8:
        from bridgelang_tpu_torch.ops.quant import quantize_llm_int8

        params["llm"] = quantize_llm_int8(params["llm"])
    return model, params


def _stream_frames(cfg: VerifyConfig):
    """(frames, instruction, unnorm_key) of the speculative stream: the
    bundle's with --golden, else a smooth synthetic camera drift."""
    if cfg.golden:
        rec = np.load(cfg.golden, allow_pickle=False)
        return (list(np.asarray(rec["frames"])), str(rec["instructions"][0]),
                str(rec["unnorm_key"]) if "unnorm_key" in rec else None)
    rng = np.random.default_rng(0)
    base = rng.integers(0, 255, size=(224, 224, 3), dtype=np.int16)
    frames = []
    for _ in range(max(cfg.calls, 8)):
        base = np.clip(base + rng.integers(-3, 4, size=base.shape), 0, 255)
        frames.append(base.astype(np.uint8))
    return frames, "pick up the object", None


def main(cfg: VerifyConfig) -> dict:
    """Run the mode the flags ask for; returns its readings (the smoke and
    the tests read them)."""
    if cfg.reference_twin:
        raise SystemExit(
            "--reference_twin runs the reference's own HF modeling tree (prismatic/extern/hf: "
            "configuration_prismatic.py, modeling_prismatic.py) through the JAX package's extern/reference_twin; "
            "that tree is not in this repository and the port does not run it. Use --golden bundles recorded "
            "by the reference stack instead.")

    model, params = _build_model(cfg)

    if cfg.golden_record:
        path = record_golden(model, params, cfg.golden_record, cfg.calls, unnorm_key=None)
        print(f"[verify] recorded golden bundle ({cfg.calls} records) -> {path}")
        return {"recorded": str(path)}
    if cfg.speculative_stream:
        frames, instruction, unnorm_key = _stream_frames(cfg)
        accepts, lat = speculative_stream(model, params, frames, instruction, unnorm_key,
                                          margin_threshold=cfg.margin_threshold)
        p50 = float(np.percentile(lat, 50))
        adim = model.get_action_dim(unnorm_key)
        hist = np.bincount(accepts, minlength=adim + 1)[1:].tolist()
        print(f"[verify] speculative stream ({len(accepts)} ticks, margin={cfg.margin_threshold}): "
              f"mean accepted {accepts.mean():.2f}/{adim} hist(k=1..{adim})={hist} "
              f"p50={p50 * 1e3:.1f}ms -> {1.0 / p50:.2f} actions/s effective")
        return {"accepts": accepts.tolist(), "hist": hist, "p50_ms": p50 * 1e3}
    if cfg.golden:
        n_pass, n_total, failures = replay_golden(model, params, cfg.golden, atol=cfg.golden_atol)
        for f in failures[:20]:
            print(f"[verify] FAIL {f}")
        print(f"[verify] golden replay: {n_pass}/{n_total} records bit-exact "
              f"({'PASS' if n_pass == n_total else 'FAIL'})")
        if n_pass != n_total:
            raise SystemExit(1)
        return {"passed": n_pass, "total": n_total}

    q01, q99, smask = _action_stats(model, "bridge_orig" if "bridge_orig" in model.norm_stats else None)
    action_dim = len(q01)
    rng = np.random.default_rng(0)
    ids = np.full((1, model.prompt_bucket), model.cfg.llm.pad_token_id, np.int32)
    mask = np.zeros_like(ids)
    ids[0, 0], ids[0, 1:20] = 1, rng.integers(3, 31000, 19)
    ids[0, 20] = 29871
    mask[0, :21] = 1

    lat = []
    for i in range(cfg.calls):
        frame = rng.integers(0, 255, size=(1, 224, 224, 3), dtype=np.uint8)
        t0 = time.perf_counter()
        action = model.predict_from_frames_device(params, ids, mask, frame, q01, q99, smask, action_dim,
                                                  parallel_decode=cfg.parallel_decode).cpu().numpy()
        dt = time.perf_counter() - t0
        lat.append(dt)
        if i < 3 or i % 20 == 0:
            print(f"[call {i:03d}] {dt * 1e3:7.1f} ms  action={np.round(action[0], 4)}")
        if action.shape != (1, action_dim) or not np.isfinite(action).all():
            raise RuntimeError(f"call {i}: action of shape {action.shape}, finite {np.isfinite(action).all()}")
    lat = np.asarray(lat[3:] if len(lat) > 3 else lat)  # the first calls capture the graphs
    p50, p90 = float(np.percentile(lat, 50)), float(np.percentile(lat, 90))
    print(f"\n[verify] {cfg.calls} calls: p50={p50 * 1e3:.1f}ms p90={p90 * 1e3:.1f}ms -> {1.0 / p50:.2f} actions/s")
    return {"p50_ms": p50 * 1e3, "p90_ms": p90 * 1e3, "calls": cfg.calls}


if __name__ == "__main__":
    main(parse_cli(VerifyConfig))
