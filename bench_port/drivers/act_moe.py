"""Driver "act_moe": the "act" driver's robots, window and check, for a VLA
on the DeepSeek-V2 decoder (latent attention, routed experts).

The same set-up, timed window, end-to-end numbers and per-layer facts as
drivers/act.py (its recorder, client and request matching are used as
they are), with the pieces that follow the decoder:

* weights: weights_moe.py's seeded draw, its decoder leaves checked
  against the port's own layout (`deepseek_v2.init_params`);
* the traced window's useful FLOPs (yardstick_moe.act_useful_flops: the
  routed top-k and the shared experts, never all of them), the (192, 128)
  flash forward's least time per launch (under its kernel's name,
  "flash_fwd_bf16_kernel<192"), and the grouped expert launches' summed
  least time (`moe_bound_s`, yardstick_moe.moe_pass_bound_s from each
  pass's prefill expert load, which the recorder reads from the model
  after the pass);
* the check: the reference is reference/mla_moe.py's, teacher-forced
  over the served ids as drivers/act.py does it; besides, each MoE layer's
  routed experts are run by the program (ops/moe.py's `moe_experts`, on
  the card its grouped kernels) on the reference's own input to that layer,
  in the prefill's and the decode steps' row counts, and held to the
  reference's (`moe_err_max`, below). At random weights the routed
  experts move the logits less than bf16 does elsewhere, so the logit
  gaps alone do not see a fault of theirs.

`ctx["reference_variant"]` (the limits' "control", never a timed run of
the benchmark) computes the reference one of mla_moe.VARIANTS in the
program's place: the readings that set the limits.
"""

from __future__ import annotations

import gc
import json
import sys
import time
from pathlib import Path
from typing import Any, Dict, List

import numpy as np

BENCH = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(Path(__file__).resolve().parent))
import act  # noqa: E402

FLASH_KERNEL = "flash_fwd_bf16_kernel<192"  # the (192, 128) instance's name in the device trace
# Router logits of the k-th and the next expert closer than this: either is a right pick, and the row is left
# out of moe_err_max (both sides route fp32 logits of the same bf16 row, apart only by the order of fp32 sums).
ROUTE_TIE = 1e-3


class MoeErr:
    """`moe_err_max`: the largest, over the MoE layers, of the relative error
    ||program - reference|| / ||reference|| of the routed experts' output
    over a layer's rows, both on the reference's input to the layer rounded
    to the served type. The program is ops/moe.py's `moe_experts` on the
    served leaves, handed the rows as a server hands them (`chunks`); the
    reference is mla_moe.moe in fp32. Under a control (`variant`) the
    variant's mla_moe.moe takes the program's place. Rows whose routing is a
    tie (ROUTE_TIE) are left out and counted (`moe_tie_share`)."""

    def __init__(self, llm: Dict, variant):
        self.llm, self.variant = llm, variant
        self.num: Dict[int, float] = {}
        self.den: Dict[int, float] = {}
        self.rows = self.ties = 0

    def __call__(self, layer: int, lp: Dict, f: Dict, x, chunks) -> None:
        import torch

        from bridgelang_tpu_torch.ops.moe import moe_experts
        from reference import mla_moe

        llm, k = self.llm, self.llm["num_experts_per_tok"]
        xb = x.to(lp["we_gate"].dtype)
        xf = xb.float()
        top = (xf @ f["router"].T).topk(k + 1, dim=-1).values
        keep = top[:, k - 1] - top[:, k] > ROUTE_TIE
        want = mla_moe.moe(xf, f, llm, None)
        if self.variant is None:
            got = torch.cat([moe_experts(xb[a:b], lp["router"], lp["we_gate"], lp["we_up"], lp["we_down"], k,
                                         llm["norm_topk_prob"], llm["routed_scaling_factor"]) for a, b in chunks])
        else:
            got = mla_moe.moe(xf, f, llm, self.variant)
        self.num[layer] = self.num.get(layer, 0.0) + float((got.float() - want)[keep].square().sum())
        self.den[layer] = self.den.get(layer, 0.0) + float(want[keep].square().sum())
        self.rows += x.shape[0]
        self.ties += int((~keep).sum())

    def readings(self) -> Dict[str, float]:
        if not self.num:
            return {"moe_err_max": float("inf")}
        err = max((self.num[i] / max(self.den[i], 1e-30)) ** 0.5 for i in self.num)
        return {"moe_err_max": err, "moe_tie_share": self.ties / max(self.rows, 1)}


def check_decoder_layout(model, params: Dict) -> None:
    """The decoder's leaves have exactly the names and shapes the port's
    own init draws (on the meta device)."""
    import torch

    from bridgelang_tpu_torch.models.llm.deepseek_v2 import init_params

    want = init_params(None, model.cfg.llm, torch.bfloat16, torch.device("meta"))

    def shapes(tree):
        top = {k: tuple(v.shape) for k, v in tree.items() if k != "layers"}
        return top, [{k: tuple(v.shape) for k, v in lp.items()} for lp in tree["layers"]]

    if shapes(want) != shapes(params["llm"]):
        raise ValueError("the benchmark's decoder leaves differ from the port's DeepSeek-V2 layout")


def run(ctx: Dict) -> Dict[str, Any]:
    import torch

    sys.path.insert(0, str(BENCH))
    import devtrace
    import portside
    import weights_moe
    import yardstick_moe

    from bridgelang_tpu_torch.deploy import quantize_for_serving
    from bridgelang_tpu_torch.serving.server import VLAServer
    from bridgelang_tpu_torch.util.compile_cache import warmup_predict

    from harness import Phases

    phase = Phases(ctx["t0"])
    phase("import")
    cfg, traffic, device = ctx["config"], ctx["traffic"], ctx["device"]
    serving = cfg["serving"]
    dtype = portside.DTYPES[serving["dtype"]]
    model = portside.build_model(cfg, dtype, device)
    model.cache_dtype = dtype  # the latent cache in the served type: bf16 on the card, as deploy serves it
    params = weights_moe.make_weights(cfg, ctx["seed"], dtype, device)
    portside.check_layout(model, params)
    check_decoder_layout(model, params)
    phase("model and weights")
    model, params = quantize_for_serving(model, params, serving["quantize_int8"], serving["quantize_int4"],
                                         serving.get("int4_group", 128))
    for hook in ctx.get("hooks", ()):  # tests: break the timed path underneath
        hook(model, params)
    server = VLAServer(model, params, max_batch=traffic["max_batch"], batch_window_ms=traffic["batch_window_ms"],
                       speculative_default=traffic["speculative_default"], device=device)
    warmup_predict(model, params, max_batch=traffic["max_batch"], speculative=False)
    phase("server and graph capture")
    recorder = act.Recorder(model)
    loads: Dict[float, np.ndarray] = {}  # each pass's prefill expert load, by the pass's end
    recorded = model._host_predict

    def with_load(*args, **kwargs):
        out = recorded(*args, **kwargs)
        with recorder.lock:
            loads[recorder.passes[-1].t_end] = np.array(model.last_expert_load)
        return out

    model._host_predict = with_load
    httpd = server.serve_background("127.0.0.1", 0)
    client = act.start_client(ctx, httpd.server_address[1])
    try:
        if client.stdout.readline().strip() != "ready":
            raise RuntimeError("the robot client did not get ready")
        phase("robot client and warm requests")
        recorder.clear()
        stats0 = server.stats()
        setup_s = time.perf_counter() - ctx["t0"]
        client.stdin.write("go\n")
        client.stdin.flush()
        t_go = time.perf_counter()
        tr = None
        if ctx["trace"]:
            tw = traffic["trace"]
            time.sleep(max(0.0, t_go + tw["start_s"] - time.perf_counter()))
            tr = devtrace.DeviceTrace()
            with recorder.gate:
                tr.start()
            time.sleep(tw["seconds"])
            with recorder.gate:
                tr.halt()
            tr.stop()
        out, _ = client.communicate(timeout=ctx["seconds"] + 4 * traffic.get("client_timeout_s", 120))
        if client.returncode != 0:
            raise RuntimeError(f"the robot client exited with {client.returncode}")
        reqs = json.loads(out.strip().splitlines()[-1])["requests"]
        stats1 = server.stats()
    finally:
        if client.poll() is None:
            client.kill()
            client.wait()
        httpd.shutdown()
        httpd.server_close()
        server.close()
    memory_peak = portside.memory_peak(device)
    passes = list(recorder.passes)
    platform, kind, count = portside.device_facts(device)

    ok = [r for r in reqs if r["ok"]]
    lat = np.asarray([1e3 * (r["t1"] - r["t0"]) for r in ok]) if ok else np.asarray([np.nan])
    t_start = min(r["t0"] for r in reqs)
    t_last = max(r["t1"] for r in reqs)
    end_to_end = {"act_p50_ms": float(np.percentile(lat, 50)), "act_p95_ms": float(np.percentile(lat, 95)),
                  "actions_per_s": len(ok) / (t_last - t_start), "setup_s": setup_s}

    layer: Dict[str, Any] = {"counters": {k: stats1[k] - stats0[k] for k in ("requests", "errors", "model_passes")}}
    if tr is not None:
        traced = [p for p in passes if tr.host_start <= p.t_end <= tr.host_stop]
        llm = cfg["port"]["llm"]
        patches = (cfg["port"]["towers"][0]["image_size"] // cfg["port"]["towers"][0]["patch_size"]) ** 2
        dqk = llm["qk_nope_head_dim"] + llm["qk_rope_head_dim"]
        flops, bounds, moe_bound, actions = 0.0, [], 0.0, 0
        for p in traced:
            n = act.real_rows(p.images)
            lens = [k + patches for k in p.prompt_lens]  # fused rows: the patches follow BOS
            t_len = p.width + patches
            bounds.append(yardstick_moe.mla_flash_bound_s(len(p.images), t_len, t_len, llm["n_heads"], dqk,
                                                          llm["v_head_dim"], lens))
            flops += sum(yardstick_moe.act_useful_flops(cfg, lens[j], p.tokens.shape[1]) for j in range(n))
            moe_bound += yardstick_moe.moe_pass_bound_s(llm, loads[p.t_end], p.tokens.shape[1], len(p.images)) or 0.0
            actions += n
        layer.update(trace=tr, traced={"actions": actions, "passes": len(traced), "useful_flops": flops,
                                       "flash_bound_per_launch_s": {FLASH_KERNEL: float(np.mean(bounds)) if bounds
                                                                    else None},
                                       "moe_bound_s": moe_bound})
    del server, model, params, recorder
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    phase("window")
    checks, readings, correct = check(ctx, reqs, passes)
    phase("reference check")
    failed = len(reqs) - len(ok)
    return {"end_to_end": end_to_end, "layer": layer, "correct": correct and failed == 0, "checks": checks,
            "readings": readings, "attempted": len(reqs), "failed": failed, "memory_peak_bytes": memory_peak,
            "platform": platform, "kind": kind, "count": count}


def check(ctx: Dict, reqs: List[Dict], passes: List) -> tuple:
    """drivers/act.py's check with reference/mla_moe.py's decoder: each
    served action equals the de-tokenization of the served ids, the
    teacher-forced reference gives the gaps by which a served id lies below
    its best (the widest and the mean), and the routed experts are held to
    the reference's layer by layer (MoeErr)."""
    import torch

    import gen
    import portside
    import weights_moe
    from harness import judge
    from reference import mla_moe
    from reference import model as ref
    from reference.tokens import ids_to_actions

    cfg, traffic, seed, device = ctx["config"], ctx["traffic"], ctx["seed"], ctx["device"]
    limits = ctx["limits"]
    served = {}
    for p in passes:
        for j in range(act.real_rows(p.images)):
            served[act.frame_key(p.images[j])] = (p.instructions[j], p.tokens[j], p.actions[j])
    ok = [r for r in reqs if r["ok"]]
    longest = max(range(len(ok)), key=lambda i: (len(ok[i]["instruction"]), -i)) if ok else None
    picked = [ok[i] for i in gen.sample(seed, len(ok), limits["check_requests"], [longest] if ok else [])]
    frames, instructions, tokens, missing, action_err = [], [], [], 0, 0.0
    stats = next(iter(cfg["norm_stats"].values()))["action"]
    vocab = cfg["port"]["llm"]["vocab_size"]
    for r in picked:
        frame = gen.act_frame(seed, r["robot"], r["tick"], traffic["frame_hw"])
        hit = served.get(act.frame_key(frame))
        if hit is None or hit[0] != r["instruction"]:
            missing += 1
            continue
        want = ids_to_actions(hit[1], vocab, stats)
        action_err = max(action_err, float(np.max(np.abs(np.asarray(r["action"], np.float32) - want))))
        frames.append(frame)
        instructions.append(r["instruction"])
        tokens.append(hit[1])
    gaps = []
    moe_err = MoeErr(cfg["port"]["llm"], ctx.get("reference_variant"))
    if frames:
        ref.no_tf32()
        with torch.no_grad():
            params = weights_moe.make_weights(cfg, seed, portside.DTYPES[cfg["serving"]["dtype"]], device)
            block = traffic.get("check_block", 16)
            for a in range(0, len(frames), block):
                f = torch.as_tensor(np.stack(frames[a:a + block]), device=device)
                logits = mla_moe.served_logits(params, cfg, f, instructions[a:a + block],
                                               np.stack(tokens[a:a + block]), ctx.get("reference_variant"),
                                               moe_err)
                chosen = [torch.as_tensor(np.asarray(tok, np.int64), device=device) for tok in tokens[a:a + block]]
                for lg, t in zip(logits, chosen):
                    gaps += (lg.max(dim=-1).values - lg.gather(1, t[:, None])[:, 0]).tolist()
            del params
    readings = {"logit_gap_max": max(gaps) if gaps else float("inf"),
                "logit_gap_mean": float(np.mean(gaps)) if gaps else float("inf"), **moe_err.readings()}
    checks = {
        "requests_checked": judge(len(frames), limits["check_requests"], ok_if="ge"),
        "unmatched": judge(missing, 0),
        "action_abs_err": judge(action_err, limits["action_abs_err"]),
        **{k: judge(v, limits[k]) for k, v in readings.items() if k in limits},
    }
    return checks, readings, all(c["ok"] for c in checks.values())
