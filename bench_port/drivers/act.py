"""Driver "act": robots in closed loops over HTTP to the port's VLAServer.

Set-up: the configuration's model (the port's OpenVLA) and the benchmark's
seeded weights, quantized as `deploy` serves them (`quantize_for_serving`),
a `VLAServer` with the mix's `max_batch`, `batch_window_ms` and speculative
default, the predict graphs of every batch bucket captured by the port's
`warmup_predict`, the server on a free localhost port, and the robot client
(`client.py`, its own process) with one warm request per robot.

Window: the robots send for `seconds`, each waiting for its action before
its next frame. A recorder wraps the model's `_host_predict` and `_predict`
(outside the port) and keeps each pass's frames, instructions and served
ids (the greedy wire format carries only the action, and the check needs
the ids), and the padded prompt width and real prompt lengths handed to the
device, from which the traced window's FLOPs and flash bounds are counted.

End-to-end (client clock): `act_p50_ms` / `act_p95_ms` over every request
sent in the window, `actions_per_s` = the requests sent in the window over
the time from the window's start to the last answer. Per-layer facts for
the metric readers: the server's counters across the window, and, with
--trace, the traced window's actions, useful FLOPs and flash bounds.

Check (after the window, the program's state freed): a sample drawn from
the seed of the requests served, the longest prompt among them; each served
action equals the reference's de-tokenization of the served ids, and the
reference's teacher-forced logits give the widest gap by which a served id
lies below the reference's best.
"""

from __future__ import annotations

import gc
import hashlib
import json
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, NamedTuple

import numpy as np

BENCH = Path(__file__).resolve().parent.parent


class Pass(NamedTuple):
    t_end: float
    images: List[Any]
    instructions: List[str]
    tokens: np.ndarray  # served ids [B, n]
    actions: np.ndarray
    width: int  # the padded prompt width handed to the device
    prompt_lens: List[int]  # each row's real prompt ids, from the mask handed to the device


class Recorder:
    """Keeps every pass of the model's host predict (`Pass`). A pass runs
    under `gate`, so whoever holds it knows that no thread runs the model."""

    def __init__(self, model):
        import torch

        self.passes: List[Pass] = []
        self.lock = threading.Lock()
        self.gate = threading.Lock()
        handed = threading.local()
        inner, inner_predict = model._host_predict, model._predict

        def predict(mode, params, inputs, n_tokens):
            handed.shape = (int(np.shape(inputs["ids"])[1]), np.asarray(inputs["mask"]).sum(axis=1).tolist())
            return inner_predict(mode, params, inputs, n_tokens)

        def recorded(mode, params, images, instructions, unnorm_key, *args, **kwargs):
            with self.gate, torch.profiler.record_function("bench:predict"):
                out = inner(mode, params, images, instructions, unnorm_key, *args, **kwargs)
            with self.lock:
                self.passes.append(Pass(time.perf_counter(), list(images), list(instructions), np.array(out[1]),
                                        np.array(out[0]), *handed.shape))
            return out

        model._predict = predict
        model._host_predict = recorded

    def clear(self) -> None:
        with self.lock:
            self.passes.clear()


def real_rows(images: List[Any]) -> int:
    """Rows of a pass that carry a request: the server pads a group with the
    first request's frame object itself."""
    for j in range(1, len(images)):
        if images[j] is images[0]:
            return j
    return len(images)


def frame_key(frame: np.ndarray) -> bytes:
    return hashlib.blake2b(np.ascontiguousarray(frame).tobytes(), digest_size=16).digest()


def start_client(ctx: Dict, port: int) -> subprocess.Popen:
    t = ctx["traffic"]
    spec = {"port": port, "seed": ctx["seed"], "robots": t["robots"], "seconds": ctx["seconds"],
            "frame_hw": t["frame_hw"], "instructions": t["instructions"], "unnorm_key": t.get("unnorm_key"),
            "warm_requests": t.get("warm_requests", 1), "timeout_s": t.get("client_timeout_s", 120)}
    return subprocess.Popen([sys.executable, str(BENCH / "client.py"), json.dumps(spec)], stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE, text=True)


def run(ctx: Dict) -> Dict[str, Any]:
    import torch

    sys.path.insert(0, str(BENCH))
    import devtrace
    import portside
    import weights
    import yardstick

    from bridgelang_tpu_torch.deploy import quantize_for_serving
    from bridgelang_tpu_torch.serving.server import VLAServer
    from bridgelang_tpu_torch.util.compile_cache import warmup_predict

    from harness import Phases

    phase = Phases(ctx["t0"])
    phase("import")
    cfg, traffic, seed, device = ctx["config"], ctx["traffic"], ctx["seed"], ctx["device"]
    serving = dict(cfg["serving"], **ctx.get("serving_override", {}))
    dtype = portside.DTYPES[serving["dtype"]]
    model = portside.build_model(cfg, dtype, device)
    params = weights.make_weights(cfg, seed, dtype, device)
    portside.check_layout(model, params)
    phase("model and weights")
    model, params = quantize_for_serving(model, params, serving["quantize_int8"], serving["quantize_int4"],
                                         serving.get("int4_group", 128))
    phase("quantization")
    for hook in ctx.get("hooks", ()):  # tests: break the timed path underneath
        hook(model, params)
    server = VLAServer(model, params, max_batch=traffic["max_batch"], batch_window_ms=traffic["batch_window_ms"],
                       speculative_default=traffic["speculative_default"], device=device)
    warmup_predict(model, params, max_batch=traffic["max_batch"], speculative=False)
    phase("server and graph capture")
    recorder = Recorder(model)
    httpd = server.serve_background("127.0.0.1", 0)
    client = start_client(ctx, httpd.server_address[1])
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
            # the profiler of every thread starts and stops between passes:
            # a pass of another thread running into its start or stop hung the run
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

    rows = [real_rows(p.images) for p in passes]
    print(f"bench_port: requests per pass {dict(sorted(zip(*np.unique(rows, return_counts=True))))}".replace("np.int64", ""),
          file=sys.stderr)
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
        hd = llm["dim"] // llm["n_heads"]
        flops, bounds, actions = 0.0, [], 0
        for p in traced:
            n = real_rows(p.images)
            lens = [k + patches for k in p.prompt_lens]  # fused rows: the patches follow BOS
            t_len = p.width + patches
            bounds.append(yardstick.flash_fwd_bound_s(len(p.images), t_len, t_len, llm["n_heads"], llm["n_kv_heads"],
                                                      hd, lens, llm.get("sliding_window")))
            flops += sum(yardstick.act_useful_flops(cfg, lens[j], p.tokens.shape[1]) for j in range(n))
            actions += n
        layer.update(trace=tr, traced={"actions": actions, "passes": len(traced), "useful_flops": flops,
                                       "flash_bound_per_launch_s": {"flash_fwd": float(np.mean(bounds)) if bounds else None}})
    del server, model, params, recorder
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    phase("window")
    checks, readings, correct = check(ctx, reqs, passes)
    phase("reference check")
    failed = len(reqs) - len(ok)
    return {"end_to_end": end_to_end, "layer": layer, "correct": correct and failed == 0, "checks": checks,
            "readings": readings,
            "attempted": len(reqs), "failed": failed, "memory_peak_bytes": memory_peak, "platform": platform,
            "kind": kind, "count": count}


def check(ctx: Dict, reqs: List[Dict], passes: List[Pass]) -> tuple:
    """The sample's reference check -> (checks, readings, correct): the
    readings are every gap number; those with a limit are checked."""
    import torch

    import gen
    import portside
    import weights
    from harness import judge
    from reference import model as ref
    from reference.tokens import ids_to_actions

    cfg, traffic, seed, device = ctx["config"], ctx["traffic"], ctx["seed"], ctx["device"]
    limits = ctx["limits"]
    served = {}
    for p in passes:
        for j in range(real_rows(p.images)):
            served[frame_key(p.images[j])] = (p.instructions[j], p.tokens[j], p.actions[j])
    ok = [r for r in reqs if r["ok"]]
    longest = max(range(len(ok)), key=lambda i: (len(ok[i]["instruction"]), -i)) if ok else None
    picked = [ok[i] for i in gen.sample(seed, len(ok), limits["check_requests"], [longest] if ok else [])]
    frames, instructions, tokens, missing, action_err = [], [], [], 0, 0.0
    stats = next(iter(cfg["norm_stats"].values()))["action"]
    vocab = cfg["port"]["llm"]["vocab_size"]
    for r in picked:
        frame = gen.act_frame(seed, r["robot"], r["tick"], traffic["frame_hw"])
        hit = served.get(frame_key(frame))
        if hit is None or hit[0] != r["instruction"]:
            missing += 1
            continue
        want = ids_to_actions(hit[1], vocab, stats)
        action_err = max(action_err, float(np.max(np.abs(np.asarray(r["action"], np.float32) - want))))
        frames.append(frame)
        instructions.append(r["instruction"])
        tokens.append(hit[1])
    gaps = []
    if frames:
        ref.no_tf32()
        quant = "int8" if cfg["serving"]["quantize_int8"] else None
        with torch.no_grad():
            params = weights.make_weights(cfg, seed, portside.DTYPES[cfg["serving"]["dtype"]], device)
            block = traffic.get("check_block", 16)
            for a in range(0, len(frames), block):
                f = torch.as_tensor(np.stack(frames[a:a + block]), device=device)
                logits = ref.served_logits(params, cfg, f, instructions[a:a + block], np.stack(tokens[a:a + block]),
                                           quant)
                chosen = [torch.as_tensor(np.asarray(tok, np.int64), device=device) for tok in tokens[a:a + block]]
                for lg, t in zip(logits, chosen):
                    gaps += (lg.max(dim=-1).values - lg.gather(1, t[:, None])[:, 0]).tolist()
            del params
    readings = {"logit_gap_max": max(gaps) if gaps else float("inf"),
                "logit_gap_mean": float(np.mean(gaps)) if gaps else float("inf")}
    checks = {
        "requests_checked": judge(len(frames), limits["check_requests"], ok_if="ge"),
        "unmatched": judge(missing, 0),
        "action_abs_err": judge(action_err, limits["action_abs_err"]),
        **{k: judge(v, limits[k]) for k, v in readings.items() if k in limits},
    }
    return checks, readings, all(c["ok"] for c in checks.values())
