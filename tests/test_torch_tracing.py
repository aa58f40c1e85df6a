"""The port's tracing (bridgelang_tpu_torch/util/profiling.py) and the spans
the server, the predict and the train step record.

CPU tests on the deploy smoke model (2-layer 128-wide Llama, 64 px tower):
the span module (nesting, request ids across threads, the ring's bound, a
profiler range only while a profiler records, Chrome-trace dumps),
one /act whose children tile its `serve:request`, a batched pass of four
concurrent requests, and the phases of one train step. The `gpu` test checks
on a card that the device marks captured into the predict graph time two
successive replays. The file imports no JAX, so it also runs on a GPU
machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_tracing.py -q
"""

import collections
import json
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from bridgelang_tpu_torch import deploy
from bridgelang_tpu_torch.serving.server import VLAServer, client_act
from bridgelang_tpu_torch.util import profiling

INSTRUCTION = "pick up the red block"


def _frame(seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, size=(64, 64, 3), dtype=np.uint8)


def _kids(records):
    kids = collections.defaultdict(list)
    for r in records:
        kids[r.parent].append(r)
    return kids


@pytest.fixture(scope="module")
def smoke():
    return deploy.build_smoke_model(torch.device("cpu"))


def test_spans_nest_with_parent_and_request_ids():
    with profiling.span("outer", rid=profiling.new_request_id(), rows=2) as outer:
        with profiling.span("inner") as inner:
            profiling.note(extra=1)
            assert profiling.current() is inner
        with profiling.span("second") as second:
            pass
    assert profiling.current() is None
    assert inner.parent == outer.id and second.parent == outer.id and outer.parent is None
    assert inner.rid == second.rid == outer.rid is not None
    assert inner.attrs == {"extra": 1} and outer.attrs == {"rows": 2}
    assert outer.t0 <= inner.t0 <= inner.t1 <= second.t0 <= second.t1 <= outer.t1
    ended = profiling.spans(outer.t0, outer.t1)
    assert [r.name for r in ended][-3:] == ["inner", "second", "outer"]
    assert profiling.spans(outer.t0, outer.t1, name="inner") == [inner]


def test_request_ids_stay_on_their_threads():
    seen = {}
    barrier = threading.Barrier(4)

    def work(k: int) -> None:
        with profiling.span("req", rid=profiling.new_request_id()) as req:
            barrier.wait()
            with profiling.span("child") as child:
                pass
        seen[k] = (req, child)

    threads = [threading.Thread(target=work, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len({req.rid for req, _ in seen.values()}) == 4
    for req, child in seen.values():
        assert child.rid == req.rid and child.parent == req.id and child.thread == req.thread
    late = profiling.record("wait", 5, 9, rid=seen[0][0].rid, parent=seen[0][0].id, thread=seen[0][0].thread)
    assert (late.ms, late.rid, late.parent) == (4e-6, seen[0][0].rid, seen[0][0].id)


def test_the_ring_is_bounded(monkeypatch):
    ring = collections.deque(maxlen=profiling.RING_SIZE)
    monkeypatch.setattr(profiling, "_ring", ring)
    first = profiling.record("first", 0, 1)
    for _ in range(profiling.RING_SIZE):
        with profiling.span("fill"):
            pass
    assert len(ring) == profiling.RING_SIZE == 65_536
    assert first not in ring and all(r.name == "fill" for r in profiling.spans())


def test_a_span_is_a_profiler_range_only_while_one_records(monkeypatch):
    made = []
    real = torch._C._profiler._RecordFunctionFast

    def counting(name):
        made.append(name)
        return real(name)

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", counting)
    with profiling.span("serve:untraced"):
        pass
    assert made == []
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("serve:traced"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    assert made == ["serve:traced"]
    # a host op, not a user annotation (which the profiler also lays on the device's timeline)
    (event,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "serve:traced"]
    assert not event.is_user_annotation()
    assert profiling.spans(name="serve:traced") and profiling.spans(name="serve:untraced")


def test_dump_and_stage_summary(tmp_path, monkeypatch):
    with profiling.span("dumped", rid=7, rows=3) as rec:
        pass
    trace = json.loads(open(profiling.dump(str(tmp_path / "spans.json"))).read())
    mine = [e for e in trace["traceEvents"] if e["args"]["id"] == rec.id]
    assert len(mine) == 1 and mine[0]["name"] == "dumped" and mine[0]["ph"] == "X"
    assert mine[0]["args"]["rid"] == 7 and mine[0]["args"]["rows"] == 3 and mine[0]["dur"] >= 0
    monkeypatch.setattr(profiling, "_recent", {})
    monkeypatch.setattr(profiling, "_ended", {})
    monkeypatch.setattr(profiling, "SUMMARY_SPANS", 50)
    for ms in range(1, 101):
        profiling.record("s", 0, ms * 1_000_000)
    assert profiling.stage_summary() == {"s": {"count": 100, "p50_ms": 75.5, "p99_ms": 99.51}}


def test_spans_and_counters_lose_nothing_across_threads(monkeypatch):
    monkeypatch.setattr(profiling, "_ring", collections.deque(maxlen=profiling.RING_SIZE))
    before = profiling.counters("stress:").get("stress:n", 0)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work() -> None:
            for _ in range(500):
                with profiling.span("stress:outer", rid=profiling.new_request_id()):
                    with profiling.span("stress:inner"):
                        profiling.count("stress:n")

        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    assert profiling.counters("stress:")["stress:n"] - before == 16 * 500
    records = profiling.spans()
    outer = {r.id: r for r in records if r.name == "stress:outer"}
    inner = [r for r in records if r.name == "stress:inner"]
    assert len(outer) == len(inner) == 16 * 500 and len({r.rid for r in outer.values()}) == 16 * 500
    assert all(outer[r.parent].rid == r.rid and outer[r.parent].thread == r.thread for r in inner)


def test_one_act_request_is_tiled_by_its_spans(smoke):
    model, params = smoke
    server = VLAServer(model, params, speculative_default=False, device="cpu")
    httpd = server.serve_background(port=0)
    t0 = time.perf_counter_ns()
    try:
        client_act("127.0.0.1", httpd.server_address[1], _frame(1), INSTRUCTION)
        stats = server.stats()
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.close()
    records = profiling.spans()
    req = profiling.spans(t0, name="serve:request")
    assert len(req) == 1
    req = req[0]
    kids = _kids(records)
    names = [k.name for k in kids[req.id]]
    assert names == ["serve:parse", "serve:wait", "serve:pass", "serve:respond"]
    covered = sum(k.t1 - k.t0 for k in kids[req.id])
    assert 0.9 * (req.t1 - req.t0) <= covered <= req.t1 - req.t0
    (pass_,) = [k for k in kids[req.id] if k.name == "serve:pass"]
    assert [k.name for k in kids[pass_.id]] == ["predict:prepare", "predict:eager", "predict:wait", "predict:unpack"]
    assert pass_.attrs == {"rows": 1}  # no device marks on the CPU
    assert {r.rid for r in records if r.rid == req.rid} == {req.rid}
    assert all(k.rid == req.rid for k in kids[req.id] + kids[pass_.id])
    assert stats["latency_ms"]["window"] == 1 and stats["latency_ms"]["last"] == round(req.ms, 1)
    assert stats["passes_by_rows"] == {"1": 1} and stats["windows"] == {"full": 0, "deadline": 0, "close": 0}
    assert stats["graph_captures"] == 0 and set(stats["memory"]) == set(profiling.device_memory_stats())
    assert {"serve:request", "serve:parse", "serve:wait", "serve:pass", "serve:respond", "predict:prepare",
            "predict:wait", "predict:unpack"} <= set(stats["stages_ms"])


def test_a_batched_pass_carries_its_requests(smoke):
    model, params = smoke
    server = VLAServer(model, params, max_batch=4, batch_window_ms=5000.0, device="cpu")
    httpd = server.serve_background(port=0)
    t0 = time.perf_counter_ns()
    try:
        port = httpd.server_address[1]
        with ThreadPoolExecutor(4) as ex:
            futures = [ex.submit(client_act, "127.0.0.1", port, _frame(10 + k), INSTRUCTION) for k in range(4)]
            actions = [f.result(timeout=120) for f in futures]
        stats = server.stats()
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.close()
    assert all(np.asarray(a).shape == (7,) for a in actions)
    records = profiling.spans()
    reqs = profiling.spans(t0, name="serve:request")
    assert len(reqs) == 4 and len({r.rid for r in reqs}) == 4
    rids = {r.rid for r in reqs}
    passes = [r for r in records if r.name == "serve:pass" and set(r.attrs.get("request_ids", ())) & rids]
    assert len(passes) == 1
    assert passes[0].attrs["rows"] == 4 and sorted(passes[0].attrs["request_ids"]) == sorted(r.rid for r in reqs)
    kids = _kids(records)
    for r in reqs:
        (wait,) = [k for k in kids[r.id] if k.name == "serve:wait"]
        assert wait.rid == r.rid and wait.thread == r.thread and wait.t1 <= passes[0].t0
    assert stats["passes_by_rows"] == {"4": 1} and stats["model_passes"] == 1
    assert stats["windows"] == {"full": 1, "deadline": 0, "close": 0}
    assert stats["stages_ms"]["serve:pass"]["count"] >= 1
    assert stats["latency_ms"]["window"] == 4 and stats["latency_ms"]["p99"] <= round(max(r.ms for r in reqs), 1)


def test_a_window_closed_by_close_is_counted(smoke):
    model, params = smoke
    server = VLAServer(model, params, max_batch=4, batch_window_ms=60_000.0, device="cpu")
    with ThreadPoolExecutor(1) as ex:
        future = ex.submit(server.predict, {"image": _frame(20).tolist(), "instruction": INSTRUCTION})
        while not server._queue.unfinished_tasks:  # the request is queued: close() ends its window
            time.sleep(0.01)
        server.close()
        assert np.asarray(future.result(timeout=60)["action"]).shape == (7,)
    stats = server.stats()
    assert stats["windows"] == {"full": 0, "deadline": 0, "close": 1} and stats["passes_by_rows"] == {"1": 1}


def test_train_step_phases(smoke):
    from bridgelang_tpu_torch.training.lora import add_lora_params, lora_trainable_mask
    from bridgelang_tpu_torch.training.trainer import (OptimConfig, init_train_state, make_optimizer,
                                                         make_vla_train_step)

    model, base = smoke
    g = torch.Generator().manual_seed(3)
    params = dict(base, llm=add_lora_params(g, base["llm"], rank=4, alpha=4.0))
    mask = lora_trainable_mask(params)
    ocfg = OptimConfig(learning_rate=1e-3, lr_scheduler_type="constant")
    optimizer = make_optimizer(ocfg, params, trainable_mask=mask)
    step = make_vla_train_step(model, optimizer, trainable_mask=mask, compute_dtype=torch.float32,
                               image_transform=model.image_transform)
    state = init_train_state(params, optimizer, trainable_mask=mask)
    ids = torch.randint(3, 1000, (2, 24), generator=g)
    ids[:, 0] = 1
    labels = ids.clone()
    labels[:, :16] = -100
    batch = {"input_ids": ids, "attention_mask": torch.ones_like(ids), "labels": labels,
             "frames": torch.randint(0, 256, (2, 64, 64, 3), dtype=torch.uint8, generator=g)}
    state, metrics = step(state, batch)
    assert torch.isfinite(metrics["loss"])
    (rec,) = profiling.spans(name="train:step")[-1:]
    kids = [k for k in profiling.spans(rec.t0, rec.t1) if k.parent == rec.id]
    assert [k.name for k in kids] == ["train:forward", "train:backward", "train:optimizer"]
    assert sum(k.t1 - k.t0 for k in kids) <= rec.t1 - rec.t0 and kids[0].t0 >= rec.t0
    assert rec.attrs == {}  # device times come from a card's marks only


@pytest.mark.gpu
def test_captured_marks_time_each_replay(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the marks are CUDA events inside the predict graph")
    import dataclasses

    from bridgelang_tpu_torch.models.vla import PREDICT_TIMES

    # heads of 64: the flash kernels' smallest head dim
    smoke_llm = deploy.smoke_llm_config()
    monkeypatch.setattr(deploy, "smoke_llm_config", lambda: dataclasses.replace(smoke_llm, n_heads=2, n_kv_heads=2))
    model, params = deploy.build_smoke_model(torch.device("cuda"))
    times = []
    for seed in (1, 2):
        with profiling.span("probe:pass") as rec:
            model.predict_action_batch(params, [_frame(seed)], [INSTRUCTION])
        times.append(rec.attrs)
    (entry,) = model.graphs.entries.values()
    assert entry.marks is not None and model.last_marks is entry.marks
    assert times[0] != times[1]  # each replay records its marks anew
    for attrs in times:
        assert set(PREDICT_TIMES) <= set(attrs) and attrs["tokens"] == 7
        assert 0 < attrs["vision_ms"] < attrs["prefill_ms"] and attrs["decode_ms"] > 0
    # the eager path marks the same points with plain events
    model.use_graphs = False
    with profiling.span("probe:eager") as rec:
        model.predict_action_batch(params, [_frame(3)], [INSTRUCTION])
    assert 0 < rec.attrs["vision_ms"] < rec.attrs["prefill_ms"] and rec.attrs["decode_ms"] > 0
