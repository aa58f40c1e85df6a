"""The span readers (`metrics/_spans.py` and the ten metrics on it) on a
synthetic run: spans planted in the program's ring before, inside and after
a fake trace's host window, the numbers each reader should give (from the
untraced stretch just before the window), and None where the program has no
spans or a stretch holds none."""

from __future__ import annotations

import collections
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

import tiny  # noqa: F401  (puts the benchmark and the checkout on sys.path)

import harness  # noqa: E402
from bridgelang_tpu_torch.util import profiling  # noqa: E402

METRICS = Path(__file__).resolve().parent.parent / "metrics"
if str(METRICS) not in sys.path:
    sys.path.insert(0, str(METRICS))

ACT = ("rest_host_ms.act", "queue_wait_ms.act", "predict_host_ms.act", "graph_launch_ms.act", "prefill_ms.act",
       "decode_ms_per_token.act")
LORA = ("dispatch_s_per_step.lora", "forward_ms.lora", "backward_ms.lora", "optimizer_ms.lora")
MS = 1_000_000  # ns


def reader(name: str):
    return harness.load_module(METRICS / f"{name}.py", "test_metric_" + name.replace(".", "_")).read


@pytest.fixture
def ring(monkeypatch):
    ring = collections.deque(maxlen=profiling.RING_SIZE)
    monkeypatch.setattr(profiling, "_ring", ring)
    return ring


def ctx(start_s: float = 1.0, stop_s: float = 2.0):
    return {"trace": SimpleNamespace(host_start=start_s, host_stop=stop_s)}


def plant_request(t0: int, rows: int = 1, device=None, wait_ms: float = 0.02, replay_ms: float = 20.0):
    """One served request from t0 (ns): parse 1 ms, wait, a pass (prepare
    0.5, copy_in 0.1, replay, wait 79, unpack 0.2), respond 2 ms."""
    req = profiling.Span(0, None, 1, "serve:request", 1, t0)
    req.id = next(profiling._span_ids)
    t = t0
    profiling.record("serve:parse", t, t + 1 * MS, parent=req.id)
    t += 1 * MS
    profiling.record("serve:wait", t, t + int(wait_ms * MS), parent=req.id)
    t += int(wait_ms * MS)
    pass_ = profiling.Span(next(profiling._span_ids), req.id, 1, "serve:pass", 1, t, 0,
                           dict(rows=rows, **(device or {})))
    for name, ms in (("predict:prepare", 0.5), ("graphs:copy_in", 0.1), ("graphs:replay", replay_ms), ("predict:wait", 79.0),
                     ("predict:unpack", 0.2)):
        profiling.record(name, t, t + int(ms * MS), parent=pass_.id)
        t += int(ms * MS)
    pass_.t1 = t
    profiling._ring.append(pass_)
    profiling.record("serve:respond", t, t + 2 * MS, parent=req.id)
    t += 2 * MS
    req.t1 = t
    profiling._ring.append(req)
    return t


def test_act_readers_read_the_window(ring):
    marks = {"vision_ms": 5.0, "prefill_ms": 30.0, "decode_ms": 120.0, "tokens": 7}
    slow = dict(marks, prefill_ms=45.0, decode_ms=180.0)  # the device waiting on a slowed launch
    plant_request(int(0.1e9), device=slow, replay_ms=80.0)  # before the stretch
    plant_request(int(0.3e9), device=marks)  # the untraced stretch: two requests
    plant_request(int(0.5e9), device=dict(marks, decode_ms=180.0), wait_ms=0.06)
    plant_request(int(0.8e9), device=slow, replay_ms=90.0, wait_ms=7.0)  # the last before the window: left out
    t = plant_request(int(1.1e9), device=slow, replay_ms=50.0, wait_ms=3.0)  # the window, under the profiler
    plant_request(t, device=slow, replay_ms=50.0, wait_ms=3.0)
    plant_request(int(2.5e9), device=slow, replay_ms=70.0)  # after it
    got = {name: reader(name)(ctx()) for name in ACT}
    assert got["rest_host_ms.act"] == pytest.approx(3.0)
    assert got["queue_wait_ms.act"] == pytest.approx(0.04)
    assert got["predict_host_ms.act"] == pytest.approx(0.8)
    assert got["graph_launch_ms.act"] == pytest.approx(20.0)
    assert got["prefill_ms.act"] == pytest.approx(30.0)
    assert got["decode_ms_per_token.act"] == pytest.approx(150.0 / 6)


def test_a_batched_pass_counts_per_request(ring):
    plant_request(int(0.3e9), rows=4, device={"prefill_ms": 40.0, "decode_ms": 60.0, "tokens": 7})
    plant_request(int(0.6e9), rows=4, replay_ms=90.0)  # the last before the window: left out
    plant_request(int(1.1e9), rows=4, device={"prefill_ms": 50.0, "decode_ms": 90.0, "tokens": 7}, replay_ms=50.0)
    assert reader("graph_launch_ms.act")(ctx()) == pytest.approx(5.0)
    assert reader("prefill_ms.act")(ctx()) == pytest.approx(10.0)
    assert reader("decode_ms_per_token.act")(ctx()) == pytest.approx(60.0 / 4 / 6)


def test_lora_readers_read_the_window(ring):
    # steps 1 and 2 are the untraced stretch (as many as the window's two, just before it)
    for k, t0 in enumerate((0.0, 0.2e9, 0.5e9, 1.1e9, 1.5e9, 2.4e9)):
        rec = profiling.record("train:step", t0, t0 + 100 * MS + k * 100 * MS)
        if k != 2:  # the marks of a step not yet resolved leave its device times out
            rec.attrs.update(forward_ms=200.0 + k, backward_ms=400.0 + 10 * (k > 2), optimizer_ms=50.0)
    got = {name: reader(name)(ctx(1.0, 2.0)) for name in LORA}
    assert got["dispatch_s_per_step.lora"] == pytest.approx((0.2 + 0.3) / 2)
    assert got["forward_ms.lora"] == pytest.approx(201.0)
    assert got["backward_ms.lora"] == pytest.approx(400.0)
    assert got["optimizer_ms.lora"] == pytest.approx(50.0)


def test_nothing_to_read_gives_none(ring, monkeypatch):
    plant_request(int(1.1e9))  # a CPU pass: no device times, and no untraced stretch before it
    for name in ACT + LORA:
        assert reader(name)(ctx()) is None, name
    plant_request(int(0.3e9))
    plant_request(int(0.6e9))
    assert reader("graph_launch_ms.act")(ctx()) == pytest.approx(20.0)
    assert reader("prefill_ms.act")(ctx()) is None  # CPU passes: no device times
    for name in ACT + LORA:
        assert reader(name)({}) is None, name
        assert reader(name)(ctx(3.0, 4.0)) is None, name
    monkeypatch.delattr(profiling, "spans")  # a program without the spans
    for name in ACT + LORA:
        assert reader(name)(ctx()) is None, name


def test_every_span_metric_is_in_the_benchmark():
    import json

    bench = json.loads((Path(__file__).resolve().parent.parent.parent / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in ACT + LORA:
        m = entries[name]
        assert m["source"] == "program_counter" and (METRICS / f"{name}.py").exists()
        assert m["workloads"] == (["mistral7b-int8-act-1robot"] if name in ACT else ["phi2-lora-b32"])
