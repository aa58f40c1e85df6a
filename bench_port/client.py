"""The robots: closed loops over HTTP, in a process of their own.

    python3 bench_port/client.py '<json spec>'

Each robot (a thread) sends POST /act with a fresh frame as base64 bytes
(the wire format of the port's `client_act`) and an instruction, both drawn
from (seed, robot, tick), waits for the action, and sends the next. Its
camera (another thread) encodes the next request while the robot waits, so
that a robot sends the moment its action arrives, as a controller whose
next frame is already captured does. First
`warm_requests` untimed requests per robot; then it prints "ready" and
waits for "go" on standard input; then it sends for `seconds` from "go",
and lets each robot's last request finish. It prints one JSON line: every
timed request with its robot, tick, instruction, send and answer times
(time.perf_counter), status and action.
"""

from __future__ import annotations

import base64
import http.client
import json
import queue
import sys
import threading
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import gen  # noqa: E402


def body(spec, robot: int, tick: int):
    frame = gen.act_frame(spec["seed"], robot, tick, spec["frame_hw"])
    instruction = gen.act_instruction(spec["seed"], robot, tick, spec["instructions"])
    payload = {"image": {"__b64__": base64.b64encode(frame.tobytes()).decode("ascii"), "shape": list(frame.shape),
                         "dtype": "uint8"},
               "instruction": instruction, "unnorm_key": spec.get("unnorm_key")}
    return json.dumps(payload), instruction


def act(spec, data: str):
    conn = http.client.HTTPConnection("127.0.0.1", spec["port"], timeout=spec["timeout_s"])
    try:
        conn.request("POST", "/act", body=data, headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        out = json.loads(resp.read())
        return resp.status == 200, out.get("action")
    except (OSError, ValueError, http.client.HTTPException) as e:
        return False, repr(e)
    finally:
        conn.close()


def camera(spec, r: int, prepared: queue.Queue) -> None:
    """Encodes robot r's requests in order, one ahead of the robot."""
    tick = 0
    while True:
        prepared.put(body(spec, r, tick))
        tick += 1


def robot(spec, r: int, go: threading.Event, ready: threading.Barrier, clock: dict, out: list) -> None:
    for w in range(spec["warm_requests"]):
        act(spec, body(spec, r, -1 - w)[0])
    prepared: queue.Queue = queue.Queue(maxsize=1)
    threading.Thread(target=camera, args=(spec, r, prepared), daemon=True).start()
    ready.wait()
    go.wait()
    tick = 0
    while True:
        data, instruction = prepared.get()
        t0 = time.perf_counter()
        if t0 >= clock["end"]:
            break
        ok, action = act(spec, data)
        t1 = time.perf_counter()
        out.append({"robot": r, "tick": tick, "instruction": instruction, "t0": t0, "t1": t1, "ok": ok,
                    "action": action})
        tick += 1


def main() -> int:
    spec = json.loads(sys.argv[1])
    n = spec["robots"]
    go, ready = threading.Event(), threading.Barrier(n + 1)
    clock: dict = {}
    results = [[] for _ in range(n)]
    threads = [threading.Thread(target=robot, args=(spec, r, go, ready, clock, results[r])) for r in range(n)]
    for t in threads:
        t.start()
    ready.wait()
    print("ready", flush=True)
    if sys.stdin.readline().strip() != "go":
        return 1
    clock["end"] = time.perf_counter() + spec["seconds"]
    go.set()
    for t in threads:
        t.join()
    print(json.dumps({"requests": [x for rs in results for x in rs]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
