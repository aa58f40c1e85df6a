"""The port's `demo` and `generate` entry points against scripts/demo.py and
scripts/generate.py, and util/profiling, on the CPU.

A tiny OpenVLA (dual 32-px towers, 2-layer Llama with the real vocabulary,
its LM head's action columns scaled) is exported by the JAX package
(tests/test_torch_load.py's `ckpts`) and loaded by each package's script
from that directory, with the same image file: the port reads it with
`open_rgb`, the JAX scripts with PIL (bit-equal). Both run bf16, as the
scripts do. The image is a 32x32 JPEG, the towers' size: at 640x480 the two
packages' resize-naive differs by ~2e-6 (float rounding), which flips bf16
roundings of ~0.1 % of the pixels, and a random tiny bf16 model's greedy
ids follow such flips.
* demo: the action line the JAX demo prints equal to the port's (5
  decimals), the returned action within 1e-5 of it (the rounding), with
  int8 off and on.
* generate: two turns fed on standard input; each reply's token ids equal
  the JAX script's (recorded from its model's generate_greedy), and the
  printed conversation equal.
* util/profiling: a trace file with the annotated range, StepTimer, and {}
  for device memory without a card.
"""

import io
import json
import re
import sys

import numpy as np
import pytest
import torch

import bridgelang_tpu.models.load as jload
import bridgelang_tpu.models.vlm as jvlm
import bridgelang_tpu_torch.models.vlm as tvlm
from bridgelang_tpu.ops import image_ops as jimg
from bridgelang_tpu_torch import demo, generate
from bridgelang_tpu_torch.ops import image_ops as timg
from bridgelang_tpu_torch.util import profiling
from tests.test_torch_load import TOWERS, ckpts, registries  # noqa: F401 (fixtures)
from tests.test_torch_pretraining_data import _load_script

TURNS = "What is on the table?\nAnd to its left?\n"


@pytest.fixture
def image(tmp_path):
    from PIL import Image

    path = tmp_path / "frame.jpg"
    Image.fromarray(np.random.default_rng(3).integers(0, 256, (32, 32, 3), dtype=np.uint8)).save(path, quality=90)
    return str(path)


@pytest.fixture
def tiny_transforms(monkeypatch):
    for vlm, img in ((jvlm, jimg), (tvlm, timg)):
        cfg = img.ImageTransformConfig("resize-naive", tuple(img.ImageTowerSpec(*t) for t in TOWERS["fused"]))
        monkeypatch.setattr(vlm, "transform_config_for_backbone", lambda *a, _cfg=cfg: _cfg)


def _action_line(text):
    return next(line for line in text.splitlines() if line.startswith("action="))


@pytest.mark.parametrize("int8", [False, True])
def test_demo_prints_the_jax_action(ckpts, registries, tiny_transforms, image, capsys, tmp_path, int8):  # noqa: F811
    path = str(ckpts["fused"][2])
    jdemo = _load_script("demo")
    jdemo.main(jdemo.DemoConfig(checkpoint=path, image=image, instruction="pick up the red block",
                                quantize_int8=int8))
    want = capsys.readouterr().out
    log = tmp_path / "log.txt"
    action = demo.main(demo.DemoConfig(checkpoint=path, image=image, instruction="pick up the red block",
                                       quantize_int8=int8, log_file=str(log), device="cpu"))
    got = capsys.readouterr().out
    assert _action_line(got) == _action_line(want)
    np.testing.assert_allclose(action, json.loads(_action_line(want)[len("action="):]), atol=1e-5)
    assert action.shape == (7,) and np.isfinite(action).all()
    assert _action_line(log.read_text()) == _action_line(got)


def test_generate_replies_equal_jax(ckpts, registries, tiny_transforms, image, capsys, monkeypatch):  # noqa: F811
    path = str(ckpts["fused"][2])
    j_ids = []
    j_load = jload.load_vla

    def recording_load(*a, **kw):
        model, params = j_load(*a, **kw)
        greedy = model.generate_greedy

        def record(*ga, **gkw):
            out = greedy(*ga, **gkw)
            j_ids.append(np.asarray(out)[0].tolist())
            return out

        model.generate_greedy = record
        return model, params

    monkeypatch.setattr(jload, "load_vla", recording_load)
    jgen = _load_script("generate")
    monkeypatch.setattr(sys, "stdin", io.StringIO(TURNS))
    jgen.main(jgen.GenerateConfig(checkpoint=path, image=image, max_new_tokens=16))
    want = capsys.readouterr().out

    monkeypatch.setattr(sys, "stdin", io.StringIO(TURNS))
    replies = generate.main(generate.GenerateConfig(checkpoint=path, image=image, max_new_tokens=16,
                                                    device="cpu"))
    got = capsys.readouterr().out
    assert len(replies) == len(j_ids) == 2
    eos = 2
    for r, j in zip(replies, j_ids):
        assert r == (j[: j.index(eos)] if eos in j else j)
    assert len(replies[0]) == 16 and replies[0] != replies[1]
    assert got == want


def test_generate_and_demo_default_to_cuda(ckpts, registries, image):  # noqa: F811
    path = str(ckpts["fused"][2])
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is CUDA")
    for main, cfg in ((demo.main, demo.DemoConfig(checkpoint=path, image=image)),
                      (generate.main, generate.GenerateConfig(checkpoint=path, image=image))):
        with pytest.raises(RuntimeError, match="CUDA|cuda"):
            main(cfg)


def test_profiling_on_the_cpu(tmp_path):
    timer = profiling.StepTimer()
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("tiny_matmul"):
            x = torch.ones(64, 64) @ torch.ones(64, 64)
    dt = timer.tick(sync_on=x)
    assert dt > 0 and timer.avg == dt
    assert timer.tick() > 0 and 0 < timer.avg
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert any(e.get("name") == "tiny_matmul" for e in trace["traceEvents"])
    assert profiling.device_memory_stats() == {}


def test_entry_point_configs_take_every_jax_field():
    import dataclasses

    for name, mod, cls in (("demo", demo, "DemoConfig"), ("generate", generate, "GenerateConfig")):
        jfields = {f.name: f.default for f in dataclasses.fields(getattr(_load_script(name), cls))}
        tfields = {f.name: f.default for f in dataclasses.fields(getattr(mod, cls))}
        assert tfields == dict(jfields, device=None), name
    assert re.search(r"open_rgb", demo.__doc__) and re.search(r"open_rgb", generate.__doc__)
