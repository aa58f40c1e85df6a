"""The port's `verify` and `inspect_checkpoint` entry points against
scripts/verify.py and scripts/inspect_checkpoint.py, on the CPU.

The tiny fused OpenVLA of tests/test_torch_load.py (dual 32-px towers, a
2-layer Llama with the real vocabulary), exported by the JAX package, is
loaded by each package's script from that directory, with the registries
patched under the real ids and the towers' preprocessing at 32 px (the
golden frames are drawn at the first tower's size).

* Golden bundles: one recorded by the JAX script replays in the port with
  every token equal, and one recorded by the port replays in the JAX
  script, with int8 off and at int8 w8a8 (the scripts' default). The float
  leaves load at fp32 (tests/test_torch_robot.py's `fp32_loads`): at bf16
  the two packages' CPU arithmetic rounds apart and flips ids of the tiny
  random model (2 of 28 here). Tokens exactly equal, actions within
  `--golden_atol` (1e-5). One altered token fails the replay in both.
* inspect_checkpoint: the printed rows and per-module summary equal the
  JAX script's on the HF export; on a port run dir the tensor count and
  bytes equal what `torch.save` wrote.
* The default mode and `--speculative_stream` run on the CPU and give
  finite actions and accept counts in [1, 7]; `--reference_twin` and a
  missing card (no `--device cpu`) raise.
"""

import dataclasses

import numpy as np
import pytest
import torch

import bridgelang_tpu_torch.ops.image_ops as timg
from bridgelang_tpu_torch import inspect_checkpoint, verify
from tests.test_torch_load import ckpts  # noqa: F401 (a fixture)
from tests.test_torch_pretraining_data import _load_script
from tests.test_torch_robot import fp32_loads, tiny  # noqa: F401 (fixtures)

N_RECORDS = 4


@pytest.fixture(scope="module")
def jverify():
    return _load_script("verify")


def _cfgs(jv, path, int8, **kw):
    return (jv.VerifyConfig(checkpoint=str(path), quantize_int8=int8, **kw),
            verify.VerifyConfig(checkpoint=str(path), quantize_int8=int8, device="cpu", **kw))


def _altered(src, dst):
    rec = dict(np.load(src, allow_pickle=False))
    rec["expected_tokens"] = rec["expected_tokens"].copy()
    rec["expected_tokens"][1, 3] += 1
    np.savez(dst, **rec)
    return dst


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8-w8a8"])
def test_golden_bundles_replay_across_packages(ckpts, tiny, fp32_loads, jverify, tmp_path, capsys, int8):
    path = ckpts["fused"][2]
    j_bundle, t_bundle = tmp_path / "jax.npz", tmp_path / "port.npz"
    jcfg, tcfg = _cfgs(jverify, path, int8, calls=N_RECORDS)
    jverify.main(dataclasses.replace(jcfg, golden_record=str(j_bundle)))
    verify.main(dataclasses.replace(tcfg, golden_record=str(t_bundle)))
    j, t = np.load(j_bundle), np.load(t_bundle)
    assert sorted(j.files) == sorted(t.files)
    assert str(t["numerics"]) == str(j["numerics"]) == ("int8+w8a8" if int8 else "bf16")
    np.testing.assert_array_equal(t["frames"], j["frames"])
    np.testing.assert_array_equal(t["expected_tokens"], j["expected_tokens"])
    assert t["frames"].shape == (N_RECORDS, 32, 32, 3)
    assert ((j["expected_tokens"] >= 31744) & (j["expected_tokens"] < 32000)).mean() > 0.5
    capsys.readouterr()

    # the JAX bundle in the port, the port's in the JAX script: every record exact
    assert verify.main(dataclasses.replace(tcfg, golden=str(j_bundle))) == {"passed": N_RECORDS, "total": N_RECORDS}
    jverify.main(dataclasses.replace(jcfg, golden=str(t_bundle)))
    assert f"golden replay: {N_RECORDS}/{N_RECORDS} records bit-exact (PASS)" in capsys.readouterr().out

    # one altered token fails both
    bad = _altered(j_bundle, tmp_path / "bad.npz")
    for main, cfg in ((verify.main, tcfg), (jverify.main, jcfg)):
        with pytest.raises(SystemExit):
            main(dataclasses.replace(cfg, golden=str(bad)))
        out = capsys.readouterr().out
        assert f"golden replay: {N_RECORDS - 1}/{N_RECORDS}" in out and "FAIL record 1: tokens" in out


def test_pre_tokenized_bundle_and_numerics_warning(ckpts, tiny, fp32_loads, tmp_path, capsys):
    """The pre-tokenized bundle form (pixel_values + input_ids) replays like
    the frames form; a bundle recorded under other numerics warns."""
    path = ckpts["fused"][2]
    cfg = verify.VerifyConfig(checkpoint=str(path), quantize_int8=False, device="cpu", calls=2)
    model, params = verify._build_model(cfg)
    verify.record_golden(model, params, tmp_path / "g.npz", 2, None)
    rec = dict(np.load(tmp_path / "g.npz"))
    ids, mask = model.pad_prompt([model.prepare_prompt_ids(str(s)) for s in rec["instructions"]])
    pixels = timg.preprocess_batch(torch.from_numpy(rec["frames"]), model.image_transform).numpy()
    pre = {k: rec[k] for k in ("expected_tokens", "expected_actions", "unnorm_key")}
    np.savez(tmp_path / "pre.npz", pixel_values=pixels, input_ids=ids, attention_mask=mask, numerics="int4", **pre)
    n_pass, n_total, failures = verify.replay_golden(model, params, tmp_path / "pre.npz")
    assert (n_pass, n_total, failures) == (2, 2, [])
    assert "recorded under numerics 'int4' but this model runs 'bf16'" in capsys.readouterr().out


def test_default_mode_and_speculative_stream(ckpts, tiny, fp32_loads, tmp_path, capsys):
    path = ckpts["fused"][2]
    base = verify.VerifyConfig(checkpoint=str(path), device="cpu", calls=5)
    out = verify.main(base)
    assert out["calls"] == 5 and out["p90_ms"] >= out["p50_ms"] > 0
    assert "5 calls: p50=" in capsys.readouterr().out
    stream = verify.main(dataclasses.replace(base, speculative_stream=True, calls=6))  # at least 8 frames
    assert len(stream["accepts"]) == 7 and all(1 <= a <= 7 for a in stream["accepts"])
    assert sum(stream["hist"]) == 7
    # a golden bundle's frames as the stream
    verify.main(dataclasses.replace(base, quantize_int8=False, golden_record=str(tmp_path / "g.npz"), calls=4))
    replay = verify.main(dataclasses.replace(base, quantize_int8=False, speculative_stream=True,
                                             golden=str(tmp_path / "g.npz")))
    assert len(replay["accepts"]) == 3


def test_reference_twin_and_device_rules(ckpts, tiny, tmp_path):
    with pytest.raises(SystemExit, match="prismatic/extern/hf"):
        verify.main(verify.VerifyConfig(reference_twin=str(tmp_path), device="cpu"))
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        verify.main(verify.VerifyConfig(checkpoint=str(ckpts["fused"][2]), calls=1))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        inspect_checkpoint.main(inspect_checkpoint.InspectConfig(path=str(ckpts["fused"][2])))


def test_random_init_flagship_is_the_trimmed_7b():
    """The random-init path's model at full width (its config only: no
    parameters are drawn), cut here to one layer and two blocks; the script
    cuts to 8 and 8."""
    model = verify.flagship_model("cpu", llm_layers=1, vit_depth=2)
    cfg = model.cfg
    assert (cfg.llm.dim, cfg.llm.n_layers, cfg.llm.intermediate_size) == (4096, 1, 11008)
    assert [t.depth for t in cfg.vision_override] == [2, 2] and [t.width for t in cfg.vision_override] == [1024, 1152]
    assert verify.TRIM_LLM_LAYERS == 8 and verify.TRIM_VIT_DEPTH == 8
    assert model.norm_stats == verify.FLAGSHIP_STATS and model.get_action_dim() == 7


@pytest.mark.parametrize("filt,limit", [(None, 40), ("llm", 0), ("projector", 3)])
def test_inspect_hf_prints_the_jax_rows(ckpts, capsys, filt, limit):
    path = ckpts["fused"][2]
    jinspect = _load_script("inspect_checkpoint")
    jinspect.main(jinspect.InspectConfig(path=str(path), filter=filt, limit=limit))
    want = capsys.readouterr().out
    summary = inspect_checkpoint.main(inspect_checkpoint.InspectConfig(path=str(path), filter=filt, limit=limit,
                                                                      device="cpu"))
    assert capsys.readouterr().out == want
    from safetensors.numpy import load_file

    tensors = load_file(str(next(path.glob("*.safetensors"))))
    assert summary["tensors"] == len(tensors) and summary["bytes"] == sum(t.nbytes for t in tensors.values())


def test_inspect_port_run_dir(tmp_path, capsys):
    """A port run dir: the latest step's state.pt, tensors named by their
    path, None leaves skipped; count and bytes as written."""
    g = torch.Generator().manual_seed(0)
    params = {"llm": {"layers": [{"wq": torch.randn(8, 4, generator=g), "wq_lora_a": torch.randn(2, 4, generator=g),
                                  "wk": None}], "embed": torch.zeros(16, 4, dtype=torch.bfloat16)},
              "projector": {"fc1.weight": torch.ones(4, 4, dtype=torch.int8)}}
    state = {"step": 3, "params": params, "opt_state": {"count": 3, "mu": [torch.zeros(5), None]}}
    run = tmp_path / "run"
    for step in (2, 3):
        d = run / "checkpoints" / f"step-00000{step}-epoch-00-loss=1.0000"
        d.mkdir(parents=True)
        torch.save(dict(state, step=step), d / "state.pt")
    summary = inspect_checkpoint.main(inspect_checkpoint.InspectConfig(path=str(run), device="cpu"))
    out = capsys.readouterr().out
    assert "step-000003-epoch-00-loss=1.0000/state.pt" in out
    assert "params/llm/layers/0/wq_lora_a" in out and "opt_state/mu/0" in out and "/wk" not in out
    assert summary["tensors"] == 5
    assert summary["bytes"] == (8 * 4 + 2 * 4 + 5) * 4 + 16 * 4 * 2 + 16
    assert summary["by_prefix"]["params"] == [4, (8 * 4 + 2 * 4) * 4 + 16 * 4 * 2 + 16]
    step_dir = run / "checkpoints" / "step-000002-epoch-00-loss=1.0000"
    assert inspect_checkpoint.main(inspect_checkpoint.InspectConfig(path=str(step_dir), device="cpu"))["tensors"] == 5
    (tmp_path / "orbax").mkdir()
    (tmp_path / "orbax" / "_METADATA").write_text("{}")
    with pytest.raises(SystemExit, match="Orbax"):
        inspect_checkpoint.main(inspect_checkpoint.InspectConfig(path=str(tmp_path / "orbax"), device="cpu"))
