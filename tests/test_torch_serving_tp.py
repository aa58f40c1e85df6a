"""Tensor-parallel serving of the port vs the JAX package, on the CPU.

The JAX package's single-device predicts are the reference (its own
tests/test_serving_tp.py holds its 8-device mesh to them). The port serves
the same weights (converted from the JAX tree) over gloo groups spawned
once per mesh size (tests/torch_mesh_worker.py, no JAX in the ranks):
tensor=2 (2 ranks, every variant) and replica=2 x tensor=2 (4 ranks, the
float, int8, w4a8 and int8-cache variants), each rank holding its blocks of
the decoder (OpenVLA.use_mesh), rank 0 leading every predict. One small
vision tower: the towers are replicated.

Variants: the fp32 tree (the flash prefill: the port's only chunk
attention), int8 w8a8, int4 w4a8 replicated (`int4_shards` 1) and
shard-blocked (`int4_shards` 2: column blocks per rank, wo / w_down split
on K; int4 with w8a8 off, and shard-blocked w4a8), a speculative tick, a
horizon-4 parallel chunk and the int8 KV cache. Token ids are compared
exactly, actions at atol 1e-5 (fp32 sums in another order: partial products
meet in all-reduces); the JAX actions are its ids through its own bin
decoding and unnormalization (one compiled program per variant fewer). The decoder is 256 wide so
that its 2 x 128-row int4 scale groups split over 2 ranks.

Also: `deploy --mesh_spec tensor=2 --device cpu` (two processes from the
environment, as torchrun starts them) answers /act as the single-process
deploy does; the 13B's geometry cut to 2 layers at int8 (`slow`: ~4 GB of
fp32 weights to build on the CPU).
"""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bridgelang_tpu.models.llm.llama import LLMConfig as JLLMConfig
from bridgelang_tpu.models.vision.vit import ViTConfig as JViTConfig
from bridgelang_tpu.models.vla import OpenVLA as JOpenVLA
from bridgelang_tpu.models.vlm import VLMConfig as JVLMConfig
from bridgelang_tpu.ops import image_ops as jimg
from bridgelang_tpu.ops import quant as jq
from bridgelang_tpu.parallel import sharding as jsh
from bridgelang_tpu.vla.action_tokenizer import make_bins, token_ids_to_actions, unnormalize_actions
from bridgelang_tpu_torch.convert import params_from_jax
from bridgelang_tpu_torch.models.llm.llama import LLMConfig
from bridgelang_tpu_torch.parallel import sharding as tsh
from tests.helpers import TINY_NORM_STATS, TINY_VIT, StubTokenizer, random_image
from tests.torch_mesh_worker import run_group

REPO = Path(__file__).resolve().parents[1]
# The real vocabulary: the Llama prompt appends the '▁' token (29871).
SERVE_LLM = JLLMConfig(vocab_size=32000, padded_vocab_size=32064, dim=256, n_layers=2, n_heads=4, n_kv_heads=2,
                       intermediate_size=512, max_seq_len=256)
SERVE_TOWERS = (JViTConfig(image_size=32, patch_size=8, width=32, depth=2, num_heads=4, mlp_dim=64),)  # replicated
N = 4
HORIZON = 4
MESHES = {2: ["tensor=2"], 4: ["replica=2,tensor=2"]}
ON_FOUR = ("fp32", "int8", "int4_blocked_a8", "kv8")  # the replica split is the same for every weight kind
VARIANTS = [
    dict(name="fp32", speculative=True, parallel=True),
    dict(name="int8", w8a8=True, speculative=True),
    dict(name="int4", int4_shards=1),
    dict(name="int4_blocked", int4_shards=2),
    dict(name="int4_blocked_a8", w8a8=True, int4_shards=2, speculative=True),
    dict(name="kv8", kv_cache_int8=True),
]
# The shard-blocked int4 tree has the unblocked one's codes, so its JAX ids
# are the unblocked tree's. The w4a8 and w8a8 variants are held to JAX too:
# their ids follow activation codes, which a near-half rounding tie could
# send apart between the packages (tests/test_torch_int4.py), but no code
# of these inputs sits on one (the ids and the speculative ticks are equal).
JAX_SAME_AS = {"int4_blocked": "int4"}


def _port_fields(cfg, port_cls):
    names = {f.name for f in dataclasses.fields(port_cls)} - {"tp", "w8a8", "int4_shards"}
    return {k: getattr(cfg, k) for k in names}


def _jax_model(llm, towers=SERVE_TOWERS, w8a8=False, int4_shards=1):
    cfg = dataclasses.replace(JVLMConfig(), llm=dataclasses.replace(llm, w8a8=w8a8, int4_shards=int4_shards),
                              vision_override=towers if len(towers) > 1 else towers[0])
    model = JOpenVLA(cfg, TINY_NORM_STATS, tokenizer=StubTokenizer(), dtype=jnp.float32, prompt_bucket=32)
    model.image_transform = jimg.ImageTransformConfig("resize-naive", tuple(jimg.ImageTowerSpec(size=t.image_size)
                                                                          for t in towers))
    return model


def _model_spec(llm, towers=SERVE_TOWERS):
    from bridgelang_tpu_torch.models.vision.vit import ViTConfig

    return {"llm": _port_fields(llm, LLMConfig), "towers": [_port_fields(t, ViTConfig) for t in towers],
            "prompt_bucket": 32}


def _variant_params(jparams, v):
    llm = jparams["llm"]
    if v["name"] == "int8":
        llm = jq.quantize_llm_int8(llm)
    elif v["name"].startswith("int4"):
        llm = jq.quantize_llm_int4(llm, n_shards=v.get("int4_shards", 1))
    return dict(jparams, llm=llm)


def _jax_reference(jparams, v, images, instructions, draft, speculative: bool):
    model = _jax_model(SERVE_LLM, w8a8=v.get("w8a8", False), int4_shards=v.get("int4_shards", 1))
    if v.get("kv_cache_int8"):
        model.cache_dtype = jnp.int8
    params = _variant_params(jparams, v)
    ids, mask = model.pad_prompt([model.prepare_prompt_ids(t) for t in instructions])
    pixels = jimg.preprocess_batch(jnp.asarray(np.stack(images)), model.image_transform)
    tokens = model.generate_greedy(params, jnp.asarray(ids), jnp.asarray(mask), pixels, max_new_tokens=7)
    stats = TINY_NORM_STATS["bridge_orig"]["action"]
    actions = unnormalize_actions(token_ids_to_actions(tokens, jnp.asarray(make_bins()[1]), SERVE_LLM.vocab_size),
                                  jnp.asarray(stats["q01"]), jnp.asarray(stats["q99"]), jnp.asarray(stats["mask"]))
    ref = {"actions": np.asarray(actions, np.float32), "ids": np.asarray(tokens)}
    if speculative:
        act, tok = model.predict_action_speculative(params, images[0], instructions[0], draft_tokens=draft)
        ref.update(spec_action=np.asarray(act), spec_ids=np.asarray(tok))
    if v.get("parallel"):
        model.parallel_decode = True
        ref["chunk"] = np.asarray(model.predict_action_chunk(params, images[0], instructions[0], horizon=HORIZON))
    return ref


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The JAX references and the port's outputs on both mesh sizes."""
    tmp = tmp_path_factory.mktemp("serving")
    jparams = _jax_model(SERVE_LLM).init_params(jax.random.key(3))
    images = [random_image(32, 32, seed=i) for i in range(N)]
    instructions = [f"pick up object {i}" for i in range(N)]
    draft = np.arange(31800, 31807, dtype=np.int32)  # action-token ids
    variants, refs = [], {}
    for v in VARIANTS:
        path = tmp / f"{v['name']}.pt"
        tparams = params_from_jax(jax.tree.map(np.asarray, _variant_params(jparams, v)), device="cpu")
        torch.save(tparams, path)
        variants.append(dict(v, params=str(path)))
        name = v["name"]
        if name in JAX_SAME_AS:
            refs[name] = dict(refs[JAX_SAME_AS[name]])
        else:
            refs[name] = _jax_reference(jparams, v, images, instructions, draft, speculative=v.get("speculative"))
    job = {"suite": "serving", "model": _model_spec(SERVE_LLM), "norm_stats": TINY_NORM_STATS, "images": images,
           "instructions": instructions, "draft": draft, "horizon": HORIZON, "variants": variants}
    outs = run_group(dict(job, meshes=MESHES[2]), 2, tmp / "w2")
    outs.update(run_group(dict(job, meshes=MESHES[4], variants=[v for v in variants if v["name"] in ON_FOUR]), 4,
                          tmp / "w4"))
    return refs, outs


@pytest.mark.parametrize("mesh,variant", [(m, v["name"]) for m in MESHES[2] for v in VARIANTS]
                         + [(m, v) for m in MESHES[4] for v in ON_FOUR])
def test_tensor_parallel_predicts_match_jax_single_device(served, mesh, variant):
    refs, outs = served
    ref, got = refs[variant], outs[f"{mesh}|{variant}"]
    np.testing.assert_array_equal(got["ids"], ref["ids"])
    np.testing.assert_allclose(got["actions"], ref["actions"], atol=1e-5, rtol=1e-5)
    for key in ("spec_ids", "chunk", "spec_action"):
        if key in ref:
            if key == "spec_ids":
                np.testing.assert_array_equal(got[key], ref[key])
            else:
                np.testing.assert_allclose(got[key], ref[key], atol=1e-5, rtol=1e-5)
    assert got["collectives"] > 0  # the decoder's reductions and the logits' gathers ran


def test_serving_specs_match_jax_serving_shardings():
    """The port's serving placements for float, int8 and shard-blocked int4
    trees are the JAX `serving_param_shardings`' specs, carried to the port's
    layout (the int4 overrides: column blocks, K-split rows where
    `int4_row_shardable`, replicated otherwise)."""
    from bridgelang_tpu.parallel.mesh import make_mesh as jmake

    jparams = _jax_model(SERVE_LLM).init_params(jax.random.key(3))
    jmesh = jmake("replica=4,fsdp=1,tensor=2")

    class TwoRanks:  # the tensor size the port's specs read
        mesh_dim_names = ("replica", "fsdp", "tensor")

        def size(self, i):
            return (1, 1, 2)[i]

    for v in (dict(name="fp32"), dict(name="int8"), dict(name="int4_blocked", int4_shards=2),
              dict(name="int4", int4_shards=1)):
        jtree = _variant_params(jparams, v)
        jspecs = jax.tree.map(lambda s: s.spec, jsh.serving_param_shardings(jmesh, jtree,
                                                                             int4_shards=v.get("int4_shards", 1)))
        ttree = params_from_jax(jax.tree.map(np.asarray, jtree), device="cpu")
        tspecs = tsh.serving_param_pspecs(TwoRanks(), ttree, int4_shards=v.get("int4_shards", 1))
        for path, leaf, parent in tsh._walk(ttree):
            jpath, stacked, perm = tsh.jax_path_of(path, leaf, parent)
            node = jspecs
            for part in jpath.split("/"):
                node = node[part]
            want = list(node) + [None] * (leaf.dim() + int(stacked) - len(node))
            want = want[1:] if stacked else want
            got = tspecs
            for part in path.split("/"):
                got = got[int(part)] if isinstance(got, list) else got[part]
            assert tuple(got) == tuple(want[j] for j in perm), (v["name"], path, got, want)


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _post(port, body, timeout=120.0):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    conn.request("POST", "/act", json.dumps(body), {"Content-Type": "application/json"})
    resp = conn.getresponse()
    return resp.status, json.loads(resp.read())


def _get(port, path):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    conn.request("GET", path)
    return json.loads(conn.getresponse().read())


def test_deploy_mesh_spec_answers_as_single_process(tmp_path):
    """Two `deploy --mesh_spec tensor=2 --device cpu` processes (WORLD_SIZE /
    RANK / DIST_INIT_METHOD in the environment, as a launcher sets them):
    rank 0 listens and leads, rank 1 follows. /act (speculative by default)
    answers the single-process deploy's action and tokens; /stats reports
    the mesh; stopping rank 0 ends both."""
    from bridgelang_tpu_torch import deploy

    port = _free_port()
    args = ["--random_init_for_smoke", "true", "--device", "cpu", "--mesh_spec", "tensor=2", "--port", str(port),
            "--host", "127.0.0.1"]
    env = {k: v for k, v in os.environ.items() if k not in ("MASTER_ADDR", "MASTER_PORT")}
    env.update(WORLD_SIZE="2", DIST_INIT_METHOD=f"file://{tmp_path / 'store'}", OMP_NUM_THREADS="2")
    logs = [open(tmp_path / f"rank{r}.log", "w+") for r in range(2)]
    procs = [subprocess.Popen([sys.executable, "-m", "bridgelang_tpu_torch.deploy", *args], cwd=REPO,
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), stdout=logs[r],
                              stderr=subprocess.STDOUT) for r in range(2)]
    try:
        single = deploy.build_server(deploy.parse_args(["--random_init_for_smoke", "true", "--device", "cpu",
                                                        "--warmup", "false"]))
        img = np.random.default_rng(5).integers(0, 256, size=(64, 64, 3), dtype=np.uint8)
        body = {"image": img.tolist(), "instruction": "pick up the red block"}
        want = [single.predict(dict(body)) for _ in range(2)]  # tick 2 drafts from tick 1
        deadline = time.time() + 240
        while True:
            try:
                if _get(port, "/healthz")["status"] == "ok":
                    break
            except OSError:
                pass
            if time.time() > deadline or any(p.poll() is not None for p in procs):
                raise AssertionError("the mesh deploy did not come up")
            time.sleep(0.5)
        got = [_post(port, body) for _ in range(2)]
        for (status, out), ref in zip(got, want):
            assert status == 200
            np.testing.assert_allclose(out["action"], ref["action"], atol=1e-5)
            assert out["tokens"] == ref["tokens"]
        stats = _get(port, "/stats")
        assert stats["world_size"] == 2 and stats["mesh"] == {"replica": 1, "fsdp": 1, "tensor": 2}
    finally:
        if procs[0].poll() is None:
            procs[0].send_signal(signal.SIGINT)
        rcs = []
        for p in procs:
            try:
                rcs.append(p.wait(timeout=60))
            except subprocess.TimeoutExpired:
                p.kill()
                rcs.append("killed")
        for f in logs:
            f.seek(0)
            print(f.read()[-3000:])
    assert rcs[1] == 0, rcs  # the follower returned when rank 0 stopped


def test_check_mesh_args_refuses_as_scripts_deploy():
    """deploy's mesh checks: tensor must divide the head counts; int4 needs
    --int4_shards equal to tensor; shard-local shapes outside the card's
    int4 rule are refused, on a CUDA device even with
    --allow_int4_tp_fallback (the CPU may take the dequant fallback)."""
    from bridgelang_tpu_torch import deploy
    from bridgelang_tpu_torch.models.llm.llama import LLM_CONFIGS

    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    args = lambda *a: deploy.parse_args(list(a))  # noqa: E731
    with pytest.raises(SystemExit, match="head counts"):
        deploy.check_mesh_args(args(), LLM_CONFIGS["llama2-7b-pure"], 3, cpu)
    with pytest.raises(SystemExit, match="--int4_shards 2"):
        deploy.check_mesh_args(args("--quantize_int4", "true"), LLM_CONFIGS["llama2-7b-pure"], 2, cpu)
    deploy.check_mesh_args(args("--quantize_int4", "true", "--int4_shards", "2"), LLM_CONFIGS["llama2-7b-pure"], 2,
                           cuda)  # passes the card's rule at tensor=2
    seven4 = args("--quantize_int4", "true", "--int4_shards", "4")
    with pytest.raises(SystemExit, match="w_gate, w_up"):
        deploy.check_mesh_args(seven4, LLM_CONFIGS["llama2-7b-pure"], 4, cuda)
    allow = args("--quantize_int4", "true", "--int4_shards", "4", "--allow_int4_tp_fallback", "true")
    with pytest.raises(SystemExit, match="refused on a CUDA device"):
        deploy.check_mesh_args(allow, LLM_CONFIGS["llama2-7b-pure"], 4, cuda)
    deploy.check_mesh_args(allow, LLM_CONFIGS["llama2-7b-pure"], 4, cpu)  # the CPU fallback serves
    with pytest.raises(SystemExit, match="allow_int4_tp_fallback true"):
        deploy.check_mesh_args(seven4, LLM_CONFIGS["llama2-7b-pure"], 4, cpu)
    deploy.check_mesh_args(args("--quantize_int4", "true", "--int4_shards", "4"), LLM_CONFIGS["llama2-13b-pure"],
                           4, cuda)


@pytest.mark.slow
def test_13b_geometry_int8_tensor_parallel_matches_jax(tmp_path):
    """The 13B's widths (5120, 40 heads, 13824, vocab 32064) cut to 2 of 40
    layers, int8 w8a8, tensor=2 against the JAX single-device predict."""
    from bridgelang_tpu.models.llm.llama import LLM_CONFIGS as JLLM

    llm13 = dataclasses.replace(JLLM["llama2-13b-pure"], n_layers=2, max_seq_len=256)
    jm = _jax_model(llm13, towers=(TINY_VIT,), w8a8=True)
    jparams = jm.init_params(jax.random.key(4))
    jparams = dict(jparams, llm=jq.quantize_llm_int8(jparams["llm"]))
    images = [random_image(32, 32, seed=i) for i in range(2)]
    instructions = [f"pick up object {i}" for i in range(2)]
    ref = np.asarray(jm.predict_action_batch(jparams, images, instructions))
    path = tmp_path / "p13.pt"
    torch.save(params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu"), path)
    del jparams
    job = {"suite": "serving", "model": _model_spec(llm13, towers=(TINY_VIT,)), "norm_stats": TINY_NORM_STATS,
           "images": images, "instructions": instructions, "draft": np.zeros(7, np.int32), "horizon": HORIZON,
           "meshes": ["tensor=2"], "variants": [dict(name="int8", w8a8=True, params=str(path))]}
    out = run_group(job, 2, tmp_path / "w2")["tensor=2|int8"]
    np.testing.assert_allclose(out["actions"], ref, atol=1e-5, rtol=1e-5)
