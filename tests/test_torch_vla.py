"""The port's main path end to end vs the JAX package, on the CPU in fp32.

A tiny OpenVLA (the tests/test_e2e_torch_parity.py dual-tower geometry, a
2-layer GQA Llama with the real 32000/32064 vocabulary so the byte tokenizer
and the '▁' token fit) is initialised by the JAX package and converted into
the port. The LM head's action-token columns are scaled up so that greedy
decoding lands inside the action range and the actions differ per input.

Token ids must be EXACTLY equal; actions agree to atol 1e-6 (both packages
de-tokenize and unnormalize in fp32 with the same operation order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bridgelang_tpu.models.llm.llama import LLMConfig as JLLMConfig
from bridgelang_tpu.models.llm.tokenizer import ByteFallbackTokenizer as JTokenizer
from bridgelang_tpu.models.vision.vit import ViTConfig as JViTConfig
from bridgelang_tpu.models.vla import OpenVLA as JOpenVLA
from bridgelang_tpu.models.vlm import VLMConfig as JVLMConfig
from bridgelang_tpu.ops import image_ops as jimg
from bridgelang_tpu_torch.convert import params_from_jax
from bridgelang_tpu_torch.models.llm.llama import LLMConfig
from bridgelang_tpu_torch.models.llm.tokenizer import ByteFallbackTokenizer
from bridgelang_tpu_torch.models.vision.vit import ViTConfig
from bridgelang_tpu_torch.models.vla import OpenVLA, norm_stats_from_json
from bridgelang_tpu_torch.models.vlm import VLMConfig
from bridgelang_tpu_torch.ops import image_ops as timg
from bridgelang_tpu_torch.ops.flash_attention import flash_attention
from bridgelang_tpu_torch.serving.server import VLAServer, client_act
from tests.helpers import TINY_NORM_STATS

DINO = dict(image_size=32, patch_size=8, width=32, depth=4, num_heads=4, mlp_dim=128,
            use_cls_token=True, num_reg_tokens=4, no_embed_class=True, layerscale_init=1e-5)
SIG = dict(image_size=32, patch_size=8, width=48, depth=4, num_heads=4, mlp_dim=96,
           use_cls_token=False, act="gelu_tanh")
LLM = dict(vocab_size=32000, padded_vocab_size=32064, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
           intermediate_size=128)
TOWERS = ((32, jimg.IMAGENET_DEFAULT_MEAN, jimg.IMAGENET_DEFAULT_STD), (32, jimg.INCEPTION_MEAN, jimg.INCEPTION_STD))
INSTRUCTIONS = ["pick up the red block", "put the small spoon on the towel next to the blue cup"]


def _frames(n, seed):
    return np.random.default_rng(seed).integers(0, 256, size=(n, 48, 64, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def pair():
    jcfg = dataclasses.replace(JVLMConfig(), llm=JLLMConfig(**LLM),
                               vision_override=(JViTConfig(**DINO), JViTConfig(**SIG)))
    jmodel = JOpenVLA(jcfg, TINY_NORM_STATS, tokenizer=JTokenizer(), dtype=jnp.float32)
    jmodel.image_transform = jimg.ImageTransformConfig(
        "resize-naive", tuple(jimg.ImageTowerSpec(*t) for t in TOWERS))
    jparams = jmodel.init_params(jax.random.key(0))
    head = jparams["llm"]["lm_head"]
    jparams["llm"]["lm_head"] = head.at[:, 31744:32000].multiply(8.0)

    tcfg = dataclasses.replace(VLMConfig(), llm=LLMConfig(**LLM),
                               vision_override=(ViTConfig(**DINO), ViTConfig(**SIG)))
    tmodel = OpenVLA(tcfg, norm_stats_from_json(TINY_NORM_STATS), tokenizer=ByteFallbackTokenizer(),
                     dtype=torch.float32, device="cpu")
    tmodel.image_transform = timg.ImageTransformConfig(
        "resize-naive", tuple(timg.ImageTowerSpec(*t) for t in TOWERS))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    return jmodel, jparams, tmodel, tparams


def test_generate_greedy_token_ids_equal(pair):
    jmodel, jparams, tmodel, tparams = pair
    frames = _frames(2, seed=1)
    ids, mask = jmodel.pad_prompt([jmodel.prepare_prompt_ids(t) for t in INSTRUCTIONS])
    t_ids, t_mask = tmodel.pad_prompt([tmodel.prepare_prompt_ids(t) for t in INSTRUCTIONS])
    np.testing.assert_array_equal(ids, t_ids)
    np.testing.assert_array_equal(mask, t_mask)
    assert mask[0].sum() != mask[1].sum(), "the two prompts must differ in length"
    pixels = np.array(jimg.preprocess_batch(jnp.asarray(frames), jmodel.image_transform))
    j_tok = np.asarray(jmodel.generate_greedy(jparams, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(pixels),
                                              max_new_tokens=7))
    before = flash_attention.launches
    t_tok = tmodel.generate_greedy(tparams, torch.from_numpy(ids), torch.from_numpy(mask),
                                   torch.from_numpy(pixels), max_new_tokens=7).numpy()
    assert flash_attention.launches == before  # CPU: the plain version, no kernel launch
    np.testing.assert_array_equal(t_tok, j_tok)
    assert ((j_tok >= 31744) & (j_tok < 32000)).mean() > 0.5, "decoding should land in the action range"
    assert not np.array_equal(j_tok[0], j_tok[1])


def test_predict_action_batch_matches_jax(pair):
    jmodel, jparams, tmodel, tparams = pair
    frames = list(_frames(2, seed=2))
    j_act = np.asarray(jmodel.predict_action_batch(jparams, frames, INSTRUCTIONS))
    t_act = tmodel.predict_action_batch(tparams, frames, INSTRUCTIONS)
    assert t_act.shape == (2, 7) and t_act.dtype == np.float32
    np.testing.assert_allclose(t_act, j_act, atol=1e-6, rtol=0)
    assert not np.allclose(t_act[0], t_act[1])
    np.testing.assert_allclose(tmodel.predict_action(tparams, frames[1], INSTRUCTIONS[1]), j_act[1], atol=1e-6, rtol=0)


@pytest.mark.parametrize("max_batch", [1, 2])
def test_server_act_matches_jax_predict_action(pair, max_batch):
    jmodel, jparams, tmodel, tparams = pair
    frames = _frames(2, seed=3)
    server = VLAServer(tmodel, tparams, max_batch=max_batch, batch_window_ms=50.0, device="cpu")
    httpd = server.serve_background(port=0)
    try:
        port = httpd.server_address[1]
        if max_batch == 1:
            got = [client_act("127.0.0.1", port, f, t) for f, t in zip(frames, INSTRUCTIONS)]
        else:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(2) as ex:
                futs = [ex.submit(client_act, "127.0.0.1", port, f, t) for f, t in zip(frames, INSTRUCTIONS)]
                got = [f.result(timeout=120) for f in futs]
        for frame, instr, action in zip(frames, INSTRUCTIONS, got):
            want = np.asarray(jmodel.predict_action(jparams, frame, instr))
            assert action.shape == (7,)
            np.testing.assert_allclose(action, want, atol=1e-6, rtol=0)
        stats = server.stats()
        assert stats["requests"] == 2 and stats["errors"] == 0
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.close()


def _post(port, body):
    import http.client
    import json

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST", "/act", json.dumps(body), {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def _body(img, instruction, **extra):
    import base64

    return {"image": {"__b64__": base64.b64encode(img.tobytes()).decode(), "shape": list(img.shape),
                      "dtype": "uint8"}, "instruction": instruction, **extra}


@pytest.fixture
def fp32_cache(pair):
    """The exact speculative contract: both packages on an fp32 KV cache."""
    jmodel, _, tmodel, _ = pair
    jmodel.cache_dtype, tmodel.cache_dtype = jnp.float32, torch.float32
    yield
    jmodel.cache_dtype, tmodel.cache_dtype = jnp.bfloat16, torch.bfloat16


def test_server_speculative_default_over_rest(pair, fp32_cache):
    """Batch 1 decodes speculatively by default, drafting from the server's
    own history: the cold and the warm tick equal greedy (the JAX
    predict_action), the response carries "tokens"; a server with the
    default off keeps the plain greedy wire shape."""
    jmodel, jparams, tmodel, tparams = pair
    img = _frames(1, seed=5)[0]
    want = np.asarray(jmodel.predict_action(jparams, img, INSTRUCTIONS[0]))
    greedy_srv = VLAServer(tmodel, tparams, speculative_default=False, device="cpu")
    spec_srv = VLAServer(tmodel, tparams, device="cpu")
    assert spec_srv.speculative_default and spec_srv.speculative_margin == 0.25
    h0, h1 = greedy_srv.serve_background(port=0), spec_srv.serve_background(port=0)
    try:
        g_action, g_tokens = client_act("127.0.0.1", h0.server_address[1], img, INSTRUCTIONS[0], return_tokens=True)
        assert g_tokens is None
        np.testing.assert_allclose(g_action, want, atol=1e-6, rtol=0)
        a1, t1 = client_act("127.0.0.1", h1.server_address[1], img, INSTRUCTIONS[0], return_tokens=True)
        a2, t2 = client_act("127.0.0.1", h1.server_address[1], img, INSTRUCTIONS[0], return_tokens=True,
                            use_b64=False)
        np.testing.assert_allclose(a1, want, atol=1e-6, rtol=0)  # cold: a zero draft
        np.testing.assert_allclose(a2, want, atol=1e-6, rtol=0)  # warm: the history's draft
        np.testing.assert_array_equal(t1, t2)
        assert t1.shape == (7,) and (INSTRUCTIONS[0], None) in spec_srv._draft_cache
        # a client-held draft takes the speculative path on either server
        a3, t3 = client_act("127.0.0.1", h0.server_address[1], img, INSTRUCTIONS[0], draft_tokens=t2,
                            return_tokens=True)
        np.testing.assert_allclose(a3, want, atol=1e-6, rtol=0)
        np.testing.assert_array_equal(t3, t1)
        assert greedy_srv.stats()["model_passes"] == 2 and spec_srv.stats()["model_passes"] == 2
    finally:
        for h in (h0, h1):
            h.shutdown()
            h.server_close()


def test_draft_from_history_equals_jax():
    from bridgelang_tpu.serving.server import draft_from_history as j_draft
    from bridgelang_tpu_torch.serving.server import draft_from_history

    V = 32000
    prev1 = np.array([V - 100, V - 50, V - 10, V - 200, V - 2, V - 256, V - 30], np.int32)
    raw_step = np.array([0, 1, -3, 20, 0, -1, 5], np.int64)
    prev2 = (prev1 - raw_step).astype(np.int32)
    np.testing.assert_array_equal(draft_from_history(None, prev1, V), prev1)  # cold tick
    out = draft_from_history(prev2, prev1, V)
    np.testing.assert_array_equal(out, j_draft(prev2, prev1, V))
    applied = np.array([0, 0, -3, 8, 0, 0, 5])  # clamp +-8, then zero sub-2-bin steps
    np.testing.assert_array_equal(out, np.clip(prev1 + applied, V - 256, V - 1))
    assert out.dtype == np.int32
    junk = np.array([5, 31999, 40000, 7, 31744, 12, 0], np.int32)  # outside the action range: kept verbatim
    for p2 in (junk - 3, junk + 9, junk):
        np.testing.assert_array_equal(draft_from_history(p2, junk, V), j_draft(p2, junk, V))


def test_server_horizon_on_a_parallel_model(pair):
    jmodel, jparams, tmodel, tparams = pair
    img = _frames(1, seed=6)[0]
    want = np.asarray(jmodel.predict_action_chunk(jparams, img, INSTRUCTIONS[0], horizon=3))
    tmodel.parallel_decode = True
    try:
        server = VLAServer(tmodel, tparams, device="cpu")
        assert not server.speculative_default  # a parallel model decodes in one forward
        httpd = server.serve_background(port=0)
        try:
            port = httpd.server_address[1]
            chunk = client_act("127.0.0.1", port, img, INSTRUCTIONS[0], horizon=3)
            assert chunk.shape == (3, 7) and np.isfinite(chunk).all()
            np.testing.assert_allclose(chunk, want, atol=1e-6, rtol=0)
            # a draft is ignored by a parallel model: the one-forward decode answers
            action, tokens = client_act("127.0.0.1", port, img, INSTRUCTIONS[0], draft_tokens=np.zeros(7),
                                        return_tokens=True)
            assert tokens is None
            np.testing.assert_allclose(action, want[0], atol=1e-6, rtol=0)
            for bad in (0, 33):
                status, payload = _post(port, _body(img, INSTRUCTIONS[0], horizon=bad))
                assert status == 500 and "horizon must be in [1, 32]" in payload["detail"]
        finally:
            httpd.shutdown()
            httpd.server_close()
    finally:
        tmodel.parallel_decode = False


def test_server_refuses_horizon_on_a_sequential_model(pair):
    _, _, tmodel, tparams = pair
    server = VLAServer(tmodel, tparams, device="cpu", request_timeout_s=30.0)
    assert server.request_timeout_s == 30.0
    httpd = server.serve_background(port=0)
    try:
        port = httpd.server_address[1]
        status, payload = _post(port, _body(_frames(1, seed=4)[0], "x", horizon=4))
        assert status == 500 and "parallel-objective model" in payload["detail"]
        assert server.stats()["errors"] == 1 and server.stats()["model_passes"] == 0
    finally:
        httpd.shutdown()
        httpd.server_close()
