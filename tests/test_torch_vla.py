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


def test_server_refuses_unported_modes(pair):
    import base64
    import http.client
    import json

    _, _, tmodel, tparams = pair
    server = VLAServer(tmodel, tparams, device="cpu")
    httpd = server.serve_background(port=0)
    try:
        port = httpd.server_address[1]
        img = _frames(1, seed=4)[0]
        body = {"image": {"__b64__": base64.b64encode(img.tobytes()).decode(), "shape": list(img.shape),
                          "dtype": "uint8"}, "instruction": "x"}
        for extra in ({"draft_tokens": [0] * 7}, {"horizon": 4}):
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
            conn.request("POST", "/act", json.dumps({**body, **extra}), {"Content-Type": "application/json"})
            resp = conn.getresponse()
            detail = json.loads(resp.read())["detail"]
            conn.close()
            assert resp.status == 500 and "not yet ported" in detail
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("GET", "/healthz")
        assert json.loads(conn.getresponse().read()) == {"status": "ok"}
        conn.close()
    finally:
        httpd.shutdown()
        httpd.server_close()
