"""The port's speculative, parallel and chunked decoding vs the JAX package, on the CPU.

The tiny OpenVLA of tests/test_torch_vla.py (dual 32 px towers, a 2-layer
GQA Llama with the real 32000/32064 vocabulary, the action columns of the LM
head scaled up so that decoding lands in the action range), initialised by
the JAX package and converted. The model is fp32 and every exactness test
runs an fp32 KV cache, where the speculative contract is exact.

Tolerances: token ids EXACTLY equal (to the JAX function and to the port's
own greedy ids); accepted counts and calibrated margins equal; actions atol
1e-6 (both packages de-tokenize and unnormalize in fp32 in the same order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from bridgelang_tpu.ops import image_ops as jimg
from tests.test_torch_vla import INSTRUCTIONS, _frames, pair  # noqa: F401 (pair is a fixture)

N = 7  # action dims


def _inputs(jmodel, n_rows, seed):
    ids, mask = jmodel.pad_prompt([jmodel.prepare_prompt_ids(INSTRUCTIONS[r % 2]) for r in range(n_rows)])
    pixels = np.array(jimg.preprocess_batch(jnp.asarray(_frames(n_rows, seed)), jmodel.image_transform))
    return ids, mask, pixels


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _greedy(pair_, ids, mask, pixels, n=N):
    jmodel, jparams, tmodel, tparams = pair_
    j = np.asarray(jmodel.generate_greedy(jparams, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(pixels),
                                          max_new_tokens=n, cache_dtype=jnp.float32))
    t = tmodel.generate_greedy(tparams, *_t(ids, mask, pixels), max_new_tokens=n, cache_dtype=torch.float32).numpy()
    np.testing.assert_array_equal(t, j)
    return t


def _drafts(greedy):
    partial = greedy.copy()
    partial[:, 4:] = 7
    mid = greedy.copy()
    mid[:, 2] = (mid[:, 2] + 1) % 500
    return {"perfect": greedy.copy(), "garbage": np.full_like(greedy, 3), "partial": partial, "mid_mismatch": mid}


@pytest.mark.parametrize("draft_kind", ["perfect", "garbage", "partial", "mid_mismatch"])
def test_speculative_ids_equal_jax_and_greedy(pair, draft_kind):
    jmodel, jparams, tmodel, tparams = pair
    ids, mask, pixels = _inputs(jmodel, 1, seed=11)
    greedy = _greedy(pair, ids, mask, pixels)
    draft = _drafts(greedy)[draft_kind]
    j_out, j_k = jmodel.generate_speculative(jparams, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(pixels),
                                             jnp.asarray(draft, jnp.int32), cache_dtype=jnp.float32,
                                             margin_threshold=0.0, return_accept_count=True)
    t_out, t_k = tmodel.generate_speculative(tparams, *_t(ids, mask, pixels, draft), cache_dtype=torch.float32,
                                             margin_threshold=0.0, return_accept_count=True)
    np.testing.assert_array_equal(t_out.numpy(), np.asarray(j_out))
    np.testing.assert_array_equal(t_out.numpy(), greedy)
    np.testing.assert_array_equal(t_k.numpy(), np.asarray(j_k))
    # token 1 follows the canonical token 0, so even garbage accepts 2; a wrong draft[i] rejects token i + 1
    assert int(t_k[0]) == {"perfect": N, "garbage": 2, "partial": 5, "mid_mismatch": 3}[draft_kind]
    # at the serving margin the ids stay greedy's whatever is accepted
    t_out25 = tmodel.generate_speculative(tparams, *_t(ids, mask, pixels, draft), cache_dtype=torch.float32)
    np.testing.assert_array_equal(t_out25.numpy(), greedy)


def test_speculative_batched_with_one_garbage_row(pair):
    jmodel, jparams, tmodel, tparams = pair
    ids, mask, pixels = _inputs(jmodel, 3, seed=12)
    greedy = _greedy(pair, ids, mask, pixels, n=5)
    drafts = greedy.copy()
    drafts[1] = 3
    j_out, j_k = jmodel.generate_speculative(jparams, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(pixels),
                                             jnp.asarray(drafts), cache_dtype=jnp.float32, margin_threshold=0.0,
                                             return_accept_count=True)
    t_out, t_k = tmodel.generate_speculative(tparams, *_t(ids, mask, pixels, drafts), cache_dtype=torch.float32,
                                             margin_threshold=0.0, return_accept_count=True)
    np.testing.assert_array_equal(t_out.numpy(), greedy)
    np.testing.assert_array_equal(t_out.numpy(), np.asarray(j_out))
    np.testing.assert_array_equal(t_k.numpy(), np.asarray(j_k))
    assert t_k.tolist() == [5, 2, 5]


def test_generate_parallel_equals_jax_and_is_prefix_independent(pair):
    jmodel, jparams, tmodel, tparams = pair
    ids, mask, pixels = _inputs(jmodel, 2, seed=13)
    j7 = np.asarray(jmodel.generate_parallel(jparams, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(pixels),
                                             max_new_tokens=7))
    t7 = tmodel.generate_parallel(tparams, *_t(ids, mask, pixels), max_new_tokens=7).numpy()
    t3 = tmodel.generate_parallel(tparams, *_t(ids, mask, pixels), max_new_tokens=3).numpy()
    np.testing.assert_array_equal(t7, j7)
    assert t7.shape == (2, 7)
    np.testing.assert_array_equal(t7[:, :3], t3)  # the queries see the prefix only
    np.testing.assert_array_equal(t7[:, 0], _greedy(pair, ids, mask, pixels, n=1)[:, 0])


def test_parallel_forward_never_reaches_the_flash_kernel(pair, monkeypatch):
    from bridgelang_tpu_torch.models.llm import llama as tllama

    jmodel, _, tmodel, tparams = pair
    ids, mask, pixels = _inputs(jmodel, 1, seed=14)
    calls = []
    monkeypatch.setattr(tllama, "flash_attention", lambda *a, **k: calls.append(1) or (_ for _ in ()).throw(
        AssertionError("the parallel forward reached the flash kernel")))
    tmodel.generate_parallel(tparams, *_t(ids, mask, pixels), max_new_tokens=4)
    assert calls == []


def test_predict_action_chunk_shape_stat_tiling_and_jax(pair):
    jmodel, jparams, tmodel, tparams = pair
    frame = _frames(1, seed=15)[0]
    j_chunk = np.asarray(jmodel.predict_action_chunk(jparams, frame, INSTRUCTIONS[0], horizon=3))
    t_chunk = tmodel.predict_action_chunk(tparams, frame, INSTRUCTIONS[0], horizon=3)
    assert t_chunk.shape == (3, N) and np.isfinite(t_chunk).all()
    np.testing.assert_allclose(t_chunk, j_chunk, atol=1e-6, rtol=0)
    # every step of the chunk unnormalizes with the same per-dim stats
    stats = tmodel.get_action_stats()
    actions, tokens, _ = tmodel._host_predict("parallel", tparams, [frame], [INSTRUCTIONS[0]], None, horizon=3)
    want = tmodel.tokens_to_actions(torch.from_numpy(tokens.astype(np.int64)).reshape(3, N),
                                    torch.tensor(stats["q01"]), torch.tensor(stats["q99"]), torch.tensor(stats["mask"]))
    np.testing.assert_allclose(t_chunk, want.numpy(), atol=1e-6, rtol=0)


def test_calibrate_speculative_margin_equals_jax(pair):
    jmodel, jparams, tmodel, tparams = pair
    frames = list(_frames(4, seed=16))
    jmodel.cache_dtype, tmodel.cache_dtype = jnp.float32, torch.float32
    try:
        j = jmodel.calibrate_speculative_margin(jparams, frames, INSTRUCTIONS[0])
        t = tmodel.calibrate_speculative_margin(tparams, frames, INSTRUCTIONS[0])
    finally:
        jmodel.cache_dtype, tmodel.cache_dtype = jnp.bfloat16, torch.bfloat16
    assert t == j


def test_predict_action_speculative_equals_jax(pair):
    jmodel, jparams, tmodel, tparams = pair
    frame = _frames(1, seed=17)[0]
    jmodel.cache_dtype, tmodel.cache_dtype = jnp.float32, torch.float32
    try:
        draft = np.zeros(N, np.int32)
        for _ in range(2):  # a cold tick, then its own ids as the draft
            j_act, j_tok = jmodel.predict_action_speculative(jparams, frame, INSTRUCTIONS[0], draft)
            t_act, t_tok = tmodel.predict_action_speculative(tparams, frame, INSTRUCTIONS[0], draft)
            np.testing.assert_array_equal(t_tok, np.asarray(j_tok))
            np.testing.assert_allclose(t_act, np.asarray(j_act), atol=1e-6, rtol=0)
            draft = t_tok
    finally:
        jmodel.cache_dtype, tmodel.cache_dtype = jnp.bfloat16, torch.bfloat16


def test_predict_from_frames_device_equals_predict_action_batch(pair):
    _, _, tmodel, tparams = pair
    frames = _frames(2, seed=18)
    want = tmodel.predict_action_batch(tparams, list(frames), INSTRUCTIONS)
    stats = tmodel.get_action_stats()
    ids, mask = tmodel.pad_prompt([tmodel.prepare_prompt_ids(t) for t in INSTRUCTIONS])
    got = tmodel.predict_from_frames_device(
        tparams, *_t(ids, mask, frames), torch.tensor(stats["q01"]), torch.tensor(stats["q99"]),
        torch.tensor(stats["mask"]), action_dim=N)
    np.testing.assert_array_equal(got.numpy(), want)
    # the parallel decode through the same entry point
    par = tmodel.predict_from_frames_device(
        tparams, *_t(ids, mask, frames), torch.tensor(stats["q01"]), torch.tensor(stats["q99"]),
        torch.tensor(stats["mask"]), action_dim=N, parallel_decode=True)
    tmodel.parallel_decode = True
    try:
        np.testing.assert_array_equal(par.numpy(), tmodel.predict_action_batch(tparams, list(frames), INSTRUCTIONS))
    finally:
        tmodel.parallel_decode = False


def test_temperature_sampling(pair):
    jmodel, _, tmodel, tparams = pair
    ids, mask, pixels = _inputs(jmodel, 1, seed=19)
    args = _t(ids, mask, pixels)
    greedy = tmodel.generate_greedy(tparams, *args, max_new_tokens=6, cache_dtype=torch.float32)
    zero = tmodel.generate_greedy(tparams, *args, max_new_tokens=6, cache_dtype=torch.float32, temperature=0.0,
                                  generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(zero.numpy(), greedy.numpy())
    s1 = tmodel.generate_greedy(tparams, *args, max_new_tokens=6, temperature=5.0,
                                generator=torch.Generator().manual_seed(1))
    s2 = tmodel.generate_greedy(tparams, *args, max_new_tokens=6, temperature=5.0,
                                generator=torch.Generator().manual_seed(2))
    s1b = tmodel.generate_greedy(tparams, *args, max_new_tokens=6, temperature=5.0,
                                 generator=torch.Generator().manual_seed(1))
    assert not np.array_equal(s1.numpy(), s2.numpy())
    np.testing.assert_array_equal(s1.numpy(), s1b.numpy())  # one generator state, one rollout


def test_warmup_predict_runs_every_bucket_eagerly_on_the_cpu(pair, monkeypatch):
    from bridgelang_tpu_torch.util.compile_cache import warmup_predict

    _, _, tmodel, tparams = pair
    calls = []
    real = tmodel.predict_packed
    monkeypatch.setattr(tmodel, "predict_packed", lambda mode, *a, **k: calls.append((mode, a[1].shape[0])) or real(
        mode, *a, **k))
    assert warmup_predict(tmodel, tparams, max_batch=3, speculative=True, instruction=INSTRUCTIONS[0]) > 0
    assert calls == [("greedy", 1), ("greedy", 2), ("greedy", 3), ("speculative", 1)]
    assert tmodel.graphs.entries == {}  # graphs are the card's; the CPU runs the predicts eagerly
