"""Port flash attention vs the JAX kernel (Pallas interpret mode on CPU).

The same numpy inputs go through `bridgelang_tpu.ops.flash_attention` and
`bridgelang_tpu_torch.ops.flash_attention` (which runs its plain version for
CPU tensors). fp32, atol/rtol 2e-5 on `o` and on `lse`, over query rows below
each example's length (rows past it are don't-care in both).

The CUDA kernel itself is compared with the plain version on the card by
tests/test_torch_kernels_gpu.py and by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bridgelang_tpu.ops.flash_attention import _flash_fwd_impl
from bridgelang_tpu.ops.flash_attention import flash_attention as jax_flash
from bridgelang_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain

TOL = dict(atol=2e-5, rtol=2e-5)

# (b, t, s, h, hkv, d, lengths, window, causal)
CASES = {
    "causal_ragged": (2, 160, 160, 4, 4, 64, [130, 97], None, True),
    "gqa": (2, 128, 128, 8, 2, 64, [128, 100], None, True),
    "keys_longer": (2, 48, 176, 4, 4, 64, [48, 31], None, True),
    "window": (2, 256, 256, 4, 4, 64, [256, 200], 100, True),
    "not_causal": (1, 128, 128, 2, 2, 64, [90], None, False),
}


def _inputs(b, t, s, h, hkv, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, t, h, d)).astype(np.float32)
    k = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_forward_matches_jax(name):
    b, t, s, h, hkv, d, lengths, window, causal = CASES[name]
    q, k, v = _inputs(b, t, s, h, hkv, d, seed=sorted(CASES).index(name))
    lens = np.asarray(lengths, np.int32)

    block_q = min(128, -(-t // 128) * 128)
    block_k = min(128, -(-s // 128) * 128)
    jo, res = _flash_fwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, block_q, block_k,
                              window, jnp.asarray(lens))
    j_lse = np.asarray(res[5])[:, :, :t, 0]  # [B, H, T]
    j_api = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), lengths=jnp.asarray(lens),
                      causal=causal, window=window)
    np.testing.assert_array_equal(np.asarray(jo), np.asarray(j_api))

    before = flash_attention.launches
    to, t_lse = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                lengths=torch.from_numpy(lens), causal=causal, window=window)
    assert flash_attention.launches == before, "a CPU tensor must not count as a kernel launch"
    assert to.dtype == torch.float32 and to.shape == (b, t, h, d) and t_lse.shape == (b, h, t)
    for i, L in enumerate(lengths):
        rows = min(L, t)
        np.testing.assert_allclose(to[i, :rows].numpy(), np.asarray(jo)[i, :rows], **TOL)
        np.testing.assert_allclose(t_lse[i, :, :rows].numpy(), j_lse[i, :, :rows], **TOL)


def test_window_wider_than_keys_is_dense():
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 64, 64, 2, 2, 64, seed=11))
    o_w, lse_w = flash_attention(q, k, v, window=4096)
    o_d, lse_d = flash_attention(q, k, v)
    assert torch.equal(o_w, o_d) and torch.equal(lse_w, lse_d)


def test_bf16_plain_matches_fp32_plain():
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 96, 96, 4, 2, 128, seed=12))
    o32, lse32 = flash_attention_plain(q, k, v, lengths=torch.tensor([80]))
    o16, lse16 = flash_attention_plain(q.bfloat16(), k.bfloat16(), v.bfloat16(), lengths=torch.tensor([80]))
    assert o16.dtype == torch.bfloat16 and lse16.dtype == torch.float32
    # bf16 inputs round at 2^-9 relative; outputs are averages of O(1) values.
    np.testing.assert_allclose(o16[0, :80].float().numpy(), o32[0, :80].numpy(), atol=3e-2, rtol=3e-2)
    np.testing.assert_allclose(lse16[0, :, :80].numpy(), lse32[0, :, :80].numpy(), atol=5e-2)


def test_rejects_bad_inputs():
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 32, 16, 4, 3, 64, seed=13))
    with pytest.raises(ValueError):  # S < T
        flash_attention(q, k[:, :16], v[:, :16])
    q2, k2, v2 = (torch.from_numpy(x) for x in _inputs(1, 16, 16, 4, 3, 64, seed=13))
    with pytest.raises(ValueError):  # 4 heads over 3 KV heads
        flash_attention(q2, k2, v2)
    meta = torch.empty((1, 16, 2, 64), device="meta")
    with pytest.raises(RuntimeError):  # neither cuda nor cpu: no silent path
        flash_attention(meta, meta, meta)

