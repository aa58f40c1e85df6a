"""The port's CUDA kernels against their plain torch versions, on the card.

Every test here carries the `gpu` marker and skips without a CUDA card (the
kernels have no CPU build). The file imports neither JAX nor the JAX package,
so it runs on a GPU machine without them:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_gpu.py -q

Tolerances: fp32 o atol 1e-4; bf16 o atol 2e-2 (kernel and plain both
accumulate in fp32 and round once to bf16, so they may sit one bf16 ulp
apart for |o| < 4); lse is fp32 in both, atol 1e-3.
"""

import pytest
import torch

from bridgelang_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain

# (b, t, s, h, hkv, d, lengths, window, causal)
CASES = {
    "causal_ragged": (2, 160, 160, 4, 4, 64, [130, 97], None, True),
    "gqa": (2, 128, 128, 8, 2, 128, [128, 100], None, True),
    "keys_longer": (2, 48, 176, 4, 4, 64, [48, 31], None, True),
    "window": (2, 256, 256, 4, 4, 128, [256, 200], 100, True),
    "not_causal": (1, 128, 128, 2, 2, 64, [90], None, False),
    "serving_7b": (2, 352, 352, 32, 32, 128, [331, 300], None, True),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash kernel has no CPU build")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_kernel_matches_plain(cuda_device, name, dtype, atol):
    b, t, s, h, hkv, d, lengths, window, causal = CASES[name]
    g = torch.Generator(device=cuda_device).manual_seed(3)
    q = torch.randn((b, t, h, d), generator=g, device=cuda_device, dtype=dtype)
    k = torch.randn((b, s, hkv, d), generator=g, device=cuda_device, dtype=dtype)
    v = torch.randn((b, s, hkv, d), generator=g, device=cuda_device, dtype=dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda_device)
    before = flash_attention.launches
    o, lse = flash_attention(q, k, v, lengths=lens, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    po, plse = flash_attention_plain(q, k, v, lengths=lens, causal=causal, window=window)
    for i, L in enumerate(lengths):
        rows = min(L, t)
        torch.testing.assert_close(o[i, :rows].float(), po[i, :rows].float(), atol=atol, rtol=0)
        torch.testing.assert_close(lse[i, :, :rows], plse[i, :, :rows], atol=1e-3, rtol=0)


@pytest.mark.gpu
def test_flash_kernel_rejects_unsupported_head_dim(cuda_device):
    q = torch.randn((1, 8, 2, 32), device=cuda_device)
    with pytest.raises(ValueError):
        flash_attention(q, q, q)
