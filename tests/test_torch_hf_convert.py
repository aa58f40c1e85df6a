"""The port's HF vision converters and pos-embed resample against the JAX
package's.

`convert_hf_dinov2` / `convert_hf_siglip` on tiny random `transformers`
models (built as tests/test_vit_hf_parity.py builds them) equal
`params_from_jax` of the JAX converters' output bit for bit (the same fp32
values, renamed and transposed); the resample is within 1e-6 (fp32, absolute)
of `jax.image.resize(..., "bicubic", antialias=True)`, down (37x37 -> 16x16,
a 518 px DINOv2 grid to 224 px) and up.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from bridgelang_tpu.models.vision import hf_convert as jconv  # noqa: E402
from bridgelang_tpu.models.vision.vit import ViTConfig as JViTConfig  # noqa: E402
from bridgelang_tpu_torch.convert import vit_state_from_jax  # noqa: E402
from bridgelang_tpu_torch.models.vision import hf_convert as tconv  # noqa: E402
from bridgelang_tpu_torch.models.vision.vit import ViT, ViTConfig  # noqa: E402

DEPTH = 4


def _assert_state_equal(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        g = got[k]
        assert tuple(g.shape) == v.shape, k
        np.testing.assert_array_equal(g.numpy(), np.asarray(v, np.float32), err_msg=k)


def _dinov2(image_size, seed=0):
    from transformers import Dinov2WithRegistersConfig, Dinov2WithRegistersModel

    cfg = Dinov2WithRegistersConfig(hidden_size=32, num_hidden_layers=DEPTH, num_attention_heads=4, mlp_ratio=4,
                                    image_size=image_size, patch_size=8, num_register_tokens=4,
                                    layerscale_value=1e-5, hidden_act="gelu", layer_norm_eps=1e-6)
    torch.manual_seed(seed)
    hf = Dinov2WithRegistersModel(cfg).eval()
    with torch.no_grad():
        for layer in hf.encoder.layer:
            layer.layer_scale1.lambda1.uniform_(0.5, 1.5)
            layer.layer_scale2.lambda1.uniform_(0.5, 1.5)
        hf.embeddings.cls_token.normal_()
    return hf


DINO = dict(image_size=32, patch_size=8, width=32, depth=DEPTH, num_heads=4, mlp_dim=128, use_cls_token=True,
            num_reg_tokens=4, no_embed_class=True, layerscale_init=1e-5)
SIGLIP = dict(image_size=32, patch_size=8, width=48, depth=DEPTH, num_heads=4, mlp_dim=96, use_cls_token=False,
              act="gelu_tanh")


@pytest.mark.parametrize("hf_image_size", [32, 48])
def test_dinov2_equal_to_jax(hf_image_size):
    hf = _dinov2(hf_image_size)
    sd = hf.state_dict()
    want = vit_state_from_jax(jconv.convert_hf_dinov2(sd, JViTConfig(**DINO)))
    got = tconv.convert_hf_dinov2(sd, ViTConfig(**DINO))
    if hf_image_size == 32:
        _assert_state_equal(got, want)
    else:  # resampled 6x6 -> 4x4 grid: to 1e-6, the rest exact
        np.testing.assert_allclose(got.pop("pos_embed").numpy(), want.pop("pos_embed"), rtol=0, atol=1e-6)
        _assert_state_equal(got, want)
    assert got["cls_token"].dtype == torch.float32


def test_siglip_equal_to_jax_and_runs_like_hf():
    from transformers import SiglipVisionConfig, SiglipVisionModel

    hf_cfg = SiglipVisionConfig(hidden_size=48, num_hidden_layers=DEPTH, num_attention_heads=4,
                                intermediate_size=96, image_size=32, patch_size=8,
                                hidden_act="gelu_pytorch_tanh", layer_norm_eps=1e-6)
    torch.manual_seed(0)
    hf = SiglipVisionModel(hf_cfg).eval()
    sd = hf.state_dict()
    want = vit_state_from_jax(jconv.convert_hf_siglip(sd, JViTConfig(**SIGLIP)))
    got = tconv.convert_hf_siglip(sd, ViTConfig(**SIGLIP))
    _assert_state_equal(got, want)

    pixels = torch.from_numpy(np.random.default_rng(2).normal(size=(2, 3, 32, 32)).astype(np.float32))
    ours = torch.func.functional_call(ViT(ViTConfig(**SIGLIP), device="meta"), got, (pixels,))
    with torch.no_grad():
        theirs = hf(pixels, output_hidden_states=True).hidden_states[DEPTH - 1]
    torch.testing.assert_close(ours, theirs, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("std", [0.02, 1.0])
@pytest.mark.parametrize("side_in,side_out", [(37, 16), (16, 37), (6, 4), (4, 6), (16, 24)])
def test_resample_pos_embed_matches_jax_image_resize(side_in, side_out, std):
    """Within 1e-6 of max|value| (fp32; at std 0.02, the ViT pos-embed init
    scale, that is within 1e-6 absolute by a wide margin). Both sides build
    the same weights; XLA's einsum sums in its own order, ~1e-6 relative."""
    rng = np.random.default_rng(side_in * 100 + side_out)
    pos = (std * rng.normal(size=(1, side_in * side_in, 8))).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(pos.reshape(side_in, side_in, 8)), (side_out, side_out, 8),
                                       "bicubic", antialias=True))
    got = tconv.resample_pos_embed(torch.from_numpy(pos), side_out * side_out)
    assert got.shape == (1, side_out * side_out, 8) and got.dtype == torch.float32
    err = np.abs(got.numpy().reshape(side_out, side_out, 8) - want).max()
    assert err <= 1e-6 * max(1.0, np.abs(want).max()), err
    # torch's own bicubic is another filter (a = -0.75, no antialias): the resample is not it
    if side_out < side_in:
        theirs = torch.nn.functional.interpolate(torch.from_numpy(pos).reshape(1, side_in, side_in, 8)
                                                 .permute(0, 3, 1, 2), size=(side_out, side_out), mode="bicubic")
        assert float((theirs.permute(0, 2, 3, 1).reshape(got.shape) - got).abs().max()) > 1e-3 * std


def test_resample_rejects_non_square():
    with pytest.raises(ValueError, match="non-square"):
        tconv.resample_pos_embed(torch.zeros(1, 12, 4), 16)


def test_dinov2_without_cls_fold_differs():
    """The CLS-position fold is load-bearing in the port too."""
    hf = _dinov2(32, seed=4)
    got = tconv.convert_hf_dinov2(hf.state_dict(), ViTConfig(**DINO))
    assert not torch.equal(got["cls_token"], hf.state_dict()["embeddings.cls_token"])
    pixels = torch.from_numpy(np.random.default_rng(5).normal(size=(1, 3, 32, 32)).astype(np.float32))
    ours = torch.func.functional_call(ViT(ViTConfig(**DINO), device="meta"), got, (pixels,))
    with torch.no_grad():
        theirs = hf(pixels, output_hidden_states=True).hidden_states[DEPTH - 1][:, 1 + 4:]
    torch.testing.assert_close(ours, theirs, atol=2e-5, rtol=2e-5)

