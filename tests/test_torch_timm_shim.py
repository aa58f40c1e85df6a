"""The port's timm shim (bridgelang_tpu_torch/extern/timm_shim.py) and version
module against the JAX package's, on the CPU.

* every tower id the shim models: the port's shim builds the module tree of
  the JAX package's shim (state-dict keys and shapes equal), at full size on
  the meta device;
* at a tiny geometry (both packages' VIT_CONFIGS entries patched alike), the
  same weights in both shims give bit-equal `get_intermediate_layers`
  features, a DINOv2-style tower (cls, registers, LayerScale) and a SigLIP
  one (no prefix, the attention-pool head);
* the shim's feature tap (after block depth - 2, prefix stripped) equals the
  port's own vision tower (models/vision/vit.ViT) given the same weights
  through the checkpoint loader's timm names (models/load.hf_to_port), fp32
  at atol 1e-5 (the shim attends through SDPA, the tower through einsums);
* `install()` hands `import timm` the shim where timm is absent;
* `bridgelang_tpu_torch.version.__version__` is the JAX package's.
"""

import dataclasses

import numpy as np
import pytest
import torch

from bridgelang_tpu import version as jversion
from bridgelang_tpu.extern import timm_shim as jshim
from bridgelang_tpu.models.vision import vit as jvit
from bridgelang_tpu_torch import version as tversion
from bridgelang_tpu_torch.extern import timm_shim as tshim
from bridgelang_tpu_torch.models.load import hf_to_port
from bridgelang_tpu_torch.models.vision import vit as tvit

TOWER_IDS = sorted(tshim._TIMM_ID_TO_OURS)
# tiny geometries of the two families the fused 224px backbone uses
TINY = {"vit_large_patch14_reg4_dinov2.lvd142m": dict(image_size=28, patch_size=7, width=32, depth=4, num_heads=4,
                                                      mlp_dim=64),
        "vit_so400m_patch14_siglip_224": dict(image_size=28, patch_size=7, width=24, depth=3, num_heads=2,
                                              mlp_dim=40)}


def _shapes(model) -> dict:
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


@pytest.mark.parametrize("timm_id", TOWER_IDS)
def test_port_shim_builds_the_jax_shims_module_tree(timm_id):
    assert tshim._TIMM_ID_TO_OURS[timm_id] == jshim._TIMM_ID_TO_OURS[timm_id]
    with torch.device("meta"):
        got, want = tshim.create_model(timm_id), jshim.create_model(timm_id)
    assert list(_shapes(got).items()) == list(_shapes(want).items())


@pytest.fixture(params=sorted(TINY), ids=["dinov2", "siglip"])
def tiny(request, monkeypatch):
    """(timm id, the port's shim model, the JAX shim's model) at a tiny
    geometry, the JAX shim's weights drawn from a seed and loaded into the
    port's."""
    timm_id = request.param
    ours, _ = tshim._TIMM_ID_TO_OURS[timm_id]
    monkeypatch.setitem(jvit.VIT_CONFIGS, ours, dataclasses.replace(jvit.VIT_CONFIGS[ours], **TINY[timm_id]))
    monkeypatch.setitem(tvit.VIT_CONFIGS, ours, dataclasses.replace(tvit.VIT_CONFIGS[ours], **TINY[timm_id]))
    torch.manual_seed(5)
    want = jshim.create_model(timm_id).eval()
    with torch.no_grad():
        for p in want.parameters():
            p.copy_(torch.randn(p.shape) * 0.2)
    got = tshim.create_model(timm_id).eval()
    got.load_state_dict(want.state_dict(), strict=True)
    return timm_id, got, want


def test_port_shim_features_equal_the_jax_shims(tiny):
    _, got, want = tiny
    x = torch.from_numpy(np.random.default_rng(6).normal(size=(2, 3, 28, 28)).astype(np.float32))
    depth = len(want.blocks)
    with torch.no_grad():
        for n in ({depth - 2}, 2):
            for a, b in zip(got.get_intermediate_layers(x, n=n), want.get_intermediate_layers(x, n=n)):
                assert torch.equal(a, b)
        assert torch.equal(got(x), want(x))


def test_port_shim_tap_equals_the_ports_vision_tower(tiny):
    timm_id, shim, _ = tiny
    ours, _ = tshim._TIMM_ID_TO_OURS[timm_id]
    cfg = tvit.VIT_CONFIGS[ours]
    tower = tvit.ViT(cfg).eval()
    carried = {}
    for name, t in shim.state_dict().items():
        mapped = hf_to_port(f"vision_backbone.featurizer.{name}", 1, {"featurizer": cfg.depth})
        if mapped is not None:
            carried[mapped[1].split(".", 1)[1]] = t
    tower.load_state_dict(carried, strict=True)
    x = torch.from_numpy(np.random.default_rng(7).normal(size=(2, 3, 28, 28)).astype(np.float32))
    with torch.no_grad():
        (feat,) = shim.get_intermediate_layers(x, n={cfg.depth - 2})
        torch.testing.assert_close(tower(x), feat, atol=1e-5, rtol=0)


def test_install_gives_the_shim_where_timm_is_absent():
    import importlib.util
    import sys

    names = ("timm", "timm.models", "timm.models.vision_transformer")
    if importlib.util.find_spec("timm") is not None:  # the real package wins
        import timm

        assert tshim.install() is timm
        return
    saved = {n: sys.modules.pop(n) for n in names if n in sys.modules}
    try:
        timm = tshim.install()
        from timm.models.vision_transformer import LayerScale

        assert timm.create_model is tshim.create_model and LayerScale is tshim.LayerScale
        assert timm.__version__ == jshim.__version__
    finally:
        for n in names:
            sys.modules.pop(n, None)
        sys.modules.update(saved)


def test_version_equals_the_jax_packages():
    import bridgelang_tpu_torch

    assert tversion.__version__ == jversion.__version__ == bridgelang_tpu_torch.__version__
