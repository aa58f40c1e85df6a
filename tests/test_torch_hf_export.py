"""The port's HF exporter against the JAX package's (bridgelang_tpu/extern/
hf_export.py) on the same tiny params (`params_from_jax` of the JAX tree).

Both write model.safetensors: the same keys, shapes, dtypes (fp32) and
values, exactly; equal config.json and dataset_statistics.json. Also for
int8 and packed-int4 decoders (dequantized in both) and for the `source_hf`
passthrough. Each package's `load_vla` reads the other's export.
"""

import json

import jax
import numpy as np
import pytest
import torch

from bridgelang_tpu.extern import hf_export as jexport
from bridgelang_tpu.models import load as jload
from bridgelang_tpu.ops import quant as jquant
from bridgelang_tpu_torch.convert import params_from_jax
from bridgelang_tpu_torch.extern import hf_export as texport
from bridgelang_tpu_torch.models import load as tload
from bridgelang_tpu_torch.util import safetensors_io as sio
from tests.test_torch_load import assert_bit_equal, bits, ckpts, jax_loaded, registries  # noqa: F401 (fixtures)


def _port_model(path):
    model, _ = tload.load_vla(str(path), load_weights=False, device="cpu")
    return model


def _assert_exports_equal(got_dir, want_dir):
    got, want = sio.load_file(got_dir / "model.safetensors"), sio.load_file(want_dir / "model.safetensors")
    assert set(got) == set(want), sorted(set(got) ^ set(want))[:8]
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, (k, got[k].dtype, w.dtype)
        assert torch.equal(bits(got[k]), bits(w)), k
    for name in ("config.json", "dataset_statistics.json"):
        assert json.loads((got_dir / name).read_text()) == json.loads((want_dir / name).read_text()), name


@pytest.mark.parametrize("kind,quant", [("fused", None), ("single", None), ("fused", "int8"), ("fused", "int4")])
def test_export_equals_jax_export(ckpts, registries, tmp_path, kind, quant):
    jmodel, jparams, path = ckpts[kind]
    if quant == "int8":
        jparams = dict(jparams, llm=jquant.quantize_llm_int8(jparams["llm"]))
    elif quant == "int4":
        jparams = dict(jparams, llm=jquant.quantize_llm_int4(jparams["llm"], group=128))
    want_dir = jexport.export_checkpoint(jmodel, jparams, tmp_path / "jax")
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    got_dir = texport.export_checkpoint(_port_model(path), tparams, tmp_path / "port")
    _assert_exports_equal(got_dir, want_dir)
    sf = sio.SafetensorsFile(got_dir / "model.safetensors")
    assert all(sf.dtype_shape(k)[0] == torch.float32 for k in sf.keys())


def test_source_hf_passthrough_equals_jax(ckpts, registries, tmp_path):
    """A source checkpoint with the tensors the port never runs (a real
    final block, the towers' `norm`, SigLIP's pooling head): both exporters
    pass them through the same way."""
    jmodel, jparams, path = ckpts["fused"]
    src = tmp_path / "src"
    src.mkdir()
    sd = sio.load_file(path / "model.safetensors")
    rng = np.random.default_rng(0)
    for k in [k for k in sd if ".blocks.3." in k]:
        sd[k] = torch.from_numpy(rng.normal(size=tuple(sd[k].shape)).astype(np.float32))
    sd["vision_backbone.featurizer.norm.weight"] = torch.ones(32)
    sd["vision_backbone.fused_featurizer.attn_pool.latent"] = torch.full((1, 1, 48), 0.5)
    sio.save_file(sd, src / "model.safetensors")
    want_dir = jexport.export_checkpoint(jmodel, jparams, tmp_path / "jax", source_hf=src)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    got_dir = texport.export_checkpoint(_port_model(path), tparams, tmp_path / "port", source_hf=src)
    _assert_exports_equal(got_dir, want_dir)
    got = sio.load_file(got_dir / "model.safetensors")
    assert torch.equal(got["vision_backbone.featurizer.blocks.3.attn.qkv.weight"],
                       sd["vision_backbone.featurizer.blocks.3.attn.qkv.weight"])
    assert "vision_backbone.fused_featurizer.attn_pool.latent" in got


def test_each_loader_reads_the_other_export(ckpts, registries, tmp_path):
    jmodel, jparams, path = ckpts["fused"]
    model, tparams = tload.load_vla(str(path), dtype=torch.float32, device="cpu")
    port_dir = texport.export_checkpoint(model, tparams, tmp_path / "port")
    _, from_port = jax_loaded(port_dir, dtype=jax.numpy.float32)  # the JAX loader on the port's export
    assert_bit_equal(from_port, tparams)
    _, round_trip = tload.load_vla(str(port_dir), dtype=torch.float32, device="cpu")
    assert_bit_equal(round_trip, tparams)
    jm2, _ = jload.load_vla(str(port_dir), load_weights=False)
    assert jm2.norm_stats == model.norm_stats


def test_export_is_lazy_one_tensor_at_a_time(ckpts):
    """The state dict is made of Lazy entries: nothing is copied to the
    host until the writer asks for that tensor."""
    _, jparams, path = ckpts["fused"]
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    dead = set()
    lazy = texport.export_state_dict(tparams, dead, dtype=torch.bfloat16)
    assert all(isinstance(v, sio.Lazy) for v in lazy.values())
    assert dead and all(".blocks.3." in k for k in dead)
    k = "language_model.model.layers.1.mlp.down_proj.weight"
    t = lazy[k].make()
    assert t.dtype == torch.bfloat16 and tuple(t.shape) == lazy[k].shape == (128, 256)
    assert torch.equal(t, tparams["llm"]["layers"][1]["w_down"].to(torch.bfloat16))
