"""Rules of the torch port that hold for the package as a whole.

* No module of bridgelang_tpu_torch, and not chip_smoke.py, imports jax,
  flax or the JAX package (an AST scan of every import statement).
* Entry points default to CUDA and raise without a card; the CPU runs only
  when asked for.
* Importing the kernel builder compiles nothing.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import bridgelang_tpu_torch
from bridgelang_tpu_torch import _device
from bridgelang_tpu_torch.deploy import build_smoke_model
from bridgelang_tpu_torch.deploy import main as deploy_main
from bridgelang_tpu_torch.models.vla import OpenVLA
from bridgelang_tpu_torch.models.vlm import VLMConfig
from bridgelang_tpu_torch.ops import _build
from bridgelang_tpu_torch.serving.server import VLAServer, batch_buckets

ROOT = Path(__file__).resolve().parent.parent
PKG = Path(bridgelang_tpu_torch.__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "bridgelang_tpu"}


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_port_imports_no_jax():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15 and (ROOT / "chip_smoke.py").exists()
    bad = {str(f.relative_to(ROOT)): sorted(set(_imported_roots(f)) & FORBIDDEN) for f in files}
    assert not {f: m for f, m in bad.items() if m}


def test_ast_scan_catches_a_jax_import(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import os\nfrom bridgelang_tpu.models import vla\nimport bridgelang_tpu_torch\n")
    assert set(_imported_roots(f)) & FORBIDDEN == {"bridgelang_tpu"}


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_without_cuda_raises(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _device.resolve_device()
    with pytest.raises(RuntimeError):
        _device.resolve_device("cuda:0")
    with pytest.raises(RuntimeError):
        OpenVLA(VLMConfig(), {"k": {"action": {"q01": [0.0], "q99": [1.0]}}})
    with pytest.raises(RuntimeError):
        deploy_main(["--random_init_for_smoke", "true"])
    assert _device.resolve_device("cpu") == torch.device("cpu")


def test_server_default_device_without_cuda_raises(no_cuda):
    model, params = build_smoke_model(torch.device("cpu"))
    with pytest.raises(RuntimeError):
        VLAServer(model, params)
    VLAServer(model, params, device="cpu")  # explicit CPU is allowed


def test_smoke_model_serves_on_cpu():
    model, params = build_smoke_model(torch.device("cpu"))
    img = np.random.default_rng(0).integers(0, 256, (64, 64, 3), dtype=np.uint8)
    action = model.predict_action(params, img, "pick up the block")
    assert action.shape == (7,) and np.isfinite(action).all()


def test_build_is_lazy_and_hashed():
    assert _build.sources() == ["flash_bwd", "flash_fwd", "int4_matmul", "int8_matmul"]
    assert not _build._loaded  # nothing built or loaded at import
    for name in _build.sources():
        path = _build.library_path(name)
        assert path.parent == ROOT / "build" / "torch_kernels" and path.name.startswith(f"{name}-")


def test_library_names_hash_the_shared_headers(tmp_path, monkeypatch):
    """Every source may include any csrc/*.cuh, so an edit to a header
    renames every library and a stale build is never loaded."""
    for src in list(_build.CSRC_DIR.glob("*.cu")) + list(_build.CSRC_DIR.glob("*.cuh")):
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    before = {name: _build.library_path(name) for name in _build.sources()}
    assert before == {name: _build.library_path(name) for name in _build.sources()}
    header = tmp_path / "bf16_mma.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {name: _build.library_path(name) for name in _build.sources()}
    assert all(after[name] != before[name] for name in before)


def test_batch_buckets():
    assert batch_buckets(1) == [1]
    assert batch_buckets(4) == [1, 2, 4]
    assert batch_buckets(6) == [1, 2, 4, 6]
