"""BridgeLang on PyTorch + CUDA: the OpenVLA serving path of `bridgelang_tpu`,
ported to PyTorch for NVIDIA Hopper.

The module layout mirrors `bridgelang_tpu/` so that each port module sits at
the same relative path as its JAX counterpart. The JAX package stays the
reference: the `tests/test_torch_*.py` files hold every module here against
it. This package imports torch, numpy and the standard library only.

Entry points default to `device="cuda"` and raise when no card is present;
pass `device="cpu"` to run the plain-torch versions of the kernels (tests).
"""

__version__ = "0.1.0"
