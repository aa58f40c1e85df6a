"""REST serving entry point of the torch port.

    python -m bridgelang_tpu_torch.deploy --random_init_for_smoke true [--port 8000] \
        [--max_batch 4] [--batch_window_ms 6] [--device cuda]

Mirrors scripts/deploy.py for the options the port has so far. Loading a
checkpoint is not yet ported: serving needs `--random_init_for_smoke true`,
which serves a tiny random-weight model (as scripts/deploy.py does). The
device defaults to CUDA and the command fails without a card unless
`--device cpu` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional, Sequence

import torch


def _bool(text: str) -> bool:
    low = text.lower()
    if low not in ("true", "false", "1", "0", "yes", "no"):
        raise argparse.ArgumentTypeError(f"expected true/false, got {text!r}")
    return low in ("true", "1", "yes")


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--unnorm_key", default=None)
    ap.add_argument("--random_init_for_smoke", type=_bool, default=False)
    ap.add_argument("--max_batch", type=int, default=1)
    ap.add_argument("--batch_window_ms", type=float, default=6.0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def build_smoke_model(device: torch.device):
    """The tiny random-weight OpenVLA that scripts/deploy.py serves for smoke
    tests: 64 px single tower, 2-layer 128-wide Llama, fp32."""
    from bridgelang_tpu_torch.models.llm.llama import LLMConfig
    from bridgelang_tpu_torch.models.llm.tokenizer import get_tokenizer
    from bridgelang_tpu_torch.models.vision.vit import ViTConfig
    from bridgelang_tpu_torch.models.vla import OpenVLA
    from bridgelang_tpu_torch.models.vlm import VLMConfig
    from bridgelang_tpu_torch.ops.image_ops import ImageTowerSpec, ImageTransformConfig

    tiny_vit = ViTConfig(image_size=64, patch_size=8, width=64, depth=4, num_heads=4, mlp_dim=128)
    tiny_llm = LLMConfig(vocab_size=32000, padded_vocab_size=32064, dim=128, n_layers=2, n_heads=4,
                         n_kv_heads=4, intermediate_size=256)
    vcfg = dataclasses.replace(VLMConfig(), llm=tiny_llm, vision_override=tiny_vit)
    stats = {"bridge_orig": {"action": {"q01": [-0.1] * 7, "q99": [0.1] * 7, "mask": [True] * 6 + [False]}}}
    model = OpenVLA(vcfg, stats, tokenizer=get_tokenizer(None), dtype=torch.float32, device=device)
    model.image_transform = ImageTransformConfig("resize-naive", (ImageTowerSpec(size=64),))
    gen = torch.Generator(device=model.device).manual_seed(0)
    return model, model.init_params(gen)


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    from bridgelang_tpu_torch._device import resolve_device
    from bridgelang_tpu_torch.serving.server import VLAServer

    device = resolve_device(args.device)
    if not args.random_init_for_smoke:
        raise SystemExit("checkpoint loading is not yet ported to torch; pass --random_init_for_smoke true")
    model, params = build_smoke_model(device)
    VLAServer(model, params, default_unnorm_key=args.unnorm_key, max_batch=args.max_batch,
              batch_window_ms=args.batch_window_ms, device=device).run(args.host, args.port)


if __name__ == "__main__":
    main()
