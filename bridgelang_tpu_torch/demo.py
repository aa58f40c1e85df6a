"""Single-image predict_action demo: load a checkpoint, predict one action
for an image and an instruction, print (and optionally log) it.

    python -m bridgelang_tpu_torch.demo --checkpoint /ckpts/openvla-7b --image test.jpg \
        --instruction "pick up the cup" [--log_file run_log.txt] [--device cuda]

Counterpart of scripts/demo.py (the fork's run_openvla_demo.py): every field
of its `DemoConfig` under its name and default, plus `--device` (CUDA unless
`--device cpu`; no fallback). `--checkpoint` is a local directory in the HF
OpenVLA layout (`models/load.load_vla`, int8 w8a8 by default as the JAX
script); the image is read as PIL reads it (`native.image.open_rgb`).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

from bridgelang_tpu_torch.conf import parse_cli


@dataclass
class DemoConfig:
    checkpoint: str = "openvla-7b"
    image: str = "test.jpg"
    instruction: str = "pick up the object"
    unnorm_key: Optional[str] = None
    tokenizer_path: Optional[str] = None
    quantize_int8: bool = True
    log_file: Optional[str] = None
    device: Optional[str] = None  # cuda (default) | cpu


def main(cfg: DemoConfig):
    """Predict and print one action; returns it (numpy)."""
    import numpy as np

    from bridgelang_tpu_torch.models.llm.tokenizer import get_tokenizer
    from bridgelang_tpu_torch.models.load import load_vla
    from bridgelang_tpu_torch.native.image import open_rgb

    model, params = load_vla(cfg.checkpoint, quantize_int8=cfg.quantize_int8, device=cfg.device)
    model.tokenizer = get_tokenizer(cfg.tokenizer_path)
    image = open_rgb(cfg.image)

    t0 = time.time()
    action = model.predict_action(params, image, cfg.instruction, unnorm_key=cfg.unnorm_key)
    msg = (f"instruction={cfg.instruction!r}\naction={np.round(action, 5).tolist()}\n"
           f"latency={time.time() - t0:.2f}s (incl. graph capture)")
    print(msg)
    if cfg.log_file:
        with open(cfg.log_file, "a") as f:
            f.write(msg + "\n")
    return action


if __name__ == "__main__":
    main(parse_cli(DemoConfig))
