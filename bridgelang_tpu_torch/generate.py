"""Interactive VLM REPL: chat about an image from the terminal.

    python -m bridgelang_tpu_torch.generate --checkpoint /ckpts/openvla-7b --image test.jpg \
        [--max_new_tokens 128] [--quantize_int8 true] [--device cuda]

Counterpart of scripts/generate.py (the reference's scripts/generate.py:
52-133): every field of its `GenerateConfig` under its name and default,
plus `--device` (CUDA unless `--device cpu`; no fallback). `--checkpoint` is
a local directory in the HF OpenVLA layout (`models/load.load_vla`, int8
w8a8 by default as the JAX script). The image is read as PIL reads it
(`native.image.open_rgb`). Each line read from standard input is a human
turn; the reply is the greedy continuation of the conversation so far, cut
at the first EOS. End of input ends the session.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from bridgelang_tpu_torch.conf import parse_cli


@dataclass
class GenerateConfig:
    checkpoint: str = "prism-dinosiglip-224px+7b"
    image: str = "test.jpg"
    tokenizer_path: Optional[str] = None
    max_new_tokens: int = 128
    quantize_int8: bool = True
    device: Optional[str] = None  # cuda (default) | cpu


def main(cfg: GenerateConfig) -> List[List[int]]:
    """Chat until end of input; returns each reply's token ids."""
    import numpy as np
    import torch

    from bridgelang_tpu_torch.models.llm.prompting import get_prompt_builder
    from bridgelang_tpu_torch.models.llm.tokenizer import get_tokenizer
    from bridgelang_tpu_torch.models.load import load_vla
    from bridgelang_tpu_torch.native.image import open_rgb
    from bridgelang_tpu_torch.ops.image_ops import preprocess_batch

    model, params = load_vla(cfg.checkpoint, quantize_int8=cfg.quantize_int8, device=cfg.device)
    tokenizer = get_tokenizer(cfg.tokenizer_path)
    image = open_rgb(cfg.image)
    pixels = preprocess_batch(torch.from_numpy(image[None]).to(model.device), model.image_transform, dtype=model.dtype)

    print(f"Loaded {cfg.checkpoint}; chatting about {cfg.image} (ctrl-d to exit)")
    builder = get_prompt_builder(model.cfg.llm_family)
    replies = []
    while True:
        try:
            user = input("\n>> ")
        except EOFError:
            break
        builder.add_turn("human", user)
        ids = torch.tensor([tokenizer.encode(builder.get_prompt())], dtype=torch.int32, device=model.device)
        with torch.inference_mode():
            out = model.generate_greedy(params, ids, torch.ones_like(ids), pixels, max_new_tokens=cfg.max_new_tokens)
        out_ids = out[0].cpu().numpy()
        eos = np.where(out_ids == model.cfg.llm.eos_token_id)[0]
        if len(eos):
            out_ids = out_ids[: eos[0]]
        replies.append(out_ids.tolist())
        reply = tokenizer.decode(out_ids.tolist())
        builder.add_turn("gpt", reply)
        print(reply)
    return replies


if __name__ == "__main__":
    main(parse_cli(GenerateConfig))
