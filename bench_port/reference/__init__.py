"""The plain reference the benchmark judges the port by: fp32 PyTorch, TF32
off, no kernels, no cache, no batching tricks.

`model.py`: the Prismatic VLA's forward (both towers, the projector, the
Mistral/Llama and Phi-2 decoders) teacher-forced over a prompt and its
served tokens, with the int8 weight-only and w8a8 arithmetic re-derived
from the float weights. `tokens.py`: the prompt ids, the training examples
and the action de-tokenization, re-derived from the strings and actions.
`lora.py`: the LoRA train step (loss, backward, clip, AdamW) in fp32.

Nothing here imports `jax`, the JAX package or the port.
"""
