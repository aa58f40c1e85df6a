#!/usr/bin/env python3
"""Smoke run of the torch port on one NVIDIA GPU (H100): `python3 chip_smoke.py`.

Run from the root of a checkout. Phases (`--phases`, all by default), each
of which fails the run:
  build    compile every bridgelang_tpu_torch/csrc/*.cu with nvcc (sm_90a),
           all sources in parallel; print the build seconds, the ptxas
           register report, and the card's name and power limit.
  leftovers the last port slice's host-only modules (this machine has no
           Pillow): preprocessing.download.convert_gif_png_to_jpg over a copy
           of tests/data/images/ocr (GIF: global and local tables,
           interlaced, offset and oversized frames, transparency, comments;
           PNG at every colour type and depth), each JPEG's sha256 equal to
           the Pillow 12.1 bytes of the folder's manifest; extern/timm_shim
           building every tower id it models (meta device); version.
  kernels  the flash-attention forward kernel against its plain torch
           version at the serving path's shapes (bf16, H=32, D=128 and
           Phi-2's D=80, ragged lengths, B in {1, 4}) and at GQA, S > T,
           window and fp32 cases (D=80 too);
           the two backward kernels (dQ, dK/dV) against the plain backward
           at the training shape (B=16, T=S=352, bf16, ragged lengths) and
           at the same four other cases, element by element (GRAD_TOL),
           with exactly zero gradient for dead key slots; the two int4
           kernels (int4_mm_a8, int4_mm) against their plain versions at
           the three 7B projection shapes (a8 at M 1, 352, 1408; bf16 at M
           1, 352, 5632) and Phi-2's three (a8 at M 1, 4, 352, 1408: K 2560
           in 20 groups, 10240 in 80; bf16 at its QLoRA M 5888), groups 256
           and 512, fp32 activations, shard-blocked
           packs, ragged M and the a8 kernels' edges (M 4, 16, 17, 65;
           w_down's split-K split does not divide its 86 groups), element
           by element (INT4_TOL); the quantize_a8 kernel bit-equal to
           quantize_activations_per_token (zero rows, rounding ties; a row
           holding a NaN gets a NaN scale in both) and the w4a8 route (quantize_a8, then int4_mm_a8
           with the token scale in its epilogue) bit-equal to its plain
           composition. Then each kernel, its plain version, a PyTorch
           yardstick (F.scaled_dot_product_attention with the equivalent
           boolean mask, forward or autograd backward, the backward pinned to
           the memory-efficient backend and timed as the median of 5 rounds
           interleaved with the kernels; F.linear over the int4 weight
           dequantized to bf16 ahead of time; the port never calls either)
           and the bound from bytes and operations, with each timed shape's
           share of the bound and its ratio to the yardstick. The timings
           are CUDA events around back-to-back wrapper calls (the earlier
           series), and for int4_mm_a8 (M=1, 352, the 7B's and Phi-2's
           shapes), its F.linear yardstick, quantize_a8 and flash_fwd (B=1,
           D=128 and 80) also device-side: a captured CUDA
           graph of launches, the int4 weights rotated over >= 100 MB of
           copies so that every launch reads them cold, as a decode pass does.
  moe      DeepSeek-V2-Lite's kernels at its widths (no model): the routed
           experts (ops/moe.py: router, top-6, counts and offsets, the grouped
           gated and down products, the combine; E 64, D 2048, I 1408)
           against their plain per-expert version at the decode shape (M 1)
           and the prefill's (M 352: 2112 picks over 64 experts), element by
           element (MOE_TOL), and the flash forward's (D 192, Dv 128)
           instance against the plain forward at the prefill (B 1, T 352, H
           16, YaRN's softmax scale); each timed (CUDA events over back-to-
           back calls) beside its plain version, its bound and, for the flash
           instance, F.scaled_dot_product_attention; a captured graph of one
           MoE call replayed, whose expert load equals the eager one.
  ring     the ring attention's per-block compute (ops/ring_attention.py) on
           the card: a virtual ring of n = 2, 4 and 8 blocks of one bf16
           sequence (B=2, T=2304, the 7B's 32 heads, D=128; Mistral's GQA
           32/8 at n=4), through the block functions the ranks call with the
           rotations replaced by indexing; the blocks' kernels write fp32
           o, dq, dk and dv, merged and summed in fp32 and cast once, as the
           JAX ring. Held to JAX's arithmetic (the plain whole-sequence
           forward and backward on the inputs upcast to fp32, cast once):
           o within FWD_ATOL, lse 1e-3, the ring's own gradients under
           GRAD_TOL per element; given the whole-sequence kernel's o and
           lse, the gradients under GRAD_TOL of the whole-sequence kernels';
           the gap of the ring's own gradients to those kernels logged;
           n (n + 1) / 2 launches of each flash kernel per ring pass,
           exactly. CUDA event times of the ring's forward and backward
           beside the whole-sequence kernels'; the kernels at one full and
           one diagonal block of the 8-block ring (bf16 and fp32 outputs,
           the fp32 ones against the plain versions with fp32 out_dtype)
           and at a tensor=2 rank's LoRA step (16 heads, B=16, T=352),
           beside the plain versions, SDPA and the bound.
  load     right after the 7B's random weights are drawn: write them in the
           published HF layout (bf16, three shards with an index,
           config.json, dataset_statistics.json; plus the source-only tensors
           a published file carries: each tower's final norm and SigLIP's
           attention-pooling head) through the port's safetensors writer, the
           core keys and shapes equal to tests/golden/hf_export_manifest_
           openvla7b.json; then load_vla onto the card, cold (the files'
           pages dropped first) and page-cache warm: bf16 leaves bit-equal to
           the in-memory params; quantize_int8 and quantize_int4 on load
           bit-equal to quantize_llm_int8 / quantize_llm_int4 of them, with
           equal batch-1 ids. Seconds, GB/s, host peak RSS and device peak of
           each load; the first /act of the loaded model. Then a subprocess
           `python -m bridgelang_tpu_torch.deploy --checkpoint <dir>
           --quantize_int4 true` answers 3 /act equal to the in-process int4
           predict_action (time to listen, /act median). Every later phase
           serves and trains the bf16 weights this phase loaded.
  cold     only those device-side timings (not in the default run); with
           --package-root DIR they time another checkout's kernels (an
           earlier commit unpacked with git archive), for before-and-after
           on one card.
  serve    OpenVLA-7B (prism-dinosiglip-224px+7b) at full width in bf16,
           random weights drawn on the card from a seed, served through
           replayed CUDA graphs (models/graphs.py) and, for comparison,
           eagerly. The prefill argmax must differ between two frames; the
           graphs of the batch buckets 1, 2 and 4 are captured first (peak
           GB after each); replayed ids must equal eager generate_greedy ids
           at B=1 and B=4. Prefill and decode times, graph and eager; a CUDA
           event reading of one replay; a torch.profiler pass over batch-1
           predicts of each (device time, idle share, launches, top kernels).
           The port's VLAServer (greedy) answers POST /act: batch-1
           requests, then one micro-batch of 4 concurrent requests, through
           the graphs and then eagerly. Kernel launch counts are zeroed
           before and read after: each model pass must launch the flash
           kernel once per decoder layer (32), replays counting what their
           capture recorded.
  spec     batch-1 speculative decoding through the graph pair (verify,
           then fix-up steps) on the bf16, the int8 and the int4 7B:
           garbage, perfect and partial drafts give greedy's ids at the
           0.25 margin (accept counts printed); calibrate_speculative_margin
           on 4 frames; the server's default mode (drafts from its own
           history) over 8 ticks of slowly drifting frames, against a greedy
           server on the same ticks: /act medians, accept counts, ids equal
           on every tick, 32 flash_fwd per predict (and for int4 whole
           decoder passes of 224 int4_mm_a8 and quantize_a8). In the parity
           phase: the depth-cut fp32 model with an fp32 KV cache gives
           greedy's ids exactly for four draft kinds.
  parallel parallel_decode on the bf16 7B: POST /act with horizon=8 answers
           an [8, 7] chunk of finite floats from one masked forward that
           launches no flash_fwd; its /act beside greedy's.
  train    LoRA fine-tuning of the same bf16 7B weights: r=32 fp32
           adapters on all seven projections, adapter-only AdamW (lr 5e-4,
           constant), batch 16 from DummyDataset through RLDSBatchTransform
           and the collator (96 tokens + 256 patches = 352), raw frames
           preprocessed in the step, full remat. One warm step, 6 timed
           steps: each must launch flash_fwd 64 times (32 layers, forward
           and recompute) and each backward kernel 32 times; losses finite
           and falling. One profiled step; then one warm and 2 timed
           steps under "dots" remat (scripts/finetune.py's default), with
           the same launch counts; then CheckpointManager.save of the LoRA
           state (frozen base dropped), restore into a fresh state, and one
           step from each of the restored and the uninterrupted state (bit-
           equal, else 1e-6 relative); then merge the adapters and predict
           one action through the merged weights.
  int8     the same decoder quantized by quantize_llm_int8 (int8 embedding
           and head), LLMConfig.w8a8 on, served as `serve`: model and peak
           GB; every projection of the prefill (T=352) must take the int8 x
           int8 product (torch._int_mm) and every decode projection the
           weight cast; the device time of one decode step's casts and their
           share of a predict's device time.
  int4     the same decoder packed to int4 by quantize_llm_int4 (group
           128; int8 embedding and head) and the bf16 layers freed; with
           LLMConfig.w8a8 on, served as `serve`: every decoder pass must
           launch int4_mm_a8 and quantize_a8 224 times each (7 projections
           x 32 layers), 7 passes per predict, and each predict flash_fwd 32
           times (the prefill); model and peak GB.
  qlora    r=32 fp32 adapters over that int4 base with w8a8 off, as `train`
           (batch 16, 352 tokens, full remat, one warm and 6 timed steps):
           each step launches int4_mm 448 times (forward and recompute) and
           the flash kernels 64/32/32; losses finite and falling; merge into
           the int4 base (dequantize, add, requantize) and predict one
           action through the merged int4 weights.
  variants the decoder variants, random bf16 weights from the seed: the int8
           KV cache on the bf16 7B (before int4 packs it); Phi-2
           (prism-phi-dinosiglip+3b, cut to 16 of its 32 layers, head dim
           80) served through graphs (ids equal to eager at B=1 and B=4, 16
           flash_fwd per predict) and VLAServer, the int8 KV cache on it, 3
           LoRA steps (B=16, 112 + 256 tokens, full remat: 32/16/16 flash
           launches per step, losses finite), then packed to int4 and served
           w4a8 (96 int4_mm_a8 and quantize_a8 per decoder pass), then 3
           QLoRA steps over the int4 base with w8a8 off (192 int4_mm per step
           at Phi's shapes, 32/16/16 flash launches, losses finite), merged and
           predicting through the merged int4 weights; Mistral
           (prism-mistral-dinosiglip+7b) cut to 4 of its 32 layers (ids equal
           to eager, 8 flash_fwd per predict). The int8 cache: ids of graphs
           equal to eager, teacher-forced logits within 0.05 max|logit| of
           the bf16 cache's (the argmax equal where the margin clears twice
           that), the server's speculative default off, cache GB at B=4 and
           decode ms per token at B=1 and B=4 for both dtypes.
  tfds     TFDS datasets read without TensorFlow: every image fixture of
           tests/data/images decoded on this host, hashed against the
           manifest of tf.io.decode_image's output (uint8 and float32), and
           the host's ms per 256x256 JPEG frame; then a TFDS directory in
           LIBERO's layout (24 episodes x 50 steps, two JPEG cameras from
           the fixtures, 4 shards, dataset_info.json and features.json) and
           a small fractal20220817_data one (the action a dict), written
           with the port's tf.train.Example serializer; finetune.main on the
           load phase's published-layout 7B over the TFDS root (bf16 LoRA
           r=32, batch 16, 6 steps, 64/32/32 flash launches per step, the
           statistics against numpy's quantiles), then train.main at full
           width with 2 decoder layers over a mixture of both datasets (4
           steps, frames drawn from each). Host wait per batch and step ms
           beside the native store's (finetune phase). `build` also compiles
           the port's host library (g++: TFRecord framing, image decoding).
  scripts  the port's demo and generate entry points on the load phase's
           published-layout 7B with their defaults (int8 w8a8 on load) and a
           committed 640x480 JPEG read by open_rgb: demo.main's action equal
           to predict_action's on the same frame; generate.main with two
           turns on standard input and 64 new tokens, each reply's ids
           equal to generate_greedy's on the conversation's prompt; the eager
           int8 prefill ms and decode ms per token.
  robot    robot evaluation on the load phase's published-layout 7B:
           verify.main (int8 w8a8 on load, 8 calls, its default 16: p50,
           p90, finite actions, 32 flash_fwd per predict), --golden_record
           then --golden on the bf16 load (every record's tokens exact),
           --speculative_stream (8 ticks: the accept histogram) and
           --quantize_int4 (8 calls, 224 int4_mm_a8 and quantize_a8 per
           decoder pass); inspect_checkpoint.main on the published 7B and on a
           port run dir (tensors and bytes as written); run_libero_eval.main
           over a fake `libero` package (256 px, center crop, 1 task x 2
           episodes x 8 steps) in greedy mode (each action equal to
           predict_action's on the cropped frame), speculative (each tick's
           ids equal to greedy's), remote (RemoteVLA against
           VLAServer.serve_background on the card: actions equal to
           in-process) and chunk mode (--action_chunk 8: one model pass per 8
           ticks), with each mode's closed-loop rate; run_bridgev2_eval.main
           over a fake WidowX stack with the prompts answered, 2 episodes of
           10 steps (every step sent, the achieved rate against 5 Hz, the
           policy's ms per step).
  finetune the port's entry points over a native episode store that the
           phase writes (LIBERO's layout: 24 episodes x 50 steps, 256x256
           frames from two cameras, 7-D actions, 8-D states), read through
           the TF-free pipeline by the dataset's worker processes:
           finetune.main on the load phase's published-layout 7B (bf16 LoRA
           r=32, batch 16, image_aug, 6 steps, the bf16 HF export loaded
           back and serving one action under the store's statistics), int8
           QLoRA (3 steps, no int8 code moves, the merge against the plain
           formula), the parallel objective (--action_chunk 8, full remat: no
           flash launch, peak under the train phase's dots peak; an [8, 7]
           chunk from the trained weights), and train.main at full width with
           2 decoder layers (5 steps; resumed from the step-4 checkpoint, the
           5th step bit-equal). The entry points run unchanged; the phase
           times their steps, batches, saves and exports from outside, and
           profiles steps 3-6.
  mesh     multi-GPU at world size W = the visible cards (1 on a one-card
           machine), on the load phase's published-layout 7B, run inside the
           finetune phase (which it needs): `deploy --checkpoint <dir>
           --mesh_spec tensor=W` (int8 w8a8, the default; one process at
           W = 1, torchrun otherwise) answers 3 /act (a zero draft, so the
           response carries the ids) with ids and actions equal to the
           in-process predict_action_speculative of the same load; the same
           with --quantize_int4 true --int4_shards W (skipped where the card's
           int4 rule refuses the shard-local shapes; every decoder pass
           launches 224 int4_mm_a8 and 224 quantize_a8, the row-parallel
           wo / w_down quantized with the group's absmax); each prints the
           collectives per predict (/stats: the decoder's all-reduces and the
           logits' gathers, replayed inside the CUDA graphs) and its /act
           median beside the same deploy's without --mesh_spec, started
           with it and answering the same requests (the baseline of this
           run); then finetune.main --mesh_shape fsdp=W and again with
           tensor=W (the decoder tensor-parallel: its adapters used by
           block, the loss over the vocabulary blocks) for 3 steps each over
           the finetune phase's store with its first run's flags: losses
           bit-equal to that run's first 3 at W = 1 (its one-rank NCCL group
           released after), collectives per step, step ms, peak GB; after
           the finetune phase's train.main runs, train.main --attention_impl
           ring --vla.mesh_shape fsdp=W on the same 2-layer cut for 2 steps:
           at W = 1 the ring's axis has one rank (the JAX rule's fallback,
           the flash kernels) and the losses are bit-equal to the run
           without the flag. It prints the NCCL version and says when no
           collective crossed a device; with more than one card tensor=2
           and fsdp=2 run as well (and fsdp=2,tensor=W/2 from 4 cards), the
           ring then runs over fsdp=W.
  pretrain VLM pretraining through pretrain.run (what pretrain.main runs),
           random fp32 weights from the seed, over a LLaVA-layout directory
           written here (558k-shaped captions, mix665k-shaped chats with
           text-only ones past the bucket, images from the committed
           fixtures), 16 x (2048 + 256) fused tokens per micro-batch, "full"
           remat, grad_accum 2, 4 micro-steps per stage: every fixture read
           to Pillow's manifest hashes first; the align stage on the 7B at
           full width, cut to 4 of 32 decoder layers (only the projector changes; the epoch-end
           checkpoint of the whole state read back for the projector and its
           moments, bit-equal; 8/4/4 flash launches per micro-step); the
           finetune stage on the 7B cut to 2 decoder layers (LLM and
           projector change, the towers do not); then the flash kernels at
           T = 2304 against their plain versions (B = 2, the runs' lengths)
           and timed at B = 16 beside SDPA and the bound. Step ms, padded
           and real tokens/s, useful-FLOP share, peak GB, host ms per batch,
           save s and GB.
  parity   a depth-cut fp32 model with the same weights on the card
           (through the kernels) and on the CPU (plain versions): the
           action token ids must be equal, and one LoRA train step must
           give the same loss (1e-5 relative) and adapter gradients
           (1e-4 of max |g|); then the same cut packed to int4: equal ids
           with w8a8 on and off, and one QLoRA step under the same rule; the
           cut quantized to int8: equal ids with w8a8 off, and with it on
           teacher-forced logits within 0.05 max|logit| (argmax equal where
           the CPU's top-2 margin clears twice that); greedy over the int8 KV
           cache: equal ids. The fp32 cut is also exported
           (export_checkpoint) and loaded back with load_vla on the card:
           leaves bit-equal, batch-2 ids equal. Then a 2-layer fp32 Phi-2 cut
           (the kernels at head dim 80, biases drawn): equal ids and one LoRA
           step under the same rule; a 2-layer fp32 Mistral cut with its
           window at 64, below the 352-token prefill: equal ids. And a
           golden bundle recorded by verify.record_golden on the CPU from the
           fp32 cut replays on the card (verify.replay_golden) token-exact.
Then one line {"kernels": [...]}, the nvidia-smi line, and as the last line
{"ok": true, "device": {...}}. Without a CUDA card, or outside a checkout,
it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12         # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense bf16 tensor cores; fp32 outside them
N_LAYERS_7B = 32
SEED = 0                 # random weights are drawn on the card from this seed
N_SINGLE_REQUESTS = 5    # batch-1 /act requests in the serve phase
TRAIN_BATCH = 16         # scripts/finetune.py's per-device batch
TRAIN_MAX_LEN = 96       # collator bucket: 96 tokens + 256 patches = 352
TRAIN_STEPS = 6          # timed steps after one warm step
LORA_RANK = 32           # scripts/finetune.py: r=32, "all-linear"
LORA_LR = 5e-4
TRAIN_T = TRAIN_MAX_LEN + 256  # fused length of a training example
PHI_TRAIN_MAX_LEN = 112  # the phi prompt format ("<|endoftext|>Input: ...\nOutput: ") is 100 byte-tokens
PHI_TRAIN_T = PHI_TRAIN_MAX_LEN + 256
DOTS_STEPS = 2           # timed "dots"-remat steps after one warm step
BWD_ROUNDS = 5           # interleaved rounds of the backward timing (median)

# Attention cases that both the forward and the backward check run.
# name: (b, t, s, h, hkv, d, lengths, window, dtype)
ATTENTION_CASES = {
    "train_b16": (16, TRAIN_T, TRAIN_T, 32, 32, 128, [TRAIN_T - (37 * i) % 90 for i in range(16)], None,
                  "bfloat16"),  # ragged: 352 down to 266
    "gqa_hkv8": (2, 304, 304, 32, 8, 128, [304, 262], None, "bfloat16"),
    "keys_longer": (2, 304, 311, 32, 32, 128, [304, 250], None, "bfloat16"),
    "window100": (2, 304, 304, 32, 32, 128, [304, 280], 100, "bfloat16"),
    "fp32_d64": (2, 200, 200, 8, 8, 64, [200, 150], None, "float32"),
    # Phi-2's head dim 80 (2560 / 32): the LoRA step's shape, GQA and fp32 (the parity cut)
    "phi_train_b16": (16, PHI_TRAIN_T, PHI_TRAIN_T, 32, 32, 80, [PHI_TRAIN_T - (37 * i) % 90 for i in range(16)],
                      None, "bfloat16"),
    "phi_gqa_hkv8": (2, TRAIN_T, TRAIN_T, 32, 8, 80, [TRAIN_T, 301], None, "bfloat16"),
    "phi_fp32_d80": (2, TRAIN_T, TRAIN_T, 32, 32, 80, [TRAIN_T, 290], None, "float32"),
    # Mistral's GQA with a window below the sequence: the parity cut's fp32 shape
    "mistral_window64_fp32": (2, TRAIN_T, TRAIN_T, 32, 8, 128, [TRAIN_T, 300], 64, "float32"),
}
BWD_TIMED = ("train_b16", "phi_train_b16")  # the LoRA steps' shapes (7B D=128, Phi-2 D=80)
# Forward o, absolute: kernel and plain both accumulate in fp32 and round once
# (half a bf16 ulp is <= 0.008 for |o| < 4), so bf16 allows one ulp apart.
FWD_ATOL = {"bfloat16": 2e-2, "float32": 1e-4}
# Gradients, per element: |got - want| <= rtol * |want| + atol * rms(want).
# bf16: kernel and plain both sum in fp32 and round once, so they may sit one
# bf16 ulp apart, and an ulp is <= 2^-7 |want|; the rms term admits the fp32
# order differences of a sum that cancels near zero. fp32: order differences
# only. A kernel that drops a tile's share of a sum moves entries by about a
# typical entry, far past either term.
GRAD_TOL = {"bfloat16": (2.0 ** -7, 1e-3), "float32": (1e-5, 1e-5)}
# The int4 kernels against their plain versions, per element as GRAD_TOL.
# a8: the f32 output before the token scale; the group sums are exact
# integers on both sides, so only the fp32 order of the scale-accumulate may
# differ (the kernel follows the plain order, so 0 is expected). bf16: one
# bf16 ulp plus 1e-3 rms, as GRAD_TOL. fp32: order only.
INT4_TOL = {"a8": (1e-5, 1e-6), "bfloat16": (2.0 ** -7, 1e-3), "float32": (1e-5, 1e-5)}
INT4_GROUP = 128         # quantize_llm_int4's default group, the serving pack
INT4_SHAPES_7B = {"wq": (4096, 4096), "w_gate": (4096, 11008), "w_down": (11008, 4096)}  # (K, N) per projection
# Phi-2's projections: K 2560 (20 groups of 128) or 10240 (80 groups)
INT4_SHAPES_PHI = {"phi wq": (2560, 2560), "phi w_up": (2560, 10240), "phi w_down": (10240, 2560)}
# The blocks a rank holds under tensor parallelism (deploy --mesh_spec tensor=T --int4_shards T): the 7B's
# column blocks and K-row shards at T=2 (wo's 2048 rows in 16 groups, w_down's 5504 in 43: its split-K over
# 43 groups), and the 13B's w_gate/w_up column block at T=4 (N/2 = 1728)
INT4_SHAPES_TP = {"t2 wq block": (4096, 2048), "t2 w_gate block": (4096, 5504), "t2 wo rows": (2048, 4096),
                  "t2 w_down rows": (5504, 4096), "13b t4 w_gate block": (5120, 3456)}
INT4_SHAPES = {**INT4_SHAPES_7B, **INT4_SHAPES_PHI, **INT4_SHAPES_TP}
# The int8 weight-only GEMV at Mistral-7B's (K, N) (wo is wq's shape, wv wk's, w_up w_gate's) and its int8
# head; Phi-2's projections and head for the check only. Timed at every M it may route, 1 to 16.
INT8_GEMV_SHAPES = {"wq": (4096, 4096), "wk": (4096, 1024), "w_gate": (4096, 14336), "w_down": (14336, 4096),
                    "head": (4096, 32000)}
INT8_GEMV_PHI = {"phi wq": (2560, 2560), "phi w_up": (2560, 10240), "phi w_down": (10240, 2560),
                 "phi head": (2560, 51200)}
INT8_GEMV_MS = (1, 2, 4, 8, 16)
PHI_QLORA_M = 16 * 368  # int4_mm's M in a Phi-2 QLoRA step: B = 16 x (112 + 256) fused tokens
INT4_PER_PASS = 7 * N_LAYERS_7B   # int4 launches per decoder pass: 7 projections x 32 layers
ACTION_DIM = 7           # decoder passes per predict: the prefill and 6 decode steps
# int8_gemv launches: an int8 7B decode step runs its 224 projections and the int8 head through it (225); a
# predict adds the prefill's head row (its projections, 352 rows, stay w8a8). An int4 decoder's int8 head
# takes it once per pass.
INT8_GEMV_PER_STEP = 7 * N_LAYERS_7B + 1
INT8_GEMV_PER_PREDICT = (ACTION_DIM - 1) * INT8_GEMV_PER_STEP + 1
INT8_PER_PREDICT = {"flash_fwd": N_LAYERS_7B, "int8_gemv": INT8_GEMV_PER_PREDICT}
INT4_PER_PREDICT = {"flash_fwd": N_LAYERS_7B, "int4_mm_a8": ACTION_DIM * INT4_PER_PASS,
                    "quantize_a8": ACTION_DIM * INT4_PER_PASS, "int8_gemv": ACTION_DIM}
QLORA_STEPS = 6          # timed QLoRA steps after one warm step
PEAK_OPS = {"a8": 1979e12, "bfloat16": 989e12, "float32": 67e12}  # int8 and bf16 tensor cores; fp32 FMAs
KERNEL_NAMES = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "int4_mm_a8", "int4_mm", "quantize_a8", "int8_gemv")
# substrings of the kernels' names in a profiler trace ("int4_mm_a8_": the split-K and the wgmma kernel)
PROFILE_NAMES = {"flash_fwd": "flash_fwd", "flash_bwd_dq": "flash_bwd_dq", "flash_bwd_dkv": "flash_bwd_dkv",
                 "int4_mm_a8": "int4_mm_a8_", "quantize_a8": "quantize_a8_kernel",
                 "int4_mm bf16": "int4_mm_bf16_wgmma", "int4_mm bf16 M<=64": "int4_mm_tc_kernel",
                 "int4_mm fp32": "int4_mm_f32"}
COLD_BYTES = 100e6       # weight copies rotated per timed launch: twice the 50 MB L2, so each launch reads cold
GRAPH_LAUNCHES = 60      # launches per captured graph in the device-side timings
SPEC_TICKS = 8           # server ticks of one instruction in the spec phase
HORIZON = 8              # the parallel phase's chunk length


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# --- phase 2: kernel against plain ------------------------------------------------


def attention_case(b, t, s, h, hkv, d, lengths, window, dtype, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, t, h, d), generator=g, device="cuda", dtype=dtype)
    k = torch.randn((b, s, hkv, d), generator=g, device="cuda", dtype=dtype)
    v = torch.randn((b, s, hkv, d), generator=g, device="cuda", dtype=dtype)
    return q, k, v, torch.tensor(lengths, dtype=torch.int32, device="cuda")


def valid_mask(t, s, lengths, window, device="cpu"):
    """[B, T, S] bool: key c is attended by row r (causal, length, window)."""
    import torch

    r = torch.arange(t, device=device)[:, None]
    c = torch.arange(s, device=device)[None, :]
    m = (c <= r)[None] & (c[None] < torch.as_tensor(lengths, device=device)[:, None, None])
    if window is not None and window < s:
        m = m & (c > r - window)[None]
    return m


def read_keys(mask, k) -> int:
    """Bytes of k (or of v) that the function must read: the keys that some
    row attends under `mask` [B, T, S]. A key at or past its row's length is
    never read (the kernels stop at the length's last block)."""
    _, _, hkv, d = k.shape
    return int(mask.any(dim=1).sum()) * hkv * d * k.element_size()


def bound_ms(q, k, v, lengths, window):
    """Least time for the function: max(bytes moved / HBM rate, FLOPs / peak).
    Bytes: q and lengths read once, k and v read once for each key some row
    attends (read_keys), o and lse written once. FLOPs: 4*D per attended
    (row, key) pair (QK^T and PV); both counted from this run's lengths."""
    b, t, h, d = q.shape
    s = k.shape[1]
    mask = valid_mask(t, s, lengths.cpu().tolist(), window)
    n_bytes = 2 * q.numel() * q.element_size() + 2 * read_keys(mask, k) + 4 * b * h * t + 4 * b
    pairs = int(mask.sum()) * h
    flops = 4.0 * d * pairs
    peak = PEAK_FLOPS[str(q.dtype).replace("torch.", "")]
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def bwd_bound_ms(q, k, lengths, window, which):
    """Least time for one backward kernel's function: max(bytes / HBM rate,
    FLOPs / peak). Bytes: q, dO, lengths read once, k and v read once for
    each key some row attends (read_keys), lse and delta (f32 [B, H, T])
    read once, the outputs (dq; or dk and dv, dead keys' zeros included)
    written once. FLOPs per attended (row, key) pair: dq needs S, dP and dS.K
    (6 D); dk/dv need S, dP, P^T.dO and dS^T.Q (8 D); the whole backward 10 D."""
    b, t, h, d = q.shape
    s = k.shape[1]
    e = q.element_size()
    mask = valid_mask(t, s, lengths.cpu().tolist(), window)
    inputs = 2 * q.numel() * e + 2 * read_keys(mask, k) + 2 * 4 * b * h * t + 4 * b
    outputs = {"dq": q.numel() * e, "dkv": 2 * k.numel() * e, "both": (q.numel() + 2 * k.numel()) * e}[which]
    pairs = int(mask.sum()) * h
    flops = {"dq": 6, "dkv": 8, "both": 10}[which] * d * pairs
    peak = PEAK_FLOPS[str(q.dtype).replace("torch.", "")]
    t_bytes, t_ops = (inputs + outputs) / HBM_BYTES_PER_S, flops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def grad_tolerance_use(got, want, rule=None) -> float:
    """The share of GRAD_TOL that `got` uses against `want`: the max over
    elements of |got - want| / (rtol |want| + atol rms(want)). Above 1 fails.
    `rule`: GRAD_TOL's key, by default want's dtype (an fp32 output of bf16
    inputs is held to the bf16 rule: its error is the bf16 operands')."""
    import torch

    rtol, atol = GRAD_TOL[rule or str(want.dtype).replace("torch.", "")]
    w = want.float()
    allowed = (rtol * w.abs() + atol * w.square().mean().sqrt()).clamp_min(torch.finfo(torch.float32).tiny)
    return float(((got.float() - w).abs() / allowed).max())


def jax_arithmetic_ring_reference(q, k, v, do, causal: bool = True):
    """What the JAX ring (bridgelang_tpu/ops/ring_attention.py, fp32 einsums
    per block, one cast at the end) computes for these bf16 inputs, up to
    fp32 summation order: the plain whole-sequence forward and backward on
    q, k, v and dO upcast to fp32, o and the gradients cast to the inputs'
    dtype once. Returns (o, lse, (dq, dk, dv))."""
    from bridgelang_tpu_torch.ops.flash_attention import flash_attention_bwd_plain, flash_attention_plain

    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    o, lse = flash_attention_plain(qf, kf, vf, causal=causal)
    grads = flash_attention_bwd_plain(qf, kf, vf, o, lse, dof, causal=causal)
    return o.to(q.dtype), lse, tuple(g.to(x.dtype) for g, x in zip(grads, (q, k, v)))


def check_backward_kernels():
    """dq, dk, dv from the kernels against flash_attention_bwd_plain under
    GRAD_TOL, then timings at the training shapes (BWD_TIMED)."""
    import torch

    from bridgelang_tpu_torch.ops.flash_attention import (
        flash_attention_bwd_plain, flash_attention_plain, flash_bwd_dkv, flash_bwd_dq)

    worst = {"dq": 0.0, "dkv": 0.0}
    readings, timing = {}, {}
    for i, (name, (b, t, s, h, hkv, d, lengths, window, dtype_name)) in enumerate(ATTENTION_CASES.items()):
        dtype = getattr(torch, dtype_name)
        q, k, v, lens = attention_case(b, t, s, h, hkv, d, lengths, window, dtype, seed=200 + i)
        do = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(300 + i), device="cuda",
                         dtype=dtype)
        o, lse = flash_attention_plain(q, k, v, lengths=lens, causal=True, window=window)
        delta = (do.float() * o.float()).sum(dim=-1).transpose(1, 2).contiguous()
        dq = flash_bwd_dq(q, k, v, do, lse, delta, lens, True, window)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, lens, True, window)
        torch.cuda.synchronize()
        pdq, pdk, pdv = flash_attention_bwd_plain(q, k, v, o, lse, do, lens, True, window)
        r = {}
        for what, got, want in (("dq", dq, pdq), ("dk", dk, pdk), ("dv", dv, pdv)):
            if not torch.isfinite(got).all():
                fail(f"backward case {name}: non-finite {what}")
            w = want.float()
            r[what] = dict(err=(got.float() - w).abs().max().item(), use=grad_tolerance_use(got, want),
                           max=w.abs().max().item(), rms=w.square().mean().sqrt().item())
        dead = max(max(dk[bi, L:].abs().max().item(), dv[bi, L:].abs().max().item()) if L < s else 0.0
                   for bi, L in enumerate(lengths))
        ok = all(x["use"] <= 1.0 for x in r.values()) and dead == 0.0
        log(f"kernel bwd {name}: B={b} T={t} S={s} H={h} Hkv={hkv} D={d} {dtype_name} window={window} "
            f"rule |err| <= {GRAD_TOL[dtype_name][0]:.3g}|g| + {GRAD_TOL[dtype_name][1]:g} rms(g); "
            + "; ".join(f"{w} max|err| {x['err']:.3e} tolerance use {x['use']:.3g} (max|g| {x['max']:.4g}, "
                        f"rms {x['rms']:.4g})" for w, x in r.items())
            + f"; dead-key dk/dv {dead} {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"flash backward kernels disagree with the plain backward in case {name}")
        readings[name] = r
        worst["dq"] = max(worst["dq"], r["dq"]["err"])
        worst["dkv"] = max(worst["dkv"], r["dk"]["err"], r["dv"]["err"])

        if name in BWD_TIMED:
            timing[name] = time_backward(name, q, k, v, do, lse, delta, lens, window)
            timing[name]["plain_ms"] = cuda_ms(
                lambda: flash_attention_bwd_plain(q, k, v, o, lse, do, lens, True, window), 5)
            log(f"timing bwd {name}: plain backward {timing[name]['plain_ms']:.4f} ms")
    return timing, worst, readings


def time_backward(name, q, k, v, do, lse, delta, lens, window) -> dict:
    """The backward kernels against the yardstick at one shape: each the
    median of BWD_ROUNDS rounds, kernels and SDPA's backward interleaved
    (kernels, SDPA, SDPA, kernels, ...). SDPA runs pinned to the
    memory-efficient backend (it takes the boolean mask), so the yardstick
    is the same kernel in every run; the log names the backward it ran."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from bridgelang_tpu_torch.ops.flash_attention import flash_bwd_dkv, flash_bwd_dq

    b, t, h, d = q.shape
    s = k.shape[1]
    lengths = lens.tolist()
    mask = valid_mask(t, s, lengths, window, device="cuda")[:, None]
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
    dot = do.transpose(1, 2)
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
    backend = type(out.grad_fn).__name__

    def sdpa_ms():
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return cuda_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True), 20)

    readings = {"dq": [], "dkv": [], "sdpa": []}
    for r in range(BWD_ROUNDS):
        for what in (("kernels", "sdpa") if r % 2 == 0 else ("sdpa", "kernels")):
            if what == "sdpa":
                readings["sdpa"].append(sdpa_ms())
            else:
                readings["dq"].append(cuda_ms(lambda: flash_bwd_dq(q, k, v, do, lse, delta, lens, True, window), 20))
                readings["dkv"].append(cuda_ms(lambda: flash_bwd_dkv(q, k, v, do, lse, delta, lens, True, window), 20))
    dq_ms, dkv_ms, library_ms = (statistics.median(readings[w]) for w in ("dq", "dkv", "sdpa"))
    # For the record only: the backend SDPA picks unpinned, and its backward's time.
    out_default = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
    default_ms = cuda_ms(lambda: torch.autograd.grad(out_default, (qt, kt, vt), dot, retain_graph=True), 20)
    default_backend = type(out_default.grad_fn).__name__
    bounds = {w: bwd_bound_ms(q, k, lens, window, w) for w in ("dq", "dkv", "both")}
    log(f"timing bwd {name}: median of {BWD_ROUNDS} interleaved rounds: dq {dq_ms:.4f} ms (bound "
        f"{bounds['dq'][0]:.4f} ms, {bounds['dq'][1]}), dk/dv {dkv_ms:.4f} ms (bound {bounds['dkv'][0]:.4f} ms, "
        f"{bounds['dkv'][1]}), pair {dq_ms + dkv_ms:.4f} ms; sdpa backward (yardstick, backend "
        f"EFFICIENT_ATTENTION, grad_fn {backend}) {library_ms:.4f} ms (unpinned: grad_fn {default_backend}, "
        f"{default_ms:.4f} ms); "
        f"whole-backward bound {bounds['both'][0]:.4f} ms ({bounds['both'][1]}); readings "
        + json.dumps({w: [round(x, 4) for x in xs] for w, xs in readings.items()}))
    return dict(shape=f"B={b} T={t} S={s} H={h} D={d} bf16 (lengths {min(lengths)}-{max(lengths)})", d=d,
                dq_ms=dq_ms, dkv_ms=dkv_ms, library_ms=library_ms, library_backend=backend,
                unpinned=dict(backend=default_backend, ms=default_ms), bounds=bounds, readings=readings)


def check_kernels(serve_t: int):
    import torch
    import torch.nn.functional as F

    from bridgelang_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain

    T = serve_t
    cases = {
        # name: (b, t, s, h, hkv, d, lengths, window, dtype)
        "serve_b1": (1, T, T, 32, 32, 128, [T - 21], None, "bfloat16"),
        "serve_b4": (4, T, T, 32, 32, 128, [T - 21, T - 9, T - 40, T - 77], None, "bfloat16"),
        "t304_b1": (1, 304, 304, 32, 32, 128, [290], None, "bfloat16"),
        "t304_b4": (4, 304, 304, 32, 32, 128, [304, 290, 271, 256], None, "bfloat16"),
        "phi_serve_b1": (1, T, T, 32, 32, 80, [T - 21], None, "bfloat16"),
        "phi_serve_b4": (4, T, T, 32, 32, 80, [T - 21, T - 9, T - 40, T - 77], None, "bfloat16"),
        # a rank's heads of the 7B under tensor parallelism: 16 at tensor=2, 8 at tensor=4
        "tp2_b1": (1, T, T, 16, 16, 128, [T - 21], None, "bfloat16"),
        "tp2_b4": (4, T, T, 16, 16, 128, [T - 21, T - 9, T - 40, T - 77], None, "bfloat16"),
        "tp4_b1": (1, T, T, 8, 8, 128, [T - 21], None, "bfloat16"),
        "tp4_b4": (4, T, T, 8, 8, 128, [T - 21, T - 9, T - 40, T - 77], None, "bfloat16"),
        **ATTENTION_CASES,
    }
    timed = ("serve_b1", "serve_b4", "t304_b1", "train_b16", "phi_serve_b1", "phi_serve_b4", "phi_train_b16",
             "tp2_b1", "tp2_b4", "tp4_b1", "tp4_b4")
    # lse is fp32 in both: only the summation order differs (atol 1e-3).
    rows, worst = [], {}
    for i, (name, (b, t, s, h, hkv, d, lengths, window, dtype_name)) in enumerate(cases.items()):
        dtype, tol = getattr(torch, dtype_name), FWD_ATOL[dtype_name]
        q, k, v, lens = attention_case(b, t, s, h, hkv, d, lengths, window, dtype, seed=100 + i)
        o, lse = flash_attention(q, k, v, lengths=lens, causal=True, window=window)
        torch.cuda.synchronize()
        po, plse = flash_attention_plain(q, k, v, lengths=lens, causal=True, window=window)
        err_o = err_lse = 0.0
        for bi, L in enumerate(lengths):
            n = min(L, t)
            if not torch.isfinite(o[bi, :n]).all():
                fail(f"kernel case {name}: non-finite output")
            err_o = max(err_o, (o[bi, :n].float() - po[bi, :n].float()).abs().max().item())
            err_lse = max(err_lse, (lse[bi, :, :n] - plse[bi, :, :n]).abs().max().item())
        ok = err_o <= tol and err_lse <= 1e-3
        log(f"kernel {name}: B={b} T={t} S={s} H={h} Hkv={hkv} D={d} {dtype_name} window={window} "
            f"max|o-plain|={err_o:.3e} (tol {tol}) max|lse-plain|={err_lse:.3e} (tol 1e-3) {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"flash kernel disagrees with its plain version in case {name}")
        worst[name] = err_o

        if name in timed:
            kernel_ms = cuda_ms(lambda: flash_attention(q, k, v, lengths=lens, causal=True, window=window), 100)
            plain_ms = cuda_ms(lambda: flash_attention_plain(q, k, v, lengths=lens, causal=True, window=window), 20)
            mask = valid_mask(t, s, lengths, window, device="cuda")[:, None]
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask), 100)
            b_ms, b_by = bound_ms(q, k, v, lens, window)
            rows.append(dict(case=name, shape=f"B={b} T={t} S={s} H={h} D={d} bf16", d=d, h=h, kernel_ms=kernel_ms,
                             plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms, bound_by=b_by,
                             bound_share=b_ms / kernel_ms, vs_library=kernel_ms / library_ms, max_abs_err=err_o))
            log(f"timing {name}: kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"sdpa (yardstick) {library_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}); "
                f"share of bound {b_ms / kernel_ms:.3f}, kernel / sdpa {kernel_ms / library_ms:.2f}")
    return rows, max(worst.values())


# --- phase ring: the ring attention's blocks on one card -----------------------------

RING_T = 2304            # pretraining's fused length (2048 + 256 patches)
RING_B = 2
RING_NS = (2, 4, 8)      # virtual ring sizes on the 7B's heads
RING_GQA_N = 4           # Mistral's GQA heads (32 / 8) at one ring size
RING_TIMED_REPS = 5
TP_TRAIN_SHAPE = (TRAIN_BATCH, TRAIN_T, 16, 16, 128)  # a tensor=2 rank's LoRA step: B, T, H, Hkv, D


def block_bound_ms(q, k, causal: bool, which: str, out_bytes: int = 0):
    """Least time for one ring block (every key valid): max(bytes / HBM rate,
    FLOPs / peak). Bytes: q, k, v read once, and o and lse written once
    ("fwd"); q, k, v, dO, lse and delta read once, and dq or dk and dv
    written once ("dq", "dkv"), the outputs in `out_bytes` per element
    (default the inputs'). FLOPs per attended (row, key) pair: 4 D forward,
    6 D for dq, 8 D for dk/dv; a diagonal block attends T (T + 1) / 2 pairs
    per head, a full block T S."""
    b, t, h, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    e = q.element_size()
    oe = out_bytes or e
    qb, kb, stats = b * t * h * d * e, b * s * hkv * d * e, 4 * b * h * t
    pairs = b * h * (t * (t + 1) // 2 if causal else t * s)
    n_bytes = {"fwd": qb * (1 + oe / e) + 2 * kb + stats, "dq": qb * (2 + oe / e) + 2 * kb + 2 * stats,
               "dkv": 2 * qb + kb * (2 + 2 * oe / e) + 2 * stats}[which]
    flops = {"fwd": 4, "dq": 6, "dkv": 8}[which] * d * pairs
    peak = PEAK_FLOPS[str(q.dtype).replace("torch.", "")]
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def ring_case(label: str, h: int, hkv: int, n: int, seed: int, timed: bool) -> dict:
    """One virtual ring of n blocks of a bf16 sequence of RING_T tokens on
    the card, through ops/ring_attention's block functions (the flash
    kernels with fp32 outputs, merged and summed in fp32, cast once), held
    to JAX's arithmetic (jax_arithmetic_ring_reference: the plain
    whole-sequence forward and backward on the inputs upcast to fp32, cast
    once): o within FWD_ATOL of it and of the whole-sequence kernel's, lse
    within 1e-3; the ring's own gradients (from its fp32 o and lse) under
    GRAD_TOL of it (`*_end_to_end`); given the whole-sequence kernel's o and
    lse, under GRAD_TOL of the whole-sequence kernels' gradients
    (`*_vs_whole_kernel`); exactly n (n + 1) / 2 launches of each flash
    kernel per ring pass. Logged, not gated: the ring's own gradients
    against the whole-sequence kernels' (`*_vs_whole_kernels_grad_tol`: those
    form delta from their bf16 o). With `timed`, CUDA event times of the
    ring's forward and backward beside the whole-sequence kernels'."""
    import torch

    from bridgelang_tpu_torch.ops.flash_attention import flash_attention, flash_attention_bwd
    from bridgelang_tpu_torch.ops.ring_attention import virtual_ring_backward, virtual_ring_forward

    q, k, v, _ = attention_case(RING_B, RING_T, RING_T, h, hkv, 128, [RING_T] * RING_B, None, torch.bfloat16, seed)
    do = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(seed + 1), device="cuda",
                     dtype=q.dtype)
    blocks = n * (n + 1) // 2
    o_w, lse_w = flash_attention(q, k, v, causal=True)
    whole = flash_attention_bwd(q, k, v, o_w, lse_w, do, causal=True)
    ref_o, ref_lse, ref = jax_arithmetic_ring_reference(q, k, v, do)
    reset_launch_counts()
    o, lse = virtual_ring_forward(q, k, v, n)
    expect_counts(launch_counts(), {"flash_fwd": blocks}, f"ring {label} n={n} forward")
    reset_launch_counts()
    grads = virtual_ring_backward(q, k, v, o, lse, do, n)
    expect_counts(launch_counts(), {"flash_bwd_dq": blocks, "flash_bwd_dkv": blocks}, f"ring {label} n={n} backward")
    given_whole = virtual_ring_backward(q, k, v, o_w, lse_w, do, n)
    launches = {"flash_fwd": blocks, "flash_bwd_dq": 2 * blocks, "flash_bwd_dkv": 2 * blocks}
    ob = o.to(q.dtype)
    err = {"o_vs_jax_arithmetic": (ob.float() - ref_o.float()).abs().max().item(),
           "o_vs_kernel": (ob.float() - o_w.float()).abs().max().item(),
           "lse_vs_plain": (lse - ref_lse).abs().max().item()}
    uses = {}
    for i, name in enumerate(("dq", "dk", "dv")):
        uses[f"{name}_end_to_end"] = grad_tolerance_use(grads[i], ref[i])
        uses[f"{name}_vs_whole_kernel"] = grad_tolerance_use(given_whole[i], whole[i])
        # for the record: the ring end to end against the whole-sequence kernels (delta from their bf16 o)
        uses[f"{name}_vs_whole_kernels_grad_tol"] = grad_tolerance_use(grads[i], whole[i])
    finite = all(torch.isfinite(x).all() for x in (o, *grads, *given_whole))
    ok = (finite and err["o_vs_jax_arithmetic"] <= FWD_ATOL["bfloat16"] and err["o_vs_kernel"] <= FWD_ATOL["bfloat16"]
          and err["lse_vs_plain"] <= 1e-3
          and max(u for key, u in uses.items() if not key.endswith("grad_tol")) <= 1.0)
    log(f"ring {label} n={n}: B={RING_B} T={RING_T} H={h}/{hkv} D=128 bf16, {blocks} blocks per pass: "
        + ", ".join(f"{key} {val:.3e}" for key, val in err.items()) + "; tolerance use "
        + ", ".join(f"{key} {val:.3g}" for key, val in uses.items()) + f" {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"ring {label} n={n}: the ring disagrees with JAX's arithmetic or the whole-sequence kernels")
    out = dict(n=n, heads=f"{h}/{hkv}", blocks=blocks, errors=err, tolerance_use=uses, launches=launches)
    if timed:
        ring_fwd = cuda_ms(lambda: virtual_ring_forward(q, k, v, n), RING_TIMED_REPS)
        ring_bwd = cuda_ms(lambda: virtual_ring_backward(q, k, v, o, lse, do, n), RING_TIMED_REPS)
        whole_fwd = cuda_ms(lambda: flash_attention(q, k, v, causal=True), RING_TIMED_REPS)
        whole_bwd = cuda_ms(lambda: flash_attention_bwd(q, k, v, o_w, lse_w, do, causal=True), RING_TIMED_REPS)
        out["ms"] = dict(ring_fwd=ring_fwd, ring_bwd=ring_bwd, whole_fwd=whole_fwd, whole_bwd=whole_bwd)
        log(f"timing ring {label} n={n} (CUDA events, one card, the n ranks' blocks one after another): forward "
            f"{ring_fwd:.3f} ms against the whole-sequence kernel's {whole_fwd:.3f} ms; backward {ring_bwd:.3f} ms "
            f"against {whole_bwd:.3f} ms (both backward kernels and delta)")
    del q, k, v, do, o_w, lse_w, whole, ref_o, ref_lse, ref, o, lse, ob, grads, given_whole
    torch.cuda.empty_cache()
    return out


def time_block(label: str, b: int, t: int, s: int, h: int, hkv: int, causal: bool, seed: int,
               f32_out: bool = False) -> dict:
    """The flash kernels at one block shape (every key valid): forward, dq
    and dk/dv each timed with CUDA events, beside the plain versions, SDPA
    (memory-efficient backend: forward, and autograd backward for dq, dk and
    dv together) and the bound. `f32_out` (a ring block): also the fp32
    outputs the ring launches, held against the plain versions with the same
    out_dtype (o within FWD_ATOL["bfloat16"], lse 1e-3, the gradients under
    GRAD_TOL's bf16 rule) and timed (`*_f32`; the bound counts their 4-byte
    outputs)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from bridgelang_tpu_torch.ops.flash_attention import (
        _launch, flash_attention_bwd_plain, flash_attention_plain, flash_bwd_dkv, flash_bwd_dq)
    from bridgelang_tpu_torch.ops.ring_attention import row_delta

    q, k, v, lens = attention_case(b, t, s, h, hkv, 128, [s] * b, None, torch.bfloat16, seed)
    do = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(seed + 1), device="cuda",
                     dtype=q.dtype)
    o, lse = _launch(q, k, v, lens, causal, None)
    delta = row_delta(o, do)
    ms = {"fwd": cuda_ms(lambda: _launch(q, k, v, lens, causal, None), 20),
          "dq": cuda_ms(lambda: flash_bwd_dq(q, k, v, do, lse, delta, lens, causal), 20),
          "dkv": cuda_ms(lambda: flash_bwd_dkv(q, k, v, do, lse, delta, lens, causal), 20),
          "plain_fwd": cuda_ms(lambda: flash_attention_plain(q, k, v, causal=causal), 3),
          "plain_bwd": cuda_ms(lambda: flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal), 3)}
    checks = {}
    if f32_out:
        f32 = torch.float32
        o32, lse32 = _launch(q, k, v, lens, causal, None, out_dtype=f32)
        po32, plse = flash_attention_plain(q, k, v, causal=causal, out_dtype=f32)
        got = (flash_bwd_dq(q, k, v, do, lse, delta, lens, causal, out_dtype=f32),
               *flash_bwd_dkv(q, k, v, do, lse, delta, lens, causal, out_dtype=f32))
        want = flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal, out_dtype=f32)
        checks = {"o_f32": (o32 - po32).abs().max().item(), "lse": (lse32 - plse).abs().max().item(),
                  **{f"{w}_f32_use": grad_tolerance_use(a, b_, rule="bfloat16")
                     for w, a, b_ in zip(("dq", "dk", "dv"), got, want)}}
        if not (all(x.dtype == f32 for x in (o32, *got)) and checks["o_f32"] <= FWD_ATOL["bfloat16"]
                and checks["lse"] <= 1e-3 and max(checks[f"{w}_f32_use"] for w in ("dq", "dk", "dv")) <= 1.0):
            fail(f"block {label}: the fp32-output kernels disagree with the plain versions: {checks}")
        ms.update(fwd_f32=cuda_ms(lambda: _launch(q, k, v, lens, causal, None, out_dtype=f32), 20),
                  dq_f32=cuda_ms(lambda: flash_bwd_dq(q, k, v, do, lse, delta, lens, causal, out_dtype=f32), 20),
                  dkv_f32=cuda_ms(lambda: flash_bwd_dkv(q, k, v, do, lse, delta, lens, causal, out_dtype=f32), 20),
                  plain_fwd_f32=cuda_ms(lambda: flash_attention_plain(q, k, v, causal=causal, out_dtype=f32), 3))
        del o32, lse32, po32, plse, got, want
    rep = h // hkv
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k.repeat_interleave(rep, 2), v.repeat_interleave(rep, 2)))
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        ms["library_fwd"] = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal), 20)
        qg, kg, vg = (x.detach().requires_grad_(True) for x in (qt, kt, vt))
        out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal)
        ms["library_bwd"] = cuda_ms(lambda: torch.autograd.grad(out, (qg, kg, vg), do.transpose(1, 2),
                                                                retain_graph=True), 20)
    bounds = {w: block_bound_ms(q, k, causal, w) for w in ("fwd", "dq", "dkv")}
    if f32_out:
        bounds.update({f"{w}_f32": block_bound_ms(q, k, causal, w, out_bytes=4) for w in ("fwd", "dq", "dkv")})
    log(f"timing block {label}: B={b} T={t} S={s} H={h}/{hkv} D=128 bf16 {'causal' if causal else 'full'}: "
        + ", ".join(f"{key} {val:.4f} ms" for key, val in ms.items()) + "; bounds "
        + ", ".join(f"{w} {bd[0]:.4f} ms ({bd[1]})" for w, bd in bounds.items())
        + " (library: SDPA memory-efficient; GQA keys repeated for it, outside the timing)"
        + (f"; fp32 outputs against the plain versions: {checks}" if checks else ""))
    del q, k, v, do, o, lse, delta, qt, kt, vt, qg, kg, vg, out
    torch.cuda.empty_cache()
    return dict(shape=f"B={b} T={t} S={s} H={h}/{hkv} D=128 bf16 {'causal' if causal else 'full'}", ms=ms,
                bounds=bounds, f32_checks=checks)


def ring_phase() -> dict:
    """The ring attention's per-block compute on the card: a virtual ring of
    n blocks of one sequence (ops/ring_attention.virtual_ring_forward /
    virtual_ring_backward, the block functions the ranks call, the rotations
    replaced by indexing) at the 7B's heads for n in RING_NS, timed against
    the whole-sequence kernels, and at Mistral's GQA heads for one n; then
    the kernels at the shapes this slice launches them at: a full and a
    diagonal block of the 8-block ring, and a tensor=2 rank's LoRA step
    (16 of the 7B's 32 heads, B=16, T=352, causal)."""
    t0 = time.perf_counter()
    cases = [ring_case("7B", 32, 32, n, 900 + n, timed=True) for n in RING_NS]
    cases.append(ring_case("mistral", 32, 8, RING_GQA_N, 950, timed=False))
    tb = RING_T // RING_NS[-1]
    blocks = {"full": time_block(f"ring n={RING_NS[-1]} full", RING_B, tb, tb, 32, 32, False, 960, f32_out=True),
              "diagonal": time_block(f"ring n={RING_NS[-1]} diagonal", RING_B, tb, tb, 32, 32, True, 962,
                                     f32_out=True)}
    b, t, h, hkv, _ = TP_TRAIN_SHAPE
    tensor_rank = time_block("tensor=2 rank", b, t, t, h, hkv, True, 964)
    launches = {name: sum(c["launches"].get(name, 0) for c in cases) for name in KERNEL_NAMES}
    result = dict(cases=cases, blocks=blocks, tensor_rank=tensor_rank, launches=launches,
                  phase_s=time.perf_counter() - t0)
    log(f"ring phase: {result['phase_s']:.1f} s; launches {launches}; {nvidia_smi_line()}")
    return result


def int4_bound_ms(m: int, k: int, n: int, group: int, mode: str):
    """Least time for one int4 product: max(bytes / HBM rate, 2 M K N / peak).
    Bytes: x (int8, bf16 or fp32) and the packed weights and bf16 scales read
    once, the output (f32 for a8, else x's type) written once."""
    x_b = {"a8": 1, "bfloat16": 2, "float32": 4}[mode]
    out_b = 4 if mode == "a8" else x_b
    n_bytes = m * k * x_b + k * n // 2 + (k // group) * n * 2 + m * n * out_b
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, 2.0 * m * k * n / PEAK_OPS[mode]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_int4_kernels() -> dict:
    """Both int4 kernels against their plain versions at the 7B shapes (a8 at
    the serving M: decode 1, prefill 352, micro-batch 1408; bf16 at the QLoRA
    M: 1, 352, 5632), plus group 256, fp32 activations, a shard-blocked pack
    and a ragged M, element by element under INT4_TOL; then kernel, plain,
    yardstick (F.linear over the weight dequantized to bf16 ahead of time;
    the port never calls it) and bound at the path's shapes."""
    import torch
    import torch.nn.functional as F

    from bridgelang_tpu_torch.ops import int4_matmul as im
    from bridgelang_tpu_torch.ops.quant import _quantize4_2d, dequant_int4, quantize_activations_per_token

    weights = {}

    def packed_weights(shape, group, n_shards=1):
        key = (shape, group, n_shards)
        if key not in weights:
            k, n = INT4_SHAPES[shape]
            g = torch.Generator(device="cuda").manual_seed(400 + len(weights))
            w = torch.randn((k, n), generator=g, device="cuda").mul_(k ** -0.5)
            weights[key] = _quantize4_2d(w, group, n_shards=n_shards)
        return weights[key]

    def use(got, want, mode):
        rtol, atol = INT4_TOL[mode]
        w = want.float()
        allowed = (rtol * w.abs() + atol * w.square().mean().sqrt()).clamp_min(torch.finfo(torch.float32).tiny)
        return float(((got.float() - w).abs() / allowed).max()), float((got.float() - w).abs().max())

    # (shape, mode, M, group, n_shards)
    cases = [(sh, "a8", m, INT4_GROUP, 1) for sh in INT4_SHAPES_7B for m in (1, 352, 1408)]
    cases += [(sh, "bfloat16", m, INT4_GROUP, 1) for sh in INT4_SHAPES_7B for m in (1, 352, 5632)]
    cases += [("w_gate", "a8", 352, 256, 1), ("w_down", "bfloat16", 352, 256, 1), ("w_gate", "float32", 352, 128, 1),
              ("wq", "float32", 37, 256, 1), ("w_down", "a8", 37, 128, 1), ("w_gate", "bfloat16", 37, 128, 1),
              ("w_gate", "bfloat16", 37, 128, 2), ("w_gate", "a8", 352, 128, 2),  # 5504-wide blocks
              ("w_gate", "a8", 4, 128, 1), ("w_down", "a8", 16, 128, 1), ("wq", "a8", 17, 128, 1),
              ("w_gate", "a8", 65, 128, 1), ("wq", "a8", 1, 512, 1), ("w_down", "a8", 1, 256, 1),
              ("w_gate", "a8", 1, 128, 2), ("w_gate", "a8", 4, 128, 2)]
    cases += [(sh, "a8", m, INT4_GROUP, 1) for sh in INT4_SHAPES_PHI for m in (1, 4, 352, 1408)]
    cases += [(sh, "bfloat16", PHI_QLORA_M, INT4_GROUP, 1) for sh in INT4_SHAPES_PHI]
    cases += [(sh, "a8", m, INT4_GROUP, 1) for sh in INT4_SHAPES_TP for m in (1, 352)]
    timed = {("wq", "a8", 1), ("w_gate", "a8", 1), ("w_down", "a8", 1), ("wq", "a8", 352), ("w_gate", "a8", 352),
             ("w_down", "a8", 352), ("wq", "bfloat16", 5632), ("w_gate", "bfloat16", 5632),
             ("w_down", "bfloat16", 5632)}
    timed |= {(sh, "a8", m) for sh in INT4_SHAPES_PHI for m in (1, 352)}
    timed |= {(sh, "bfloat16", PHI_QLORA_M) for sh in INT4_SHAPES_PHI}
    timed |= {(sh, "a8", m) for sh in INT4_SHAPES_TP for m in (1, 352)}
    worst = {"a8": (0.0, 0.0), "float": (0.0, 0.0)}
    rows, blocked = [], []
    for i, (shape, mode, m, group, n_shards) in enumerate(cases):
        k, n = INT4_SHAPES[shape]
        packed, scales = packed_weights(shape, group, n_shards)
        g = torch.Generator(device="cuda").manual_seed(500 + i)
        x = torch.randn((m, k), generator=g, device="cuda")
        name = f"{shape} {mode} M={m} group={group}" + (f" n_shards={n_shards}" if n_shards > 1 else "")
        if n_shards > 1:  # the blocked route through the model-facing function, against its plain twin
            xin = x.to(torch.bfloat16) if mode != "a8" else x
            fn = im.matmul_int4_a8 if mode == "a8" else im.matmul_int4
            wrapper = im.int4_mm_a8 if mode == "a8" else im.int4_mm
            before = wrapper.launches
            got = fn(xin, packed, scales, n_shards)
            torch.cuda.synchronize()
            if wrapper.launches != before + n_shards:
                fail(f"int4 case {name}: expected one kernel launch per shard block")
            w2, ns = packed.shape[1] // n_shards, n // n_shards
            if mode == "a8":
                q, xs = quantize_activations_per_token(xin)
                want = torch.cat([im.int4_matmul_a8_plain(q, packed[:, d * w2:(d + 1) * w2], scales[:, d * ns:(d + 1) * ns])
                                  for d in range(n_shards)], dim=1)
                got = got.float() / xs  # back to the kernel's output before the token scale
                tol_mode = "float32"  # one fp32 rounding each way around the token scale
            else:
                want = torch.cat([im.int4_matmul_plain(xin, packed[:, d * w2:(d + 1) * w2], scales[:, d * ns:(d + 1) * ns])
                                  for d in range(n_shards)], dim=1)
                tol_mode = mode
            # the blocked route (one launch per block, read in place) against one launch over a whole pack
            xk = quantize_activations_per_token(xin)[0] if mode == "a8" else xin
            whole_p, whole_s = packed_weights(shape, group)
            blocked_ms = cuda_ms(lambda: im._int4_route_blocked(xk, packed, scales, mode == "a8", n_shards), 20)
            whole_ms = cuda_ms(lambda: im._int4_route(xk, whole_p, whole_s, mode == "a8"), 20)
            blocked.append(dict(case=name, blocked_ms=blocked_ms, whole_ms=whole_ms))
            log(f"timing int4 {name}: blocked route {blocked_ms:.4f} ms, one launch over the unblocked pack "
                f"{whole_ms:.4f} ms")
        elif mode == "a8":
            xin, _ = quantize_activations_per_token(x)
            got = im.int4_mm_a8(xin, packed, scales)
            torch.cuda.synchronize()
            want = im.int4_matmul_a8_plain(xin, packed, scales)
            tol_mode = "a8"
        else:
            xin = x.to(getattr(torch, mode))
            got = im.int4_mm(xin, packed, scales)
            torch.cuda.synchronize()
            want = im.int4_matmul_plain(xin, packed, scales)
            tol_mode = mode
        if got.shape != (m, n) or not torch.isfinite(got).all():
            fail(f"int4 kernel case {name}: shape {tuple(got.shape)} or non-finite output")
        share, err = use(got, want, tol_mode)
        rtol, atol = INT4_TOL[tol_mode]
        log(f"kernel int4 {name}: max|err| {err:.3e} (max|want| {float(want.float().abs().max()):.4g}), "
            f"rule |err| <= {rtol:.3g}|want| + {atol:g} rms(want), tolerance use {share:.3g} "
            f"{'ok' if share <= 1.0 else 'FAIL'}")
        if share > 1.0:
            fail(f"int4 kernel disagrees with its plain version in case {name}")
        key = "a8" if mode == "a8" else "float"
        worst[key] = (max(worst[key][0], err), max(worst[key][1], share))

        if (shape, mode, m) in timed and group == INT4_GROUP and n_shards == 1:
            kfn = (lambda: im.int4_mm_a8(xin, packed, scales)) if mode == "a8" else (lambda: im.int4_mm(xin, packed, scales))
            pfn = ((lambda: im.int4_matmul_a8_plain(xin, packed, scales)) if mode == "a8"
                   else (lambda: im.int4_matmul_plain(xin, packed, scales)))
            kernel_ms = cuda_ms(kfn, 50 if m < 5632 else 10)  # 10 at the QLoRA M (5632; Phi's 5888)
            plain_ms = cuda_ms(pfn, 3, warmup=1)
            w_bf = dequant_int4(packed, scales, torch.bfloat16).t().contiguous()  # [N, K], ahead of time
            x_bf = x.to(torch.bfloat16)
            library_ms = cuda_ms(lambda: F.linear(x_bf, w_bf), 50 if m < 5632 else 10)
            del w_bf
            b_ms, b_by = int4_bound_ms(m, k, n, group, mode)
            rows.append(dict(case=name, mode=mode, shape=f"M={m} K={k} N={n} group={group}", m=m, k=k, n=n,
                             kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms,
                             bound_by=b_by, bound_share=b_ms / kernel_ms, vs_library=kernel_ms / library_ms,
                             max_abs_err=err, tolerance_use=share))
            log(f"timing int4 {name}: kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"F.linear over bf16 weights (yardstick) {library_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}); "
                f"share of bound {b_ms / kernel_ms:.3f}, kernel / F.linear {kernel_ms / library_ms:.2f}")
        del x, xin, got, want
    weights.clear()
    torch.cuda.empty_cache()
    return dict(rows=rows, worst=worst, blocked=blocked)


def int8_gemv_bound_ms(m: int, k: int, n: int) -> float:
    """Least time for one int8 GEMV: bytes (x and the codes and scales read
    once, the bf16 output written once) at the HBM rate; its 2 M K N
    operations take under a hundredth of that at M <= 16."""
    return 1e3 * (2 * m * k + n * k + 2 * n + 2 * m * n) / HBM_BYTES_PER_S


# Routed experts, kernel against plain: the fp32 sums run in other orders, so each of an expert's four bf16
# roundings (gate, up, silu * up, down) may land one ulp (2^-8) apart, which moves the weighted sum by a few
# ulps, and by a share of the output's rms where terms cancel.
MOE_TOL = (4 * 2.0 ** -8, 2e-2)
DSV2 = dict(E=64, K=6, D=2048, I=1408, H=16, DQK=192, DV=128, SCALE=0.11472826)


def moe_bound_ms(load, m: int) -> float:
    """Least time of one moe_experts call's two grouped products: the touched
    experts' weights once, their rows read and written once (bytes bind)."""
    d, i = DSV2["D"], DSV2["I"]
    picks, touched = int(load.sum()), int((load > 0).sum())
    gated = (touched * 2 * i * d + picks * d + picks * i) * 2
    down = (touched * d * i + picks * i + picks * d) * 2
    flops = 2.0 * picks * d * i * 3
    return 1e3 * max((gated + down) / HBM_BYTES_PER_S, flops / 989e12)


def moe_phase() -> dict:
    import torch
    import torch.nn.functional as F

    from bridgelang_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain
    from bridgelang_tpu_torch.ops.moe import moe_experts, moe_experts_plain

    e, k, d, i = DSV2["E"], DSV2["K"], DSV2["D"], DSV2["I"]
    g = torch.Generator(device="cuda").manual_seed(SEED)
    bf = torch.bfloat16
    router = (torch.randn((e, d), generator=g, device="cuda") * d ** -0.5).to(bf)
    wg, wu = ((torch.randn((e, i, d), generator=g, device="cuda") * d ** -0.5).to(bf) for _ in range(2))
    wd = (torch.randn((e, d, i), generator=g, device="cuda") * i ** -0.5).to(bf)
    rtol, atol_rms = MOE_TOL
    out = {"card": nvidia_smi_line(), "moe": {}}
    for m in (1, 352):
        x = torch.randn((m, d), generator=g, device="cuda").to(bf)
        load = torch.zeros(e, dtype=torch.int32, device="cuda")
        before = moe_experts.launches
        got = moe_experts(x, router, wg, wu, wd, k, False, 1.0, load)
        torch.cuda.synchronize()
        if moe_experts.launches != before + 5:
            fail(f"moe_experts M={m}: expected five launches, counted {moe_experts.launches - before}")
        want_load = torch.zeros(e, dtype=torch.int32, device="cuda")
        want = moe_experts_plain(x, router, wg, wu, wd, k, False, 1.0, want_load).float()
        use = float(((got.float() - want).abs() / (rtol * want.abs() + atol_rms * want.square().mean().sqrt())).max())
        if not torch.equal(load, want_load) or use > 1.0 or not torch.isfinite(got).all():
            fail(f"moe_experts M={m} disagrees with its plain version: tolerance use {use:.3f}, loads equal "
                 f"{torch.equal(load, want_load)}")
        kernel_ms = cuda_ms(lambda: moe_experts(x, router, wg, wu, wd, k, False, 1.0, load), 50)
        plain_ms = cuda_ms(lambda: moe_experts_plain(x, router, wg, wu, wd, k, False, 1.0), 5)
        b_ms = moe_bound_ms(load.cpu(), m)
        # one call captured and replayed: no host sync inside, the same output and load
        graph, load2 = torch.cuda.CUDAGraph(), torch.zeros_like(load)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            moe_experts(x, router, wg, wu, wd, k, False, 1.0, load2)
        torch.cuda.current_stream().wait_stream(side)
        with torch.cuda.graph(graph, stream=side):
            replayed = moe_experts(x, router, wg, wu, wd, k, False, 1.0, load2)
        load2.zero_()
        graph.replay()
        torch.cuda.synchronize()
        if not torch.equal(replayed, got) or not torch.equal(load2, load):
            fail(f"moe_experts M={m}: the graph replay differs from the eager call")
        row = dict(m=m, picks=int(load.sum()), experts_touched=int((load > 0).sum()), tolerance_use=use,
                   kernel_ms=kernel_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_share=b_ms / kernel_ms)
        out["moe"][f"m{m}"] = row
        log(f"moe_experts M={m}: {row['picks']} picks over {row['experts_touched']} experts, tolerance use "
            f"{use:.3f}; kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms (bytes), share "
            f"{b_ms / kernel_ms:.3f}; no single PyTorch call computes it; {out['card']}")

    h, t = DSV2["H"], 352
    q = torch.randn((1, t, h, DSV2["DQK"]), generator=g, device="cuda").to(bf)
    kk = torch.randn((1, t, h, DSV2["DQK"]), generator=g, device="cuda").to(bf)
    v = torch.randn((1, t, h, DSV2["DV"]), generator=g, device="cuda").to(bf)
    lens = torch.tensor([331], dtype=torch.int32, device="cuda")
    o, lse = flash_attention(q, kk, v, lengths=lens, scale=DSV2["SCALE"])
    po, plse = flash_attention_plain(q, kk, v, lengths=lens, scale=DSV2["SCALE"])
    err = float((o[0, :331].float() - po[0, :331].float()).abs().max())
    err_lse = float((lse[0, :, :331] - plse[0, :, :331]).abs().max())
    if err > FWD_ATOL["bfloat16"] or err_lse > 1e-3:
        fail(f"flash (192, 128) disagrees with its plain version: max|o| {err:.3e}, max|lse| {err_lse:.3e}")
    kernel_ms = cuda_ms(lambda: flash_attention(q, kk, v, lengths=lens, scale=DSV2["SCALE"]), 100)
    plain_ms = cuda_ms(lambda: flash_attention_plain(q, kk, v, lengths=lens, scale=DSV2["SCALE"]), 20)
    mask = valid_mask(t, t, [331], None, device="cuda")[:, None]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, kk, v))
    try:
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                                    scale=DSV2["SCALE"]), 100)
    except RuntimeError as ex:  # a backend without v's own head dim
        log(f"flash (192, 128): F.scaled_dot_product_attention refused the shapes ({ex})")
        library_ms = float("nan")
    keys = 331
    n_bytes = t * h * (DSV2["DQK"] + DSV2["DV"]) * 2 + keys * h * (DSV2["DQK"] + DSV2["DV"]) * 2 + 4 * h * t + 4
    pairs = sum(min(r, keys - 1) + 1 for r in range(t))
    b_ms = 1e3 * max(n_bytes / HBM_BYTES_PER_S, 2.0 * (DSV2["DQK"] + DSV2["DV"]) * pairs * h / 989e12)
    out["flash_192_128"] = dict(max_abs_err=err, kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                                bound_ms=b_ms, bound_share=b_ms / kernel_ms)
    log(f"flash (192, 128) B=1 T=352 H=16 lengths 331: max|o-plain| {err:.3e}; kernel {kernel_ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound {b_ms:.5f} ms, share {b_ms / kernel_ms:.3f}")
    return out


def check_int8_gemv() -> dict:
    """int8_gemv against int8_gemv_plain at Mistral-7B's shapes and head (M =
    1, 8, 16) and Phi-2's (M = 1, 8), a ragged N and an odd M: the unscaled
    product under INT4_TOL's bf16 rule, the scaled one bit-equal to
    bf16(unscaled * scale), its epilogue. Then device time per launch, cold
    (a captured graph over rotated weight copies), at each Mistral shape and
    M in INT8_GEMV_MS: the kernel, the plain version (the cast route: the
    codes cast to bf16, F.linear, the scale), F.linear over bf16 weights cast
    ahead of time (the yardstick), and the byte bound; and the largest M at
    which the kernel beats the cast route at every shape."""
    import torch
    import torch.nn.functional as F

    from bridgelang_tpu_torch.ops.int8_matmul import int8_gemv, int8_gemv_plain

    def operands(k, n, seed):
        g = torch.Generator(device="cuda").manual_seed(seed)
        w = torch.randint(-127, 128, (n, k), generator=g, device="cuda", dtype=torch.int8)
        s = (torch.rand((n,), generator=g, device="cuda") * 0.02 + 1e-3).to(torch.bfloat16)
        return w, s

    def use(got, want):
        rtol, atol = INT4_TOL["bfloat16"]
        w = want.float()
        allowed = (rtol * w.abs() + atol * w.square().mean().sqrt()).clamp_min(torch.finfo(torch.float32).tiny)
        return float(((got.float() - w).abs() / allowed).max()), float((got.float() - w).abs().max())

    cases = [(sh, k, n, m) for sh, (k, n) in INT8_GEMV_SHAPES.items() for m in (1, 8, 16)]
    cases += [(sh, k, n, m) for sh, (k, n) in INT8_GEMV_PHI.items() for m in (1, 8)]
    cases += [("ragged", 4096, 1000, 3), ("ragged", 80, 37, 5)]
    worst = (0.0, 0.0)
    for i, (shape, k, n, m) in enumerate(cases):
        w, s = operands(k, n, 800 + i)
        x = torch.randn((m, k), generator=torch.Generator(device="cuda").manual_seed(900 + i), device="cuda",
                        dtype=torch.bfloat16)
        before = int8_gemv.launches
        raw, scaled = int8_gemv(x, w), int8_gemv(x, w, s)
        torch.cuda.synchronize()
        if int8_gemv.launches != before + 2:
            fail(f"int8_gemv {shape} M={m}: expected two launches, counted {int8_gemv.launches - before}")
        share, err = use(raw, int8_gemv_plain(x, w))
        exact = torch.equal(scaled, (raw.float() * s.float()).to(torch.bfloat16))
        log(f"kernel int8_gemv {shape} M={m} K={k} N={n}: unscaled max|err| {err:.3e} against the plain version "
            f"(tolerance use {share:.3g}, rule one bf16 ulp + 1e-3 rms); scaled {'bit-equal' if exact else 'DIFFERS'} "
            f"to bf16(unscaled * scale)")
        if share > 1.0 or not exact or not torch.isfinite(scaled).all():
            fail(f"int8_gemv disagrees with its plain version in case {shape} M={m}")
        worst = (max(worst[0], err), max(worst[1], share))

    rows = []
    for shape, (k, n) in INT8_GEMV_SHAPES.items():
        w, s = operands(k, n, 1000)
        copies = rotated((w, s), w.numel() + 2 * s.numel())
        w_copies = rotated((w.to(torch.bfloat16),), 2 * w.numel())
        for m in INT8_GEMV_MS:
            x = torch.randn((m, k), device="cuda", dtype=torch.bfloat16)
            r = dict(case=shape, shape=f"M={m} K={k} N={n}", m=m, k=k, n=n, copies=len(copies))
            r["kernel_ms"] = graph_ms([lambda w=w, s=s: int8_gemv(x, w, s) for w, s in copies])
            r["plain_ms"] = graph_ms([lambda w=w, s=s: int8_gemv_plain(x, w, s) for w, s in copies])
            r["library_ms"] = graph_ms([lambda w=w: F.linear(x, w) for (w,) in w_copies])
            r["bound_ms"], r["bound_by"] = int8_gemv_bound_ms(m, k, n), "bytes"
            r["bound_share"] = r["bound_ms"] / r["kernel_ms"]
            rows.append(r)
            log(f"timing int8_gemv {shape} {r['shape']} (device, cold over {len(copies)} weight copies): kernel "
                f"{1e3 * r['kernel_ms']:.2f} us, plain (cast route) {1e3 * r['plain_ms']:.2f} us, F.linear over "
                f"bf16 weights (yardstick) {1e3 * r['library_ms']:.2f} us, bound {1e3 * r['bound_ms']:.2f} us "
                f"(bytes); share of bound {r['bound_share']:.3f}, kernel / cast route "
                f"{r['kernel_ms'] / r['plain_ms']:.3f}")
        del copies, w_copies
        torch.cuda.empty_cache()
    limit = 0
    for m in INT8_GEMV_MS:
        if not all(r["kernel_ms"] < r["plain_ms"] for r in rows if r["m"] == m):
            break
        limit = m
    log(f"int8_gemv beats the cast route at every Mistral shape up to M = {limit} (of {INT8_GEMV_MS})")
    return dict(rows=rows, worst=worst, m_limit=limit)


_WARM_STREAM = []  # one side stream for every capture's warm-up: cuBLAS keeps a workspace per stream


def graph_ms(fns, launches: int = GRAPH_LAUNCHES, replays: int = 3) -> float:
    """Device time per launch, the host's path through the wrappers outside
    the window: `launches` calls cycling over `fns`, captured in one CUDA
    graph, replayed once warm and then `replays` times between two events;
    the median per launch."""
    import torch

    if not _WARM_STREAM:
        _WARM_STREAM.append(torch.cuda.Stream())
    side = _WARM_STREAM[0]
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns:  # builds, configures and allocates what a launch needs before the capture
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(launches):
            fns[i % len(fns)]()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(replays):
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    del graph
    torch.cuda.empty_cache()
    return statistics.median(times)


def rotated(tensors, n_bytes_each: int):
    """The tensors and enough clones of them that one pass over all copies
    moves COLD_BYTES: each launch of a rotation finds its weights out of L2."""
    n = max(2, -(-int(COLD_BYTES) // max(1, n_bytes_each)))
    return [tensors] + [tuple(t.clone() for t in tensors) for _ in range(n - 1)]


def cold_timings(label: str) -> dict:
    """Device-side times, cold L2 (weights rotated over COLD_BYTES of
    copies): int4_mm_a8 at M=1 and M=352 at the three 7B and the three
    Phi-2 shapes and at the blocks a rank holds under tensor parallelism
    (INT4_SHAPES_TP), F.linear over the weight dequantized to bf16 (the
    yardstick), and flash_fwd at the serving shape B=1 at head dims 128 and
    80 and at a rank's 16 and 8 heads (B = 1 and 4) (its inputs warm, as the
    prefill writes them just before); each beside its CUDA-event reading around back-to-back wrapper
    calls, the series the earlier PRs report. Where the package has it, the
    quantize_a8 kernel. Runs on any checkout's package (--package-root)."""
    import torch
    import torch.nn.functional as F

    from bridgelang_tpu_torch.ops import int4_matmul as im
    from bridgelang_tpu_torch.ops.flash_attention import flash_attention
    from bridgelang_tpu_torch.ops.quant import _quantize4_2d, dequant_int4, quantize_activations_per_token

    new = hasattr(im, "quantize_a8")
    rows = {}
    for shape, (k, n) in INT4_SHAPES.items():
        g = torch.Generator(device="cuda").manual_seed(700)
        packed, scales = _quantize4_2d(torch.randn((k, n), generator=g, device="cuda").mul_(k ** -0.5), INT4_GROUP)
        copies = rotated((packed, scales), packed.numel() + 2 * scales.numel())
        w_bf = dequant_int4(packed, scales, torch.bfloat16).t().contiguous()
        w_copies = rotated((w_bf,), 2 * w_bf.numel())
        for m in (1, 352):
            x = torch.randn((m, k), generator=g, device="cuda")
            q, _ = quantize_activations_per_token(x)
            x_bf = x.to(torch.bfloat16)
            r = dict(shape=f"M={m} K={k} N={n} group={INT4_GROUP}", copies=len(copies), library_copies=len(w_copies))
            r["device_ms"] = graph_ms([lambda p=p, s=s: im.int4_mm_a8(q, p, s) for p, s in copies])
            r["event_ms"] = cuda_ms(lambda: im.int4_mm_a8(q, packed, scales), 50)
            r["library_device_ms"] = graph_ms([lambda w=w: F.linear(x_bf, w) for (w,) in w_copies])
            r["library_event_ms"] = cuda_ms(lambda: F.linear(x_bf, w_bf), 50)
            r["bound_ms"], r["bound_by"] = int4_bound_ms(m, k, n, INT4_GROUP, "a8")
            rows[(shape, m)] = r
            log(f"cold int4_mm_a8 ({label}) {shape} {r['shape']}: device {r['device_ms']:.5f} ms over {len(copies)} "
                f"rotated weight copies (event window {r['event_ms']:.4f} ms); F.linear device "
                f"{r['library_device_ms']:.5f} ms (event {r['library_event_ms']:.4f} ms); bound {r['bound_ms']:.5f} ms "
                f"({r['bound_by']}), share {r['bound_ms'] / r['device_ms']:.3f}, kernel / F.linear "
                f"{r['device_ms'] / r['library_device_ms']:.2f}")
        del copies, w_copies, w_bf
        torch.cuda.empty_cache()

    t = 352
    out = {"int4_mm_a8": rows}
    from bridgelang_tpu_torch.ops.flash_attention import KERNEL_HEAD_DIMS

    ragged = [t - 21, t - 9, t - 40, t - 77]
    # the 7B's and Phi-2's head dims; then a rank's heads of the 7B at tensor=2 (16) and 4 (8), B = 1 and 4
    for key, d, h, b in (("flash_fwd", 128, 32, 1), ("flash_fwd_d80", 80, 32, 1), ("flash_fwd_h16_b1", 128, 16, 1),
                         ("flash_fwd_h16_b4", 128, 16, 4), ("flash_fwd_h8_b1", 128, 8, 1),
                         ("flash_fwd_h8_b4", 128, 8, 4)):
        if d not in KERNEL_HEAD_DIMS:  # an earlier checkout (--package-root) without D = 80
            continue
        q_, k_, v_, lens = attention_case(b, t, t, h, h, d, ragged[:b], None, torch.bfloat16, seed=100)
        mask = valid_mask(t, t, ragged[:b], None, device="cuda")[:, None]
        qt, kt, vt = (x.transpose(1, 2) for x in (q_, k_, v_))
        out[key] = flash = dict(
            shape=f"B={b} T={t} S={t} H={h} D={d} bf16",
            device_ms=graph_ms([lambda: flash_attention(q_, k_, v_, lengths=lens, causal=True)]),
            event_ms=cuda_ms(lambda: flash_attention(q_, k_, v_, lengths=lens, causal=True), 100),
            library_device_ms=graph_ms([lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)]),
            bound_ms=bound_ms(q_, k_, v_, lens, None)[0])
        log(f"device-side flash_fwd ({label}) {flash['shape']}: {flash['device_ms']:.5f} ms (event window "
            f"{flash['event_ms']:.4f} ms); sdpa (yardstick) device {flash['library_device_ms']:.5f} ms; bound "
            f"{flash['bound_ms']:.5f} ms (bytes)")
        del q_, k_, v_, lens, qt, kt, vt, mask
    if new:
        out["quantize_a8"] = time_quantize(label)
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)  # a CUDA build's; its workspaces per stream
    if clear is not None:  # would otherwise count in every later phase's peak memory
        clear()
    torch.cuda.empty_cache()
    log(f"after the device-side timings the card holds {torch.cuda.memory_allocated() / 1e9:.3f} GB")
    return out


def time_quantize(label: str) -> dict:
    """quantize_a8 at the serving shapes (bf16 x, K=4096; M=1 and 352):
    device time (graph), event time, the plain version's, and the bound:
    M K 2 bytes read, M K + 4 M written."""
    import torch

    from bridgelang_tpu_torch.ops.int4_matmul import quantize_a8
    from bridgelang_tpu_torch.ops.quant import quantize_activations_per_token

    rows = {}
    for m in (1, 352):
        k = INT4_SHAPES_7B["wq"][0]
        x = torch.randn((m, k), generator=torch.Generator(device="cuda").manual_seed(800 + m), device="cuda",
                        dtype=torch.bfloat16)
        n_bytes = 2 * m * k + m * k + 4 * m
        r = dict(shape=f"M={m} K={k} bf16", device_ms=graph_ms([lambda: quantize_a8(x)]),
                 event_ms=cuda_ms(lambda: quantize_a8(x), 100),
                 plain_ms=cuda_ms(lambda: quantize_activations_per_token(x), 100),
                 plain_device_ms=graph_ms([lambda: quantize_activations_per_token(x)]),
                 bound_ms=1e3 * n_bytes / HBM_BYTES_PER_S, bound_by="bytes")
        rows[m] = r
        log(f"timing quantize_a8 ({label}) {r['shape']}: device {r['device_ms']:.5f} ms (event {r['event_ms']:.4f} ms); "
            f"plain (torch ops) device {r['plain_device_ms']:.5f} ms (event {r['plain_ms']:.4f} ms); bound "
            f"{r['bound_ms']:.6f} ms (bytes)")
    return rows


def check_quantize_and_route() -> dict:
    """The quantize_a8 kernel bit-equal to quantize_activations_per_token
    (bf16 and fp32 rows, zero rows, rows on rounding ties; rows holding a
    NaN get a NaN scale in both, their codes not compared; a row-parallel K
    shard quantized with the whole row's absmax), and the w4a8
    route on the card (quantize_a8, then int4_mm_a8 with the token scale and
    the cast in its epilogue: two launches) bit-equal to the plain
    composition (int4_matmul_a8_plain(q) * xs).to(x's dtype). Returns the
    largest |q - plain q|, |scale - plain scale| and route error read."""
    import torch

    from bridgelang_tpu_torch.ops import int4_matmul as im
    from bridgelang_tpu_torch.ops.quant import _quantize4_2d, quantize_activations_per_token

    g = torch.Generator(device="cuda").manual_seed(900)
    ties = torch.tensor([127.0, 2.5, -2.5, 3.5, 0.5, -0.5, 1.5, -1.5, 126.5, -126.5, 0.0, 64.5] * 341 + [0.0] * 4,
                        device="cuda")
    cases = {"bf16_m352": torch.randn((352, 4096), generator=g, device="cuda").to(torch.bfloat16),
             "fp32_m37_k11008": torch.randn((37, 11008), generator=g, device="cuda") * 3.0,
             "zero_rows": torch.cat([torch.zeros((2, 4096), device="cuda"),
                                     torch.randn((2, 4096), generator=g, device="cuda")]).to(torch.bfloat16),
             "ties_bf16": torch.stack([ties, 2 * ties, -ties]).to(torch.bfloat16),
             "ties_fp32": torch.stack([ties, 2 * ties, -ties]),
             "nan_rows_bf16": torch.randn((6, 4096), generator=g, device="cuda").to(torch.bfloat16)}
    cases["nan_rows_bf16"][1, 0] = cases["nan_rows_bf16"][4, 4095] = float("nan")
    errs = {"codes": 0.0, "scales": 0.0, "route": 0.0}
    for name, x in cases.items():
        q, xs = im.quantize_a8(x)
        torch.cuda.synchronize()
        pq, pxs = quantize_activations_per_token(x)
        rows = ~pxs[:, 0].isnan()  # a NaN row's codes are conversions of NaN: only its NaN scale is compared
        nan_rows = int((~rows).sum())
        code_err = float((q[rows].int() - pq[rows].int()).abs().max())
        scale_err = float((xs[rows] - pxs[rows]).abs().max())
        errs["codes"], errs["scales"] = max(errs["codes"], code_err), max(errs["scales"], scale_err)
        ok = (torch.equal(q[rows], pq[rows]) and torch.equal(xs[rows], pxs[rows])
              and torch.equal(xs.isnan(), pxs.isnan()) and nan_rows == (2 if name.startswith("nan") else 0))
        log(f"kernel quantize_a8 {name} {tuple(x.shape)} {x.dtype}: max|codes err| {code_err:g}, max|scales err| "
            f"{scale_err:g}, rows with a NaN scale (kernel, plain) ({int(xs.isnan().sum())}, {nan_rows}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"quantize_a8 differs from quantize_activations_per_token in case {name}")
    for name in ("bf16_m352", "fp32_m37_k11008", "zero_rows", "ties_fp32"):  # a K shard, the whole row's absmax
        x = cases[name]
        shard = x[:, :x.shape[1] // 2].contiguous()
        absmax = x.float().abs().amax(dim=-1, keepdim=True)
        q, xs = im.quantize_a8(shard, absmax)
        torch.cuda.synchronize()
        pq, pxs = quantize_activations_per_token(shard, absmax)
        code_err = float((q.int() - pq.int()).abs().max())
        scale_err = float((xs - pxs).abs().max())
        errs["codes"], errs["scales"] = max(errs["codes"], code_err), max(errs["scales"], scale_err)
        ok = torch.equal(q, pq) and torch.equal(xs, pxs)
        log(f"kernel quantize_a8 {name} K shard {tuple(shard.shape)} with the row's absmax: max|codes err| "
            f"{code_err:g}, max|scales err| {scale_err:g} {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"quantize_a8 with a given absmax differs from quantize_activations_per_token in case {name}")
    k, n = INT4_SHAPES_7B["w_gate"]
    packed, scales = _quantize4_2d(torch.randn((k, n), generator=g, device="cuda").mul_(k ** -0.5), INT4_GROUP)
    for m, dtype in ((1, torch.bfloat16), (4, torch.bfloat16), (352, torch.bfloat16), (37, torch.float32)):
        x = torch.randn((m, k), generator=g, device="cuda").to(dtype)
        before = (im.quantize_a8.launches, im.int4_mm_a8.launches)
        got = im.matmul_int4_a8(x, packed, scales)
        torch.cuda.synchronize()
        launched = (im.quantize_a8.launches - before[0], im.int4_mm_a8.launches - before[1])
        pq, pxs = quantize_activations_per_token(x)
        want = (im.int4_matmul_a8_plain(pq, packed, scales) * pxs).to(dtype)
        ok = torch.equal(got, want) and launched == (1, 1)
        err = float((got.float() - want.float()).abs().max())
        errs["route"] = max(errs["route"], err)
        log(f"w4a8 route w_gate M={m} {dtype}: launches (quantize_a8, int4_mm_a8) {launched}, max|err| "
            f"{err:.3e} {'bit-equal ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"the w4a8 route on the card differs from its plain composition at M={m} {dtype}")
    return errs


# --- phase 3: full-width serving --------------------------------------------------

STATS = {"bridge_orig": {"action": {
    "q01": [-0.03, -0.05, -0.06, -0.13, -0.12, -0.43, 0.0],
    "q99": [0.03, 0.04, 0.06, 0.13, 0.12, 0.43, 1.0],
    "mask": [True, True, True, True, True, True, False],
}}}
INSTRUCTIONS = ["pick up the red block", "open the drawer", "put the spoon on the towel",
                "move the blue cup to the left side"]


def build_7b(seed: int):
    import torch

    from bridgelang_tpu_torch.models.llm.tokenizer import ByteFallbackTokenizer
    from bridgelang_tpu_torch.models.vla import OpenVLA
    from bridgelang_tpu_torch.models.vlm import VLMConfig

    cfg = VLMConfig()  # prism-dinosiglip-224px+7b: DINOv2-L + SigLIP-So400m, Llama-2 7B
    model = OpenVLA(cfg, STATS, tokenizer=ByteFallbackTokenizer(), dtype=torch.bfloat16, device="cuda")
    t0 = time.perf_counter()
    params = model.init_params(torch.Generator(device="cuda").manual_seed(seed))
    torch.cuda.synchronize()
    n = sum(p.numel() for p in params["vision"].values()) + sum(p.numel() for p in params["projector"].values())
    n += sum(p.numel() for lp in params["llm"]["layers"] for p in lp.values())
    n += sum(params["llm"][k].numel() for k in ("embed", "final_norm", "lm_head"))
    log(f"OpenVLA-7B random bf16 weights on the card: {n / 1e9:.3f} B params in {time.perf_counter() - t0:.1f} s")
    return model, params


def frames(n: int, seed: int):
    import numpy as np

    return list(np.random.default_rng(seed).integers(0, 256, size=(n, 224, 224, 3), dtype=np.uint8))


def time_generate(model, params, frame, instruction, max_new_tokens: int, reps: int = 5) -> float:
    import torch

    from bridgelang_tpu_torch.ops.image_ops import frames_to_tensor, preprocess_batch

    ids, mask = model.pad_prompt([model.prepare_prompt_ids(instruction)])
    ids_t = torch.as_tensor(ids, device="cuda")
    mask_t = torch.as_tensor(mask, device="cuda")
    pix = preprocess_batch(frames_to_tensor(frame[None], model.device), model.image_transform, dtype=model.dtype)
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.generate_greedy(params, ids_t, mask_t, pix, max_new_tokens=max_new_tokens)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def prefill_logits(model, params, frame, instruction):
    """The logits [V] (fp32) that choose a batch-1 predict's first token:
    the prefill's last real row through the LM head."""
    import torch

    from bridgelang_tpu_torch.models.llm.llama import lm_logits
    from bridgelang_tpu_torch.ops.image_ops import frames_to_tensor, preprocess_batch

    ids, mask = model.pad_prompt([model.prepare_prompt_ids(instruction)])
    pix = preprocess_batch(frames_to_tensor(frame[None], model.device), model.image_transform, dtype=model.dtype)
    with torch.inference_mode():
        last, _, _ = model._prefill(params, torch.as_tensor(ids, device=model.device),
                                    torch.as_tensor(mask, device=model.device), pix, 1, None)
        return lm_logits(params["llm"], last, model.cfg.llm)[0, 0].float()


def profile_device(label: str, fn, reps: int) -> dict:
    """torch.profiler over `reps` calls of `fn` (warmed up by the caller):
    wall ms per call, device kernel ms per call (sum of kernel durations on
    the one stream), the device's idle share, launches per call, the port's
    kernels' share and the top kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / reps
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        log(f"profile ({label}): wall {wall_ms:.2f} ms/call; device time not measured (no CUDA events traced)")
        return {"wall_ms": wall_ms}
    by_name: dict = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / reps
    busy_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    flash = {k: sum(v for n, v in by_name.items() if sub in n) for k, sub in PROFILE_NAMES.items()}
    log(f"profile ({label}, {reps} calls): wall {wall_ms:.2f} ms, device kernels {busy_ms:.2f} ms "
        f"({len(kernels) / reps:.0f} launches), device idle {100 * (1 - busy_ms / wall_ms):.1f}%, "
        + ", ".join(f"{k} {v:.3f} ms ({100 * v / busy_ms:.1f}%)" for k, v in flash.items() if v))
    for name, ms in top:
        log(f"  {ms:8.3f} ms  {100 * ms / busy_ms:5.1f}%  {name[:110]}")
    # dtype conversions (an int8 weight cast to bf16 among them) run ATen's direct_copy kernel
    copy_ms = sum(v for n, v in by_name.items() if "direct_copy_kernel" in n)
    return {"wall_ms": wall_ms, "device_ms": busy_ms, "idle_share": 1 - busy_ms / wall_ms,
            "launches_per_call": len(kernels) / reps, "flash_ms": flash, "direct_copy_ms": copy_ms,
            "top": [(name[:80], ms) for name, ms in top[:6]]}


def profile_predict(model, params, reps: int = 3) -> dict:
    """The profile over batch-1 predict_action calls."""
    img = frames(1, seed=5)[0]
    model.predict_action(params, img, INSTRUCTIONS[0])  # warm
    return profile_device("B=1 predict_action", lambda: model.predict_action(params, img, INSTRUCTIONS[0]), reps)


def check_action(action, what: str) -> None:
    import numpy as np

    a = np.asarray(action)
    if a.shape != (7,) or not np.isfinite(a).all():
        fail(f"{what}: expected 7 finite floats, got {a!r}")


def serve(model, params, n_single: int, per_pass: dict) -> dict:
    """VLAServer /act with greedy decoding (the speculative default off; the
    spec phase serves it): `n_single` batch-1 requests, then a micro-batch of
    4 concurrent ones. Launch counts are zeroed before each and read after;
    each of the server's model passes (one predict: the prefill and the
    decode steps) must launch each kernel `per_pass[name]` times (the others
    never). A CUDA model with `use_graphs` answers through replayed graphs,
    whose replays add the launches their capture recorded."""
    import torch

    from bridgelang_tpu_torch.serving.server import VLAServer, client_act

    imgs = frames(4, seed=7)
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()

    single = VLAServer(model, params, max_batch=1, speculative_default=False, device=model.device)
    httpd = single.serve_background(port=0)
    lat = []
    try:
        port = httpd.server_address[1]
        for i in range(n_single):
            t0 = time.perf_counter()
            action = client_act("127.0.0.1", port, imgs[i % 4], INSTRUCTIONS[i % 4], timeout=300)
            lat.append(1e3 * (time.perf_counter() - t0))
            check_action(action, f"batch-1 request {i}")
        passes_single = single.stats()["model_passes"]
    finally:
        httpd.shutdown()
        httpd.server_close()
        single.close()
    counts_single = launch_counts()
    log(f"batch-1: {n_single} x HTTP 200 with 7 floats; latency ms {[round(x, 1) for x in lat]}; "
        f"model passes {passes_single}; launches {counts_single}")
    if passes_single != n_single:
        fail(f"expected {n_single} model passes, got {passes_single}")
    expect_counts(counts_single, {k: v * passes_single for k, v in per_pass.items()}, "batch-1 serving")

    reset_launch_counts()
    batched = VLAServer(model, params, max_batch=4, batch_window_ms=2000.0, speculative_default=False,
                        device=model.device)
    httpd = batched.serve_background(port=0)
    results, errors = [None] * 4, []
    try:
        port = httpd.server_address[1]

        def one(i):
            try:
                results[i] = client_act("127.0.0.1", port, imgs[i], INSTRUCTIONS[i], timeout=300)
            except Exception as e:  # noqa: BLE001 - reported below, fails the run
                errors.append(f"request {i}: {e!r}")

        threads = [threading.Thread(target=one, args=(i,)) for i in range(4)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        batch_ms = 1e3 * (time.perf_counter() - t0)
        passes_batched = batched.stats()["model_passes"]
    finally:
        httpd.shutdown()
        httpd.server_close()
        batched.close()
    if errors or any(th.is_alive() for th in threads):
        fail(f"micro-batched requests failed: {errors}")
    for i, action in enumerate(results):
        check_action(action, f"micro-batched request {i}")
    counts_batched = launch_counts()
    log(f"micro-batch of 4 (instruction lengths {[len(s) for s in INSTRUCTIONS]}): 4 x HTTP 200 with 7 floats "
        f"in {batch_ms:.1f} ms; model passes {passes_batched}; launches {counts_batched}")
    if passes_batched < 1:
        fail("the micro-batch ran no model pass")
    expect_counts(counts_batched, {k: v * passes_batched for k, v in per_pass.items()}, "micro-batched serving")
    return dict(latencies_ms=lat, median_ms=statistics.median(lat[1:] if len(lat) > 1 else lat),
                batch4_ms=batch_ms, batch4_passes=passes_batched,
                launches={k: counts_single[k] + counts_batched[k] for k in KERNEL_NAMES},
                passes=passes_single + passes_batched, max_memory_gb=torch.cuda.max_memory_allocated() / 1e9)


# --- phase 3b: the published checkpoint layout, written and loaded ---------------------

CKPT_SHARDS = 3           # the published openvla-7b's model-0000{1,2,3}-of-00003.safetensors
CKPT_FREE_BYTES = 17e9    # the bf16 7B checkpoint (15.05 GB) and its headroom
GOLDEN_MANIFEST = os.path.join(ROOT, "tests", "golden", "hf_export_manifest_openvla7b.json")
N_DEPLOY_REQUESTS = 3     # /act requests to the deploy --checkpoint subprocess
DEPLOY_LISTEN_S = 600     # its load, graph warm-up and listen must fit in this


def source_only_tensors(params) -> dict:
    """The tensors a published OpenVLA checkpoint carries that the port never
    runs, so the loader must skip them: each tower's final `norm` and
    SigLIP's attention-pooling head (bridgelang_tpu/extern/timm_shim.py:155-181
    shapes), random bf16 drawn on the card when written."""
    import torch

    from bridgelang_tpu_torch.util.safetensors_io import Lazy

    g = torch.Generator(device="cuda").manual_seed(SEED + 7)
    shapes = {}
    for tower in ("featurizer", "fused_featurizer"):
        w = params["vision"][f"{tower}.patch_embed.weight"].shape[0]
        shapes[f"vision_backbone.{tower}.norm.weight"] = (w,)
        shapes[f"vision_backbone.{tower}.norm.bias"] = (w,)
    w, hidden = params["vision"]["fused_featurizer.patch_embed.weight"].shape[0], \
        params["vision"]["fused_featurizer.blocks.0.mlp_fc1.weight"].shape[0]
    pool = {"latent": (1, 1, w), "q.weight": (w, w), "q.bias": (w,), "kv.weight": (2 * w, w), "kv.bias": (2 * w,),
            "proj.weight": (w, w), "proj.bias": (w,), "norm.weight": (w,), "norm.bias": (w,),
            "mlp.fc1.weight": (hidden, w), "mlp.fc1.bias": (hidden,), "mlp.fc2.weight": (w, hidden),
            "mlp.fc2.bias": (w,)}
    shapes.update({f"vision_backbone.fused_featurizer.attn_pool.{k}": v for k, v in pool.items()})
    return {k: Lazy(torch.bfloat16, v, lambda v=v: torch.randn(v, generator=g, device="cuda", dtype=torch.bfloat16)
                    .mul_(0.02)) for k, v in shapes.items()}


def write_published_checkpoint(model, params, out_dir) -> dict:
    """The 7B in the published layout: bf16, three shards with an index,
    config.json and dataset_statistics.json, through the port's writer and
    the exporter's key mapping; the core keys and shapes held to the golden
    manifest. Timed to the end of an fsync of every file."""
    import math

    import torch

    from bridgelang_tpu_torch.extern.hf_export import export_state_dict, write_sidecars
    from bridgelang_tpu_torch.util.safetensors_io import save_sharded, tensor_nbytes

    core = export_state_dict(params, dtype=torch.bfloat16)
    with open(GOLDEN_MANIFEST) as f:
        golden = json.load(f)
    got = {k: list(v.shape) for k, v in core.items()}
    if got != golden:
        fail(f"load: the written core keys differ from the golden manifest: "
             f"{sorted(set(got) ^ set(golden))[:6] or [k for k in got if got[k] != golden.get(k)][:6]}")
    extra = source_only_tensors(params)
    tensors = {**core, **extra}
    n_core = sum(math.prod(v.shape) for v in core.values())
    n_bytes = sum(tensor_nbytes(v) for v in tensors.values())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    files = save_sharded(tensors, out_dir, CKPT_SHARDS, metadata={"format": "pt"})
    write_sidecars(model, out_dir)
    for f in files:
        fd = os.open(f, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    dt = time.perf_counter() - t0
    log(f"load: wrote {len(tensors)} tensors ({len(core)} core = the golden manifest, {n_core / 1e9:.3f} B params; "
        f"{len(extra)} source-only), {n_bytes / 1e9:.2f} GB bf16 in {CKPT_SHARDS} shards in {dt:.1f} s "
        f"({n_bytes / 1e9 / dt:.2f} GB/s, fsync included)")
    return dict(tensors=len(tensors), core_tensors=len(core), core_params=n_core, bytes=n_bytes, seconds=dt,
                gb_per_s=n_bytes / 1e9 / dt, files=[os.path.basename(f) for f in files])


def drop_page_cache(ckpt_dir) -> bool:
    """Ask the kernel to drop the checkpoint's clean pages (fadvise
    DONTNEED), so the next read comes from the disk."""
    for name in sorted(os.listdir(ckpt_dir)):
        fd = os.open(os.path.join(ckpt_dir, name), os.O_RDONLY)
        try:
            os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
        finally:
            os.close(fd)
    return True


def host_memory_kb() -> dict:
    with open("/proc/self/status") as f:
        return {k: int(v.split()[0]) for k, v in (line.split(":", 1) for line in f) if k in ("VmRSS", "VmHWM")}


class HostPeak:
    """The process's peak RSS over a block, above its RSS at the start:
    VmHWM after resetting it through /proc/self/clear_refs where the kernel
    allows that, else the largest VmRSS read every 2 ms by a thread (`how`
    says which)."""

    def __enter__(self):
        self.rss0 = host_memory_kb()["VmRSS"]
        try:
            with open("/proc/self/clear_refs", "w") as f:
                f.write("5")
            self.how, self.thread = "VmHWM after clear_refs", None
        except OSError as e:
            self.how = f"VmRSS sampled every 2 ms (clear_refs: {e.strerror})"
            self.peak, self.stop = self.rss0, threading.Event()
            self.thread = threading.Thread(target=self._sample, daemon=True)
            self.thread.start()
        return self

    def _sample(self):
        while not self.stop.is_set():
            self.peak = max(self.peak, host_memory_kb()["VmRSS"])
            self.stop.wait(0.002)

    def __exit__(self, *exc):
        if self.thread is None:
            self.peak = host_memory_kb()["VmHWM"]
        else:
            self.stop.set()
            self.thread.join()
            self.peak = max(self.peak, host_memory_kb()["VmRSS"])
        self.gb = (self.peak - self.rss0) * 1024 / 1e9
        return False


def timed_load(path: str, label: str, n_bytes: int, cold: bool, **kw):
    """load_vla onto the card, timed, with the host's peak RSS above its RSS
    before (HostPeak) and the device peak above what the card held before."""
    import torch

    from bridgelang_tpu_torch.models.load import load_vla

    if cold:
        drop_page_cache(path)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with HostPeak() as host:
        t0 = time.perf_counter()
        model, params = load_vla(path, **kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    r = dict(seconds=dt, gb_per_s=n_bytes / 1e9 / dt, cold=cold, host_peak_gb=host.gb, host_peak_how=host.how,
             device_peak_gb=(torch.cuda.max_memory_allocated() - base) / 1e9,
             model_gb=(torch.cuda.memory_allocated() - base) / 1e9)
    log(f"load ({label}, {'cold' if cold else 'page-cache warm'}): {dt:.2f} s, {r['gb_per_s']:.2f} GB/s of file; "
        f"host peak RSS +{host.gb:.3f} GB over the load ({host.how}); device peak +{r['device_peak_gb']:.2f} GB, "
        f"holds +{r['model_gb']:.2f} GB after")
    return model, params, r


def bits(t):
    import torch

    return t.view({1: torch.int8, 2: torch.int16, 4: torch.int32}[t.element_size()]) if t.is_floating_point() else t


def assert_params_bit_equal(got, want, what: str) -> int:
    """Every leaf of two port params trees equal in dtype, shape and bits."""
    import torch

    def named(p):
        out = {f"vision.{k}": v for k, v in p["vision"].items()}
        out.update({f"projector.{k}": v for k, v in p["projector"].items()})
        out.update({f"llm.{k}": v for k, v in p["llm"].items() if k != "layers"})
        out.update({f"llm.{i}.{k}": v for i, lp in enumerate(p["llm"]["layers"]) for k, v in lp.items()})
        return out

    g, w = named(got), named(want)
    if set(g) != set(w):
        fail(f"{what}: leaves differ: {sorted(set(g) ^ set(w))[:6]}")
    bad = [k for k in w if g[k].dtype != w[k].dtype or g[k].shape != w[k].shape or not torch.equal(bits(g[k]), bits(w[k]))]
    if bad:
        fail(f"{what}: {len(bad)} of {len(w)} leaves not bit-equal, e.g. {bad[:4]}")
    return len(w)


def counted_ids(model, params, img, instruction, per_pass: dict, what: str):
    """One batch-1 predict's ids through the graphs (captured by a first
    predict), its launches counted: `per_pass` times each kernel."""
    model.predict_action_batch(params, [img], [instruction], return_tokens=True)
    reset_launch_counts()
    _, ids = model.predict_action_batch(params, [img], [instruction], return_tokens=True)
    counts = launch_counts()
    expect_counts(counts, per_pass, what)
    return ids[0].tolist(), counts


def deploy_subprocess(ckpt_dir: str, model4, params4) -> dict:
    """`python -m bridgelang_tpu_torch.deploy --checkpoint <dir> --quantize_int4
    true` in its own process: time to listen (the load and graph warm-up
    included), then N_DEPLOY_REQUESTS /act, each equal to the in-process
    greedy predict_action of the int4-loaded model; the process is stopped."""
    import http.client
    import socket

    import numpy as np

    from bridgelang_tpu_torch.serving.server import client_act

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    log_path = os.path.join(os.path.dirname(ckpt_dir), "deploy_subprocess.log")
    cmd = [sys.executable, "-m", "bridgelang_tpu_torch.deploy", "--checkpoint", ckpt_dir, "--quantize_int4", "true",
           "--speculative_default", "false", "--host", "127.0.0.1", "--port", str(port)]
    imgs = frames(N_DEPLOY_REQUESTS, seed=13)
    with open(log_path, "w") as out:
        t0 = time.perf_counter()
        proc = subprocess.Popen(cmd, cwd=ROOT, stdout=out, stderr=subprocess.STDOUT)
        try:
            listen_s = None
            while time.perf_counter() - t0 < DEPLOY_LISTEN_S and proc.poll() is None:
                try:
                    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
                    conn.request("GET", "/healthz")
                    if conn.getresponse().status == 200:
                        listen_s = time.perf_counter() - t0
                        break
                except OSError:
                    time.sleep(0.5)
                finally:
                    conn.close()
            if listen_s is None:
                raise RuntimeError(f"deploy did not listen within {DEPLOY_LISTEN_S} s (exit code {proc.poll()})")
            lat, equal = [], []
            for i, img in enumerate(imgs):
                t1 = time.perf_counter()
                got = np.asarray(client_act("127.0.0.1", port, img, INSTRUCTIONS[i], timeout=300), np.float32)
                lat.append(1e3 * (time.perf_counter() - t1))
                want = model4.predict_action(params4, img, INSTRUCTIONS[i])
                equal.append(bool(np.array_equal(got, want)))
                if not equal[-1]:
                    raise RuntimeError(f"/act {i} from deploy {got.tolist()} != in-process predict {want.tolist()}")
        except (RuntimeError, OSError, ValueError) as e:
            with open(log_path) as f:
                tail = f.read()[-3000:]
            fail(f"deploy --checkpoint subprocess: {e}\n{tail}")
        finally:
            proc.terminate()
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
    log(f"load: deploy --checkpoint --quantize_int4 true subprocess listened after {listen_s:.1f} s (its load and "
        f"graph warm-up included); {N_DEPLOY_REQUESTS} x /act equal to the in-process int4 predict_action, latency "
        f"ms {[round(x, 1) for x in lat]} (median {statistics.median(lat):.1f}); stopped")
    return dict(listen_s=listen_s, act_ms=lat, act_median_ms=statistics.median(lat))


def load_phase(model, params, keep_ckpt: bool = False):
    """The 7B written in the published layout and loaded back through
    load_vla (bf16, then quantized on load to int8 and int4), each held to
    its in-memory twin bit for bit with equal batch-1 ids; the first /act of
    the loaded bf16 model; a deploy --checkpoint subprocess. Returns the
    loaded bf16 (model, params), which the later phases serve and train, and
    the phase's numbers. With `keep_ckpt` the written checkpoint stays (its
    path in the numbers, "ckpt_dir") for the finetune phase."""
    import shutil
    import tempfile

    from bridgelang_tpu_torch.models.llm.tokenizer import ByteFallbackTokenizer
    from bridgelang_tpu_torch.ops.quant import quantize_llm_int4, quantize_llm_int8
    from bridgelang_tpu_torch.serving.server import VLAServer, client_act

    t_phase = time.perf_counter()
    parent = os.path.join(ROOT, "build")
    os.makedirs(parent, exist_ok=True)
    free = shutil.disk_usage(parent).free
    log(f"load: {free / 1e9:.1f} GB free under {parent}")
    if free < CKPT_FREE_BYTES:
        fail(f"load: {free / 1e9:.1f} GB free on the checkout's disk; the bf16 7B checkpoint needs "
             f"{CKPT_FREE_BYTES / 1e9:.0f} GB")
    ckpt = tempfile.mkdtemp(prefix="smoke_ckpt_", dir=parent)
    result = {"launches": dict.fromkeys(KERNEL_NAMES, 0)}
    try:
        result["write"] = write_published_checkpoint(model, params, ckpt)
        n_bytes = result["write"]["bytes"]
        img = frames(1, seed=17)[0]

        loaded, lparams, result["bf16"] = timed_load(ckpt, "bf16", n_bytes, cold=True)
        n = assert_params_bit_equal(lparams, params, "load bf16")
        if loaded.norm_stats != STATS:
            fail(f"load: norm_stats {loaded.norm_stats} != {STATS}")
        loaded.tokenizer = ByteFallbackTokenizer()
        _, _, result["bf16_warm"] = timed_load(ckpt, "bf16", n_bytes, cold=False)
        release_memory()
        server = VLAServer(loaded, lparams, max_batch=1, speculative_default=False, device=loaded.device)
        httpd = server.serve_background(port=0)
        try:
            t0 = time.perf_counter()
            check_action(client_act("127.0.0.1", httpd.server_address[1], img, INSTRUCTIONS[0], timeout=300),
                         "load: the first /act of the loaded model")
            result["first_act_ms"] = 1e3 * (time.perf_counter() - t0)
        finally:
            httpd.shutdown()
            httpd.server_close()
            server.close()
        ids_mem, _ = counted_ids(model, params, img, INSTRUCTIONS[0], {"flash_fwd": N_LAYERS_7B}, "load: in-memory bf16")
        ids_bf16, counts = counted_ids(loaded, lparams, img, INSTRUCTIONS[0], {"flash_fwd": N_LAYERS_7B},
                                       "load: loaded bf16")
        result["launches"] = {k: result["launches"][k] + counts[k] for k in KERNEL_NAMES}
        if ids_bf16 != ids_mem:
            fail(f"load: loaded bf16 ids {ids_bf16} != in-memory {ids_mem}")
        log(f"load: bf16 leaves bit-equal ({n} tensors), norm_stats equal, batch-1 ids {ids_bf16} equal; the first "
            f"/act after the load {result['first_act_ms']:.1f} ms (its graph capture included)")
        model.graphs.clear()
        del model, params
        release_memory()

        for kind, quantize, per_pass in (
                ("int8", lambda llm: quantize_llm_int8(llm), INT8_PER_PREDICT),
                ("int4", lambda llm: quantize_llm_int4(llm, group=INT4_GROUP), INT4_PER_PREDICT)):
            qmodel, qparams, result[kind] = timed_load(ckpt, kind, n_bytes, cold=True, **{f"quantize_{kind}": True})
            mem = dict(lparams, llm=quantize(lparams["llm"]))
            n = assert_params_bit_equal(qparams, mem, f"load {kind}")
            qmodel.tokenizer = loaded.tokenizer
            twin = w8a8_model(loaded, w8a8=True)
            ids_mem, _ = counted_ids(twin, mem, img, INSTRUCTIONS[0], per_pass, f"load: in-memory {kind}")
            ids_q, counts = counted_ids(qmodel, qparams, img, INSTRUCTIONS[0], per_pass, f"load: loaded {kind}")
            result["launches"] = {k: result["launches"][k] + counts[k] for k in KERNEL_NAMES}
            if ids_q != ids_mem:
                fail(f"load: {kind}-loaded ids {ids_q} != quantized in memory {ids_mem}")
            log(f"load: {kind} leaves bit-equal to quantize_llm_{kind} of the bf16 params ({n} tensors), batch-1 "
                f"ids {ids_q} equal")
            twin.graphs.clear()
            del twin, mem
            release_memory()
            _, _, result[f"{kind}_warm"] = timed_load(ckpt, kind, n_bytes, cold=False, **{f"quantize_{kind}": True})
            release_memory()
            if kind == "int4":
                result["deploy"] = deploy_subprocess(ckpt, qmodel, qparams)
            qmodel.graphs.clear()
            del qmodel, qparams
            release_memory()
    finally:
        if not keep_ckpt:
            shutil.rmtree(ckpt, ignore_errors=True)
    if keep_ckpt:
        result["ckpt_dir"] = ckpt
    result["phase_s"] = time.perf_counter() - t_phase
    log(f"load phase: {result['phase_s']:.1f} s")
    return loaded, lparams, result


# --- phase 4: LoRA fine-tuning ------------------------------------------------------


def kernel_wrappers() -> dict:
    """Each kernel's wrapper, which counts its launches in `.launches`."""
    from bridgelang_tpu_torch.models.graphs import counted_wrappers

    return dict(zip(KERNEL_NAMES, counted_wrappers()))


def reset_launch_counts() -> None:
    for fn in kernel_wrappers().values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


def expect_counts(counts: dict, want: dict, what: str) -> None:
    """Fail unless each kernel launched exactly as `want` says (0 when not named)."""
    full = {name: want.get(name, 0) for name in KERNEL_NAMES}
    if counts != full:
        fail(f"{what}: expected launches {full}, got {counts}")


def int8_decode_steps(gemv: int, prefills: int, what: str) -> int:
    """The decode steps of an int8 7B behind `gemv` int8_gemv launches:
    each prefill's head row, then INT8_GEMV_PER_STEP per step."""
    steps, rest = divmod(gemv - prefills, INT8_GEMV_PER_STEP)
    if steps < 0 or rest:
        fail(f"{what}: {gemv} int8_gemv launches are not {prefills} head rows and whole decode steps of "
             f"{INT8_GEMV_PER_STEP}")
    return steps


def lora_batch(model, batch_size: int, seed: int) -> dict:
    """DummyDataset(seed) -> RLDSBatchTransform -> collator, on the model's device."""
    import torch

    from bridgelang_tpu_torch.vla.action_tokenizer import ActionTokenizer
    from bridgelang_tpu_torch.vla.datasets.datasets import (
        DummyDataset, PaddedCollatorForActionPrediction, RLDSBatchTransform)

    tok = model.tokenizer
    transform = RLDSBatchTransform(ActionTokenizer(tok), tok, llm_family=model.cfg.llm_family)
    max_len = PHI_TRAIN_MAX_LEN if model.cfg.llm_family == "phi" else TRAIN_MAX_LEN
    collate = PaddedCollatorForActionPrediction(max_length=max_len, pad_token_id=model.cfg.llm.pad_token_id)
    batch = collate(list(DummyDataset(transform, n=batch_size, seed=seed)))
    return {k: torch.as_tensor(v, device=model.device) for k, v in batch.items() if k != "dataset_names"}


def with_lora(params: dict, device, seed: int, b_std: float = 0.0) -> dict:
    """`params` with r=32 fp32 adapters on every projection the decoder has
    (seven for Llama and Mistral, six for Phi-2; shared base tensors). B is
    zero, as in training, unless `b_std` draws it too."""
    import torch

    from bridgelang_tpu_torch.training.lora import add_lora_params

    g = torch.Generator(device=device).manual_seed(seed)
    llm = add_lora_params(g, params["llm"], rank=LORA_RANK)
    if b_std:
        for lp in llm["layers"]:
            for k in (k for k in lp if k.endswith("_lora_b")):
                lp[k].normal_(0.0, b_std, generator=g)
    return dict(params, llm=llm)


def base_param_count(llm: dict) -> int:
    """Decoder parameters without adapters, a packed int4 byte counting as
    its two weights."""
    n = sum(t.numel() for k, t in llm.items() if k != "layers" and not k.endswith("_scale"))
    for lp in llm["layers"]:
        for k, t in lp.items():
            if "_lora_" not in k and not k.endswith("_scale4"):
                n += t.numel() * (2 if k + "_scale4" in lp else 1)
    return n


def train_adapters(model, params, seed: int, label: str, steps: int, per_step: dict,
                   serve_model=None, dots_steps: int = 0, resume_check: bool = False,
                   require_fall: bool = True) -> dict:
    """Full-depth fine-tuning of r=32 adapters over `params` on the card
    (`label`: "train" for the bf16 base, "qlora" for the int4 one,
    "phi_lora" for Phi-2's): one warm step and `steps` timed ones, each
    launching each kernel `per_step[name]` times, losses finite and (with
    `require_fall`) falling; a profiled step; `dots_steps` more under "dots"
    remat; then the adapters merged into the base and one action predicted
    through it with `serve_model`. With `resume_check`, the adapters are
    checkpointed and resumed (checkpoint_resume) before the merge."""
    import numpy as np
    import torch

    from bridgelang_tpu_torch.training.lora import lora_trainable_mask, merge_lora
    from bridgelang_tpu_torch.training.trainer import (
        OptimConfig, init_train_state, make_optimizer, make_vla_train_step, tree_leaves)

    lora_params = with_lora(params, model.device, seed + 1)
    mask = lora_trainable_mask(lora_params)
    optimizer = make_optimizer(OptimConfig(learning_rate=LORA_LR, lr_scheduler_type="constant"), lora_params,
                               trainable_mask=mask)
    state = init_train_state(lora_params, optimizer, trainable_mask=mask)
    step = make_vla_train_step(model, optimizer, trainable_mask=mask, compute_dtype=torch.bfloat16,
                               image_transform=model.image_transform, remat=True, remat_policy="full")
    batch = lora_batch(model, TRAIN_BATCH, seed)
    b, f = batch["input_ids"].shape[0], batch["input_ids"].shape[1] + model.num_patches
    tokens = b * f
    n_lora = sum(t.numel() for lp in lora_params["llm"]["layers"] for k, t in lp.items() if "_lora_" in k)
    n_base = base_param_count(lora_params["llm"])
    n_vis = sum(t.numel() for part in ("vision", "projector") for t in tree_leaves(params[part]))
    vis_tokens = b * (model.num_patches + 5)  # bench.py's count: DINOv2's 256 patches + class + 4 registers
    flops = 4.0 * n_base * tokens + 6.0 * n_lora * tokens + 2.0 * n_vis * vis_tokens
    base_kind = "packed-int4 (group 128)" if any(k.endswith("_scale4") for k in params["llm"]["layers"][0]) else "bf16"
    log(f"{label}: {model.cfg.model_id} {base_kind} base ({n_base / 1e9:.3f} B LLM params) + r={LORA_RANK} fp32 adapters "
        f"({n_lora / 1e6:.1f} M params), batch {b} x {f} fused tokens, full remat, AdamW lr {LORA_LR}; "
        f"useful FLOPs per step {flops:.4g}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times, totals = [], [], dict.fromkeys(KERNEL_NAMES, 0)
    for i in range(1 + steps):
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        counts = launch_counts()
        totals = {k: totals[k] + counts[k] for k in KERNEL_NAMES}
        losses.append(loss)
        log(f"{label} step {i}{' (warm)' if i == 0 else ''}: loss {loss:.4f}, grad_norm {float(m['grad_norm']):.4f}, "
            f"action_accuracy {float(m['action_accuracy']):.3f}, l1 {float(m['l1_loss']):.4f}, "
            f"{times[-1]:.1f} ms; launches {counts}")
        if not np.isfinite(loss):
            fail(f"{label} step {i}: non-finite loss {loss}")
        expect_counts(counts, per_step, f"{label} step {i}")
    if require_fall and float(np.mean(losses[-3:])) >= losses[0]:
        fail(f"{label}: the mean of the last 3 losses does not fall below the first on a fixed batch: {losses}")
    step_ms = statistics.median(times[1:])
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    share = flops / (step_ms / 1e3) / PEAK_FLOPS["bfloat16"]
    log(f"{label}: median step {step_ms:.1f} ms over {steps} steps ({[round(t, 1) for t in times[1:]]}), "
        f"{tokens / (step_ms / 1e3):.1f} tokens/s, useful-FLOP share {100 * share:.2f}% of 989 TFLOP/s, "
        f"peak memory {peak_gb:.2f} GB; losses {[round(x, 4) for x in losses]}")
    prof = profile_device(f"{label} step B={b}", lambda: step(state, batch), 1)

    dots = None
    if dots_steps:
        # scripts/finetune.py's default policy, "dots": matmul outputs are saved
        # and the rest recomputed. The flash launch is no aten op, so it reruns.
        dots_step = make_vla_train_step(model, optimizer, trainable_mask=mask, compute_dtype=torch.bfloat16,
                                        image_transform=model.image_transform, remat=True, remat_policy="dots")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        dots_times = []
        for i in range(1 + dots_steps):
            reset_launch_counts()
            t0 = time.perf_counter()
            state, m = dots_step(state, batch)
            loss = float(m["loss"])
            torch.cuda.synchronize()
            dots_times.append(1e3 * (time.perf_counter() - t0))
            counts = launch_counts()
            log(f"{label} step dots {i}{' (warm)' if i == 0 else ''}: loss {loss:.4f}, {dots_times[-1]:.1f} ms; "
                f"launches {counts}")
            if not np.isfinite(loss):
                fail(f"{label} dots step {i}: non-finite loss {loss}")
            expect_counts(counts, per_step, f"{label} dots step {i}")
        dots_ms = statistics.median(dots_times[1:])
        dots = dict(step_ms=dots_ms, step_times_ms=dots_times[1:], warm_ms=dots_times[0],
                    tokens_per_s=tokens / (dots_ms / 1e3), flop_share=flops / (dots_ms / 1e3) / PEAK_FLOPS["bfloat16"],
                    peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
        log(f"{label} dots remat: median step {dots_ms:.1f} ms over {dots_steps} steps, "
            f"{dots['tokens_per_s']:.1f} tokens/s, useful-FLOP share {100 * dots['flop_share']:.2f}%, "
            f"peak memory {dots['peak_memory_gb']:.2f} GB")
        del dots_step

    resume = checkpoint_resume(model, params, state, mask, batch, seed, losses[-1]) if resume_check else None

    trained = state.params
    del state, optimizer, step
    merged = dict(params, llm=merge_lora(trained["llm"]))
    del trained
    action = (serve_model or model).predict_action(merged, frames(1, seed=9)[0], INSTRUCTIONS[0])
    check_action(action, f"{label}: predict_action through the merged weights")
    log(f"{label}: merged weights ({base_kind}): predict_action -> {np.round(action, 4).tolist()}")
    del merged
    torch.cuda.empty_cache()
    return dict(step_ms=step_ms, step_times_ms=times[1:], warm_ms=times[0], tokens_per_step=tokens,
                tokens_per_s=tokens / (step_ms / 1e3), useful_flops=flops, flop_share=share, peak_memory_gb=peak_gb,
                losses=losses, profile=prof, launches=totals, steps=1 + steps, dots=dots, resume=resume)


def checkpoint_resume(model, params, state, mask, batch, seed: int, loss: float) -> dict:
    """CheckpointManager.save of the LoRA state with the frozen base dropped
    (`only_trainable_mask`), restored into a fresh init_train_state (other
    adapters, zero moments); then one step from the restored state and one
    from the uninterrupted one on the same batch. Losses and adapters must be
    bit-equal, or else within 1e-6 relative; the rule that held is reported."""
    import shutil
    import tempfile

    import torch

    from bridgelang_tpu_torch.training.checkpointing import STATE_FILE, CheckpointManager
    from bridgelang_tpu_torch.training.lora import lora_trainable_mask
    from bridgelang_tpu_torch.training.trainer import (
        OptimConfig, init_train_state, make_optimizer, make_vla_train_step, trainable_tensors)

    def stepper(p, m):
        opt = make_optimizer(OptimConfig(learning_rate=LORA_LR, lr_scheduler_type="constant"), p, trainable_mask=m)
        return opt, make_vla_train_step(model, opt, trainable_mask=m, compute_dtype=torch.bfloat16,
                                        image_transform=model.image_transform, remat=True, remat_policy="full")

    run = tempfile.mkdtemp(prefix="smoke_run_", dir=os.path.join(ROOT, "build"))
    try:
        mgr = CheckpointManager(run, keep=2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = mgr.save(state, step=state.step, epoch=0, loss=loss, only_trainable_mask=mask)
        save_s = time.perf_counter() - t0
        n_bytes = os.path.getsize(os.path.join(path, STATE_FILE))
        fresh_params = with_lora(params, model.device, seed + 3)
        fresh_mask = lora_trainable_mask(fresh_params)
        opt_b, step_b = stepper(fresh_params, fresh_mask)
        fresh = init_train_state(fresh_params, opt_b, trainable_mask=fresh_mask)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restored = mgr.restore(path, fresh)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(run, ignore_errors=True)
    _, step_a = stepper(state.params, mask)
    state, m_a = step_a(state, batch)
    restored, m_b = step_b(restored, batch)
    loss_a, loss_b = float(m_a["loss"]), float(m_b["loss"])
    ta, tb = trainable_tensors(state.params, mask), trainable_tensors(restored.params, fresh_mask)
    if loss_a == loss_b and all(torch.equal(x, y) for x, y in zip(ta, tb)):
        rule, loss_rel, w_rel = "bit-equal", 0.0, 0.0
    else:
        rule = "within 1e-6 relative"
        loss_rel = abs(loss_a - loss_b) / abs(loss_a)
        w_rel = max(float((x - y).abs().max()) / max(float(x.abs().max()), 1e-30) for x, y in zip(ta, tb))
        if loss_rel > 1e-6 or w_rel > 1e-6:
            fail(f"train resume: one step from the restored state differs from the uninterrupted one: loss "
                 f"{loss_b} vs {loss_a} (rel {loss_rel:.2e}), adapters rel {w_rel:.2e}")
    log(f"train resume: checkpoint of the adapters and AdamW moments {n_bytes / 1e6:.1f} MB (the frozen base "
        f"dropped), save {save_s:.2f} s, restore {restore_s:.2f} s; one step from the restored state and from the "
        f"uninterrupted one: loss {loss_b:.6f} vs {loss_a:.6f}, adapters {rule}")
    del restored
    return dict(bytes=n_bytes, save_s=save_s, restore_s=restore_s, rule=rule, loss=[loss_a, loss_b],
                loss_rel_err=loss_rel, adapter_rel_err=w_rel)


# --- serving through graphs: bf16, int8 (w8a8) and int4 (w4a8) -------------------------


def w8a8_model(model, w8a8: bool):
    """The same OpenVLA with `LLMConfig.w8a8` set (the weights travel apart)."""
    import dataclasses

    from bridgelang_tpu_torch.models.vla import OpenVLA

    cfg = dataclasses.replace(model.cfg, llm=dataclasses.replace(model.cfg.llm, w8a8=w8a8))
    out = OpenVLA(cfg, model.norm_stats, tokenizer=model.tokenizer, dtype=model.dtype, device=model.device)
    out.image_transform = model.image_transform
    return out


def tensor_gb(tree) -> float:
    from bridgelang_tpu_torch.training.trainer import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)) / 1e9


def graph_inputs(model, imgs, instructions, n: int) -> dict:
    """A greedy predict's inputs for `model.graphs.run` decoding `n` tokens
    (the stats cut or tiled to n dims)."""
    import numpy as np

    stats = model.get_action_stats()
    reps = -(-n // len(stats["q01"]))
    ids, mask = model.pad_prompt([model.prepare_prompt_ids(t) for t in instructions])
    return {"ids": ids, "mask": mask, "frames": np.ascontiguousarray(np.stack(imgs)),
            "q01": np.tile(np.asarray(stats["q01"], np.float32), reps)[:n],
            "q99": np.tile(np.asarray(stats["q99"], np.float32), reps)[:n],
            "stat_mask": np.tile(np.asarray(stats["mask"], bool), reps)[:n]}


def time_graph_generate(model, params, imgs, instructions, n: int, reps: int = 5) -> float:
    """Host-clock ms of a replayed greedy predict of `n` tokens for the
    batch of `imgs`: input copies, the replay and the one device-to-host
    copy (captured on the first call, outside the timing)."""
    import torch

    inputs = graph_inputs(model, imgs, instructions, n)
    model.graphs.run("greedy", params, dict(inputs), n).cpu()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.graphs.run("greedy", params, dict(inputs), n).cpu()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def replay_event_ms(model, params, frame, instruction, reps: int = 5) -> float:
    """Device-side ms of one replayed batch-1 predict: CUDA events around
    the replay of its captured graph."""
    import torch

    inputs = graph_inputs(model, [frame], [instruction], ACTION_DIM)
    model.graphs.run("greedy", params, dict(inputs), ACTION_DIM)
    entry = model.graphs.entries[model.graphs.key("greedy", inputs, ACTION_DIM)]
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        start.record()
        entry.graphs[0].graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graphs_equal_eager(model, params, label: str, imgs, buckets=(1, 2, 4)):
    """The inputs flow (the prefill logits move by over a tenth of their max
    between two frames); the graphs of the batch `buckets` captured, with the peak memory after each;
    replayed ids equal to eager ids at B=1 and B=4. -> (peaks, capture s)."""
    import numpy as np
    import torch

    la = prefill_logits(model, params, imgs[0], INSTRUCTIONS[0])
    lb = prefill_logits(model, params, imgs[1], INSTRUCTIONS[0])
    moved, top = float((la - lb).abs().max()), float(la.abs().max())
    log(f"{label}: prefill logits of frame A and frame B: argmax {int(la.argmax())} and {int(lb.argmax())}, "
        f"max|A - B| {moved:.4g} against max|logit| {top:.4g}")
    # Random weights may keep one argmax for two frames (full-depth Phi-2 does), so the rule is on the logits:
    # they must move by a tenth of their largest value (they move by 0.26-0.47 of it on the card).
    if not moved > 0.1 * top:
        fail(f"{label}: the prefill logits hardly move between two different frames: inputs do not flow")
    model.use_graphs = True
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    peaks = {}
    t0 = time.perf_counter()
    for b in buckets:
        model.predict_action_batch(params, imgs[:b], INSTRUCTIONS[:b])
        torch.cuda.synchronize()
        peaks[b] = torch.cuda.max_memory_allocated() / 1e9
    capture_s = time.perf_counter() - t0
    log(f"{label}: graphs of batch buckets {', '.join(map(str, buckets))} captured in {capture_s:.1f} s; peak GB "
        f"after each { {b: round(g, 3) for b, g in peaks.items()} }; {len(model.graphs.entries)} graph keys")
    ids = {}
    for use_graphs in (False, True):
        model.use_graphs = use_graphs
        for b in (1, 4):
            ids[(use_graphs, b)] = model.predict_action_batch(params, imgs[:b], INSTRUCTIONS[:b], return_tokens=True)[1]
    model.use_graphs = True
    for b in (1, 4):
        same = np.array_equal(ids[(True, b)], ids[(False, b)])
        log(f"{label}: B={b} token ids, graph {ids[(True, b)].tolist()} eager {ids[(False, b)].tolist()} "
            f"{'equal' if same else 'DIFFER'}")
        if not same:
            fail(f"{label}: replayed graph ids differ from eager generate ids at B={b}")
    return peaks, capture_s


def serve_kind(model, params, label: str, per_pass: dict) -> dict:
    """One weight kind served through replayed graphs and eagerly: the inputs
    flow (the prefill argmax differs between two frames); the graphs of the
    batch buckets 1, 2 and 4 captured before any request, with the peak
    memory after each; replayed ids equal to eager ids at B=1 and B=4;
    prefill and decode ms (graph and eager); a profile of each; the server's
    batch-1 requests and micro-batch of 4, graph then eager, under the
    per-pass launch counts."""
    import numpy as np
    import torch

    imgs = frames(4, seed=3)
    peaks, capture_s = graphs_equal_eager(model, params, label, imgs)
    model.use_graphs = False
    e1 = time_generate(model, params, imgs[0], INSTRUCTIONS[0], 1)
    e7 = time_generate(model, params, imgs[0], INSTRUCTIONS[0], 7)
    prof_eager = profile_predict(model, params)
    model.use_graphs = True
    g1 = time_graph_generate(model, params, imgs[:1], INSTRUCTIONS[:1], 1)
    g7 = time_graph_generate(model, params, imgs[:1], INSTRUCTIONS[:1], 7)
    replay_ms = replay_event_ms(model, params, imgs[0], INSTRUCTIONS[0])
    prof_graph = profile_predict(model, params)
    log(f"{label}: B=1 1 token / 7 tokens / decode per token, eager generate_greedy {e1:.2f} / {e7:.2f} / "
        f"{(e7 - e1) / 6:.2f} ms; replayed graph {g1:.2f} / {g7:.2f} / {(g7 - g1) / 6:.2f} ms; one replay of the "
        f"7-token predict between CUDA events {replay_ms:.2f} ms")
    graph = serve(model, params, N_SINGLE_REQUESTS, per_pass)
    model.use_graphs = False
    eager = serve(model, params, N_SINGLE_REQUESTS, per_pass)
    model.use_graphs = True
    log(f"{label} serve: median batch-1 /act graph {graph['median_ms']:.1f} ms, eager {eager['median_ms']:.1f} ms; "
        f"micro-batch of 4 graph {graph['batch4_ms']:.1f} ms, eager {eager['batch4_ms']:.1f} ms; peak memory "
        f"{max(peaks.values()):.2f} GB after the warm-up")
    torch.cuda.empty_cache()
    return dict(graph, eager=dict(eager, prefill_ms=e1, decode_ms_per_token=(e7 - e1) / 6, profile=prof_eager),
                prefill_ms=g1, decode_ms_per_token=(g7 - g1) / 6, profile=prof_graph, replay_event_ms=replay_ms,
                warmup_peak_gb=peaks, capture_s=capture_s, model_gb=tensor_gb(params), llm_gb=tensor_gb(params["llm"]))


def int8_routes(model8, params8) -> dict:
    """Which route each int8 product of one eager 7-token predict takes: the
    w8a8 int8 x int8 product (torch._int_mm) must run the prefill's 224
    projections (T = 352 >= W8A8_MIN_CHUNK) and nothing else; the int8
    weight-only GEMV every decode step's 224 projections and the head
    (INT8_GEMV_PER_STEP launches a step, by `int8_gemv.launches`) and the
    prefill's head row, with no product cast (`proj:` counters). Then, from
    captured graphs, the device time of one decode step's products through
    the GEMV at M = 1 (224 weights and the head) against what casting the
    same weights to bf16 alone takes."""
    import torch

    from bridgelang_tpu_torch.models.llm import llama
    from bridgelang_tpu_torch.ops.image_ops import frames_to_tensor, preprocess_batch
    from bridgelang_tpu_torch.ops.int8_matmul import int8_gemv
    from bridgelang_tpu_torch.util import profiling

    counts = {"proj": 0, "int8_product": 0}
    real_proj, real_product = llama.proj, llama._int8_product

    def proj(*a, **k):
        counts["proj"] += 1
        return real_proj(*a, **k)

    def product(*a, **k):
        counts["int8_product"] += 1
        return real_product(*a, **k)

    def routes():
        c = profiling.counters("proj:")
        return int8_gemv.launches, c.get("proj:int8_gemv", 0), c.get("proj:int8_cast", 0)

    ids, mask = model8.pad_prompt([model8.prepare_prompt_ids(INSTRUCTIONS[0])])
    pix = preprocess_batch(frames_to_tensor(frames(1, seed=3)[0][None], model8.device), model8.image_transform,
                           dtype=model8.dtype)
    before = routes()
    llama.proj, llama._int8_product = proj, product
    try:
        model8.generate_greedy(params8, torch.as_tensor(ids, device="cuda"), torch.as_tensor(mask, device="cuda"),
                               pix, max_new_tokens=ACTION_DIM)
        torch.cuda.synchronize()
    finally:
        llama.proj, llama._int8_product = real_proj, real_product
    counts["int8_gemv"], counts["route_gemv"], counts["route_cast"] = (a - b for a, b in zip(routes(), before))
    want = {"proj": ACTION_DIM * 7 * N_LAYERS_7B, "int8_product": 7 * N_LAYERS_7B, "int8_gemv": INT8_GEMV_PER_PREDICT,
            "route_gemv": INT8_GEMV_PER_PREDICT, "route_cast": 0}
    log(f"int8 routes over one 7-token predict: {counts} (want {want}: the prefill's projections on torch._int_mm, "
        f"the {ACTION_DIM - 1} decode steps' {INT8_GEMV_PER_STEP} products each (224 projections and the head) "
        f"and the prefill's head row on int8_gemv, nothing cast)")
    if counts != want:
        fail(f"int8: product routes {counts}, expected {want}")
    lp_names = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
    products = [(lp[k], lp[k + "_scale"][:, 0]) for lp in params8["llm"]["layers"] for k in lp_names]
    products.append((params8["llm"]["lm_head"], params8["llm"]["lm_head_scale"][:, 0]))
    xs = {k: torch.randn((1, k), device="cuda", dtype=torch.bfloat16) for k in {w.shape[1] for w, _ in products}}
    gemv_ms = graph_ms([lambda w=w, s=s: int8_gemv(xs[w.shape[1]], w, s) for w, s in products],
                       launches=len(products), replays=3) * len(products)
    cast_ms = graph_ms([lambda w=w: w.to(torch.bfloat16) for w, _ in products], launches=len(products),
                       replays=3) * len(products)
    log(f"int8: one decode step's {len(products)} products ({sum(w.numel() for w, _ in products) / 1e9:.3f} G "
        f"codes) through int8_gemv at M = 1 take {gemv_ms:.3f} ms on the device (bound "
        f"{1e3 * sum(w.numel() for w, _ in products) / HBM_BYTES_PER_S:.3f} ms); casting the same weights to "
        f"bf16 alone takes {cast_ms:.3f} ms")
    return dict(counts, decode_gemv_ms_per_step=gemv_ms, decode_cast_ms_per_step=cast_ms)


def spec_phase(model, params, label: str, int4: bool) -> dict:
    """Batch-1 speculative serving through the graph pair: garbage, perfect
    and partial drafts equal greedy ids at margin 0.25 (accept counts
    printed); calibrate_speculative_margin on 4 frames; the server's default
    mode over SPEC_TICKS ticks of one instruction on slowly perturbed frames
    against a greedy server on the same ticks (median /act, mean accept
    count, launch counts: the prefill's 32 flash_fwd per predict; for int4,
    224 int4_mm_a8 and quantize_a8 per decoder pass, 2 to 8 passes)."""
    import numpy as np
    import torch

    from bridgelang_tpu_torch.serving.server import VLAServer, client_act, draft_from_history
    from bridgelang_tpu_torch.util.compile_cache import warmup_predict

    model.use_graphs = True
    warm_s = warmup_predict(model, params, speculative=True, instruction=INSTRUCTIONS[0])
    img = frames(1, seed=21)[0]
    instr = INSTRUCTIONS[0]
    greedy = model.predict_action_batch(params, [img], [instr], return_tokens=True)[1][0]
    drafts = {"garbage": np.full(ACTION_DIM, 3, np.int32), "perfect": greedy.astype(np.int32),
              "partial": np.concatenate([greedy[:4], [3] * (ACTION_DIM - 4)]).astype(np.int32)}
    accepts = {}
    for kind, draft in drafts.items():
        _, tokens, acc = model._host_predict("speculative", params, [img], [instr], None, draft_tokens=draft)
        accepts[kind] = int(acc[0])
        log(f"spec ({label}) {kind} draft at margin 0.25: ids {tokens[0].tolist()}, greedy {greedy.tolist()}, "
            f"accepted {accepts[kind]} of {ACTION_DIM}")
        if not np.array_equal(tokens[0], greedy):
            fail(f"spec ({label}): the {kind} draft's ids differ from greedy at margin 0.25")
    calib = model.calibrate_speculative_margin(params, frames(4, seed=22), instr)
    log(f"spec ({label}): calibrate_speculative_margin over 4 frames -> {calib}")
    # Random weights leave near-tie logits that the 0.25 gate rejects. At margin 0
    # every exact argmax match is accepted: what a fully accepted draft costs.
    # A measurement, not the contract (bf16 verify-vs-decode noise may flip a tie).
    full = {}
    for kind, draft, margin in (("greedy", None, None), ("perfect, margin 0", drafts["perfect"], 0.0)):
        times = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if draft is None:
                _, tokens, acc = model._host_predict("greedy", params, [img], [instr], None)
            else:
                _, tokens, acc = model._host_predict("speculative", params, [img], [instr], None, draft_tokens=draft,
                                                     margin_threshold=margin)
            times.append(1e3 * (time.perf_counter() - t0))
        full[kind] = dict(ms=statistics.median(times[1:]), accepted=int(acc[0]),
                          ids_equal=bool(np.array_equal(tokens[0], greedy)))
    log(f"spec ({label}): batch-1 predict, greedy {full['greedy']['ms']:.2f} ms; perfect draft at margin 0 "
        f"{full['perfect, margin 0']['ms']:.2f} ms, accepted {full['perfect, margin 0']['accepted']} of {ACTION_DIM}, "
        f"ids {'equal to' if full['perfect, margin 0']['ids_equal'] else 'DIFFERENT from'} greedy (host clock, "
        f"median of 5)")

    rng = np.random.default_rng(23)
    ticks, cur = [], img.astype(np.int16)
    for _ in range(SPEC_TICKS):  # a slow drift: +-2 levels per pixel per tick
        cur = np.clip(cur + rng.integers(-2, 3, size=cur.shape), 0, 255)
        ticks.append(cur.astype(np.uint8))
    out = {}
    for mode in ("speculative", "greedy"):
        server = VLAServer(model, params, speculative_default=mode == "speculative", device=model.device)
        httpd = server.serve_background(port=0)
        reset_launch_counts()
        lat, toks = [], []
        try:
            for frame in ticks:
                t0 = time.perf_counter()
                action, tokens = client_act("127.0.0.1", httpd.server_address[1], frame, instr, return_tokens=True,
                                            timeout=300)
                lat.append(1e3 * (time.perf_counter() - t0))
                check_action(action, f"spec ({label}) {mode} tick")
                toks.append(tokens)
        finally:
            httpd.shutdown()
            httpd.server_close()
        out[mode] = dict(latencies_ms=lat, median_ms=statistics.median(lat[1:]), launches=launch_counts(), tokens=toks)
    counts = out["speculative"]["launches"]
    # the ticks' drafts, as the server made them, for their accept counts
    tick_accepts, prev2, prev1 = [], None, None
    greedy_ticks = [model.predict_action_batch(params, [f], [instr], return_tokens=True)[1][0] for f in ticks]
    for frame, tokens in zip(ticks, out["speculative"]["tokens"]):
        draft = np.zeros(ACTION_DIM, np.int32) if prev1 is None else draft_from_history(
            prev2, prev1, model.cfg.llm.vocab_size)
        _, again, acc = model._host_predict("speculative", params, [frame], [instr], None, draft_tokens=draft)
        tick_accepts.append(int(acc[0]))
        if not np.array_equal(again[0], tokens):
            fail(f"spec ({label}): a tick's ids differ between the server and the same draft's predict")
        prev2, prev1 = prev1, np.asarray(tokens, np.int32)
    same = all(np.array_equal(t, g) for t, g in zip(out["speculative"]["tokens"], greedy_ticks))
    log(f"spec ({label}) server default over {SPEC_TICKS} ticks: /act ms {[round(x, 1) for x in out['speculative']['latencies_ms']]} "
        f"(median of ticks 2+ {out['speculative']['median_ms']:.1f}); greedy server on the same ticks "
        f"{[round(x, 1) for x in out['greedy']['latencies_ms']]} (median {out['greedy']['median_ms']:.1f}); accept counts "
        f"{tick_accepts} (mean {np.mean(tick_accepts):.2f}); ids {'equal' if same else 'DIFFER'} to greedy on every tick; "
        f"launches {counts}")
    if not same:
        fail(f"spec ({label}): the speculative default's ids differ from greedy on some tick")
    if counts["flash_fwd"] != N_LAYERS_7B * SPEC_TICKS:
        fail(f"spec ({label}): expected {N_LAYERS_7B * SPEC_TICKS} flash_fwd launches (the prefills), got {counts}")
    passes = counts["int4_mm_a8"] / INT4_PER_PASS
    if int4 and (counts["quantize_a8"] != counts["int4_mm_a8"] or passes != int(passes)
                 or not 2 * SPEC_TICKS <= passes <= (ACTION_DIM + 1) * SPEC_TICKS):
        fail(f"spec ({label}): int4 launches {counts} are no whole number of decoder passes per tick")
    if not int4 and (counts["int4_mm_a8"] or counts["quantize_a8"] or counts["int4_mm"]):
        fail(f"spec ({label}): unexpected int4 launches {counts}")
    # int8: the head row of each prefill, then 225 per later pass (the verify chunk's 7 rows, the fix-up
    # steps); int4: the int8 head once per pass; bf16: none
    if label == "int8":
        int8_decode_steps(counts["int8_gemv"], SPEC_TICKS, f"spec ({label})")
    elif counts["int8_gemv"] != (passes if int4 else 0):
        fail(f"spec ({label}): int8_gemv launched {counts['int8_gemv']} times, expected "
             f"{passes if int4 else 0} (the int8 head per pass)")
    return dict(accepts=accepts, calibrated_margin=calib, warmup_s=warm_s, tick_accepts=tick_accepts, margin0=full,
                median_ms=out["speculative"]["median_ms"], latencies_ms=out["speculative"]["latencies_ms"],
                greedy_median_ms=out["greedy"]["median_ms"], greedy_latencies_ms=out["greedy"]["latencies_ms"],
                launches=counts, decoder_passes=passes if int4 else None)


def parallel_phase(model, params, greedy_median_ms: float) -> dict:
    """parallel_decode on: POST /act with horizon=HORIZON answers an
    [HORIZON, 7] chunk of finite floats from one masked forward that
    launches no flash_fwd; its /act median beside greedy's."""
    import numpy as np

    from bridgelang_tpu_torch.serving.server import VLAServer, client_act

    model.parallel_decode = True
    server = VLAServer(model, params, device=model.device)
    httpd = server.serve_background(port=0)
    img = frames(1, seed=31)[0]
    try:
        port = httpd.server_address[1]
        client_act("127.0.0.1", port, img, INSTRUCTIONS[0], horizon=HORIZON, timeout=300)  # captures its graph
        reset_launch_counts()
        lat = []
        for i in range(N_SINGLE_REQUESTS):
            t0 = time.perf_counter()
            chunk = client_act("127.0.0.1", port, frames(1, seed=32 + i)[0], INSTRUCTIONS[0], horizon=HORIZON,
                               timeout=300)
            lat.append(1e3 * (time.perf_counter() - t0))
            if chunk.shape != (HORIZON, ACTION_DIM) or not np.isfinite(chunk).all():
                fail(f"parallel: horizon={HORIZON} answered {chunk.shape}, finite {np.isfinite(chunk).all()}")
        counts = launch_counts()
    finally:
        httpd.shutdown()
        httpd.server_close()
        model.parallel_decode = False
    log(f"parallel: horizon={HORIZON}: {N_SINGLE_REQUESTS} x [{HORIZON}, {ACTION_DIM}] finite chunks; /act ms "
        f"{[round(x, 1) for x in lat]} (median {statistics.median(lat):.1f}; greedy batch-1 {greedy_median_ms:.1f}); "
        f"launches {counts}; speculative default {server.speculative_default}")
    expect_counts(counts, {}, "parallel decode (general mask: no flash_fwd)")
    return dict(latencies_ms=lat, median_ms=statistics.median(lat), launches=counts, chunk_shape=[HORIZON, ACTION_DIM])


# --- phase 5: card vs CPU ----------------------------------------------------------


class GradRecorder:
    """An optimizer that keeps a copy of the gradients it is handed."""

    def __init__(self, optimizer):
        self.optimizer, self.grads = optimizer, None

    def update(self, grads, state, params):
        self.grads = [g.detach().clone() for g in grads]
        self.optimizer.update(grads, state, params)


def parity_card_vs_cpu(seed: int, spec: bool) -> dict:
    """Card against CPU on a full-width, depth-cut fp32 model: float weights,
    then the same decoder packed to int4 (w8a8 on and off) and quantized to
    int8 (w8a8 off: ids; on: teacher-forced logits), and greedy over the int8
    KV cache; with `spec`, the speculative graphs' exactness on the card in
    fp32. Then a Phi-2 cut (ids and a LoRA step) and a Mistral cut with its
    window at 64 (ids)."""
    import torch

    # Full widths, depth cut: 2 decoder layers, 3-block towers (tap after block 1).
    gpu, cpu, p_gpu, p_cpu = parity_cut(LLAMA_IDS, seed)
    results = {"float": parity_pair(gpu, cpu, p_gpu, p_cpu, seed, "fp32", {"flash_fwd": 2}, {})}
    results["export"] = export_round_trip(gpu, p_gpu)
    results["golden"] = golden_cpu_to_card(gpu, cpu, p_gpu, p_cpu)

    # The same cut with its decoder packed to int4 on the card (one pack,
    # copied to the CPU): w4a8 and bf16-path tokens, and a QLoRA step.
    from bridgelang_tpu_torch.ops.quant import quantize_llm_int4
    from bridgelang_tpu_torch.training.trainer import tree_map

    llm4 = quantize_llm_int4(p_gpu["llm"], group=INT4_GROUP)
    p4_gpu = dict(p_gpu, llm=llm4)
    p4_cpu = dict(p_cpu, llm=tree_map(lambda t: t.cpu(), llm4))
    n_int4 = 7 * gpu.cfg.llm.n_layers  # per model pass
    for w8a8 in (True, False):
        kernels = ("int4_mm_a8", "quantize_a8") if w8a8 else ("int4_mm",)
        results[f"int4_w8a8_{w8a8}"] = parity_pair(
            w8a8_model(gpu, w8a8), w8a8_model(cpu, w8a8), p4_gpu, p4_cpu, seed, f"int4 w8a8={w8a8}",
            {"flash_fwd": 2, **{kernel: 7 * n_int4 for kernel in kernels}}, {kernels[0]: 2 * n_int4}, train=not w8a8)
    results["int4_w8a8_True"].update(parity_logits(w8a8_model(gpu, True), w8a8_model(cpu, True), p4_gpu, p4_cpu,
                                                   "int4 w8a8=True"))
    del llm4, p4_gpu, p4_cpu

    # The same cut quantized to int8 on the card (one quantization, copied to
    # the CPU): equal ids with w8a8 off; with it on, the w4a8 rule on the
    # teacher-forced logits (activation codes on a rounding tie may differ).
    from bridgelang_tpu_torch.ops.quant import quantize_llm_int8

    llm8 = quantize_llm_int8(p_gpu["llm"])
    p8_gpu, p8_cpu = dict(p_gpu, llm=llm8), dict(p_cpu, llm=tree_map(lambda t: t.cpu(), llm8))
    results["int8_w8a8_False"] = parity_pair(w8a8_model(gpu, False), w8a8_model(cpu, False), p8_gpu, p8_cpu, seed,
                                             "int8 w8a8=False", {"flash_fwd": 2}, {}, train=False)
    results["int8_w8a8_True"] = parity_logits(w8a8_model(gpu, True), w8a8_model(cpu, True), p8_gpu, p8_cpu,
                                              "int8 w8a8=True")
    del llm8, p8_gpu, p8_cpu

    # The int8 KV cache on the fp32 cut: the card's quantized cache against the CPU's.
    gpu.cache_dtype = cpu.cache_dtype = torch.int8
    results["kv8"] = parity_pair(gpu, cpu, p_gpu, p_cpu, seed, "fp32, int8 KV cache", {"flash_fwd": 2}, {},
                                 train=False)
    gpu.cache_dtype = cpu.cache_dtype = torch.bfloat16
    if spec:
        results["spec_fp32"] = spec_exact_fp32(gpu, p_gpu)
    del gpu, cpu, p_gpu, p_cpu
    release_memory()

    # Phi-2 (the kernels at head dim 80; biases drawn, not zero) and Mistral with
    # its window cut to 64, below the 352-token prefill.
    phi_gpu, phi_cpu, pp_gpu, pp_cpu = parity_cut(PHI_IDS, seed, biases=True)
    results["phi"] = parity_pair(phi_gpu, phi_cpu, pp_gpu, pp_cpu, seed, "phi fp32", {"flash_fwd": 2}, {})
    del phi_gpu, phi_cpu, pp_gpu, pp_cpu
    m_gpu, m_cpu, pm_gpu, pm_cpu = parity_cut(MISTRAL_IDS, seed, sliding_window=64)
    results["mistral_window64"] = parity_pair(m_gpu, m_cpu, pm_gpu, pm_cpu, seed, "mistral fp32 window 64",
                                              {"flash_fwd": 2}, {}, train=False)
    del m_gpu, m_cpu, pm_gpu, pm_cpu
    release_memory()
    return results


PARITY_GOLDEN_RECORDS = 2


def golden_cpu_to_card(gpu, cpu, p_gpu, p_cpu) -> dict:
    """verify's golden-trajectory kit across devices: a bundle recorded by
    verify.record_golden on the CPU (plain versions) from the fp32 cut,
    replayed on the card (the kernels, through the graphs) by
    verify.replay_golden: every record's tokens exact."""
    import tempfile

    from bridgelang_tpu_torch import verify

    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        path = os.path.join(tmp, "golden_cpu.npz")
        t0 = time.perf_counter()
        verify.record_golden(cpu, p_cpu, path, PARITY_GOLDEN_RECORDS, None)
        record_s = time.perf_counter() - t0
        reset_launch_counts()
        n_pass, n_total, failures = verify.replay_golden(gpu, p_gpu, path)
        counts = launch_counts()
    log(f"parity (golden): a bundle of {n_total} records recorded on the CPU in {record_s:.1f} s, replayed on the "
        f"card: {n_pass}/{n_total} records exact; launches {counts} {failures[:2]}")
    if n_pass != n_total or counts["flash_fwd"] < 2:
        fail(f"parity (golden): {n_pass}/{n_total} records replayed exactly on the card: {failures[:2]}")
    return dict(passed=n_pass, total=n_total, record_s=record_s, launches=counts)


def parity_cut(ids, seed: int, biases: bool = False, **llm_overrides):
    """A registered VLM at full width cut to 2 decoder layers and 3-block
    towers, fp32, on the card and on the CPU with the same weights (drawn on
    the card; with `biases`, a Phi tree's biases drawn from N(0, 0.1^2))."""
    import dataclasses

    import torch

    from bridgelang_tpu_torch.models.llm.tokenizer import ByteFallbackTokenizer
    from bridgelang_tpu_torch.models.vision.vit import VIT_CONFIGS
    from bridgelang_tpu_torch.models.vla import OpenVLA
    from bridgelang_tpu_torch.models.vlm import VLMConfig
    from bridgelang_tpu_torch.training.trainer import tree_map

    cfg = dataclasses.replace(
        VLMConfig.from_ids(*ids, llm_overrides=dict(n_layers=2, **llm_overrides)),
        vision_override=(dataclasses.replace(VIT_CONFIGS["dinov2-vit-l"], depth=3),
                         dataclasses.replace(VIT_CONFIGS["siglip-vit-so400m"], depth=3)))
    gpu = OpenVLA(cfg, STATS, tokenizer=ByteFallbackTokenizer(), dtype=torch.float32, device="cuda")
    cpu = OpenVLA(cfg, STATS, tokenizer=ByteFallbackTokenizer(), dtype=torch.float32, device="cpu")
    g = torch.Generator(device="cuda").manual_seed(seed)
    p_gpu = gpu.init_params(g)
    if biases:
        llm = p_gpu["llm"]
        for t in [lp[k] for lp in llm["layers"] for k in ("attn_norm_bias", "bq", "bk", "bv", "bo", "b_up", "b_down")]:
            t.normal_(0.0, 0.1, generator=g)
        llm["final_norm_bias"].normal_(0.0, 0.1, generator=g)
        llm["lm_head_bias"].normal_(0.0, 0.1, generator=g)
    return gpu, cpu, p_gpu, tree_map(lambda t: t.cpu(), p_gpu)


def export_round_trip(gpu, p_gpu) -> dict:
    """export_checkpoint of the depth-cut fp32 model (the JAX exporter's
    contract: fp32 model.safetensors, config.json, dataset_statistics.json),
    then load_vla(..., dtype=torch.float32) onto the card: leaves bit-equal
    and batch-2 action ids equal to the in-memory cut's. The cut's configs
    stand in the registries under the real ids meanwhile, as the tests
    patch them."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from bridgelang_tpu_torch.extern.hf_export import export_checkpoint
    from bridgelang_tpu_torch.models.llm import llama
    from bridgelang_tpu_torch.models.load import load_vla
    from bridgelang_tpu_torch.models.vision import vit

    cut_a, cut_b = gpu.cfg.vision_override
    patches = [(llama.LLM_CONFIGS, "llama2-7b-pure", gpu.cfg.llm), (vit.VIT_CONFIGS, "dinov2-vit-l", cut_a),
               (vit.VIT_CONFIGS, "siglip-vit-so400m", cut_b)]
    saved = [(reg, key, reg[key]) for reg, key, _ in patches]
    out = tempfile.mkdtemp(prefix="smoke_export_", dir=os.path.join(ROOT, "build"))
    try:
        for reg, key, value in patches:
            reg[key] = value
        t0 = time.perf_counter()
        export_checkpoint(gpu, p_gpu, out)
        export_s = time.perf_counter() - t0
        n_bytes = os.path.getsize(os.path.join(out, "model.safetensors"))
        model, params = load_vla(out, dtype=torch.float32)
        model.tokenizer = gpu.tokenizer
        n = assert_params_bit_equal(params, p_gpu, "parity export round trip")
        imgs = frames(2, seed=19)
        _, want = gpu.predict_action_batch(p_gpu, imgs, INSTRUCTIONS[:2], return_tokens=True)
        _, got = model.predict_action_batch(params, imgs, INSTRUCTIONS[:2], return_tokens=True)
        if not np.array_equal(got, want):
            fail(f"parity export round trip: loaded ids {got.tolist()} != in-memory {want.tolist()}")
        model.graphs.clear()
        gpu.graphs.clear()
    finally:
        for reg, key, value in saved:
            reg[key] = value
        shutil.rmtree(out, ignore_errors=True)
    log(f"parity: export_checkpoint of the fp32 depth-cut model ({n_bytes / 1e9:.2f} GB fp32, {export_s:.1f} s), "
        f"load_vla on the card: {n} leaves bit-equal, batch-2 ids {got.tolist()} equal")
    return dict(bytes=n_bytes, export_s=export_s, leaves=n, tokens=got.tolist())


def parity_logits(gpu, cpu, p_gpu, p_cpu, label: str) -> dict:
    """The card's greedy ids teacher-forced through both sides (the prefill,
    then the 6 ids as one cached chunk): logits within 0.05 max|logit| of
    the CPU's, and equal argmax wherever the CPU's top-2 margin clears twice
    that (the w4a8 token-id rule of tests/test_torch_int4.py)."""
    import numpy as np
    import torch

    from bridgelang_tpu_torch.models.llm.llama import lm_logits
    from bridgelang_tpu_torch.ops.image_ops import frames_to_tensor, preprocess_batch

    imgs = frames(2, seed=11)
    ids, mask = gpu.pad_prompt([gpu.prepare_prompt_ids(t) for t in INSTRUCTIONS[:2]])
    tokens = None
    logits = {}
    with torch.inference_mode():
        for name, model, params in (("cuda", gpu, p_gpu), ("cpu", cpu, p_cpu)):
            dev = model.device
            pix = preprocess_batch(frames_to_tensor(np.stack(imgs), dev), model.image_transform)
            args = (torch.as_tensor(ids, device=dev), torch.as_tensor(mask, device=dev), pix)
            if tokens is None:
                tokens = model.generate_greedy(params, *args, max_new_tokens=ACTION_DIM)
            toks = tokens.to(dev)
            last_hidden, cache, true_len = model._prefill(params, *args, ACTION_DIM, torch.float32)
            pos = true_len[:, None] + torch.arange(ACTION_DIM - 1, device=dev)[None, :]
            rest = model._decode_logits(params, model.cfg.llm, toks[:, :-1], pos, cache)
            logits[name] = torch.cat([lm_logits(params["llm"], last_hidden, model.cfg.llm), rest], dim=1).float().cpu()
    g, c = logits["cuda"], logits["cpu"]
    tol = 0.05 * float(c.abs().max())
    err = float((g - c).abs().max())
    top2 = c.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 2 * tol
    agree = (g.argmax(-1) == c.argmax(-1)) | ~clear
    log(f"parity ({label}): teacher-forced logits max|cuda-cpu| {err:.4g} (tol {tol:.4g} = 0.05 max|logit|); argmax "
        f"equal at all {int(clear.sum())} of {clear.numel()} positions whose CPU margin clears {2 * tol:.4g}; "
        f"card ids {tokens.cpu().tolist()}")
    if err > tol or not bool(agree.all()):
        fail(f"parity ({label}): the teacher-forced logits break the w4a8 rule between the card and the CPU")
    return dict(logit_err=err, tol=tol, positions_checked=int(clear.sum()), tokens=tokens.cpu().tolist())


def spec_exact_fp32(gpu, p_gpu) -> dict:
    """The depth-cut fp32 model with an fp32 KV cache on the card, through
    the speculative graphs: ids exactly greedy's for the perfect, garbage,
    partial and mid-mismatch drafts (the exact contract of the JAX
    tests/test_vlm.py:249)."""
    import numpy as np
    import torch

    gpu.cache_dtype = torch.float32
    img = frames(1, seed=41)[0]
    greedy = gpu.predict_action_batch(p_gpu, [img], [INSTRUCTIONS[0]], return_tokens=True)[1][0].astype(np.int32)
    mid = greedy.copy()
    mid[2] = (mid[2] + 1) % 500
    drafts = {"perfect": greedy, "garbage": np.full(ACTION_DIM, 3, np.int32),
              "partial": np.concatenate([greedy[:4], [7] * (ACTION_DIM - 4)]).astype(np.int32), "mid_mismatch": mid}
    accepts, margin0 = {}, {}
    for kind, draft in drafts.items():
        _, tokens, acc = gpu._host_predict("speculative", p_gpu, [img], [INSTRUCTIONS[0]], None, draft_tokens=draft)
        accepts[kind] = int(acc[0])
        if not np.array_equal(tokens[0], greedy):
            fail(f"spec fp32: the {kind} draft's ids {tokens[0].tolist()} differ from greedy {greedy.tolist()}")
        # margin 0 accepts every exact argmax match (a measurement: cuBLAS may tile the verify chunk apart from decode)
        _, tokens0, acc0 = gpu._host_predict("speculative", p_gpu, [img], [INSTRUCTIONS[0]], None, draft_tokens=draft,
                                             margin_threshold=0.0)
        margin0[kind] = dict(accepted=int(acc0[0]), ids_equal=bool(np.array_equal(tokens0[0], greedy)))
    log(f"spec fp32 (depth-cut model, fp32 cache, graphs): ids equal to greedy {greedy.tolist()} for every draft at "
        f"margin 0.25, accepted {accepts}; at margin 0: {margin0}")
    gpu.graphs.clear()
    return dict(accepts=accepts, tokens=greedy.tolist(), margin0=margin0)


def parity_pair(gpu, cpu, p_gpu, p_cpu, seed: int, label: str, gen_counts: dict, train_counts: dict,
                train: bool = True) -> dict:
    """Card (kernels) against CPU (plain versions) on one depth-cut model:
    7 greedy tokens for two prompts must be equal, with the card launching
    `gen_counts` and the CPU nothing; then (`train`) one adapter train step
    must give the same loss (1e-5 relative) and adapter gradients (1e-4 of
    max |g|), the card launching the flash kernels (4, 2, 2) times plus
    `train_counts`."""
    import numpy as np
    import torch

    from bridgelang_tpu_torch.ops.image_ops import frames_to_tensor, preprocess_batch

    imgs = frames(2, seed=11)
    ids, mask = gpu.pad_prompt([gpu.prepare_prompt_ids(t) for t in INSTRUCTIONS[:2]])
    out = {}
    for name, model, params in (("cuda", gpu, p_gpu), ("cpu", cpu, p_cpu)):
        dev = model.device
        pix = preprocess_batch(frames_to_tensor(np.stack(imgs), dev), model.image_transform)
        reset_launch_counts()
        tok = model.generate_greedy(params, torch.as_tensor(ids, device=dev), torch.as_tensor(mask, device=dev),
                                    pix, max_new_tokens=7)
        out[name] = (tok.cpu(), launch_counts())
    log(f"parity ({label}): depth-cut model, tokens cuda {out['cuda'][0].tolist()} (launches {out['cuda'][1]}), "
        f"cpu {out['cpu'][0].tolist()}")
    expect_counts(out["cuda"][1], gen_counts, f"parity ({label}) card generate")
    expect_counts(out["cpu"][1], {}, f"parity ({label}) CPU generate")
    if not torch.equal(out["cuda"][0], out["cpu"][0]):
        fail(f"parity ({label}): action token ids differ between the card (kernels) and the CPU (plain versions)")
    result = {"tokens": out["cuda"][0].tolist()}
    if not train:
        return result

    # One adapter train step on each side, the same adapters (B drawn too, so
    # that every adapter has a gradient) and the same batch.
    from bridgelang_tpu_torch.training.lora import lora_trainable_mask
    from bridgelang_tpu_torch.training.trainer import (
        OptimConfig, init_train_state, make_optimizer, make_vla_train_step, tree_map)

    lp_gpu = with_lora(p_gpu, "cuda", seed + 2, b_std=0.01)
    lp_cpu = dict(p_cpu, llm=tree_map(lambda t: t.detach().cpu(), lp_gpu["llm"]))
    step_out = {}
    for name, model, params in (("cuda", gpu, lp_gpu), ("cpu", cpu, lp_cpu)):
        mask = lora_trainable_mask(params)
        opt = make_optimizer(OptimConfig(learning_rate=LORA_LR), params, trainable_mask=mask)
        state = init_train_state(params, opt, trainable_mask=mask)
        recorder = GradRecorder(opt)
        step = make_vla_train_step(model, recorder, trainable_mask=mask, compute_dtype=torch.float32,
                                   image_transform=model.image_transform, remat=True)
        reset_launch_counts()
        _, m = step(state, lora_batch(model, 2, seed))
        step_out[name] = (float(m["loss"]), [g.cpu() for g in recorder.grads], launch_counts())
    (l_gpu, g_gpu, n_gpu), (l_cpu, g_cpu, n_cpu) = step_out["cuda"], step_out["cpu"]
    g_max = max(float(g.abs().max()) for g in g_cpu)
    g_err = max(float((a - b).abs().max()) for a, b in zip(g_gpu, g_cpu))
    log(f"parity ({label}): one adapter train step, loss cuda {l_gpu:.7f} cpu {l_cpu:.7f} "
        f"(rel {abs(l_gpu - l_cpu) / abs(l_cpu):.2e}, tol 1e-5); adapter grads max|cuda-cpu| {g_err:.3e} vs "
        f"max|g| {g_max:.3e} (tol 1e-4 x max|g|); launches cuda {n_gpu}")
    expect_counts(n_gpu, {"flash_fwd": 4, "flash_bwd_dq": 2, "flash_bwd_dkv": 2, **train_counts},
                  f"parity ({label}) card train step")
    expect_counts(n_cpu, {}, f"parity ({label}) CPU train step")
    if abs(l_gpu - l_cpu) > 1e-5 * abs(l_cpu) or g_err > 1e-4 * g_max:
        fail(f"parity ({label}): the train step disagrees between the card (kernels) and the CPU (plain versions)")
    return dict(result, loss_rel_err=abs(l_gpu - l_cpu) / abs(l_cpu), grad_err=g_err, grad_max=g_max)


# --- phase: the decoder variants (Phi-2, Mistral, the int8 KV cache) ------------------

# (model id, vision backbone, LLM backbone, projector) of registered VLMs
LLAMA_IDS = ("prism-dinosiglip-224px+7b", "dinosiglip-vit-so-224px", "llama2-7b-pure", "no-align+fused-gelu-mlp")
PHI_IDS = ("prism-phi-dinosiglip+3b", "dinosiglip-vit-so-224px", "phi-2-3b", "no-align+fused-gelu-mlp")
MISTRAL_IDS = ("prism-mistral-dinosiglip+7b", "dinosiglip-vit-so-224px", "mistral-v0.1-7b-pure",
               "no-align+fused-gelu-mlp")
MISTRAL_LAYERS = 4       # of its 32 decoder layers: bounds the phase's time
PHI_LAYERS = 16          # of its 32 decoder layers: bounds the whole smoke's time
PHI_LORA_STEPS = 3       # timed LoRA steps of the Phi VLA after one warm step
KV8_BAND = 0.05          # int8 against bf16 KV cache: |dlogit| <= 0.05 max|logit| (the w8a8 paths' rule)


def build_registered(ids, seed: int, **llm_overrides):
    """A registered VLM (model id, vision id, LLM id, projector) as an
    OpenVLA at full width in bf16, random weights drawn on the card from
    `seed`; `llm_overrides` cut its decoder (n_layers)."""
    import torch

    from bridgelang_tpu_torch.models.llm.tokenizer import ByteFallbackTokenizer
    from bridgelang_tpu_torch.models.vla import OpenVLA
    from bridgelang_tpu_torch.models.vlm import VLMConfig

    cfg = VLMConfig.from_ids(*ids, llm_overrides=llm_overrides or None)
    model = OpenVLA(cfg, STATS, tokenizer=ByteFallbackTokenizer(), dtype=torch.bfloat16, device="cuda")
    t0 = time.perf_counter()
    params = model.init_params(torch.Generator(device="cuda").manual_seed(seed))
    torch.cuda.synchronize()
    n_llm = base_param_count(params["llm"])
    log(f"{ids[0]}: {cfg.llm.n_layers} decoder layers (dim {cfg.llm.dim}, {cfg.llm.n_heads} heads of "
        f"{cfg.llm.head_dim}, {cfg.llm.n_kv_heads} KV heads, window {cfg.llm.sliding_window}), "
        f"{n_llm / 1e9:.3f} B decoder parameters; {tensor_gb(params):.2f} GB of bf16 weights drawn in "
        f"{time.perf_counter() - t0:.1f} s")
    return model, params


def graph_decode_ms(model, params, b: int) -> float:
    """Decode ms per token of a replayed B=b greedy predict: the host-clock
    medians of 7-token and 1-token predicts, their difference over 6."""
    imgs = frames(b, seed=21)
    t1, t7 = (time_graph_generate(model, params, imgs, INSTRUCTIONS[:b], n) for n in (1, ACTION_DIM))
    return (t7 - t1) / (ACTION_DIM - 1)


def teacher_forced_logits(model, params, imgs, tokens, cache_dtype):
    """Logits [B, 7, V] (fp32) of the prefill and of 6 decode steps fed
    `tokens` [B, 7] (the same for every cache dtype), over a KV cache of
    `cache_dtype`."""
    import numpy as np
    import torch

    from bridgelang_tpu_torch.models.llm.llama import lm_logits
    from bridgelang_tpu_torch.ops.image_ops import frames_to_tensor, preprocess_batch

    b, n = tokens.shape
    ids, mask = model.pad_prompt([model.prepare_prompt_ids(t) for t in INSTRUCTIONS[:b]])
    pix = preprocess_batch(frames_to_tensor(np.stack(imgs[:b]), model.device), model.image_transform,
                           dtype=model.dtype)
    cfg = model.cfg.llm
    tok = torch.as_tensor(tokens, device=model.device).long()
    with torch.inference_mode():
        last, cache, true_len = model._prefill(params, torch.as_tensor(ids, device=model.device),
                                               torch.as_tensor(mask, device=model.device), pix, n, cache_dtype)
        steps = [lm_logits(params["llm"], last, cfg)]
        for i in range(n - 1):
            steps.append(model._decode_logits(params, cfg, tok[:, i:i + 1], (true_len + i)[:, None], cache))
        return torch.cat(steps, dim=1).float()


def kv_cache_int8(model, params, label: str) -> dict:
    """The int8 KV cache (codes + bf16 per-(token, head) scales) against the
    bf16 cache on one served model: replayed ids equal eager ids under the
    int8 cache at B=1 and B=4, each predict launching flash_fwd once per
    layer (the prefill); teacher-forced logits over the bf16 run's ids
    within KV8_BAND max|logit| of the bf16 cache's, the argmax equal where
    the bf16 top-2 margin clears twice that, token 0 equal (the prefill
    attends unquantized); the server refuses the speculative default; cache
    GB at B=4 and decode ms per token at B=1 and B=4 for both dtypes."""
    import numpy as np
    import torch

    from bridgelang_tpu_torch.models.llm.llama import init_kv_cache
    from bridgelang_tpu_torch.serving.server import VLAServer

    imgs = frames(4, seed=13)
    n_layers = model.cfg.llm.n_layers
    f_len = model.pad_prompt([model.prepare_prompt_ids(INSTRUCTIONS[0])])[0].shape[1] + model.num_patches
    out = {"cache_gb_b4": {}, "decode_ms_per_token": {}}
    model.graphs.clear()
    for dtype in (torch.bfloat16, torch.int8):
        name = str(dtype).replace("torch.", "")
        model.cache_dtype = dtype
        cache = init_kv_cache(model.cfg.llm, 4, f_len + ACTION_DIM, dtype=dtype, device="meta")
        out["cache_gb_b4"][name] = tensor_gb(cache)
        out["decode_ms_per_token"][name] = {b: graph_decode_ms(model, params, b) for b in (1, 4)}
    log(f"{label} KV cache at B=4, S={f_len + ACTION_DIM}: bf16 {out['cache_gb_b4']['bfloat16']:.4f} GB, int8 "
        f"{out['cache_gb_b4']['int8']:.4f} GB; decode ms per token (graphs) "
        + "; ".join(f"{k}: B=1 {v[1]:.3f}, B=4 {v[4]:.3f}" for k, v in out["decode_ms_per_token"].items()))

    model.cache_dtype = torch.bfloat16
    model.use_graphs = False
    ref = model.predict_action_batch(params, imgs, INSTRUCTIONS[:4], return_tokens=True)[1]
    model.cache_dtype = torch.int8
    ids = {}
    for use_graphs in (True, False):
        model.use_graphs = use_graphs
        for b in (1, 4):
            ids[(use_graphs, b)] = model.predict_action_batch(params, imgs[:b], INSTRUCTIONS[:b], return_tokens=True)[1]
    model.use_graphs = True
    for b in (1, 4):
        same = np.array_equal(ids[(True, b)], ids[(False, b)])
        log(f"{label} int8 KV cache: B={b} ids, graph {ids[(True, b)].tolist()} eager {ids[(False, b)].tolist()} "
            f"{'equal' if same else 'DIFFER'}")
        if not same:
            fail(f"{label}: replayed graph ids differ from eager ids under the int8 KV cache at B={b}")
    reset_launch_counts()
    model.predict_action_batch(params, imgs[:1], INSTRUCTIONS[:1])
    launches = launch_counts()
    expect_counts(launches, {"flash_fwd": n_layers}, f"{label} int8 KV cache predict")

    want = teacher_forced_logits(model, params, imgs, ref, torch.bfloat16)
    got = teacher_forced_logits(model, params, imgs, ref, torch.int8)
    band = KV8_BAND * want.abs().amax(dim=-1)  # [B, 7]
    diff = (got - want).abs().amax(dim=-1)
    top2 = torch.topk(want, 2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 2 * band
    same_argmax = got.argmax(dim=-1) == want.argmax(dim=-1)
    use = float((diff / band).max())
    log(f"{label} int8 KV cache vs bf16, teacher-forced over the bf16 ids {ref.tolist()}: max|dlogit| / "
        f"({KV8_BAND} max|logit|) = {use:.3f}; {int(clear.sum())} of {clear.numel()} steps clear twice the band, "
        f"argmax equal on {int((same_argmax & clear).sum())} of them; token-0 logits max|d| {float(diff[:, 0].max()):.3g}")
    if use > 1.0 or not bool(same_argmax[clear].all()) or not np.array_equal(ids[(False, 4)][:, 0], ref[:, 0]):
        fail(f"{label}: the int8 KV cache leaves the bf16 cache's logits band or argmax")

    server = VLAServer(model, params, max_batch=1, speculative_default=True, device=model.device)
    refused = not server.speculative_default
    server.close()
    if not refused:
        fail(f"{label}: the server kept the speculative default with an int8 KV cache")
    log(f"{label} int8 KV cache: VLAServer(speculative_default=True) serves greedy (speculative default off)")
    model.cache_dtype = torch.bfloat16
    model.graphs.clear()
    release_memory()
    return dict(out, logit_band_use=use, steps_clear=int(clear.sum()), ids_int8=ids[(True, 4)].tolist(),
                ids_bf16=ref.tolist(), launches=launches)


def phi_phase() -> dict:
    """Phi-2 (prism-phi-dinosiglip+3b) at full width, its decoder cut to
    PHI_LAYERS (L) of 32 layers, bf16 random weights: served through graphs
    (ids equal to eager, L flash_fwd at D=80 per predict) and VLAServer; the
    int8 KV cache; LoRA steps (2L/L/L flash launches at D=80 per step); then
    packed to int4 and served w4a8 (6 projections x L layers int4_mm_a8 and
    quantize_a8 per pass); then QLoRA over the int4 base with w8a8 off (12 L
    int4_mm per step at Phi's shapes, 2L/L/L flash launches), merged and
    predicting."""
    import torch

    from bridgelang_tpu_torch.ops.quant import quantize_llm_int4

    model, params = build_registered(PHI_IDS, SEED, n_layers=PHI_LAYERS)
    n_layers = model.cfg.llm.n_layers
    out = {"llm_gb": tensor_gb(params["llm"]), "model_gb": tensor_gb(params)}
    ids, _ = model.pad_prompt([model.prepare_prompt_ids(INSTRUCTIONS[0])])
    out["prefill_len"] = ids.shape[1] + model.num_patches
    log(f"phi: prompt bucket {ids.shape[1]} + {model.num_patches} patches = prefill {out['prefill_len']}")
    imgs = frames(4, seed=3)
    out["warmup_peak_gb"], out["capture_s"] = graphs_equal_eager(model, params, "phi bf16", imgs)
    out["decode_ms_per_token"] = graph_decode_ms(model, params, 1)
    out["profile"] = profile_predict(model, params)
    out["serve"] = serve(model, params, N_SINGLE_REQUESTS, {"flash_fwd": n_layers})
    log(f"phi serve: median batch-1 /act {out['serve']['median_ms']:.1f} ms, micro-batch of 4 "
        f"{out['serve']['batch4_ms']:.1f} ms; decode {out['decode_ms_per_token']:.3f} ms per token (graphs); "
        f"decoder {out['llm_gb']:.2f} GB, model {out['model_gb']:.2f} GB")
    out["kv8"] = kv_cache_int8(model, params, "phi")
    model.graphs.clear()
    release_memory()
    out["lora"] = train_adapters(model, params, SEED, "phi_lora", PHI_LORA_STEPS,
                                 {"flash_fwd": 2 * n_layers, "flash_bwd_dq": n_layers, "flash_bwd_dkv": n_layers},
                                 require_fall=False)
    model.graphs.clear()
    release_memory()

    params = dict(params, llm=quantize_llm_int4(params["llm"], group=INT4_GROUP))
    release_memory()
    model4 = w8a8_model(model, w8a8=True)
    per_pass = 6 * n_layers  # wq, wk, wv, wo, w_up, w_down: Phi has no w_gate
    per_predict = {"flash_fwd": n_layers, "int4_mm_a8": ACTION_DIM * per_pass, "quantize_a8": ACTION_DIM * per_pass,
                   "int8_gemv": ACTION_DIM}  # the int8 head, one row per pass
    peaks4, _ = graphs_equal_eager(model4, params, "phi int4 w4a8", imgs, buckets=(1, 4))
    _, counts4 = counted_ids(model4, params, imgs[0], INSTRUCTIONS[0], per_predict, "phi int4 w4a8 predict")
    out["int4"] = dict(llm_gb=tensor_gb(params["llm"]), warmup_peak_gb=peaks4, launches=counts4,
                       decode_ms_per_token=graph_decode_ms(model4, params, 1), profile=profile_predict(model4, params))
    log(f"phi int4 w4a8: decoder + int8 embedding and head {out['int4']['llm_gb']:.2f} GB; {per_pass} int4_mm_a8 "
        f"and quantize_a8 per decoder pass; decode {out['int4']['decode_ms_per_token']:.3f} ms per token (graphs)")
    model4.graphs.clear()
    release_memory()
    # QLoRA over the int4 base (w8a8 off, as the 7B qlora phase): int4_mm at Phi's shapes in the forward and
    # the full-remat recompute (2 x 6 projections x the layers), the flash pair at head dim 80 in the backward;
    # then the merge (dequantize, add, requantize) and one action through the merged int4 weights.
    out["qlora"] = train_adapters(w8a8_model(model, w8a8=False), params, SEED, "phi_qlora", PHI_LORA_STEPS,
                                  {"flash_fwd": 2 * n_layers, "flash_bwd_dq": n_layers, "flash_bwd_dkv": n_layers,
                                   "int4_mm": 2 * per_pass}, serve_model=model4, require_fall=False)
    model4.graphs.clear()
    del model, model4, params
    release_memory()
    return out


def mistral_phase() -> dict:
    """Mistral (prism-mistral-dinosiglip+7b: 8 KV heads, window 4096) at
    full width, its decoder cut to MISTRAL_LAYERS layers: graph ids equal to
    eager at B=1 and B=4, MISTRAL_LAYERS flash_fwd launches per predict."""
    model, params = build_registered(MISTRAL_IDS, SEED + 1, n_layers=MISTRAL_LAYERS)
    imgs = frames(4, seed=3)
    peaks, capture_s = graphs_equal_eager(model, params, "mistral", imgs, buckets=(1, 4))
    ids, counts = counted_ids(model, params, imgs[0], INSTRUCTIONS[0], {"flash_fwd": MISTRAL_LAYERS}, "mistral predict")
    out = dict(warmup_peak_gb=peaks, capture_s=capture_s, ids=ids, launches=counts,
               decode_ms_per_token=graph_decode_ms(model, params, 1))
    log(f"mistral ({MISTRAL_LAYERS} layers): ids {ids}; {MISTRAL_LAYERS} flash_fwd per predict; decode "
        f"{out['decode_ms_per_token']:.3f} ms per token (graphs)")
    model.graphs.clear()
    del model, params
    release_memory()
    return out


# --- phase: fine-tuning through the port's entry points ------------------------------

FT_DATASET = "libero_spatial_no_noops"
FT_EPISODES = 24         # the native store: LIBERO's layout, 256x256 frames, 7-D actions, 8-D states
FT_EPISODE_STEPS = 50
FT_FRAME = 256
FT_SHARDS = 4            # store files, written in parallel
FT_STEPS = 6             # finetune.main's bf16 LoRA run
FT_SHORT_STEPS = 3       # the int8-QLoRA and parallel-objective runs
FT_TIMED = (2, FT_STEPS)  # steps 3-6: the median step, the data wait and the profiled idle share
FT_SHUFFLE = 400         # shuffle-buffer frames: the finetune default of 100_000 holds 19.7 GB of 256x256 frames
                         # in the one reader process, and filling it would read this 1200-frame store 83 times;
                         # a smaller buffer shortens each run's first-batch wait
FT_CHUNK = 8             # --action_chunk of the parallel-objective run
FT_CUT_LAYERS = 2        # train.main: full width, the decoder cut to 2 layers
FT_TRAIN_STEPS = 5       # train.main steps of the uninterrupted run (saved at step 4, resumed for step 5)
TRAIN_DOTS_PEAK_GB = 49.44  # the train phase's "dots" peak on an H100 (PERF.md), when that phase does not run


def write_native_store(root: str) -> dict:
    """FT_EPISODES episodes of FT_EPISODE_STEPS steps in LIBERO's native layout
    under <root>/FT_DATASET, written with the port's writer, FT_SHARDS files
    in parallel. Frames are gradients that drift over the episode plus
    integer noise; actions a smooth random walk in [-1, 1] with the gripper
    at +-1; states 8-D. Returns the raw actions and the bytes and seconds."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from bridgelang_tpu_torch import native
    from bridgelang_tpu_torch.vla.datasets.native_loader import write_episode

    out = os.path.join(root, FT_DATASET)
    os.makedirs(out)
    t, hw = FT_EPISODE_STEPS, FT_FRAME
    yy, xx = np.mgrid[0:hw, 0:hw].astype(np.float32)

    def episode(ep: int) -> dict:
        rng = np.random.default_rng(1000 + ep)
        phase = rng.uniform(0, 6, 3).astype(np.float32)
        base = np.stack([128 + 80 * np.sin(xx / (23 + 5 * c) + phase[c]) * np.cos(yy / (31 + 3 * c)) for c in range(3)],
                        -1)
        drift = np.arange(t, dtype=np.float32)[:, None, None, None]
        noise = rng.integers(-3, 4, (t, hw, hw, 3), dtype=np.int16)
        images = np.clip(base[None] + drift + noise, 0, 255).astype(np.uint8)
        wrist = np.clip(255 - base[None] + drift + noise, 0, 255).astype(np.uint8)
        move = np.clip(np.cumsum(rng.normal(0, 0.1, (t, 6)), axis=0), -1, 1)
        grip = np.where(np.sin(np.arange(t) / 7.0 + ep) > 0, 1.0, -1.0)[:, None]
        return dict(images=images, wrist_images=wrist, actions=np.concatenate([move, grip], 1).astype(np.float32),
                    states=rng.normal(size=(t, 8)).astype(np.float32), language=INSTRUCTIONS[ep % len(INSTRUCTIONS)])

    def shard(i: int) -> list:
        acts = []
        with native.TFRecordWriter(os.path.join(out, f"episodes-{i:05d}.tfrecord")) as w:
            for ep in range(i, FT_EPISODES, FT_SHARDS):
                e = episode(ep)
                write_episode(w, **e)
                acts.append((ep, e["actions"]))
        return acts

    t0 = time.perf_counter()
    with ThreadPoolExecutor(FT_SHARDS) as pool:
        acts = [a for part in pool.map(shard, range(FT_SHARDS)) for a in part]
    dt = time.perf_counter() - t0
    n_bytes = sum(os.path.getsize(os.path.join(out, f)) for f in os.listdir(out))
    raw = FT_EPISODES * t * 2 * hw * hw * 3
    log(f"finetune: native store {FT_EPISODES} episodes x {t} steps ({FT_EPISODES * t} frames, 2 cameras "
        f"{hw}x{hw}), {n_bytes / 1e6:.1f} MB in {FT_SHARDS} files ({raw / 1e6:.0f} MB of raw frames) written in "
        f"{dt:.1f} s")
    return dict(bytes=n_bytes, raw_frame_bytes=raw, seconds=dt,
                actions=np.concatenate([a for _, a in sorted(acts, key=lambda x: x[0])]))


# --- TFDS datasets written without TensorFlow (the tfds phase, and the tests) ----------

TFDS_VERSION = "1.0.0"
TFDS_FRACTAL = "fractal20220817_data"
TFDS_FRACTAL_EPISODES = 8  # the second dataset: RT-1's layout (nested action dict), small
TFDS_FRACTAL_STEPS = 30
TFDS_MIX = "smoke_libero_fractal"  # the tfds phase's train.main mixture: both datasets, weight 1 each
TFDS_FT_STEPS = 4        # finetune.main steps over the TFDS directory
TFDS_TRAIN_STEPS = 4     # train.main steps over the mixture
FIXTURE_DIR = os.path.join(ROOT, "tests", "data", "images")
_TFDS_CLS = "tensorflow_datasets.core.features."


def tfds_tensor(shape=(), dtype="float32", scalar=False) -> dict:
    """A Tensor (or Scalar) node of features.json, TFDS's proto JSON."""
    cls = "scalar.Scalar" if scalar else "tensor_feature.Tensor"
    return {"pythonClassName": _TFDS_CLS + cls,
            "tensor": {"shape": {"dimensions": [str(d) for d in shape]} if shape else {}, "dtype": dtype,
                       "encoding": "none"}}


def tfds_image(shape, fmt: str = "jpeg") -> dict:
    return {"pythonClassName": _TFDS_CLS + "image_feature.Image",
            "image": {"shape": {"dimensions": [str(d) for d in shape]}, "dtype": "uint8", "encodingFormat": fmt}}


def tfds_text() -> dict:
    return {"pythonClassName": _TFDS_CLS + "text_feature.Text", "text": {}}


def tfds_dict(features: dict) -> dict:
    return {"pythonClassName": _TFDS_CLS + "features_dict.FeaturesDict", "featuresDict": {"features": features}}


def tfds_steps(step: dict, metadata: dict) -> dict:
    """An RLDS episode: `steps` (a Dataset of the step FeaturesDict) and
    `episode_metadata`."""
    return tfds_dict({"steps": {"pythonClassName": _TFDS_CLS + "dataset_feature.Dataset",
                                "sequence": {"feature": tfds_dict(step), "length": "-1"}},
                      "episode_metadata": tfds_dict(metadata)})


def _rlds_step_flags() -> dict:
    return {"is_first": tfds_tensor(dtype="bool", scalar=True), "is_last": tfds_tensor(dtype="bool", scalar=True),
            "is_terminal": tfds_tensor(dtype="bool", scalar=True), "reward": tfds_tensor(scalar=True),
            "discount": tfds_tensor(scalar=True)}


def libero_features(hw: int = 256) -> dict:
    """features.json of OpenVLA's modified LIBERO RLDS datasets."""
    return tfds_steps({
        "observation": tfds_dict({"image": tfds_image((hw, hw, 3)), "wrist_image": tfds_image((hw, hw, 3)),
                                  "state": tfds_tensor((8,)), "joint_state": tfds_tensor((7,))}),
        "action": tfds_tensor((7,)), "language_instruction": tfds_text(), **_rlds_step_flags()},
        {"file_path": tfds_text()})


def fractal_features(hw: int = 256) -> dict:
    """features.json of RT-1's fractal20220817_data (the keys the pipeline
    reads, and the nested action dict)."""
    return tfds_steps({
        "observation": tfds_dict({"image": tfds_image((hw, hw, 3)), "natural_language_instruction": tfds_text(),
                                  "base_pose_tool_reached": tfds_tensor((7,)), "gripper_closed": tfds_tensor((1,))}),
        "action": tfds_dict({"world_vector": tfds_tensor((3,)), "rotation_delta": tfds_tensor((3,)),
                             "gripper_closedness_action": tfds_tensor((1,)),
                             "terminate_episode": tfds_tensor((3,), "int32"),
                             "base_displacement_vector": tfds_tensor((2,)),
                             "base_displacement_vertical_rotation": tfds_tensor((1,))}),
        **_rlds_step_flags()}, {"episode_id": tfds_text()})


def camera_fixtures() -> list:
    """The 16 committed 256x256 q95 4:2:0 JPEG camera frames."""
    return [open(os.path.join(FIXTURE_DIR, f"camera_{i:02d}.jpg"), "rb").read() for i in range(16)]


def _rlds_flags(t: int, seed: int) -> dict:
    import numpy as np

    first, last = np.zeros(t, np.int64), np.zeros(t, np.int64)
    first[0], last[-1] = 1, 1
    return {"steps/is_first": first, "steps/is_last": last, "steps/is_terminal": last.copy(),
            "steps/reward": last.astype(np.float32), "steps/discount": np.ones(t, np.float32)}


def libero_episode(ep: int, t: int, cameras: list) -> dict:
    """One episode in LIBERO's layout as {flat feature key: values}: the
    camera fixtures in turn, 8-D states, 7-D actions (a smooth random walk in
    [-1, 1], the gripper at -1/+1)."""
    import numpy as np

    rng = np.random.default_rng(2000 + ep)
    n = len(cameras)
    move = np.clip(np.cumsum(rng.normal(0, 0.1, (t, 6)), axis=0), -1, 1)
    grip = np.where(np.sin(np.arange(t) / 7.0 + ep) > 0, 1.0, -1.0)[:, None]
    return {"steps/observation/image": [cameras[(ep + i) % n] for i in range(t)],
            "steps/observation/wrist_image": [cameras[(3 * ep + 2 * i + 7) % n] for i in range(t)],
            "steps/observation/state": rng.normal(size=(t, 8)).astype(np.float32),
            "steps/observation/joint_state": rng.normal(size=(t, 7)).astype(np.float32),
            "steps/action": np.concatenate([move, grip], 1).astype(np.float32),
            "steps/language_instruction": [INSTRUCTIONS[ep % len(INSTRUCTIONS)].encode()] * t,
            **_rlds_flags(t, ep), "episode_metadata/file_path": [f"libero/episode_{ep}.hdf5".encode()]}


def fractal_episode(ep: int, t: int, cameras: list) -> dict:
    """One episode in RT-1's layout: the action as a dict, a relative
    gripper command in {-1, 0, 1}, the instruction under the observation."""
    import numpy as np

    rng = np.random.default_rng(3000 + ep)
    n = len(cameras)
    grip = rng.choice([-1.0, 0.0, 0.0, 1.0], t).astype(np.float32)[:, None]
    return {"steps/observation/image": [cameras[(5 * ep + i) % n] for i in range(t)],
            "steps/observation/natural_language_instruction": [INSTRUCTIONS[(ep + 1) % len(INSTRUCTIONS)].encode()] * t,
            "steps/observation/base_pose_tool_reached": rng.normal(size=(t, 7)).astype(np.float32),
            "steps/observation/gripper_closed": rng.uniform(0, 1, (t, 1)).astype(np.float32),
            "steps/action/world_vector": rng.uniform(-0.5, 0.5, (t, 3)).astype(np.float32),
            "steps/action/rotation_delta": rng.uniform(-0.3, 0.3, (t, 3)).astype(np.float32),
            "steps/action/gripper_closedness_action": grip,
            "steps/action/terminate_episode": np.tile(np.array([0, 1, 0], np.int32), (t, 1)),
            "steps/action/base_displacement_vector": np.zeros((t, 2), np.float32),
            "steps/action/base_displacement_vertical_rotation": np.zeros((t, 1), np.float32),
            **_rlds_flags(t, ep), "episode_metadata/episode_id": [f"{ep}".encode()]}


def write_tfds_dataset(root: str, name: str, episodes: list, features: dict, n_shards: int,
                       template=None) -> str:
    """A TFDS directory <root>/<name>/TFDS_VERSION/ in TFDS's TFRecord layout:
    `n_shards` shards of consecutive episodes (tf.train.Example records from
    the port's serializer, framed by the port's TFRecord writer, written in
    parallel), dataset_info.json (one "train" split with its shard lengths;
    the default file name template unless `template`) and features.json."""
    from concurrent.futures import ThreadPoolExecutor

    from bridgelang_tpu_torch import native
    from bridgelang_tpu_torch.vla.datasets.rlds.tfds_reader import DEFAULT_TEMPLATE, serialize_example

    out = os.path.join(root, name, TFDS_VERSION)
    os.makedirs(out, exist_ok=True)
    bounds = [len(episodes) * i // n_shards for i in range(n_shards + 1)]
    fmt = template or DEFAULT_TEMPLATE

    def shard(i: int) -> None:
        path = os.path.join(out, fmt.format(DATASET=name, SPLIT="train", FILEFORMAT="tfrecord",
                                            SHARD_INDEX=f"{i:05d}", NUM_SHARDS=f"{n_shards:05d}",
                                            SHARD_X_OF_Y=f"{i:05d}-of-{n_shards:05d}"))
        with native.TFRecordWriter(path) as w:
            for ep in episodes[bounds[i]:bounds[i + 1]]:
                w.write(serialize_example(ep))

    with ThreadPoolExecutor(n_shards) as pool:
        list(pool.map(shard, range(n_shards)))
    split = {"name": "train", "shardLengths": [str(bounds[i + 1] - bounds[i]) for i in range(n_shards)],
             "numBytes": str(sum(os.path.getsize(os.path.join(out, f)) for f in os.listdir(out)))}
    if template:
        split["filepathTemplate"] = template
    with open(os.path.join(out, "dataset_info.json"), "w") as f:
        json.dump({"name": name, "version": TFDS_VERSION, "fileFormat": "tfrecord", "moduleName": "chip_smoke",
                   "splits": [split]}, f, indent=1)
    with open(os.path.join(out, "features.json"), "w") as f:
        json.dump(features, f, indent=1)
    return out


class EntryPointProbe:
    """Watches an entry point run without changing it: while installed, the
    trainer's `make_vla_train_step` hands out a wrapped step (per step: wall
    ms to the end of the device's work, the host's wait for the batch,
    launches, loss; torch.profiler with CUDA activity only over steps
    `profile` = [a, b) (None: none); it keeps the model, optimizer, mask, last state and
    batch), the dataset's batches are timed as they come (RLDS: the wait for
    each batch; LLaVA: each batch's host work, its items and the collator),
    and checkpoint saves and HF exports are timed. `per_step`: the launches
    every step must make (else the run fails). `memory_steps` = N: the
    caching allocator's history recorded over the first N steps, and the
    device memory live at its peak by allocation site (`memory_sites`,
    in `self.memory`); `entry_gb`: the memory allocated when the first step
    begins."""

    def __init__(self, label: str, per_step: dict, profile=FT_TIMED, on_first_step=None, memory_steps: int = 0):
        self.label, self.per_step, self.profile, self.on_first_step = label, per_step, profile, on_first_step
        self.memory_steps, self.memory, self.entry_gb = memory_steps, None, None
        self.steps, self.waits, self.saves, self.exports, self.dataset_names = [], [], [], [], []
        self.host_batch_ms, self._items_ms = [], 0.0
        self.model = self.optimizer = self.mask = self.state = self.batch = self.dataset = None
        self.profile_result, self.step_peak_gb, self.reader_rss_gb = None, 0.0, None
        self._patches = []

    def _patch(self, obj, name, value):
        self._patches.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def __enter__(self):
        import torch

        from bridgelang_tpu_torch import preprocessing
        from bridgelang_tpu_torch.extern import hf_export
        from bridgelang_tpu_torch.training import checkpointing, trainer
        from bridgelang_tpu_torch.vla import materialize

        probe = self
        make_step, get_dataset = trainer.make_vla_train_step, materialize.get_vla_dataset_and_collator
        get_llava = preprocessing.get_dataset_and_collator
        save, export = checkpointing.CheckpointManager.save, hf_export.export_checkpoint

        class TimedBatches:
            def __init__(self, it):
                self.it = it

            def __getattr__(self, name):
                return getattr(self.it, name)

            def __iter__(self):
                return self

            def __next__(self):
                t0 = time.perf_counter()
                batch = next(self.it)
                probe.waits.append(1e3 * (time.perf_counter() - t0))
                probe.dataset_names.append(list(batch.get("dataset_names", [])))
                if len(probe.waits) == 1 and self.it._procs:  # the reader (its shuffle buffer full), a worker
                    probe.reader_rss_gb = [vm_rss_gb(p.pid) for p in self.it._procs[:2]]
                return batch

        class TimedDataset:
            def __init__(self, ds):
                self.ds = ds

            def __getattr__(self, name):
                return getattr(self.ds, name)

            def __iter__(self):
                return TimedBatches(iter(self.ds))

            def batches(self, state=None):
                return TimedBatches(self.ds.batches(state))

        def get_dataset_timed(*a, **k):
            ds, tok, coll = get_dataset(*a, **k)
            probe.dataset = ds
            return TimedDataset(ds), tok, coll

        class TimedItems:  # a LLaVA dataset: the items' host ms add up until the collator ends the batch
            def __init__(self, ds):
                self.ds = ds

            def __getattr__(self, name):
                return getattr(self.ds, name)

            def __len__(self):
                return len(self.ds)

            def __getitem__(self, i):
                t0 = time.perf_counter()
                item = self.ds[i]
                probe._items_ms += 1e3 * (time.perf_counter() - t0)
                return item

        def get_llava_timed(*a, **k):
            ds, collator = get_llava(*a, **k)
            probe.dataset = ds

            def collate(examples):
                t0 = time.perf_counter()
                batch = collator(examples)
                probe.host_batch_ms.append(probe._items_ms + 1e3 * (time.perf_counter() - t0))
                probe._items_ms = 0.0
                return batch

            return TimedItems(ds), collate

        def make_step_probed(model, optimizer, *a, **k):
            step = make_step(model, optimizer, *a, **k)
            probe.model, probe.optimizer, probe.mask = model, optimizer, k.get("trainable_mask")

            def run(state, batch):
                i = len(probe.steps)
                if i == 0:
                    if probe.on_first_step is not None:
                        probe.on_first_step(state)
                    torch.cuda.reset_peak_memory_stats()
                    probe.entry_gb = torch.cuda.memory_allocated() / 1e9
                    if probe.memory_steps:
                        probe._history_base = torch.cuda.memory_allocated()
                        torch.cuda.memory._record_memory_history(max_entries=MEMORY_HISTORY_ENTRIES, stacks="python")
                prof = None
                if probe.profile and i == probe.profile[0]:
                    from torch.profiler import ProfilerActivity, profile

                    probe._prof = prof = profile(activities=[ProfilerActivity.CUDA])
                    prof.__enter__()
                    probe._prof_t0 = time.perf_counter()
                torch.cuda.synchronize()
                before = launch_counts()
                t0 = time.perf_counter()
                state, m = step(state, batch)
                loss = float(m["loss"])
                torch.cuda.synchronize()
                ms = 1e3 * (time.perf_counter() - t0)
                counts = {k2: v - before[k2] for k2, v in launch_counts().items()}
                probe.steps.append(dict(ms=ms, loss=loss, launches=counts,
                                        mask_sums=batch["attention_mask"].sum(dim=1).tolist()))
                probe.step_peak_gb = max(probe.step_peak_gb, torch.cuda.max_memory_allocated() / 1e9)
                if probe.memory_steps and i == probe.memory_steps - 1:
                    snapshot = torch.cuda.memory._snapshot()
                    torch.cuda.memory._record_memory_history(enabled=None)
                    probe.memory = memory_sites(snapshot, probe._history_base)
                    del snapshot
                if probe.profile and i == probe.profile[1] - 1 and getattr(probe, "_prof", None) is not None:
                    probe._finish_profile()
                if not math.isfinite(loss):
                    fail(f"{probe.label} step {i + 1}: non-finite loss {loss}")
                expect_counts(counts, probe.per_step, f"{probe.label} step {i + 1}")
                probe.state, probe.batch = state, batch
                return state, m

            return run

        def save_timed(mgr, state, step, *a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            path = save(mgr, state, step, *a, **k)
            n = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)
            probe.saves.append(dict(step=step, seconds=time.perf_counter() - t0, bytes=n, path=str(path)))
            return path

        def export_timed(model, params, out_dir, *a, **k):
            t0 = time.perf_counter()
            out = export(model, params, out_dir, *a, **k)
            n = sum(os.path.getsize(os.path.join(out, f)) for f in os.listdir(out))
            probe.exports.append(dict(seconds=time.perf_counter() - t0, bytes=n, path=str(out)))
            return out

        self._patch(trainer, "make_vla_train_step", make_step_probed)
        self._patch(materialize, "get_vla_dataset_and_collator", get_dataset_timed)
        self._patch(preprocessing, "get_dataset_and_collator", get_llava_timed)
        self._patch(checkpointing.CheckpointManager, "save", save_timed)
        self._patch(hf_export, "export_checkpoint", export_timed)
        self._t0 = time.perf_counter()
        return self

    def _finish_profile(self):
        from torch.autograd import DeviceType

        wall_ms = 1e3 * (time.perf_counter() - self._prof_t0)
        self._prof.__exit__(None, None, None)
        kernels = [e for e in self._prof.events() if e.device_type == DeviceType.CUDA]
        n = self.profile[1] - self.profile[0]
        busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
        by_name = {}
        for e in kernels:
            by_name[e.name[:80]] = by_name.get(e.name[:80], 0.0) + e.time_range.elapsed_us() / 1e3 / n
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        self.profile_result = (dict(steps=n, wall_ms=wall_ms, device_ms=busy_ms, idle_share=1 - busy_ms / wall_ms,
                                    launches_per_step=len(kernels) / n, top_ms_per_step=top) if kernels else None)
        self._prof = None

    def __exit__(self, *exc):
        import torch

        self.wall_s = time.perf_counter() - self._t0
        if self.memory_steps and self.memory is None and self.steps:  # fewer steps than asked for
            torch.cuda.memory._record_memory_history(enabled=None)
        for obj, name, value in reversed(self._patches):
            setattr(obj, name, value)
        self._patches.clear()
        if getattr(self, "_prof", None) is not None:
            self._prof.__exit__(None, None, None)
            self._prof = None

    def summary(self) -> dict:
        a, b = self.profile or (min(1, len(self.steps) - 1), len(self.steps))
        timed = self.steps[a:b]
        waits = self.waits[:len(self.steps)]  # the loop takes one batch more before it stops
        r = dict(wall_s=self.wall_s, steps=len(self.steps), losses=[s["loss"] for s in self.steps],
                 step_ms=[s["ms"] for s in self.steps], data_wait_ms=waits,
                 median_step_ms=statistics.median(s["ms"] for s in timed) if timed else None,
                 median_data_wait_ms=statistics.median(waits[a:b]) if waits[a:b] else None,
                 step_peak_gb=self.step_peak_gb, entry_gb=self.entry_gb, memory=self.memory,
                 reader_rss_gb=self.reader_rss_gb, profile=self.profile_result,
                 saves=self.saves, exports=self.exports, host_batch_ms=self.host_batch_ms,
                 launches={k: sum(s["launches"][k] for s in self.steps) for k in KERNEL_NAMES})
        idle = (self.profile_result or {}).get("idle_share")
        log(f"{self.label}: {self.wall_s:.1f} s in the entry point, {len(self.steps)} steps, losses {[round(x, 4) for x in r['losses']]}; step ms "
            f"{[round(x, 1) for x in r['step_ms']]} (median of steps {a + 1}-{b}: "
            f"{r['median_step_ms'] if r['median_step_ms'] is None else round(r['median_step_ms'], 1)}); host wait "
            f"for each batch ms {[round(x, 1) for x in waits]}; device idle over steps {a + 1}-{b}: "
            f"{'not measured' if idle is None else f'{100 * idle:.1f}%'}; peak {self.step_peak_gb:.2f} GB; resident "
            f"memory at the first batch (the frame reader, a batch worker): "
            f"{[x if x is None else round(x, 3) for x in self.reader_rss_gb or []] or 'not measured'} GB; "
            f"saves "
            f"{[(s['step'], round(s['seconds'], 2), round(s['bytes'] / 1e9, 2)) for s in self.saves]} (step, s, GB); "
            f"exports {[(round(e['seconds'], 2), round(e['bytes'] / 1e9, 2)) for e in self.exports]} (s, GB)")
        return r


MEMORY_HISTORY_ENTRIES = 1_000_000  # allocator events kept: two steps of the 2-layer cut need ~1e4-1e5


def memory_sites(snapshot, base_bytes: int, top: int = 8) -> dict:
    """The device memory live at the peak of a window the caching allocator
    recorded (torch.cuda.memory._record_memory_history, then _snapshot), by
    allocation site: the device trace's allocs and completed frees replayed
    from `base_bytes`, the memory allocated when the recording began. A
    site is an allocation's innermost frame in the port's package (else in
    this script, else its innermost frame); "before the window" is what was
    live when the recording began and still is at the peak. Returns the
    peak and the `top` sites, in GB."""
    import torch

    trace = [e for e in snapshot["device_traces"][torch.cuda.current_device()]
             if e["action"] in ("alloc", "free_completed")]

    def site(frames) -> str:
        for key in ("bridgelang_tpu_torch", "chip_smoke"):
            for f in frames:
                if key in f["filename"]:
                    return f"{key}{f['filename'].split(key, 1)[1]}:{f['line']} {f['name']}"
        return f"{frames[0]['filename']}:{frames[0]['line']} {frames[0]['name']}" if frames else "no frame"

    cur = peak = base_bytes
    peak_at = -1
    for i, e in enumerate(trace):
        cur += e["size"] if e["action"] == "alloc" else -e["size"]
        if cur > peak:
            peak, peak_at = cur, i
    live, before = {}, base_bytes
    for e in trace[:peak_at + 1]:
        if e["action"] == "alloc":
            live[e["addr"]] = (e["size"], e.get("frames", []))
        elif live.pop(e["addr"], None) is None:
            before -= e["size"]
    by_site = {"before the window": before}
    for size, frames in live.values():
        key = site(frames)
        by_site[key] = by_site.get(key, 0) + size
    ranked = sorted(by_site.items(), key=lambda kv: -kv[1])[:top]
    return dict(peak_gb=peak / 1e9, events=len(trace), sites_gb=[(k, v / 1e9) for k, v in ranked])


def vm_rss_gb(pid: int):
    """A process's resident memory (VmRSS), or None if it has gone."""
    try:
        with open(f"/proc/{pid}/status") as f:
            return next(int(line.split()[1]) * 1024 / 1e9 for line in f if line.startswith("VmRSS:"))
    except (OSError, StopIteration):
        return None


def disk_free_gb(path: str) -> float:
    import shutil

    return shutil.disk_usage(path).free / 1e9


def plain_int8_merge(codes, scale, a, b):
    """The int8 merge written out: dequantize, add B A, requantize per output
    column with the scale absmax x fp32(1/127)."""
    import torch

    w32 = codes.float() * scale.float() + b.float() @ a.float()
    absmax = w32.abs().amax(dim=1, keepdim=True)
    new_scale = torch.where(absmax == 0, torch.ones_like(absmax), absmax * torch.full_like(absmax, 1.0 / 127.0))
    return torch.clamp(torch.round(w32 / new_scale), -127, 127).to(torch.int8), new_scale.to(torch.bfloat16)


def finetune_phase(ckpt_dir: str, dots_peak_gb: float, mesh: bool = False) -> dict:
    """The port's `finetune` and `train` entry points on the card, fed by the
    port's TF-free pipeline from a native store (write_native_store):
    1. finetune.main, bf16 LoRA r=32 on the published-layout 7B of `ckpt_dir`
       (batch 16, image_aug, FT_STEPS steps, the save of the trainable state
       and the bf16 HF export of the merged model); the export loaded with
       load_vla predicts one action under the store's statistics, inside its
       [q01, q99];
    2. int8 QLoRA (3 steps): no int8 code moves, and merge_lora of one
       layer's trained adapters into the int8 base equals plain_int8_merge;
    3. the parallel objective (--action_chunk 8, "full" remat, 3 steps): no
       flash launch, peak under the train phase's "dots" peak; one more
       step under "dots" for its peak; an [8, 7] chunk from the trained
       weights through generate_parallel;
    4. train.main at full width with the decoder cut to FT_CUT_LAYERS layers:
       FT_TRAIN_STEPS steps saved at step 4, then resumed from that
       checkpoint for one step, bit-equal to the uninterrupted run.
    With `mesh`, the mesh phase (mesh_phase) runs after 3., on the published
    7B and the store, before they are deleted; its result is "mesh".
    Each run's directory goes once its checks pass, so that the phase's disk
    footprint peaks at the source checkpoint plus one export (~31 GB)."""
    import dataclasses
    import glob
    import shutil
    import tempfile

    import numpy as np
    import torch

    from bridgelang_tpu_torch import finetune, train
    from bridgelang_tpu_torch.conf import parse_cli
    from bridgelang_tpu_torch.models.llm import llama
    from bridgelang_tpu_torch.models.llm.tokenizer import ByteFallbackTokenizer
    from bridgelang_tpu_torch.models.load import load_vla
    from bridgelang_tpu_torch.training.lora import merge_lora
    from bridgelang_tpu_torch.training.trainer import tree_leaves

    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="smoke_ft_", dir=os.path.join(ROOT, "build"))
    result = {"disk_free_gb_before": disk_free_gb(work)}
    log(f"finetune: {result['disk_free_gb_before']:.1f} GB free under {work}")
    reset_launch_counts()
    try:
        data = os.path.join(work, "data")
        store = write_native_store(data)
        result["store"] = {k: v for k, v in store.items() if k != "actions"}
        runs = os.path.join(work, "runs")
        common = ["--vla_path", ckpt_dir, "--data_root_dir", data, "--dataset_name", FT_DATASET, "--run_root_dir", runs,
                  "--batch_size", str(TRAIN_BATCH), "--shuffle_buffer_size", str(FT_SHUFFLE), "--save_steps", "1000",
                  "--lora_rank", str(LORA_RANK)]
        lora_step = {"flash_fwd": 2 * N_LAYERS_7B, "flash_bwd_dq": N_LAYERS_7B, "flash_bwd_dkv": N_LAYERS_7B}

        # 1. bf16 LoRA, saved merged and exported
        with EntryPointProbe("finetune bf16 LoRA", lora_step) as probe:
            run = finetune.main(parse_cli(finetune.FinetuneConfig, common + [
                "--max_steps", str(FT_STEPS), "--image_aug", "true", "--export_hf", "true"]))
        lora = probe.summary()
        stats = json.loads((run / "dataset_statistics.json").read_text())
        if stats != finetune.jsonable(probe.dataset.dataset_statistics):
            fail("finetune: the run's dataset_statistics.json differs from the pipeline's statistics")
        acts = store["actions"].copy()
        acts[:, -1] = 1.0 - np.clip(acts[:, -1], 0, 1)  # the libero standardization's gripper
        q = stats[FT_DATASET]["action"]
        for key, quantile in (("q01", 0.01), ("q99", 0.99)):
            want = np.quantile(acts, quantile, axis=0)
            if not np.allclose(q[key], want, rtol=1e-6, atol=1e-7):
                fail(f"finetune: statistics {key} {q[key]} != numpy's over the written actions {want.tolist()}")
        del probe
        release_memory()
        export = run / "hf_export"
        t0 = time.perf_counter()
        served, sparams = load_vla(str(export))
        load_s = time.perf_counter() - t0
        served.tokenizer = ByteFallbackTokenizer()
        action = served.predict_action(sparams, frames(1, seed=41)[0], INSTRUCTIONS[0], unnorm_key=FT_DATASET)
        check_action(action, "finetune: predict_action of the loaded export")
        # unnormalized dims lie in [q01, q99]; the gripper (mask off) keeps its bin value in [-1, 1]
        lo = np.where(q["mask"], q["q01"], -1.0)
        hi = np.where(q["mask"], q["q99"], 1.0)
        if not ((action >= lo - 1e-6) & (action <= hi + 1e-6)).all():
            fail(f"finetune: action {action.tolist()} outside [{lo.tolist()}, {hi.tolist()}] (q01/q99 where the "
                 "statistics' mask is on, [-1, 1] where off)")
        log(f"finetune: the export loads in {load_s:.1f} s and predicts {np.round(action, 4).tolist()} under "
            f"unnorm_key={FT_DATASET} (inside [q01, q99], the gripper in [-1, 1]); statistics equal the pipeline's "
            "and numpy's quantiles")
        served.graphs.clear()
        del served, sparams
        release_memory()
        lora.update(export_load_s=load_s, action=action.tolist())
        result["lora"] = lora
        shutil.rmtree(run)
        result["disk_free_gb_after_lora"] = disk_free_gb(work)

        # 2. int8 QLoRA: frozen codes, and the merge against the plain formula
        snap = {}

        def snapshot(state):
            for i, lp in enumerate(state.params["llm"]["layers"]):
                for k, t in lp.items():
                    if t.dtype == torch.int8:
                        snap[(i, k)] = t.detach().cpu()

        with EntryPointProbe("finetune int8 QLoRA", lora_step, profile=(1, FT_SHORT_STEPS),
                             on_first_step=snapshot) as probe:
            run = finetune.main(parse_cli(finetune.FinetuneConfig, common + [
                "--max_steps", str(FT_SHORT_STEPS), "--use_quantization", "true", "--quantization_bits", "8",
                "--export_hf", "false"]))
        q8 = probe.summary()
        layers = probe.state.params["llm"]["layers"]
        moved = [key for key, t in snap.items() if not torch.equal(t, layers[key[0]][key[1]].cpu())]
        if not snap or moved:
            fail(f"finetune int8: {len(moved)} of {len(snap)} int8 code tensors changed during training: {moved[:4]}")
        li = N_LAYERS_7B // 2
        lp = layers[li]
        merged = merge_lora({"layers": [lp]})["layers"][0]
        want_q, want_s = plain_int8_merge(lp["w_up"], lp["w_up_scale"], lp["w_up_lora_a"].detach(),
                                          lp["w_up_lora_b"].detach())
        if not (torch.equal(merged["w_up"], want_q) and torch.equal(merged["w_up_scale"], want_s)):
            fail(f"finetune int8: layer {li} w_up merged codes differ from dequantize + B A + requantize in "
                 f"{int((merged['w_up'] != want_q).sum())} places")
        n_moved = int((merged["w_up"] != lp["w_up"]).sum())
        log(f"finetune int8: {len(snap)} int8 code tensors unchanged over {q8['steps']} steps; merge_lora of layer "
            f"{li}'s trained adapters into its int8 w_up ({tuple(merged['w_up'].shape)} codes, {n_moved} moved) "
            "equals dequantize + B A + requantize")
        del merged, lp, layers, probe, snap
        release_memory()
        result["int8_qlora"] = q8
        shutil.rmtree(run)

        # 3. the parallel objective: masked attention, no flash launch
        with EntryPointProbe("finetune parallel objective", {}, profile=(1, FT_SHORT_STEPS)) as probe:
            run = finetune.main(parse_cli(finetune.FinetuneConfig, common + [
                "--max_steps", str(FT_SHORT_STEPS), "--parallel_decode", "true", "--action_chunk", str(FT_CHUNK),
                "--remat_policy", "full", "--export_hf", "false"]))
        par = probe.summary()
        if par["step_peak_gb"] >= dots_peak_gb:
            fail(f"finetune parallel: peak {par['step_peak_gb']:.2f} GB under full remat, not under the train "
                 f"phase's dots peak {dots_peak_gb:.2f} GB")
        from bridgelang_tpu_torch.training.trainer import make_vla_train_step

        dots = make_vla_train_step(probe.model, probe.optimizer, trainable_mask=probe.mask,
                                   image_transform=probe.model.image_transform, remat_policy="dots",
                                   parallel_decode_objective=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, m = dots(probe.state, probe.batch)
        float(m["loss"])
        dots_ms = [1e3 * (time.perf_counter() - t0)]
        par["dots"] = dict(step_ms=dots_ms, peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        model = probe.model
        model.tokenizer = ByteFallbackTokenizer()
        mparams = dict(state.params, llm=merge_lora(state.params["llm"]))
        chunk = model.predict_action_chunk(mparams, frames(1, seed=43)[0], INSTRUCTIONS[0], horizon=FT_CHUNK,
                                           unnorm_key=FT_DATASET)
        if chunk.shape != (FT_CHUNK, ACTION_DIM) or not np.isfinite(chunk).all():
            fail(f"finetune parallel: generate_parallel gave {chunk.shape}, finite {np.isfinite(chunk).all()}")
        log(f"finetune parallel: peak {par['step_peak_gb']:.2f} GB under full remat (train phase's dots "
            f"{dots_peak_gb:.2f} GB); under dots {par['dots']['peak_gb']:.2f} GB, steps "
            f"{[round(x, 1) for x in dots_ms]} ms; generate_parallel on the trained weights: a "
            f"[{FT_CHUNK}, {ACTION_DIM}] chunk of finite actions")
        model.graphs.clear()
        del model, mparams, state, dots, probe
        release_memory()
        result["parallel"] = par
        shutil.rmtree(run)
        if mesh:
            counts = launch_counts()  # the finetune phase's counts leave the mesh phase's out
            result["mesh"] = mesh_phase(ckpt_dir, common, lora["losses"])
            for name, fn in kernel_wrappers().items():
                fn.launches = counts[name]
        shutil.rmtree(ckpt_dir, ignore_errors=True)  # the published 7B: train.main draws its own weights

        # 4. train.main, depth cut, saved, resumed for one step
        full_llm = llama.LLM_CONFIGS["llama2-7b-pure"]
        llama.LLM_CONFIGS["llama2-7b-pure"] = dataclasses.replace(full_llm, n_layers=FT_CUT_LAYERS)
        try:
            targs = ["--vla.type", "prism-dinosiglip-224px+mx-bridge", "--vla.data_mix", FT_DATASET,
                     "--vla.global_batch_size", str(TRAIN_BATCH), "--vla.per_device_batch_size", str(TRAIN_BATCH),
                     "--vla.expected_device_count", "1", "--vla.shuffle_buffer_size", str(FT_SHUFFLE),
                     "--vla.freeze_vision_backbone", "true", "--vla.save_interval", str(FT_TRAIN_STEPS - 1),
                     "--max_steps_override", str(FT_TRAIN_STEPS), "--data_root_dir", data, "--run_root_dir", runs]
            cut_step = {"flash_fwd": 2 * FT_CUT_LAYERS, "flash_bwd_dq": FT_CUT_LAYERS, "flash_bwd_dkv": FT_CUT_LAYERS}
            # profiled: steps 2-4, before the save that follows step 4; the allocator's history over step 1
            with EntryPointProbe("train (2 layers)", cut_step, profile=(1, FT_TRAIN_STEPS - 1),
                                 memory_steps=1) as probe_a:
                state_a = train.main(parse_cli(train.TrainConfig, targs + ["--run_id", "a"]))
            tr = probe_a.summary()
            ckpt4 = glob.glob(os.path.join(runs, "a", "checkpoints", f"step-{FT_TRAIN_STEPS - 1:06d}-*"))
            ckpt5 = glob.glob(os.path.join(runs, "a", "checkpoints", f"step-{FT_TRAIN_STEPS:06d}-*"))
            if len(ckpt4) != 1 or len(ckpt5) != 1:
                fail(f"train: expected one step-{FT_TRAIN_STEPS - 1} and one step-{FT_TRAIN_STEPS} checkpoint, "
                     f"found {ckpt4}, {ckpt5}")
            shutil.rmtree(ckpt5[0])  # the run's state stays in memory; the disk holds one save less
            with EntryPointProbe("train resumed", cut_step, profile=None) as probe_b:
                state_b = train.main(parse_cli(train.TrainConfig, targs + [
                    "--run_id", "b", "--pretrained_checkpoint", ckpt4[0], "--resume_step", str(FT_TRAIN_STEPS - 1)]))
            res = probe_b.summary()
            la, lb = tr["losses"][-1], res["losses"][0]
            leaves_equal = all(torch.equal(x, y) for x, y in zip(tree_leaves(state_a.params),
                                                                 tree_leaves(state_b.params)))
            moments_equal = all(not isinstance(x, torch.Tensor) or torch.equal(x, y)
                                for x, y in zip(tree_leaves(state_a.opt_state), tree_leaves(state_b.opt_state)))
            n_params = sum(t.numel() for t in tree_leaves(state_a.params))
            steps_equal = state_a.step == state_b.step
            # Both runs' states go before the ring run, whose peak is held to run a's (PR 15's ring run began
            # with both still allocated).
            tr["states_gb"] = [sum(t.numel() * t.element_size() for t in tree_leaves([st.params, st.opt_state])
                                   if isinstance(t, torch.Tensor) and t.is_cuda) / 1e9 for st in (state_a, state_b)]
            log(f"train: the two runs' states (parameters and moments) hold {tr['states_gb'][0]:.2f} + "
                f"{tr['states_gb'][1]:.2f} GB on the card; freed before the ring run")
            del state_a, state_b, probe_a, probe_b
            release_memory()
            if mesh:  # the ring on the same cut, from the same flags
                t_ring = time.perf_counter()
                result["mesh"]["train_ring"] = mesh_ring_train(targs, tr, cut_step)
                result["mesh"]["phase_s"] += time.perf_counter() - t_ring
        finally:
            llama.LLM_CONFIGS["llama2-7b-pure"] = full_llm
        if la != lb or not leaves_equal or not moments_equal or not steps_equal:
            fail(f"train resume: step {FT_TRAIN_STEPS} from the checkpoint differs from the uninterrupted one: loss "
                 f"{lb} vs {la}, parameters equal {leaves_equal}, moments equal {moments_equal}")
        log(f"train: OpenVLA at full width, {FT_CUT_LAYERS} decoder layers ({n_params / 1e9:.3f} B fp32 params, vision "
            f"frozen), {FT_TRAIN_STEPS} steps, saved at step {FT_TRAIN_STEPS - 1}; resumed from that checkpoint, "
            f"step {FT_TRAIN_STEPS}: loss {lb!r} == {la!r}, parameters and moments bit-equal")
        tr.update(resume=dict(loss=[la, lb], bit_equal=True, saves=res["saves"], step_ms=res["step_ms"]),
                  params=n_params)
        result["train"] = tr
    finally:
        shutil.rmtree(work, ignore_errors=True)
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    result["launches"] = launch_counts()
    result["disk_free_gb_after"] = disk_free_gb(os.path.join(ROOT, "build"))
    result["phase_s"] = time.perf_counter() - t_phase
    log(f"finetune phase: {result['phase_s']:.1f} s; launches {result['launches']}; disk free "
        f"{result['disk_free_gb_before']:.1f} GB before, {result['disk_free_gb_after']:.1f} GB after")
    return result


# --- phase mesh ------------------------------------------------------------------

MESH_REQUESTS = 3        # /act requests to each mesh deploy
MESH_FT_STEPS = 3        # finetune.main --mesh_shape steps, held to the first steps of the unsharded run


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _get_json(port: int, path: str) -> dict:
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request("GET", path)
        return json.loads(conn.getresponse().read())
    finally:
        conn.close()


def _launcher(world: int, module: str) -> list:
    """The command that starts `module` on `world` ranks: one process for a
    mesh of one card (the entry point makes its one-rank NCCL group), else
    torchrun with a rendezvous on this host (--standalone)."""
    if world == 1:
        return [sys.executable, "-m", module]
    return [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", str(world), "-m", module]


def start_mesh_deploy(ckpt_dir: str, world: int, label: str, extra: list, mesh: bool = True) -> dict:
    """Start `deploy --checkpoint <dir> --mesh_spec tensor=<world>` (+
    `extra`) on `world` ranks, or without `mesh` the same deploy without
    --mesh_spec in one process (the same run's baseline); `finish_mesh_deploy`
    checks it."""
    port = _free_port()
    name = label if mesh else f"{label}_plain"
    log_path = os.path.join(os.path.dirname(ckpt_dir), f"mesh_deploy_{name}.log")
    cmd = (_launcher(world, "bridgelang_tpu_torch.deploy") + ["--mesh_spec", f"tensor={world}"] if mesh
           else [sys.executable, "-m", "bridgelang_tpu_torch.deploy"])
    cmd += ["--checkpoint", ckpt_dir, "--host", "127.0.0.1", "--port", str(port), *extra]
    out = open(log_path, "w")
    return dict(proc=subprocess.Popen(cmd, cwd=ROOT, stdout=out, stderr=subprocess.STDOUT), port=port, out=out,
                log_path=log_path, t0=time.perf_counter(), label=label, world=world if mesh else 1, mesh=mesh)


def finish_mesh_deploy(h: dict, model, params) -> dict:
    """A started mesh deploy (or its plain baseline): time to listen, then
    MESH_REQUESTS /act with a zero draft (the speculative path, whose
    response carries the ids), each action and ids equal to the in-process
    predict_action_speculative of (model, params); /stats before and after
    the requests gives the predicts, the decoder's collectives and the
    serving rank's kernel launches; then the deploy is stopped."""
    import numpy as np

    from bridgelang_tpu_torch.serving.server import client_act

    proc, port, label, world, mesh = h["proc"], h["port"], h["label"], h["world"], h["mesh"]
    what = f"{label} tensor={world}" if mesh else f"{label} without --mesh_spec"
    imgs = frames(MESH_REQUESTS, seed=17)
    draft = np.zeros(ACTION_DIM, np.int32)
    try:
        listen_s = None
        while time.perf_counter() - h["t0"] < DEPLOY_LISTEN_S and proc.poll() is None:
            try:
                if _get_json(port, "/healthz").get("status") == "ok":
                    listen_s = time.perf_counter() - h["t0"]
                    break
            except OSError:
                time.sleep(0.5)
        if listen_s is None:
            raise RuntimeError(f"deploy did not listen within {DEPLOY_LISTEN_S} s (exit code {proc.poll()})")
        before = _get_json(port, "/stats")
        lat = []
        for i, img in enumerate(imgs):
            t1 = time.perf_counter()
            got, ids = client_act("127.0.0.1", port, img, INSTRUCTIONS[i], draft_tokens=draft, return_tokens=True,
                                  timeout=300)
            lat.append(1e3 * (time.perf_counter() - t1))
            want, want_ids = model.predict_action_speculative(params, img, INSTRUCTIONS[i], draft)
            if not (np.array_equal(np.asarray(ids), want_ids) and np.array_equal(np.asarray(got, np.float32), want)):
                raise RuntimeError(f"/act {i}: ids {list(ids)} and action {list(got)} from the mesh deploy, "
                                   f"{want_ids.tolist()} and {want.tolist()} in-process")
        after = _get_json(port, "/stats")
    except (RuntimeError, OSError, ValueError) as e:
        h["out"].flush()
        with open(h["log_path"]) as f:
            tail = f.read()[-3000:]
        fail(f"mesh deploy {what}: {e}\n{tail}")
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        h["out"].close()
    key = "predicts" if mesh else "requests"
    predicts = after[key] - before[key]
    collectives = after["collectives"] - before["collectives"] if mesh else 0
    launches = {name: after["kernel_launches"][fn] - before["kernel_launches"][fn]  # the serving rank's
                for name, fn in zip(KERNEL_NAMES, after["kernel_launches"])}
    if (mesh and (after["world_size"] != world or after["mesh"]["tensor"] != world)) or (not mesh and "mesh" in after) \
            or predicts != MESH_REQUESTS:
        fail(f"mesh deploy {what}: /stats {after} (expected {MESH_REQUESTS} predicts)")
    if (mesh and collectives <= 0) or launches["flash_fwd"] != N_LAYERS_7B * predicts:
        fail(f"mesh deploy {what}: {collectives} collectives and launches {launches} over {predicts} predicts "
             f"(expected {N_LAYERS_7B} flash_fwd per predict, and collectives on a mesh)")
    # int4: every one of the 224 products of a decoder pass quantizes through the kernel, the row-parallel
    # wo / w_down with the tensor group's absmax (a whole number of passes, 2 to 8 per speculative predict)
    passes = launches["int4_mm_a8"] / INT4_PER_PASS
    if label == "int4" and (launches["quantize_a8"] != launches["int4_mm_a8"] or passes != int(passes)
                            or not 2 * predicts <= passes <= (ACTION_DIM + 1) * predicts):
        fail(f"mesh deploy {what}: launches {launches} over {predicts} predicts are no whole number of decoder "
             f"passes of {INT4_PER_PASS} int4_mm_a8 and quantize_a8")
    if label != "int4" and (launches["int4_mm_a8"] or launches["quantize_a8"] or launches["int4_mm"]):
        fail(f"mesh deploy {what}: unexpected int4 launches {launches}")
    # the int8 head once per int4 pass; an int8 deploy's decode products and head rows on every rank's blocks
    if label == "int4" and launches["int8_gemv"] != passes:
        fail(f"mesh deploy {what}: {launches['int8_gemv']} int8_gemv launches over {passes} int4 passes")
    if label == "int8":
        int8_decode_steps(launches["int8_gemv"], predicts, f"mesh deploy {what}")
    r = dict(listen_s=listen_s, act_ms=lat, act_median_ms=statistics.median(lat), predicts=predicts,
             collectives_per_predict=collectives / predicts, launches=launches)
    log(f"mesh deploy {what}: listened after {listen_s:.1f} s (started beside the other deploys); "
        f"{MESH_REQUESTS} x /act ids and actions equal to the in-process predict, latency ms "
        f"{[round(x, 1) for x in lat]} (median {r['act_median_ms']:.1f}); {r['collectives_per_predict']:.1f} "
        f"collectives per predict (the decoder's all-reduces and the logits' gathers, replayed in its graphs); "
        f"launches over the requests {launches}")
    return r


def mesh_finetune(shape: str, world: int, common: list, unsharded: list) -> dict:
    """finetune.main --mesh_shape <shape> for MESH_FT_STEPS steps (bf16 LoRA
    r=32, batch 16, the unsharded run's flags; "fsdp=W", or "tensor=W" with
    the decoder tensor-parallel, the adapters used by block and the loss over
    the vocabulary blocks): at one card in this process (a one-rank NCCL
    group, released after), its losses bit-equal to the unsharded run's
    first steps, launches and collectives per step, step ms and peak GB; on
    more cards through torchrun (each data rank its share of the data), its
    losses within 1e-2 relative of the unsharded run's."""
    import glob
    import shutil

    import torch
    import torch.distributed as dist

    from bridgelang_tpu_torch import finetune
    from bridgelang_tpu_torch.conf import parse_cli
    from bridgelang_tpu_torch.parallel.collectives import collective_launches

    args = common + ["--max_steps", str(MESH_FT_STEPS), "--image_aug", "true", "--export_hf", "false",
                     "--mesh_shape", shape, "--trackers", "jsonl"]
    lora_step = {"flash_fwd": 2 * N_LAYERS_7B, "flash_bwd_dq": N_LAYERS_7B, "flash_bwd_dkv": N_LAYERS_7B}
    runs = common[common.index("--run_root_dir") + 1]
    if world == 1:
        before = collective_launches()
        with EntryPointProbe(f"finetune {shape}", lora_step, profile=None) as probe:
            run = finetune.main(parse_cli(finetune.FinetuneConfig, args))
        r = probe.summary()
        r["collectives_per_step"] = (collective_launches() - before) / max(1, r["steps"])
        r["nccl_ranks"] = dist.get_world_size()
        dist.destroy_process_group()  # the later phases run as one process without a group
        del probe
        release_memory()
        losses = r["losses"]
        if losses != unsharded[:MESH_FT_STEPS]:
            fail(f"finetune {shape}: losses {losses} != the unsharded run's {unsharded[:MESH_FT_STEPS]}")
        log(f"mesh finetune {shape}: losses {losses} bit-equal to the unsharded finetune.main's first "
            f"{MESH_FT_STEPS}; {r['collectives_per_step']:.0f} collectives per step (each leaf's gather at use, "
            f"the regather in the recompute, the decoder's tensor-parallel sums and copies, the logits' gathers, "
            f"the adapters' and the count's sums); step ms {[round(x, 1) for x in r['step_ms']]}; peak "
            f"{r['step_peak_gb']:.2f} GB")
    else:
        t0 = time.perf_counter()
        log_path = os.path.join(os.path.dirname(runs), f"mesh_finetune_{shape.replace(',', '_')}.log")
        with open(log_path, "w") as out:
            rc = subprocess.call(_launcher(world, "bridgelang_tpu_torch.finetune") + args, cwd=ROOT, stdout=out,
                                 stderr=subprocess.STDOUT)
        if rc != 0:
            with open(log_path) as f:
                fail(f"finetune {shape} (torchrun): exit code {rc}\n{f.read()[-3000:]}")
        rows = [json.loads(line) for p in glob.glob(os.path.join(runs, "*", "*.jsonl")) for line in open(p)]
        losses = [row["train/loss"] for row in rows if "train/loss" in row][:MESH_FT_STEPS]
        if not losses or any(abs(a - b) > 1e-2 * abs(b) for a, b in zip(losses, unsharded)):
            fail(f"finetune {shape}: losses {losses} vs the unsharded run's {unsharded[:MESH_FT_STEPS]}")
        r = dict(losses=losses, wall_s=time.perf_counter() - t0)
        log(f"mesh finetune {shape} (torchrun): losses {losses} (unsharded {unsharded[:MESH_FT_STEPS]})")
    for run_dir in glob.glob(os.path.join(runs, "*")):  # the next mesh run's losses are read from this root
        shutil.rmtree(run_dir, ignore_errors=True)
    return r


RING_TRAIN_STEPS = 2     # train.main --attention_impl ring steps, held to the first steps of the run without it
# train.main on torchrun's ranks with the decoder cut as in this process (the registry is patched per process)
RING_TRAIN_SCRIPT = """import dataclasses, sys
sys.path.insert(0, {root!r})
from bridgelang_tpu_torch.models.llm import llama
llama.LLM_CONFIGS["llama2-7b-pure"] = dataclasses.replace(llama.LLM_CONFIGS["llama2-7b-pure"], n_layers={layers})
from bridgelang_tpu_torch import train
from bridgelang_tpu_torch.conf import parse_cli
train.main(parse_cli(train.TrainConfig, sys.argv[1:]))
"""


def with_flags(argv: list, flags: dict) -> list:
    """`argv` ("--name value" pairs) with `flags` set (replaced or added)."""
    pairs = dict(zip(argv[::2], argv[1::2]))
    pairs.update(flags)
    return [x for kv in pairs.items() for x in kv]


MESH_PEAK_RATIO = 1.25    # the one-rank mesh's train.main peak, at most this times the run without a mesh


def mesh_ring_train(targs: list, unsharded: dict, per_step: dict) -> dict:
    """train.main --attention_impl ring --vla.mesh_shape fsdp=W for
    RING_TRAIN_STEPS steps on the finetune phase's depth-cut 7B, from the
    flags of its run without the flag (`unsharded`: that run's probe
    summary): at one card (a one-rank NCCL group in this process, released
    after) the ring's axis has one rank, so the decoder takes the JAX rule's
    fallback, the flash kernels, and the losses are bit-equal to that run's
    first steps; its step peak is at most MESH_PEAK_RATIO times that run's,
    and both first steps' memory is attributed by allocation site. On more
    cards through torchrun the ring runs over fsdp=W (each data rank its
    share of the data, the losses within 1e-2 relative of the one-card
    run's)."""
    import glob
    import shutil

    import torch
    import torch.distributed as dist

    from bridgelang_tpu_torch import train
    from bridgelang_tpu_torch.conf import parse_cli
    from bridgelang_tpu_torch.models.llm import llama
    from bridgelang_tpu_torch.parallel.collectives import collective_launches

    world = torch.cuda.device_count()
    runs = targs[targs.index("--run_root_dir") + 1]
    args = with_flags(targs, {"--run_id": "ring", "--max_steps_override": str(RING_TRAIN_STEPS),
                              "--vla.save_interval": "1000", "--attention_impl": "ring",
                              "--vla.mesh_shape": f"fsdp={world}"})
    want = unsharded["losses"][:RING_TRAIN_STEPS]
    if world == 1:
        before = collective_launches()
        with EntryPointProbe("train ring fsdp=1", per_step, profile=None, memory_steps=1) as probe:
            train.main(parse_cli(train.TrainConfig, args))
        r = probe.summary()
        r["collectives_per_step"] = (collective_launches() - before) / max(1, r["steps"])
        dist.destroy_process_group()
        del probe
        if r["losses"] != want:
            fail(f"train --attention_impl ring fsdp=1: losses {r['losses']} != the run without it {want}")
        ratio = r["step_peak_gb"] / unsharded["step_peak_gb"]
        r["peak_ratio"] = ratio
        log(f"mesh train --attention_impl ring --vla.mesh_shape fsdp=1: losses {r['losses']} bit-equal to the run "
            f"without the flag (one rank on the ring's axis: the flash kernels); step ms "
            f"{[round(x, 1) for x in r['step_ms']]}; {r['collectives_per_step']:.0f} collectives per step; peak "
            f"{r['step_peak_gb']:.2f} GB against {unsharded['step_peak_gb']:.2f} GB without a mesh ({ratio:.3f}x; "
            f"allocated at the first step {r['entry_gb']:.2f} and {unsharded['entry_gb']:.2f} GB)")
        for label, m in (("ring fsdp=1", r["memory"]), ("without a mesh", unsharded["memory"])):
            log(f"mesh memory, first step of train.main {label}: peak {m['peak_gb']:.2f} GB ({m['events']} allocator "
                "events); live at the peak by allocation site: "
                + "; ".join(f"{site} {gb:.3f} GB" for site, gb in m["sites_gb"]))
        if ratio > MESH_PEAK_RATIO:
            fail(f"train --attention_impl ring fsdp=1: peak {r['step_peak_gb']:.2f} GB is {ratio:.3f}x the run "
                 f"without a mesh ({unsharded['step_peak_gb']:.2f} GB), above {MESH_PEAK_RATIO}")
    else:
        t0 = time.perf_counter()
        script = os.path.join(runs, "ring_train.py")
        with open(script, "w") as f:
            f.write(RING_TRAIN_SCRIPT.format(root=ROOT, layers=llama.LLM_CONFIGS["llama2-7b-pure"].n_layers))
        log_path = os.path.join(runs, "ring_train.log")
        with open(log_path, "w") as out:
            rc = subprocess.call([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
                                  str(world), script] + args, cwd=ROOT, stdout=out, stderr=subprocess.STDOUT)
        if rc != 0:
            with open(log_path) as f:
                fail(f"train ring fsdp={world} (torchrun): exit code {rc}\n{f.read()[-3000:]}")
        rows = [json.loads(line) for p in glob.glob(os.path.join(runs, "ring", "*.jsonl")) for line in open(p)]
        losses = [row["train/loss"] for row in rows if "train/loss" in row][:RING_TRAIN_STEPS]
        if not losses or any(abs(a - b) > 1e-2 * abs(b) for a, b in zip(losses, want)):
            fail(f"train ring fsdp={world}: losses {losses} vs the one-card run's {want}")
        r = dict(losses=losses, wall_s=time.perf_counter() - t0)
        log(f"mesh train --attention_impl ring fsdp={world} (torchrun): losses {losses} (one card {want})")
    shutil.rmtree(os.path.join(runs, "ring"), ignore_errors=True)  # its final save (~11 GB)
    release_memory()
    return r


MESH_STATE_SHAPES = ((1, 1), (2, 1), (4, 1), (8, 1), (1, 2), (2, 2), (4, 2), (2, 4))  # (fsdp, tensor)


def fsdp_state_gb(shapes=MESH_STATE_SHAPES) -> dict:
    """Worked out, not measured: each rank's bytes of the 7B's pretraining
    finetune stage (projector + LLM trained, every parameter fp32, AdamW's
    mu and nu and the grad_accum 2 accumulator for the trained tensors) at
    each (fsdp, tensor) shape, from the placements (`param_pspecs`: a leaf
    is split over each axis its spec names), on a meta-device tree; plus the
    step's transients: this rank's fp32 gradients, the towers, projector,
    embedding and head gathered over fsdp in bf16 (the head a vocabulary
    block), one decoder layer gathered over fsdp in bf16 (its tensor
    blocks)."""
    import torch

    from bridgelang_tpu_torch.models.load import _expected_llm_shapes
    from bridgelang_tpu_torch.models.vlm import PrismaticVLM, VLMConfig
    from bridgelang_tpu_torch.parallel.fsdp import _flat_axes, _leaves
    from bridgelang_tpu_torch.parallel.sharding import param_pspecs

    model = PrismaticVLM(VLMConfig(), device="cpu")
    shapes_7b = _expected_llm_shapes(model.cfg.llm)
    layer = ("wq", "wk", "wv", "wo", "attn_norm", "w_gate", "w_up", "w_down", "mlp_norm")
    llm = {k: torch.empty(shapes_7b[k], device="meta") for k in ("embed", "final_norm", "lm_head")}
    llm["layers"] = [{k: torch.empty(shapes_7b[k], device="meta") for k in layer} for _ in range(N_LAYERS_7B)]
    params = {"vision": dict(model.vision_module.named_parameters()), "projector": dict(model.projector.named_parameters()),
              "llm": llm}
    leaves, specs = _leaves(params), _leaves(param_pspecs(params))
    marks = _leaves(model.trainable_mask(params, "finetune"))
    layer_specs = param_pspecs(params)["llm"]["layers"][0]
    out = {}
    for f, t in shapes:
        share = [x.numel() / (f if "fsdp" in _flat_axes(sp) else 1) / (t if "tensor" in _flat_axes(sp) else 1)
                 for x, sp in zip(leaves, specs)]
        trained = sum(n for n, m in zip(share, marks) if m)
        eager = (sum(p.numel() for name in ("vision", "projector") for p in params[name].values())
                 + llm["embed"].numel() + llm["lm_head"].numel() / t)
        one_layer = sum(x.numel() / (t if "tensor" in _flat_axes(layer_specs[k]) else 1)
                        for k, x in llm["layers"][0].items())
        key = f"fsdp={f},tensor={t}"
        out[key] = dict(params=4e-9 * sum(share), moments=8e-9 * trained, accumulator=4e-9 * trained,
                        grads=4e-9 * trained, gathered_bf16=2e-9 * eager, layer_bf16=2e-9 * one_layer)
        out[key]["state"] = sum(out[key][k] for k in ("params", "moments", "accumulator"))
    log("worked out, not measured: per-rank GB of the 7B's pretraining finetune stage (fp32 params, AdamW mu + nu, "
        "the accumulator; then the step's transients) " + "; ".join(
            f"{k}: state {v['state']:.1f} (params {v['params']:.1f}, mu + nu {v['moments']:.1f}, accumulator "
            f"{v['accumulator']:.1f}), grads {v['grads']:.1f}, gathered {v['gathered_bf16']:.2f} + one layer "
            f"{v['layer_bf16']:.2f}" for k, v in out.items()))
    return out


def mesh_phase(ckpt_dir: str, common: list, unsharded_losses: list) -> dict:
    """Multi-GPU on the published-layout 7B at world size = the visible
    cards: the int8 (w8a8) and the shard-blocked int4 mesh deploys, and
    finetune.main over an fsdp mesh on the finetune phase's store (see
    mesh_deploy, mesh_finetune). With one card every collective runs on one
    rank (NCCL copies within the card) and none crosses a device; with more,
    tensor=2 and fsdp=2 run too."""
    import torch

    from bridgelang_tpu_torch.models.llm.llama import LLM_CONFIGS
    from bridgelang_tpu_torch.models.llm.tokenizer import ByteFallbackTokenizer
    from bridgelang_tpu_torch.models.load import load_vla
    from bridgelang_tpu_torch.ops.int4_matmul import int4_tp_fallback_matmuls

    t_phase = time.perf_counter()
    cards = torch.cuda.device_count()
    nccl = ".".join(str(x) for x in torch.cuda.nccl.version())
    result = {"cards": cards, "nccl": nccl, "deploy": {}, "finetune": {}, "fsdp_state_gb": fsdp_state_gb()}
    log(f"mesh: NCCL {nccl}, {cards} visible card(s)" + (
        "; W = 1: every collective below runs on one rank, a copy on the card; none crosses a device"
        if cards == 1 else ""))
    reset_launch_counts()
    worlds = sorted({cards, 2} if cards > 2 else {cards})
    for world in worlds:
        kinds = [("int8", [], [], dict(quantize_int8=True))]  # label, mesh flags, baseline flags, reference load
        if not int4_tp_fallback_matmuls(LLM_CONFIGS["llama2-7b-pure"], INT4_GROUP, world):
            kinds.append(("int4", ["--quantize_int4", "true", "--int4_shards", str(world)], ["--quantize_int4", "true"],
                          dict(quantize_int4=True, int4_shards=world)))
        else:
            log(f"mesh: int4 at tensor={world} skipped: the card's int4 rule refuses the 7B's shard-local shapes")
        # The deploys start together and load while this process loads their references. Beside the first
        # mesh size's, the same deploys without --mesh_spec: their /act medians in this run are the baseline the
        # mesh's overhead is read from.
        started = [([start_mesh_deploy(ckpt_dir, world, label, extra)]
                    + ([start_mesh_deploy(ckpt_dir, 1, label, plain, mesh=False)] if world == worlds[0] else []), quant)
                   for label, extra, plain, quant in kinds]
        for handles, quant in started:
            model, params = load_vla(ckpt_dir, **quant)
            model.tokenizer = ByteFallbackTokenizer()
            got = {h["mesh"]: finish_mesh_deploy(h, model, params) for h in handles}
            label = handles[0]["label"]
            result["deploy"][f"{label} tensor={world}"] = got[True]
            if False in got:
                result["deploy"][f"{label} plain"] = got[False]
                log(f"mesh: {label} /act median {got[True]['act_median_ms']:.1f} ms at tensor={world} against "
                    f"{got[False]['act_median_ms']:.1f} ms for the same deploy without --mesh_spec in this run "
                    f"({got[True]['act_median_ms'] - got[False]['act_median_ms']:+.1f} ms; "
                    f"{got[True]['collectives_per_predict']:.1f} collectives per predict); {nvidia_smi_line()}")
            model.graphs.clear()
            del model, params
            release_memory()
        reset_launch_counts()  # the main path's launches: the mesh finetunes (the deploys report theirs)
        shapes = [f"fsdp={world}", f"tensor={world}"] + ([f"fsdp=2,tensor={world // 2}"] if world >= 4 else [])
        for shape in shapes:
            result["finetune"][shape] = mesh_finetune(shape, world, common, unsharded_losses)
    result["launches"] = launch_counts()
    result["phase_s"] = time.perf_counter() - t_phase
    log(f"mesh phase: {result['phase_s']:.1f} s; launches of the mesh finetune {result['launches']}; "
        f"{nvidia_smi_line()}")
    return result


def check_fixture_decodes() -> dict:
    """Every committed image fixture decoded on this host by the port's
    native decoder, hashed against manifest.json (what tf.io.decode_image
    gave where the fixtures were written): the g++ build of this machine held
    against TensorFlow without TensorFlow. Then the host's decode time of a
    256x256 q95 4:2:0 camera frame: the median over 10 passes of the 16
    camera fixtures, one thread."""
    import hashlib

    import numpy as np

    from bridgelang_tpu_torch.native.image import decode_image

    with open(os.path.join(FIXTURE_DIR, "manifest.json")) as f:
        manifest = json.load(f)
    for name, entry in sorted(manifest.items()):
        with open(os.path.join(FIXTURE_DIR, name), "rb") as f:
            data = f.read()
        for dtype, key in ((np.uint8, "sha256_uint8"), (np.float32, "sha256_float32")):
            if key not in entry:
                continue
            image = decode_image(data, dtype)
            if list(image.shape) != entry["shape"] or hashlib.sha256(image.tobytes()).hexdigest() != entry[key]:
                fail(f"tfds: {name} decodes ({dtype.__name__}) to {image.shape} with a hash other than the "
                     f"manifest's (tf.io.decode_image's {entry['shape']})")
    cameras = camera_fixtures()
    per_frame = []
    for _ in range(10):
        t0 = time.perf_counter()
        for data in cameras:
            decode_image(data)
        per_frame.append(1e3 * (time.perf_counter() - t0) / len(cameras))
    ms = statistics.median(per_frame)
    n_hashes = sum(("sha256_float32" in e) + 1 for e in manifest.values())
    log(f"tfds: {len(manifest)} image fixtures ({n_hashes} decodes) equal tf.io.decode_image's hashes on this host; "
        f"host decode of a 256x256 q95 4:2:0 JPEG: {ms:.3f} ms per frame (median of 10 passes over 16 frames, one "
        f"thread; {nvidia_smi_line()})")
    return dict(fixtures=len(manifest), decodes=n_hashes, decode_ms_per_frame=ms, decode_ms_passes=per_frame)


def tfds_phase(ckpt_dir: str) -> dict:
    """TFDS datasets, as TFDS prepares them, through the port's entry points on
    a machine without TensorFlow:
    1. check_fixture_decodes;
    2. a TFDS directory in LIBERO's layout at the native store's size
       (FT_EPISODES episodes of FT_EPISODE_STEPS steps, `image` and
       `wrist_image` JPEGs from the camera fixtures, 8-D state, 7-D action,
       FT_SHARDS shards, dataset_info.json and features.json), and a small
       one in RT-1's (fractal20220817_data: the action a dict), both written
       by write_tfds_dataset;
    3. finetune.main, unchanged, on the published-layout 7B of `ckpt_dir`
       with --data_root_dir the TFDS root: bf16 LoRA r=32, batch 16,
       TFDS_FT_STEPS steps; every step launches the flash kernels 64/32/32,
       losses finite; the run's statistics equal numpy's quantiles over the
       written actions after the libero standardization;
    4. train.main at full width cut to FT_CUT_LAYERS decoder layers over the
       mixture TFDS_MIX of both datasets (registered for the run),
       TFDS_TRAIN_STEPS steps; the batches draw from both."""
    import dataclasses
    import shutil
    import tempfile

    import numpy as np

    from bridgelang_tpu_torch import finetune, train
    from bridgelang_tpu_torch.conf import parse_cli
    from bridgelang_tpu_torch.models.llm import llama
    from bridgelang_tpu_torch.vla.datasets.rlds.oxe.mixtures import OXE_NAMED_MIXTURES

    t_phase = time.perf_counter()
    result = {"decode": check_fixture_decodes()}
    work = tempfile.mkdtemp(prefix="smoke_tfds_", dir=os.path.join(ROOT, "build"))
    reset_launch_counts()
    # A statistics cache of its own: the cache is keyed by the dataset's name, split and transform, not its
    # files (as in the JAX package), and the finetune phase writes other data under the same name.
    home = os.environ.get("HOME")
    os.environ["HOME"] = os.path.join(work, "home")
    try:
        data = os.path.join(work, "tfds")
        cameras = camera_fixtures()
        t0 = time.perf_counter()
        libero_eps = [libero_episode(ep, FT_EPISODE_STEPS, cameras) for ep in range(FT_EPISODES)]
        write_tfds_dataset(data, FT_DATASET, libero_eps, libero_features(), FT_SHARDS)
        write_tfds_dataset(data, TFDS_FRACTAL, [fractal_episode(ep, TFDS_FRACTAL_STEPS, cameras)
                                                for ep in range(TFDS_FRACTAL_EPISODES)], fractal_features(), 2)
        n_bytes = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(data) for f in fs)
        result["write"] = dict(seconds=time.perf_counter() - t0, bytes=n_bytes)
        log(f"tfds: {FT_DATASET} ({FT_EPISODES} x {FT_EPISODE_STEPS} steps, 2 JPEG cameras, {FT_SHARDS} shards) and "
            f"{TFDS_FRACTAL} ({TFDS_FRACTAL_EPISODES} x {TFDS_FRACTAL_STEPS}) written as TFDS directories, "
            f"{n_bytes / 1e6:.1f} MB in {result['write']['seconds']:.1f} s")
        runs = os.path.join(work, "runs")
        lora_step = {"flash_fwd": 2 * N_LAYERS_7B, "flash_bwd_dq": N_LAYERS_7B, "flash_bwd_dkv": N_LAYERS_7B}
        with EntryPointProbe("tfds finetune bf16 LoRA", lora_step, profile=(1, TFDS_FT_STEPS)) as probe:
            run = finetune.main(parse_cli(finetune.FinetuneConfig, [
                "--vla_path", ckpt_dir, "--data_root_dir", data, "--dataset_name", FT_DATASET, "--run_root_dir", runs,
                "--batch_size", str(TRAIN_BATCH), "--shuffle_buffer_size", str(FT_SHUFFLE), "--save_steps", "1000",
                "--lora_rank", str(LORA_RANK), "--max_steps", str(TFDS_FT_STEPS), "--image_aug", "true",
                "--export_hf", "false"]))
        tuned = probe.summary()
        stats = json.loads((run / "dataset_statistics.json").read_text())[FT_DATASET]["action"]
        acts = np.concatenate([ep["steps/action"] for ep in libero_eps])
        acts[:, -1] = 1.0 - np.clip(acts[:, -1], 0, 1)  # the libero standardization's gripper
        for key, quantile in (("q01", 0.01), ("q99", 0.99)):
            want = np.quantile(acts, quantile, axis=0)
            if not np.allclose(stats[key], want, rtol=1e-6, atol=1e-7):
                fail(f"tfds finetune: statistics {key} {stats[key]} != numpy's over the written actions "
                     f"{want.tolist()}")
        if {n for names in probe.dataset_names for n in names} != {FT_DATASET}:
            fail(f"tfds finetune: batches from {sorted({n for b in probe.dataset_names for n in b})}")
        result["finetune"] = tuned
        del probe
        release_memory()
        shutil.rmtree(run)

        full_llm = llama.LLM_CONFIGS["llama2-7b-pure"]
        llama.LLM_CONFIGS["llama2-7b-pure"] = dataclasses.replace(full_llm, n_layers=FT_CUT_LAYERS)
        OXE_NAMED_MIXTURES[TFDS_MIX] = [(FT_DATASET, 1.0), (TFDS_FRACTAL, 1.0)]
        try:
            cut_step = {"flash_fwd": 2 * FT_CUT_LAYERS, "flash_bwd_dq": FT_CUT_LAYERS, "flash_bwd_dkv": FT_CUT_LAYERS}
            with EntryPointProbe("tfds train (2 layers, mixture)", cut_step, profile=(1, TFDS_TRAIN_STEPS)) as probe:
                train.main(parse_cli(train.TrainConfig, [
                    "--vla.type", "prism-dinosiglip-224px+mx-bridge", "--vla.data_mix", TFDS_MIX,
                    "--vla.global_batch_size", str(TRAIN_BATCH), "--vla.per_device_batch_size", str(TRAIN_BATCH),
                    "--vla.expected_device_count", "1", "--vla.shuffle_buffer_size", str(FT_SHUFFLE),
                    "--vla.freeze_vision_backbone", "true", "--vla.save_interval", "1000",
                    "--max_steps_override", str(TFDS_TRAIN_STEPS), "--data_root_dir", data, "--run_root_dir", runs,
                    "--run_id", "tfds"]))
        finally:
            llama.LLM_CONFIGS["llama2-7b-pure"] = full_llm
            OXE_NAMED_MIXTURES.pop(TFDS_MIX, None)
        mixed = probe.summary()
        drawn = {n: sum(b.count(n) for b in probe.dataset_names) for n in (FT_DATASET, TFDS_FRACTAL)}
        if not all(drawn.values()):
            fail(f"tfds train: the mixture's batches drew {drawn} frames per dataset")
        mixed["frames_per_dataset"] = drawn
        log(f"tfds train: the mixture's batches drew {drawn} frames per dataset")
        result["train"] = mixed
        del probe
        release_memory()
    finally:
        if home is None:
            os.environ.pop("HOME", None)
        else:
            os.environ["HOME"] = home
        shutil.rmtree(work, ignore_errors=True)
    result["launches"] = launch_counts()
    result["phase_s"] = time.perf_counter() - t_phase
    log(f"tfds phase: {result['phase_s']:.1f} s; launches {result['launches']}; {nvidia_smi_line()}")
    return result


# --- phases scripts and pretrain -------------------------------------------------

GEN_TURNS = ("What is on the table in this picture?", "And what lies to the left of it?")
GEN_MAX_NEW = 64         # max_new_tokens of the smoke's generate run (generate's default is 128)
PT_MODEL = "prism-dinosiglip-224px+7b"
PT_GLOBAL_BATCH = 32     # both stages' global batch in the smoke: grad_accum 2 over the registry's 16 per card
PT_MICRO_STEPS = 4       # max_steps_override: 4 micro-steps, 2 accumulated updates per stage
PT_ALIGN_EXAMPLES = 64   # the align chat.json (558k shape): 4 micro-batches of 16
PT_FT_IMAGE_EXAMPLES = 48  # the finetune JSON (mix665k shape): 3 multimodal micro-batches
PT_FT_TEXT_EXAMPLES = 16   # and 1 text-only one, some past the 2048-token bucket
PT_ALIGN_LAYERS = 4      # the align stage's cut, for the smoke's time: 4 of 32 layers, full width
PT_FT_LAYERS = 2         # the finetune stage's cut: AdamW's fp32 state of all 32 layers (~109 GB) needs FSDP;
#                          2 keeps the whole smoke under its 1200 s limit
PT_KERNEL_B = 2          # rows 1-3 against their plain versions at T=2304 (the plain scores: ~1.4 GB of fp32)
PT_PATCHES = 256
WORDS = ("a the red blue green small large wooden metal table cup block spoon towel drawer robot arm gripper "
         "kitchen counter plate bowl left right next to on under behind near holding placed open closed white "
         "black bright dark shiny person dog cat street car window tree sky building sign").split()


def check_pil_fixtures() -> dict:
    """Every committed image fixture through open_rgb and load_image(224) on
    this host, hashed against manifest.json (what Pillow gave where the
    fixtures were written: Image.open(f).convert("RGB") and its BICUBIC
    resize to 224x224), without Pillow; then the host's load_image ms for a
    640x480 JPEG (median of 10 passes over the 3 COCO-sized fixtures)."""
    import hashlib

    from bridgelang_tpu_torch.native.image import load_image, open_rgb, resize_bicubic_pil

    with open(os.path.join(FIXTURE_DIR, "manifest.json")) as f:
        manifest = json.load(f)
    for name, entry in sorted(manifest.items()):
        rgb = open_rgb(os.path.join(FIXTURE_DIR, name))
        got = (hashlib.sha256(rgb.tobytes()).hexdigest(),
               hashlib.sha256(resize_bicubic_pil(rgb, (224, 224)).tobytes()).hexdigest())
        if got != (entry["sha256_pil_rgb"], entry["sha256_pil_224"]):
            fail(f"pretrain: {name} reads (open_rgb, load_image 224) to hashes other than the manifest's (Pillow's)")
    coco = sorted(n for n in manifest if n.startswith("coco_"))
    per_image = []
    for _ in range(10):
        t0 = time.perf_counter()
        for name in coco:
            load_image(os.path.join(FIXTURE_DIR, name), 224)
        per_image.append(1e3 * (time.perf_counter() - t0) / len(coco))
    ms = statistics.median(per_image)
    log(f"pretrain: {len(manifest)} image fixtures read (open_rgb, load_image 224) to Pillow's hashes on this host; "
        f"load_image of a 640x480 JPEG {ms:.2f} ms (median of 10 passes over {len(coco)}, one thread)")
    return dict(fixtures=len(manifest), load_ms_640x480=ms, load_ms_passes=per_image)


def _sentence(rng, n_words: int) -> str:
    return " ".join(WORDS[i] for i in rng.integers(0, len(WORDS), n_words)).capitalize() + "."


def write_llava_root(root: str) -> dict:
    """A LLaVA-layout dataset root in DatasetConfig "llava-v15"'s paths:
    download/llava-laion-cc-sbu-558k/chat.json (the 558k shape: one human
    prompt with <image>, one caption; captions of 4-40 words) over
    00000/*.jpg|png, and download/llava-v1.5-instruct/llava_v1_5_mix665k.json
    (the mix665k shape: multi-turn chats over coco/train2017/*.jpg and
    gqa/images/*.png, and text-only chats, a quarter of them past the
    2048-token bucket under the byte tokenizer). The images are the committed
    fixtures (256x256 cameras, 640x480 COCO-sized frames, PNGs)."""
    import shutil

    import numpy as np

    rng = np.random.default_rng(SEED)
    jpgs = sorted(f for f in os.listdir(FIXTURE_DIR) if f.startswith(("camera_", "coco_")))
    pngs = ["rgb8_61x83.png", "rgba8_61x83.png", "palette_trns_61x83.png"]
    sources = jpgs + pngs
    align_dir = os.path.join(root, "download", "llava-laion-cc-sbu-558k")
    ft_dir = os.path.join(root, "download", "llava-v1.5-instruct")
    align, finetune = [], []
    for i in range(PT_ALIGN_EXAMPLES):
        src = sources[i % len(sources)]
        rel = f"00000/{i:09d}{os.path.splitext(src)[1]}"
        os.makedirs(os.path.dirname(os.path.join(align_dir, rel)), exist_ok=True)
        shutil.copy(os.path.join(FIXTURE_DIR, src), os.path.join(align_dir, rel))
        align.append({"id": f"{i:09d}", "image": rel, "conversations": [
            {"from": "human", "value": "<image>\nGive a brief description of the image."},
            {"from": "gpt", "value": _sentence(rng, int(rng.integers(4, 41)))}]})
    for i in range(PT_FT_IMAGE_EXAMPLES):
        src = sources[(3 * i) % len(sources)]
        rel = f"coco/train2017/{i:012d}.jpg" if src.endswith(".jpg") else f"gqa/images/{i}.png"
        os.makedirs(os.path.dirname(os.path.join(ft_dir, rel)), exist_ok=True)
        shutil.copy(os.path.join(FIXTURE_DIR, src), os.path.join(ft_dir, rel))
        turns = [{"from": "human", "value": "<image>\n" + _sentence(rng, 8)[:-1] + "?"}]
        for t in range(1 + i % 4):
            if t:
                turns.append({"from": "human", "value": _sentence(rng, 6)[:-1] + "?"})
            turns.append({"from": "gpt", "value": _sentence(rng, int(rng.integers(3, 12 + 60 * (i % 5 == 0))))})
        finetune.append({"id": str(i), "image": rel, "conversations": turns})
    for i in range(PT_FT_TEXT_EXAMPLES):
        long = i % 4 == 0  # > 2048 byte tokens: the collator truncates
        finetune.append({"id": f"text-{i}", "conversations": [
            {"from": "human", "value": _sentence(rng, 10)[:-1] + "?"},
            {"from": "gpt", "value": " ".join(_sentence(rng, 20) for _ in range(40 if long else 1 + i % 3))}]})
    with open(os.path.join(align_dir, "chat.json"), "w") as f:
        json.dump(align, f)
    with open(os.path.join(ft_dir, "llava_v1_5_mix665k.json"), "w") as f:
        json.dump(finetune, f)
    return dict(align=len(align), finetune_image=PT_FT_IMAGE_EXAMPLES, finetune_text=PT_FT_TEXT_EXAMPLES,
                image_sources=len(sources))


def leaf_checksums(params) -> dict:
    """name -> an int64 sum of each fp32 tensor's bit patterns (any update
    of a trained tensor moves it), over vision, projector and llm leaves."""
    import torch

    out = {}

    def walk(prefix, tree):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(f"{prefix}.{k}" if prefix else k, v)
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                walk(f"{prefix}.{i}", v)
        else:
            bits = tree.detach().view({4: torch.int32, 2: torch.int16, 1: torch.int8}[tree.element_size()])
            out[prefix] = bits.sum(dtype=torch.int64)

    walk("", params)
    return {k: int(v) for k, v in out.items()}


def pretrain_stage(cfg, vlm_cfg, label: str, per_step: dict, trained: set, read_back: bool) -> dict:
    """pretrain.run, unchanged, watched by EntryPointProbe (step ms, launches
    per micro-step, each batch's host work: the dataset's image loads and the
    collator; saves; a profile of micro-step 2 only, so that micro-steps
    3-PT_MICRO_STEPS, which are timed, run without the profiler).
    Checks: finite losses (the probe); the leaves that changed are exactly
    those of the groups `trained` (vision, projector, llm); with
    `read_back`, the epoch-end checkpoint's projector and its AdamW moments
    read back (memory-mapped: only those tensors) bit-equal to the live
    state."""
    import torch

    from bridgelang_tpu_torch import pretrain

    before = {}
    with EntryPointProbe(label, per_step, profile=(1, 2),
                         on_first_step=lambda s: before.update(leaf_checksums(s.params))) as probe:
        state = pretrain.run(cfg, vlm_cfg)
    r = probe.summary()
    after = leaf_checksums(state.params)
    changed = {k.split(".")[0] for k in after if after[k] != before[k]}
    unchanged_trained = sorted(k for k in after if k.split(".")[0] in trained and after[k] == before[k])
    log(f"{label}: groups whose tensors changed {sorted(changed)}; trained groups' tensors left unchanged "
        f"{unchanged_trained[:6]}{' ...' if len(unchanged_trained) > 6 else ''}")
    if changed != trained or unchanged_trained:
        fail(f"{label}: expected every tensor of {sorted(trained)} and nothing else to change; changed groups "
             f"{sorted(changed)}, unchanged trained tensors {unchanged_trained[:6]}")
    if state.opt_state["count"] != PT_MICRO_STEPS // 2 or state.step != PT_MICRO_STEPS:
        fail(f"{label}: {state.step} micro-steps and {state.opt_state['count']} updates, expected "
             f"{PT_MICRO_STEPS} and {PT_MICRO_STEPS // 2}")
    save = r["saves"][-1]
    if read_back:
        saved = torch.load(os.path.join(save["path"], "state.pt"), map_location="cpu", weights_only=True, mmap=True)
        live = [state.params["projector"][k] for k in state.params["projector"]]
        pairs = [(f"projector.{k}", saved["params"]["projector"][k], state.params["projector"][k])
                 for k in state.params["projector"]]
        pairs += [(f"opt_state.{m}[{i}]", saved["opt_state"][m][i], state.opt_state[m][i])
                  for m in ("mu", "nu") for i in range(len(live))]
        for name, got, want in pairs:
            if got.shape != want.shape or not torch.equal(bits(got), bits(want.detach().cpu())):
                fail(f"{label}: the checkpoint's {name} differs from the live state")
        log(f"{label}: the checkpoint's projector ({len(live)} tensors) and its AdamW moments read back bit-equal "
            f"to the live state")
        del saved
    n_vis = sum(t.numel() for t in state.params["vision"].values())
    n_llm = sum(t.numel() for k, t in state.params["llm"].items() if k not in ("layers", "embed"))
    n_llm += sum(t.numel() for lp in state.params["llm"]["layers"] for t in lp.values())
    n_trainable = sum(t.numel() for t in state.opt_state["mu"])
    probe_steps = probe.steps
    del state, probe  # the probe holds the last state and batch
    release_memory()
    b, t_pad = TRAIN_BATCH, cfg.model.llm_max_length + PT_PATCHES
    k_llm = 4 if trained == {"projector"} else 6  # forward + input gradient (+ weight gradient)
    steps = []
    for s in probe_steps:
        real = sum(s["mask_sums"]) + PT_PATCHES * len(s["mask_sums"])
        sec = s["ms"] / 1e3
        flops = k_llm * n_llm * real + 2 * n_vis * PT_PATCHES * b
        steps.append(dict(ms=s["ms"], real_tokens=real, padded_tokens=b * t_pad, lengths=[m + PT_PATCHES for m in
                                                                                      s["mask_sums"]],
                          real_tokens_per_s=real / sec, padded_tokens_per_s=b * t_pad / sec,
                          useful_flop_share=flops / sec / PEAK_FLOPS["bfloat16"],
                          padded_flop_share=(k_llm * n_llm * b * t_pad + 2 * n_vis * PT_PATCHES * b) / sec
                          / PEAK_FLOPS["bfloat16"]))
    timed = steps[2:]  # after the profiled micro-step 2
    med = statistics.median(x["ms"] for x in timed)
    summary = dict(
        median_step_ms=med, steps=steps, losses=r["losses"], peak_gb=r["step_peak_gb"], profile=r["profile"],
        host_ms_per_batch=r["host_batch_ms"], median_host_ms_per_batch=statistics.median(r["host_batch_ms"]),
        save_s=save["seconds"], save_gb=save["bytes"] / 1e9, launches=r["launches"], wall_s=r["wall_s"],
        params=dict(vision=n_vis, llm_without_embedding=n_llm, trainable=n_trainable),
        median_real_tokens_per_s=statistics.median(x["real_tokens_per_s"] for x in timed),
        median_padded_tokens_per_s=statistics.median(x["padded_tokens_per_s"] for x in timed),
        median_useful_flop_share=statistics.median(x["useful_flop_share"] for x in timed),
        median_padded_flop_share=statistics.median(x["padded_flop_share"] for x in timed))
    idle = (r["profile"] or {}).get("idle_share")
    log(f"{label}: median micro-step {med:.1f} ms (steps 3-{PT_MICRO_STEPS}, unprofiled); tokens/s padded "
        f"{summary['median_padded_tokens_per_s']:.0f}, real {summary['median_real_tokens_per_s']:.0f}; useful-FLOP "
        f"share of 989 TFLOP/s {100 * summary['median_useful_flop_share']:.1f}% (real tokens; "
        f"{100 * summary['median_padded_flop_share']:.1f}% over padded rows; {k_llm} x {n_llm / 1e9:.2f} B LLM "
        f"parameters per token + the towers' forward, no recompute, no attention); peak {r['step_peak_gb']:.2f} GB; "
        f"device idle {'not measured' if idle is None else f'{100 * idle:.1f}%'} (top kernels, ms per micro-step: "
        f"{[(name, round(ms, 1)) for name, ms in (r['profile'] or {}).get('top_ms_per_step', [])]}); host ms per batch "
        f"({TRAIN_BATCH} image loads + collate) {[round(x, 1) for x in r['host_batch_ms']]}; save "
        f"{save['seconds']:.1f} s, {save['bytes'] / 1e9:.2f} GB; trainable {n_trainable / 1e9:.3f} B; "
        f"fused lengths per micro-step {[(min(x['lengths']), max(x['lengths'])) for x in steps]}; "
        f"{nvidia_smi_line()}")
    return summary


def check_attention_t2304(align_lengths, ft_lengths) -> dict:
    """Rows 1-3 at the pretraining length (T = S = 2304, H = 32, D = 128,
    bf16) against their plain versions, B = PT_KERNEL_B rows (the shortest
    align row and a full finetune row; the longest align row and the shortest
    finetune row): o and lse under FWD_ATOL, dq, dk, dv under GRAD_TOL, dead
    keys' dk/dv exactly 0. Then each timed at B = 16 with the lengths of a
    real micro-batch of each stage: the kernel, SDPA's memory-efficient
    kernel with the equivalent boolean mask (forward; autograd backward) and
    the bound for those lengths."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from bridgelang_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_bwd_plain, flash_attention_plain, flash_bwd_dkv, flash_bwd_dq)

    t = 2048 + PT_PATCHES
    checks = {"short_and_full": [min(align_lengths), max(ft_lengths)],
              "long_caption_and_short_chat": [max(align_lengths), min(ft_lengths)]}
    worst = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0, "use": 0.0}
    for i, (name, lengths) in enumerate(checks.items()):
        q, k, v, lens = attention_case(PT_KERNEL_B, t, t, 32, 32, 128, lengths, None, torch.bfloat16, seed=500 + i)
        o, lse = flash_attention(q, k, v, lengths=lens, causal=True)
        po, plse = flash_attention_plain(q, k, v, lengths=lens, causal=True)
        err_o = max((o[bi, :L].float() - po[bi, :L].float()).abs().max().item() for bi, L in enumerate(lengths))
        err_lse = max((lse[bi, :, :L] - plse[bi, :, :L]).abs().max().item() for bi, L in enumerate(lengths))
        do = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(600 + i), device="cuda",
                         dtype=q.dtype)
        delta = (do.float() * po.float()).sum(dim=-1).transpose(1, 2).contiguous()
        dq = flash_bwd_dq(q, k, v, do, plse, delta, lens, True, None)
        dk, dv = flash_bwd_dkv(q, k, v, do, plse, delta, lens, True, None)
        pdq, pdk, pdv = flash_attention_bwd_plain(q, k, v, po, plse, do, lens, True, None)
        uses = {w: grad_tolerance_use(g, p) for w, g, p in (("dq", dq, pdq), ("dk", dk, pdk), ("dv", dv, pdv))}
        errs = {w: (g.float() - p.float()).abs().max().item() for w, g, p in (("dq", dq, pdq), ("dk", dk, pdk),
                                                                             ("dv", dv, pdv))}
        dead = max(max(dk[bi, L:].abs().max().item(), dv[bi, L:].abs().max().item()) if L < t else 0.0
                   for bi, L in enumerate(lengths))
        finite = all(torch.isfinite(x).all() for x in (o, dq, dk, dv))
        ok = finite and err_o <= FWD_ATOL["bfloat16"] and err_lse <= 1e-3 and max(uses.values()) <= 1.0 and dead == 0
        log(f"kernel t2304 {name}: B={PT_KERNEL_B} T=S={t} H=32 D=128 bf16 lengths {lengths}: max|o-plain| "
            f"{err_o:.3e} (tol {FWD_ATOL['bfloat16']}), max|lse-plain| {err_lse:.3e}; "
            + "; ".join(f"{w} max|err| {errs[w]:.3e} tolerance use {uses[w]:.3g}" for w in uses)
            + f"; dead-key dk/dv {dead} {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"flash kernels disagree with their plain versions at T={t} ({name}, lengths {lengths})")
        worst.update(fwd=max(worst["fwd"], err_o), dq=max(worst["dq"], errs["dq"]),
                     dkv=max(worst["dkv"], errs["dk"], errs["dv"]), use=max([worst["use"], *uses.values()]))
        plain_fwd_ms = cuda_ms(lambda: flash_attention_plain(q, k, v, lengths=lens, causal=True), 3)
        plain_bwd_ms = cuda_ms(lambda: flash_attention_bwd_plain(q, k, v, po, plse, do, lens, True, None), 3)
        log(f"timing t2304 {name} B={PT_KERNEL_B}: plain forward {plain_fwd_ms:.3f} ms, plain backward "
            f"{plain_bwd_ms:.3f} ms (the yardstick shapes of the check)")
        del q, k, v, o, lse, po, plse, do, delta, dq, dk, dv, pdq, pdk, pdv
    torch.cuda.empty_cache()
    timings = {}
    for i, (stage, lengths) in enumerate((("align", align_lengths), ("finetune", ft_lengths))):
        q, k, v, lens = attention_case(TRAIN_BATCH, t, t, 32, 32, 128, lengths, None, torch.bfloat16, seed=700 + i)
        do = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(800 + i), device="cuda",
                         dtype=q.dtype)
        o, lse = flash_attention(q, k, v, lengths=lens, causal=True)
        delta = (do.float() * o.float()).sum(dim=-1).transpose(1, 2).contiguous()
        fwd_ms = cuda_ms(lambda: flash_attention(q, k, v, lengths=lens, causal=True), 20)
        mask = valid_mask(t, t, lengths, None, device="cuda")[:, None]
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            sdpa_fwd_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask), 20)
        fwd_bound = bound_ms(q, k, v, lens, None)
        bwd = time_backward(f"t2304_{stage}_b16", q, k, v, do, lse, delta, lens, None)
        timings[stage] = dict(shape=f"B={TRAIN_BATCH} T=S={t} H=32 D=128 bf16", lengths=list(lengths),
                              fwd_ms=fwd_ms, fwd_library_ms=sdpa_fwd_ms, fwd_bound=fwd_bound,
                              dq_ms=bwd["dq_ms"], dkv_ms=bwd["dkv_ms"], bwd_library_ms=bwd["library_ms"],
                              bwd_bounds=bwd["bounds"], bwd_readings=bwd["readings"])
        log(f"timing t2304 {stage} B={TRAIN_BATCH} (lengths {min(lengths)}-{max(lengths)}, mean "
            f"{sum(lengths) / len(lengths):.0f}): flash_fwd {fwd_ms:.4f} ms (bound {fwd_bound[0]:.4f} ms, "
            f"{fwd_bound[1]}; sdpa {sdpa_fwd_ms:.4f} ms), dq {bwd['dq_ms']:.4f} ms, dk/dv {bwd['dkv_ms']:.4f} ms "
            f"(sdpa backward {bwd['library_ms']:.4f} ms)")
        del q, k, v, do, o, lse, delta, mask, qt, kt, vt
        torch.cuda.empty_cache()
    return dict(worst=worst, timings=timings, plain_fwd_ms_b2=plain_fwd_ms, plain_bwd_ms_b2=plain_bwd_ms,
                checks=checks)


def pretrain_phase() -> dict:
    """The port's `pretrain` entry point on the card (pretrain.run, which
    pretrain.main calls with the registry model's VLMConfig), over a LLaVA
    layout written here (write_llava_root), random fp32 weights from the
    seed, the byte tokenizer, micro-batches of 16 x (2048 + 256) fused
    tokens, "full" remat, global batch PT_GLOBAL_BATCH (grad_accum 2),
    PT_MICRO_STEPS micro-steps per stage:
    1. check_pil_fixtures;
    2. align on prism-dinosiglip-224px+7b at full width, the decoder cut to
       PT_ALIGN_LAYERS layers: only the projector changes; its checkpoint
       (the whole state, ~18 GB) read back for the projector and its moments;
       2 x 16 / 16 / 16 flash launches per micro-step;
    3. the finetune stage on the same model cut to PT_FT_LAYERS decoder
       layers: the LLM and the projector change, the towers do not;
       2 x 8 / 8 / 8 launches per micro-step;
    4. check_attention_t2304 with the lengths of the micro-batches just run.
    Launch counts cover steps 2-3 only. Each run directory goes once it is
    checked."""
    import dataclasses
    import shutil
    import tempfile

    from bridgelang_tpu_torch import pretrain
    from bridgelang_tpu_torch.conf import DatasetConfig, ModelConfig

    t_phase = time.perf_counter()
    result = {"images": check_pil_fixtures()}
    work = tempfile.mkdtemp(prefix="smoke_pt_", dir=os.path.join(ROOT, "build"))
    log(f"pretrain: {disk_free_gb(work):.1f} GB free under {work}")
    try:
        root = os.path.join(work, "llava")
        t0 = time.perf_counter()
        result["data"] = dict(write_llava_root(root), seconds=time.perf_counter() - t0)
        m = dataclasses.replace(ModelConfig.get(PT_MODEL), align_global_batch_size=PT_GLOBAL_BATCH,
                                finetune_global_batch_size=PT_GLOBAL_BATCH)
        ds = dataclasses.replace(DatasetConfig.get("llava-v15"), dataset_root_dir=root)
        runs = os.path.join(work, "runs")

        def config(stage):
            return pretrain.PretrainConfig(model=m, dataset=ds, stage=stage, run_root_dir=runs, run_id=stage,
                                           seed=SEED, remat_policy="full", max_steps_override=PT_MICRO_STEPS)

        def per_step(n_layers):
            return {"flash_fwd": 2 * n_layers, "flash_bwd_dq": n_layers, "flash_bwd_dkv": n_layers}

        vlm_cfg = pretrain.vlm_config(m)
        reset_launch_counts()
        align_cut = dataclasses.replace(vlm_cfg, llm=dataclasses.replace(vlm_cfg.llm, n_layers=PT_ALIGN_LAYERS))
        result["align"] = pretrain_stage(config("align"), align_cut, f"pretrain align (7B, {PT_ALIGN_LAYERS} layers)",
                                         per_step(PT_ALIGN_LAYERS), {"projector"}, read_back=True)
        shutil.rmtree(os.path.join(runs, "align"))
        cut = dataclasses.replace(vlm_cfg, llm=dataclasses.replace(vlm_cfg.llm, n_layers=PT_FT_LAYERS))
        result["finetune"] = pretrain_stage(config("finetune"), cut, f"pretrain finetune ({PT_FT_LAYERS} layers)",
                                            per_step(PT_FT_LAYERS), {"projector", "llm"}, read_back=False)
        shutil.rmtree(os.path.join(runs, "finetune"))
        result["launches"] = launch_counts()
        lengths = {s: result[s]["steps"][0]["lengths"] for s in ("align", "finetune")}
        result["kernels_t2304"] = check_attention_t2304(lengths["align"], lengths["finetune"])
    finally:
        shutil.rmtree(work, ignore_errors=True)
    result["phase_s"] = time.perf_counter() - t_phase
    log(f"pretrain phase: {result['phase_s']:.1f} s; launches {result['launches']}; {nvidia_smi_line()}")
    return result


def scripts_phase(ckpt_dir: str) -> dict:
    """The port's `demo` and `generate` entry points on the load phase's
    published-layout 7B, with their defaults (int8 w8a8 on load), on a
    committed 640x480 JPEG read by open_rgb:
    1. demo.main: its action equals predict_action of the same model on the
       same decoded frame;
    2. generate.main with GEN_TURNS fed on standard input, max_new_tokens
       128: each reply's ids equal generate_greedy's on the conversation's
       prompt, built again here; the prefill's ms and the decode's ms per
       token (the same call at 1 and at GEN_MAX_NEW new tokens, CUDA-synchronized).
    Launch counts cover the two entry points only."""
    import io

    import numpy as np
    import torch

    from bridgelang_tpu_torch import demo, generate
    from bridgelang_tpu_torch.models import load as load_mod
    from bridgelang_tpu_torch.models.llm.prompting import get_prompt_builder
    from bridgelang_tpu_torch.models.llm.tokenizer import get_tokenizer
    from bridgelang_tpu_torch.native.image import open_rgb
    from bridgelang_tpu_torch.ops.image_ops import preprocess_batch

    t_phase = time.perf_counter()
    image = os.path.join(FIXTURE_DIR, "coco_00_640x480.jpg")
    loaded, real_load = [], load_mod.load_vla

    def capturing_load(*a, **k):
        model, params = real_load(*a, **k)
        loaded.append((model, params))
        return model, params

    reset_launch_counts()
    load_mod.load_vla = capturing_load
    stdin = sys.stdin
    try:
        t0 = time.perf_counter()
        action = demo.main(demo.DemoConfig(checkpoint=ckpt_dir, image=image, instruction=INSTRUCTIONS[0]))
        demo_s = time.perf_counter() - t0
        demo_launches = launch_counts()
        sys.stdin = io.StringIO("\n".join(GEN_TURNS) + "\n")
        t0 = time.perf_counter()
        replies = generate.main(generate.GenerateConfig(checkpoint=ckpt_dir, image=image, max_new_tokens=GEN_MAX_NEW))
        generate_s = time.perf_counter() - t0
    finally:
        sys.stdin = stdin
        load_mod.load_vla = real_load
    launches = launch_counts()
    gen_launches = {k: launches[k] - demo_launches[k] for k in launches}
    gen_steps = int8_decode_steps(gen_launches["int8_gemv"], len(GEN_TURNS), "generate.main")
    expect_counts(gen_launches, {"flash_fwd": N_LAYERS_7B * len(GEN_TURNS), "int8_gemv": gen_launches["int8_gemv"]},
                  f"generate.main (one prefill per turn, {gen_steps} int8 decode steps)")
    if demo_launches["flash_fwd"] < N_LAYERS_7B:
        fail(f"demo.main launched flash_fwd {demo_launches['flash_fwd']} times, fewer than one prefill")

    (dm, dp), (gm, gp) = loaded
    frame = open_rgb(image)
    again = dm.predict_action(dp, frame, INSTRUCTIONS[0])
    if not np.array_equal(np.asarray(action), np.asarray(again)) or not np.isfinite(action).all():
        fail(f"demo.main's action {np.asarray(action).tolist()} != predict_action's {np.asarray(again).tolist()}")

    tok = get_tokenizer(None)
    pixels = preprocess_batch(torch.from_numpy(frame[None]).to(gm.device), gm.image_transform, dtype=gm.dtype)
    builder = get_prompt_builder(gm.cfg.llm_family)
    eos = gm.cfg.llm.eos_token_id
    prefill_ms = per_token_ms = None
    with torch.inference_mode():
        for turn, reply in zip(GEN_TURNS, replies):
            builder.add_turn("human", turn)
            ids = torch.tensor([tok.encode(builder.get_prompt())], dtype=torch.int32, device=gm.device)
            mask = torch.ones_like(ids)

            def greedy(n):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = gm.generate_greedy(gp, ids, mask, pixels, max_new_tokens=n)[0].cpu().tolist()
                return out, 1e3 * (time.perf_counter() - t0)

            want, full_ms = greedy(GEN_MAX_NEW)
            want = want[: want.index(eos)] if eos in want else want
            if reply != want:
                fail(f"generate.main's reply to {turn!r} differs from generate_greedy's: {reply[:12]} ... vs "
                     f"{want[:12]} ...")
            if prefill_ms is None:
                prefill_ms = statistics.median(greedy(1)[1] for _ in range(3))
                per_token_ms = (full_ms - prefill_ms) / (GEN_MAX_NEW - 1)
                prompt_tokens = ids.shape[1]
            builder.add_turn("gpt", tok.decode(want))
    del loaded, dm, dp, gm, gp, pixels
    release_memory()
    result = dict(demo_s=demo_s, generate_s=generate_s, action=np.asarray(action).tolist(),
                  reply_lengths=[len(r) for r in replies], prefill_ms=prefill_ms, decode_ms_per_token=per_token_ms,
                  prompt_tokens=prompt_tokens, launches=launches, demo_launches=demo_launches,
                  phase_s=time.perf_counter() - t_phase)
    log(f"scripts: demo.main {demo_s:.1f} s (load int8, one action {np.round(action, 4).tolist()}, equal to "
        f"predict_action's); generate.main {generate_s:.1f} s for {len(GEN_TURNS)} turns of up to {GEN_MAX_NEW} "
        f"tokens (replies {result['reply_lengths']} ids, equal to generate_greedy's); eager int8 prefill "
        f"({prompt_tokens} + {PT_PATCHES} tokens) {prefill_ms:.1f} ms, decode {per_token_ms:.2f} ms per token; "
        f"launches {launches}; phase {result['phase_s']:.1f} s; {nvidia_smi_line()}")
    return result


# --- phase: robot evaluation (verify, inspect_checkpoint, the LIBERO and BridgeV2 harnesses) ------

VERIFY_CALLS = 8         # verify.main's run (int8 w8a8 on load; its default is 16)
VERIFY_INT4_CALLS = 8    # verify --quantize_int4 true
GOLDEN_RECORDS = 4       # the bf16 golden bundle: one batch-4 predict
SPEC_STREAM_TICKS = 8    # measured ticks of --speculative_stream (tick 0, the graph capture, left out)
LIBERO_RES = 256         # run_libero_eval's default camera resolution
LIBERO_TASKS = 1          # cut for the smoke's time
LIBERO_EPISODES = 2      # per task
LIBERO_STEPS = 8         # policy steps before the fake task succeeds: one chunk of ROBOT_CHUNK
ROBOT_CHUNK = 8          # --action_chunk of the chunk mode
BRIDGE_EPISODES = 2
BRIDGE_STEPS = 10        # 2 s of control per episode at the 5 Hz target


def smooth_frame(h: int, w: int, t: float):
    """A camera frame that drifts with t (values in [40, 215])."""
    import numpy as np

    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    chans = [127 + 60 * np.sin(0.05 * x + 0.03 * y + 0.4 * t + c) + 25 * np.cos(0.02 * y - 0.3 * t * c)
             for c in range(3)]
    return np.clip(np.stack(chans, -1), 40, 215).astype(np.uint8)


class FakeLibero:
    """A `libero` package in sys.modules while the phase runs: LIBERO_TASKS
    tasks whose env renders drifting frames upside down (as LIBERO does) and
    succeeds after LIBERO_STEPS policy steps. Each policy tick records the
    upright frame the policy saw, the action the env received and the time."""

    def __init__(self):
        import types

        self.ticks = []  # (task, episode, frame, action, time)
        self.starts = {}  # (task, episode) -> the time its settle steps ended
        rec, settle = self, 10

        class Env:
            def __init__(self, bddl_file_name, camera_heights, camera_widths):
                self.hw, self.task = (camera_heights, camera_widths), int(bddl_file_name[4:-5])

            def _obs(self):
                self.frame = smooth_frame(*self.hw, self.t)
                return {"agentview_image": self.frame[::-1, ::-1]}

            def reset(self):
                self.steps = 0

            def set_init_state(self, state):
                self.t, self.episode = float(state[0]), int(state[1])
                return self._obs()

            def step(self, action):
                import numpy as np

                self.steps += 1
                if self.steps == settle:
                    rec.starts[(self.task, self.episode)] = time.perf_counter()
                elif self.steps > settle:
                    rec.ticks.append((self.task, self.episode, self.frame, np.asarray(action), time.perf_counter()))
                    self.t += 0.5
                return self._obs(), 0.0, self.steps >= settle + LIBERO_STEPS, {}

            def close(self):
                pass

        class Task:
            def __init__(self, i):
                self.language = INSTRUCTIONS[i % len(INSTRUCTIONS)]

        class Suite:
            n_tasks = LIBERO_TASKS

            def get_task(self, i):
                return Task(i)

            def get_task_bddl_file_path(self, i):
                return f"task{i}.bddl"

            def get_task_init_states(self, i):
                import numpy as np

                return [np.array([3.0 * i + e, e]) for e in range(LIBERO_EPISODES)]

        benchmark = types.ModuleType("libero.libero.benchmark")
        benchmark.get_benchmark_dict = lambda: {"libero_spatial": Suite}
        envs = types.ModuleType("libero.libero.envs")
        envs.OffScreenRenderEnv = Env
        inner = types.ModuleType("libero.libero")
        inner.benchmark, inner.envs = benchmark, envs
        outer = types.ModuleType("libero")
        outer.libero = inner
        self.modules = {"libero": outer, "libero.libero": inner, "libero.libero.benchmark": benchmark,
                        "libero.libero.envs": envs}

    def __enter__(self):
        sys.modules.update(self.modules)
        return self

    def __exit__(self, *exc):
        for name in self.modules:
            sys.modules.pop(name, None)

    def rate_hz(self) -> float:
        """Closed-loop rate: an episode's policy ticks over the time from the
        end of its settle steps to its last tick (each tick's policy call and
        env step, a chunk's model pass included); the median over episodes
        (the first episode of a mode captures the graphs)."""
        last = {tick[:2]: tick[4] for tick in self.ticks}
        return statistics.median(LIBERO_STEPS / (last[ep] - t0) for ep, t0 in self.starts.items())


class FakeWidowX:
    """`widowx_envs.widowx_env_service` in sys.modules: a client whose
    observations are [3, S, S] float images in [0, 1] and an 8-D state; it
    records each action's time and blocking flag."""

    def __init__(self, im_size: int):
        import types

        self.steps, self.moves, self.im_size = [], 0, im_size
        rec = self

        class Client:
            def __init__(self, host, port):
                self.n = 0

            def init(self, env_params):
                rec.env_params = env_params

            def get_observation(self):
                import numpy as np

                img = smooth_frame(rec.im_size, rec.im_size, 0.2 * self.n).transpose(2, 0, 1) / 255.0
                return {"image": img.reshape(-1), "state": np.full(7, 0.01 * self.n)}

            def step_action(self, action, blocking=False):
                rec.steps.append((time.perf_counter(), blocking))
                self.n += 1

            def reset(self):
                pass

            def move(self, transform, duration=0.8, blocking=True):
                rec.moves += 1

        class Configs:
            DefaultEnvParams = {"fix_zangle": 0.1, "move_duration": 0.2}

        service = types.ModuleType("widowx_envs.widowx_env_service")
        service.WidowXClient, service.WidowXConfigs = Client, Configs
        pkg = types.ModuleType("widowx_envs")
        pkg.widowx_env_service = service
        self.modules = {"widowx_envs": pkg, "widowx_envs.widowx_env_service": service}

    def __enter__(self):
        sys.modules.update(self.modules)
        return self

    def __exit__(self, *exc):
        for name in self.modules:
            sys.modules.pop(name, None)


class SharedInt8Load:
    """While it is entered, load_vla of an int8 (w8a8) checkpoint returns one
    shared (model, params): verify's int8 runs and both harnesses serve the
    same loaded 7B instead of loading it four times. Other loads (the bf16
    golden record and replay, int4) go through as they are."""

    def __init__(self):
        self.cached = None

    def __enter__(self):
        from bridgelang_tpu_torch.models import load as load_mod

        self.real = load_mod.load_vla

        def load(path, **kw):
            if not kw.get("quantize_int8") or kw.get("quantize_int4"):
                return self.real(path, **kw)
            if self.cached is None:
                self.cached = self.real(path, **kw)
            return self.cached

        load_mod.load_vla = load
        return self

    def __exit__(self, *exc):
        from bridgelang_tpu_torch.models import load as load_mod

        load_mod.load_vla = self.real
        if self.cached is not None:
            self.cached[0].graphs.clear()
        self.cached = None
        release_memory()


def verify_run(label: str, **fields):
    """verify.main on the published 7B with `fields`, its launches counted."""
    from bridgelang_tpu_torch import verify

    reset_launch_counts()
    t0 = time.perf_counter()
    out = verify.main(verify.VerifyConfig(**fields))
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    release_memory()
    log(f"robot: verify {label}: {out}; {seconds:.1f} s (a load of the 7B included unless shared); launches {counts}")
    return dict(out, seconds=seconds), counts


def verify_phase(ckpt_dir: str, tmp: str) -> dict:
    """verify.main on the published 7B: the default run (int8 w8a8 on load,
    VERIFY_CALLS calls; p50, p90, finite actions), a golden bundle recorded
    and replayed on the bf16 load (every record's tokens exact), the
    speculative stream (the accept histogram), and --quantize_int4 (224
    int4_mm_a8 and quantize_a8 launches per decoder pass)."""
    out, launches = {}, dict.fromkeys(KERNEL_NAMES, 0)

    def add(counts):
        for k in KERNEL_NAMES:
            launches[k] += counts[k]

    # One capture per key: the first predict's warm-up runs eagerly (and counts), then the graph replays.
    out["int8"], counts = verify_run("default (int8 w8a8)", checkpoint=ckpt_dir, calls=VERIFY_CALLS)
    expect_counts(counts, {k: v * (VERIFY_CALLS + 1) for k, v in INT8_PER_PREDICT.items()}, "verify default")
    add(counts)
    golden = os.path.join(tmp, "golden_7b_bf16.npz")
    out["record"], counts = verify_run("--golden_record (bf16)", checkpoint=ckpt_dir, quantize_int8=False,
                                       golden_record=golden, calls=GOLDEN_RECORDS)
    add(counts)
    out["replay"], counts = verify_run("--golden (bf16)", checkpoint=ckpt_dir, quantize_int8=False, golden=golden)
    add(counts)
    if out["replay"]["passed"] != GOLDEN_RECORDS:
        fail(f"robot: the golden replay passed {out['replay']['passed']} of {GOLDEN_RECORDS} records")
    out["stream"], counts = verify_run("--speculative_stream (int8 w8a8)", checkpoint=ckpt_dir,
                                       speculative_stream=True, calls=SPEC_STREAM_TICKS + 1)
    add(counts)
    passes = counts["flash_fwd"] / N_LAYERS_7B  # one prefill per tick, plus the captures' warm-up runs
    if len(out["stream"]["accepts"]) != SPEC_STREAM_TICKS or not SPEC_STREAM_TICKS + 1 <= passes <= SPEC_STREAM_TICKS + 3:
        fail(f"robot: the speculative stream measured {len(out['stream']['accepts'])} ticks with {passes} prefills")
    out["int4"], counts = verify_run("--quantize_int4 true", checkpoint=ckpt_dir, quantize_int4=True,
                                     calls=VERIFY_INT4_CALLS)
    predicts = VERIFY_INT4_CALLS + 1
    expect_counts(counts, {k: v * predicts for k, v in INT4_PER_PREDICT.items()}, "verify --quantize_int4")
    add(counts)
    log(f"robot: verify p50 / p90: int8 w8a8 {out['int8']['p50_ms']:.1f} / {out['int8']['p90_ms']:.1f} ms, int4 w4a8 "
        f"{out['int4']['p50_ms']:.1f} / {out['int4']['p90_ms']:.1f} ms; golden bf16 {GOLDEN_RECORDS}/{GOLDEN_RECORDS} "
        f"records exact; speculative stream accept histogram (k = 1..7) {out['stream']['hist']}, p50 "
        f"{out['stream']['p50_ms']:.1f} ms")
    out["launches"] = launches
    return out


def inspect_phase(ckpt_dir: str, written: dict, tmp: str) -> dict:
    """inspect_checkpoint.main on the published 7B (tensors and bytes as the
    load phase wrote them) and on a port run dir (a CheckpointManager save of
    the 7B's projector with its AdamW state: tensors and bytes as saved)."""
    import torch

    from bridgelang_tpu_torch import inspect_checkpoint
    from bridgelang_tpu_torch.training.checkpointing import CheckpointManager
    from bridgelang_tpu_torch.training.trainer import OptimConfig, init_train_state, make_optimizer, tree_leaves
    from bridgelang_tpu_torch.util.safetensors_io import SafetensorsFile, checkpoint_files

    t0 = time.perf_counter()
    hf = inspect_checkpoint.main(inspect_checkpoint.InspectConfig(path=ckpt_dir, limit=8))
    hf_s = time.perf_counter() - t0
    if (hf["tensors"], hf["bytes"]) != (written["tensors"], written["bytes"]):
        fail(f"robot: inspect_checkpoint counts {hf['tensors']} tensors, {hf['bytes']} bytes; the load phase wrote "
             f"{written['tensors']}, {written['bytes']}")
    projector = {}
    for f in checkpoint_files(ckpt_dir):
        sf = SafetensorsFile(f)
        projector.update({k: sf.get_tensor(k).float() for k in sf.keys() if k.startswith("projector.")})
    params = {"projector": projector}
    opt = make_optimizer(OptimConfig(), params)
    state = init_train_state(params, opt)
    path = CheckpointManager(os.path.join(tmp, "run"), keep=1).save(state, step=1, epoch=0, loss=1.0)
    saved = [t for t in tree_leaves({"params": state.params, "opt": state.opt_state}) if isinstance(t, torch.Tensor)]
    run = inspect_checkpoint.main(inspect_checkpoint.InspectConfig(path=os.path.join(tmp, "run"), limit=8))
    want = (len(saved), sum(t.numel() * t.element_size() for t in saved))
    if (run["tensors"], run["bytes"]) != want:
        fail(f"robot: inspect_checkpoint on {path} counts {run['tensors']} tensors, {run['bytes']} bytes; "
             f"saved {want}")
    log(f"robot: inspect_checkpoint: the published 7B {hf['tensors']} tensors, {hf['bytes'] / 1e9:.2f} GB in "
        f"{hf_s:.2f} s (as written); the run dir's state.pt {run['tensors']} tensors, {run['bytes'] / 1e6:.1f} MB "
        f"(as saved)")
    return dict(hf=dict(hf, seconds=hf_s), run=run)


def libero_phase(ckpt_dir: str, tmp: str, shared: SharedInt8Load) -> dict:
    """run_libero_eval.main with the fake simulator (LIBERO_TASKS tasks x
    LIBERO_EPISODES episodes x LIBERO_STEPS steps, 256 px, center crop) in
    each policy mode, on the int8 checkpoint that `shared` loaded once:
    * greedy: each action the env received equals predict_action's on the
      tick's frame cropped as the harness crops it (on the card);
    * speculative: each tick's ids equal greedy's on that frame;
    * remote: RemoteVLA against VLAServer.serve_background of the same model
      (speculative by default); each action equals the in-process
      predict_action on the frame cropped on the host, as RemoteVLA does;
    * chunk (--action_chunk ROBOT_CHUNK): one model pass per ROBOT_CHUNK
      ticks.
    The closed-loop rate of each mode (one over the median tick interval)."""
    import numpy as np

    from bridgelang_tpu_torch.experiments.robot import openvla_utils as ou
    from bridgelang_tpu_torch.experiments.robot.libero import run_libero_eval as rle
    from bridgelang_tpu_torch.experiments.robot.robot_utils import invert_gripper_action, normalize_gripper_action
    from bridgelang_tpu_torch.serving.server import VLAServer

    def run(mode, **kw):
        cfg = rle.LiberoEvalConfig(pretrained_checkpoint=ckpt_dir, num_trials_per_task=LIBERO_EPISODES,
                                   unnorm_key="bridge_orig", center_crop=True, resolution=LIBERO_RES,
                                   local_log_dir=os.path.join(tmp, "logs"), **kw)
        reset_launch_counts()
        t0 = time.perf_counter()
        with FakeLibero() as sim:
            rle.main(cfg)
        seconds = time.perf_counter() - t0
        n = LIBERO_TASKS * LIBERO_EPISODES * LIBERO_STEPS
        if len(sim.ticks) != n:
            fail(f"robot: libero {mode}: {len(sim.ticks)} policy ticks, expected {n} (an episode died)")
        log(f"robot: libero {mode}: {n} ticks in {seconds:.1f} s, closed loop {sim.rate_hz():.2f} Hz; launches "
            f"{launch_counts()}")
        return sim, dict(seconds=seconds, hz=sim.rate_hz(), launches=launch_counts())

    def expected(vla_model, params, frame, instruction, device):
        action, ids = vla_model.predict_action_batch(params, [ou.crop_frame_u8(frame, device=device)], [instruction],
                                                     unnorm_key="bridge_orig", return_tokens=True)
        return invert_gripper_action(normalize_gripper_action(action[0], binarize=True)), ids[0]

    out, spec_ids = {}, []
    real_predict = ou.InProcessVLA.predict

    def recording_predict(self, image, instruction, unnorm_key):
        action = real_predict(self, image, instruction, unnorm_key)
        if self.speculative:
            spec_ids.append(np.asarray(self._last_tokens))
        return action

    ou.InProcessVLA.predict = recording_predict
    try:
        greedy, out["greedy"] = run("greedy")
        model, params = shared.cached
        instr = [INSTRUCTIONS[t % len(INSTRUCTIONS)] for t, *_ in greedy.ticks]
        want_ids = []
        for tick, text in zip(greedy.ticks, instr):
            want, ids = expected(model, params, tick[2], text, model.device)
            want_ids.append(ids)
            if not np.array_equal(tick[3], want):
                fail(f"robot: libero greedy: the env got {tick[3].tolist()}, predict_action gives {want.tolist()}")
        spec, out["speculative"] = run("speculative", speculative=True)
        for i, (tick, ids) in enumerate(zip(spec.ticks, spec_ids)):
            if not np.array_equal(tick[2], greedy.ticks[i][2]) or not np.array_equal(ids, want_ids[i]):
                fail(f"robot: libero speculative tick {i}: ids {ids.tolist()} != greedy's {want_ids[i].tolist()}")
        server = VLAServer(model, params, device=model.device)
        httpd = server.serve_background(port=0)
        try:
            remote, out["remote"] = run("remote", remote_host="127.0.0.1", remote_port=httpd.server_address[1])
        finally:
            httpd.shutdown()
            httpd.server_close()
            server.close()
        for tick, text in zip(remote.ticks, instr):
            want, _ = expected(model, params, tick[2], text, "cpu")
            if not np.array_equal(tick[3], want):
                fail(f"robot: libero remote: the env got {tick[3].tolist()}, in-process gives {want.tolist()}")
        passes = []
        real_chunk = model.predict_action_chunk
        model.predict_action_chunk = lambda *a, **k: passes.append(1) or real_chunk(*a, **k)
        try:
            _, out["chunk"] = run("chunk", action_chunk=ROBOT_CHUNK)
        finally:
            del model.predict_action_chunk
        if len(passes) * ROBOT_CHUNK != LIBERO_TASKS * LIBERO_EPISODES * LIBERO_STEPS:
            fail(f"robot: libero chunk: {len(passes)} model passes for {LIBERO_TASKS * LIBERO_EPISODES * LIBERO_STEPS} "
                 f"ticks, expected one per {ROBOT_CHUNK}")
        out["chunk"]["passes"] = len(passes)
    finally:
        ou.InProcessVLA.predict = real_predict
    del model, params
    log("robot: libero closed-loop rates (Hz): " + ", ".join(f"{m} {r['hz']:.2f}" for m, r in out.items())
        + f"; greedy actions equal predict_action's, speculative ids equal greedy's, remote actions equal "
          f"in-process, chunk {out['chunk']['passes']} passes for {LIBERO_TASKS * LIBERO_EPISODES * LIBERO_STEPS} ticks")
    return out


def bridge_phase(ckpt_dir: str, tmp: str) -> dict:
    """run_bridgev2_eval.main with a fake WidowX stack and the prompts
    answered (the task, then Enter), BRIDGE_EPISODES episodes of
    BRIDGE_STEPS steps with the in-process policy (int8 on load, the shared
    load of robot_phase): every step
    sends an action, non-blocking; the achieved control rate against the
    5 Hz target and the policy's ms per step."""
    import builtins

    from bridgelang_tpu_torch.experiments.robot import openvla_utils as ou
    from bridgelang_tpu_torch.experiments.robot.bridge import run_bridgev2_eval as rbe

    prompts = iter([INSTRUCTIONS[0]])
    policy_ms = []
    real_input, real_predict = builtins.input, ou.InProcessVLA.predict

    def timed_predict(self, image, instruction, unnorm_key):
        t0 = time.perf_counter()
        action = real_predict(self, image, instruction, unnorm_key)
        policy_ms.append(1e3 * (time.perf_counter() - t0))
        return action

    cfg = rbe.BridgeEvalConfig(pretrained_checkpoint=ckpt_dir, max_episodes=BRIDGE_EPISODES, max_steps=BRIDGE_STEPS,
                               rollout_dir=os.path.join(tmp, "rollouts"))
    builtins.input = lambda *a: next(prompts, "")
    ou.InProcessVLA.predict = timed_predict
    t0 = time.perf_counter()
    try:
        with FakeWidowX(cfg.resize_hw) as robot:
            rbe.main(cfg)
    finally:
        builtins.input, ou.InProcessVLA.predict = real_input, real_predict
    seconds = time.perf_counter() - t0
    release_memory()
    if len(robot.steps) != BRIDGE_EPISODES * BRIDGE_STEPS or any(b for _, b in robot.steps):
        fail(f"robot: bridge: {len(robot.steps)} actions sent, expected {BRIDGE_EPISODES * BRIDGE_STEPS} "
             "non-blocking ones (a step raised)")
    gaps = [b[0] - a[0] for i, (a, b) in enumerate(zip(robot.steps, robot.steps[1:])) if (i + 1) % BRIDGE_STEPS]
    hz = 1.0 / statistics.median(gaps)
    steady = policy_ms[1:]  # the first predict captures the graph
    out = dict(seconds=seconds, hz=hz, target_hz=cfg.control_frequency, policy_ms_median=statistics.median(steady),
               policy_ms_max=max(steady), moves=robot.moves)
    log(f"robot: bridge: {len(robot.steps)} steps in {BRIDGE_EPISODES} episodes, achieved {hz:.2f} Hz against the "
        f"{cfg.control_frequency:g} Hz target; policy {out['policy_ms_median']:.1f} ms per step (median, max "
        f"{out['policy_ms_max']:.1f}); {seconds:.1f} s")
    return out


def robot_phase(ckpt_dir: str, written: dict) -> dict:
    """verify, inspect_checkpoint and the two harnesses on the load phase's
    published-layout 7B (see verify_phase, inspect_phase, libero_phase,
    bridge_phase); the int8 load is shared (SharedInt8Load)."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="smoke_robot_", dir=os.path.join(ROOT, "build"))
    try:
        with SharedInt8Load() as shared:
            result = {"verify": verify_phase(ckpt_dir, tmp), "inspect": inspect_phase(ckpt_dir, written, tmp)}
            result["libero"] = libero_phase(ckpt_dir, tmp, shared)
            result["bridge"] = bridge_phase(ckpt_dir, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = dict(result["verify"]["launches"])
    for mode in result["libero"].values():
        launches = {k: launches[k] + mode["launches"][k] for k in KERNEL_NAMES}
    result["launches"] = launches
    result["phase_s"] = time.perf_counter() - t_phase
    log(f"robot phase: {result['phase_s']:.1f} s; launches {launches}; {nvidia_smi_line()}")
    return result


# --- phase leftovers: the host-only modules of the last port slice ------------------

OCR_FIXTURE_DIR = os.path.join(ROOT, "tests", "data", "images", "ocr")


def leftovers_phase() -> dict:
    """The port's last host-only modules on this machine, which has no
    Pillow: preprocessing.download.convert_gif_png_to_jpg over a copy of the
    committed OCR-VQA fixtures (tests/data/images/ocr: GIF and PNG of every
    kind preprocess meets), each JPEG's sha256 equal to the one Pillow 12.1
    wrote where the fixtures were made (manifest.json `jpegs`, the JAX
    package's conversion), the same file names; extern/timm_shim.create_model
    for every tower id it models, on the meta device (its module tree, and
    every kept block's weights named as the checkpoint loader maps them into
    the port's towers); version.__version__."""
    import hashlib
    import shutil
    import tempfile

    import torch

    from bridgelang_tpu_torch import version
    from bridgelang_tpu_torch.extern import timm_shim
    from bridgelang_tpu_torch.models.load import hf_to_port
    from bridgelang_tpu_torch.models.vision.vit import VIT_CONFIGS
    from bridgelang_tpu_torch.preprocessing.download import convert_gif_png_to_jpg

    t0 = time.perf_counter()
    with open(os.path.join(OCR_FIXTURE_DIR, "manifest.json")) as f:
        want = json.load(f)["jpegs"]
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="smoke_ocr_", dir=os.path.join(ROOT, "build"))
    try:
        for name in os.listdir(OCR_FIXTURE_DIR):
            if name.endswith((".gif", ".png")):
                shutil.copy(os.path.join(OCR_FIXTURE_DIR, name), os.path.join(work, name))
        t_conv = time.perf_counter()
        convert_gif_png_to_jpg(work)
        conv_s = time.perf_counter() - t_conv
        got = {}
        for name in sorted(os.listdir(work)):
            if name.endswith(".jpg"):
                with open(os.path.join(work, name), "rb") as f:
                    got[name] = hashlib.sha256(f.read()).hexdigest()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    bad = sorted(n for n in set(got) | set(want) if got.get(n) != want.get(n))
    if bad:
        fail(f"leftovers: the OCR-VQA conversion differs from Pillow's bytes (or file set) for {bad}")
    towers = {}
    for timm_id, (ours, _) in sorted(timm_shim._TIMM_ID_TO_OURS.items()):
        with torch.device("meta"):
            model = timm_shim.create_model(timm_id)
        cfg = VIT_CONFIGS[ours]
        names = model.state_dict().keys()
        mapped = [n for n in names if hf_to_port(f"vision_backbone.featurizer.{n}", 1, {"featurizer": cfg.depth})]
        params = sum(p.numel() for p in model.parameters())
        if len(model.blocks) != cfg.depth or not any(n.startswith(f"blocks.{cfg.depth - 2}.") for n in mapped):
            fail(f"leftovers: timm_shim.create_model({timm_id!r}) does not build the {ours} tower")
        towers[timm_id] = dict(ours=ours, params=params, tensors=len(names), mapped=len(mapped))
    result = dict(jpegs=len(got), conversion_s=conv_s, towers=towers, version=version.__version__,
                  phase_s=time.perf_counter() - t0)
    log(f"leftovers: convert_gif_png_to_jpg wrote {len(got)} JPEGs in {conv_s:.2f} s, every sha256 equal to "
        f"Pillow 12.1's (tests/data/images/ocr/manifest.json); timm_shim built {len(towers)} tower ids ("
        + ", ".join(f"{k} {v['params'] / 1e6:.1f} M" for k, v in towers.items())
        + f"); version {version.__version__}; phase {result['phase_s']:.1f} s")
    return result


def report_build(logs: dict) -> None:
    """Each kernel's ptxas report (registers, spills, static shared memory)
    and the dynamic shared memory its launcher asks for."""
    import ctypes
    import re

    from bridgelang_tpu_torch.ops import _build

    for source, text in logs.items():
        fn = "?"
        for line in text.splitlines():
            found = re.search(r"(?:entry function|Function properties for) '?(\w+)", line)
            if found:
                short = re.search(r"(?:flash|int4)\w*?kernel(?:IL?[^E]*E)?", found.group(1))
                fn = short.group(0) if short else found.group(1)[:60]
            if "registers" in line or "spill" in line or "(C7" in line or "error" in line.lower():
                log(f"  {source}: {fn}: {line.strip()}")
    smem = ctypes.c_int
    flash = _build.load("flash_fwd").flash_fwd_smem_bytes
    bwd = _build.load("flash_bwd").flash_bwd_smem_bytes
    int4 = _build.load("int4_matmul").int4_mm_smem_bytes
    flash.argtypes, bwd.argtypes, int4.argtypes = [smem, smem], [smem, smem, smem], [smem, smem]
    log("dynamic shared memory per block: flash_fwd bf16 D=128 {} B, D=80 {} B, D=64 {} B, fp32 D=128 {} B, "
        "D=80 {} B; flash_bwd_dq bf16 D=128 {} B, D=80 {} B, fp32 {} B; flash_bwd_dkv bf16 D=128 {} B, D=80 {} B, "
        "fp32 {} B; int4_mm bf16 M>64 {} B, M<=64 {} B".format(
            flash(128, 1), flash(80, 1), flash(64, 1), flash(128, 0), flash(80, 0), bwd(0, 128, 1), bwd(0, 80, 1),
            bwd(0, 128, 0), bwd(1, 128, 1), bwd(1, 80, 1), bwd(1, 128, 0), int4(5632, 1), int4(64, 1)))
    lib = _build.load("int4_matmul")
    if hasattr(lib, "int4_mm_a8_smem_bytes"):  # absent from an earlier checkout timed with --package-root
        a8, splits = lib.int4_mm_a8_smem_bytes, lib.int4_mm_a8_splits
        a8.argtypes, splits.argtypes = [smem], [smem] * 4
        log(f"int4_mm_a8: split-K kernel (M<=16) {a8(1)} B, wgmma kernel (M>16) {a8(352)} B of dynamic shared memory; "
            "split-K blocks per column tile at M<=16: " + ", ".join(
                f"{sh} {splits(k, n // 2, INT4_GROUP, 0)}" for sh, (k, n) in INT4_SHAPES.items()))


def kernel_entry(name: str, source: str, replaces: str, launches: dict, timing: dict, **extra) -> dict:
    """One kernel's object in the {"kernels": [...]} line; `launches` is its
    count on each main path's run."""
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(launches.values()), "launches_by_path": launches, **{k: timing[k] for k in keys}, **extra}


def release_memory() -> None:
    """Free what a finished phase dropped: a served model's weights stay
    referenced from its HTTP handler class, a reference cycle that only the
    cyclic garbage collector breaks, until then counting in later peaks."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def main() -> None:
    ap = argparse.ArgumentParser(description="torch port smoke run on one GPU")
    ap.add_argument("--phases",
                    default="build,leftovers,load,kernels,moe,ring,serve,spec,parallel,train,int8,int4,qlora,variants,"
                            "tfds,scripts,robot,finetune,mesh,pretrain,parity",
                    help="comma-separated subset, for bring-up; the full run is the default; `cold` (not in "
                         "the default) runs only the device-side cold-L2 timings of the kernels phase")
    ap.add_argument("--package-root", default=ROOT,
                    help="import bridgelang_tpu_torch from this checkout (e.g. an earlier commit unpacked with "
                         "git archive) to time its kernels with --phases build,cold")
    args = ap.parse_args()
    phases = set(args.phases.split(","))
    if "mesh" in phases and not {"load", "finetune"} <= phases:
        fail("the mesh phase runs on the load phase's checkpoint and the finetune phase's store: "
             "--phases build,load,finetune,mesh")

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a CUDA card")
    sys.path.insert(0, os.path.abspath(args.package_root))
    try:
        from bridgelang_tpu_torch.ops import _build
    except ImportError as e:
        fail(f"run from the root of a checkout of the repository ({e})")
    # Full fp32 matmuls and convolutions, so the parity phase compares fp32
    # with fp32 and the int4 plain versions' group dots stay exact.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = nvidia_smi_line()
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; card: {smi}")

    from concurrent.futures import ThreadPoolExecutor

    from bridgelang_tpu_torch import native

    seconds, last = {}, [time.perf_counter()]

    def mark(phase: str) -> None:
        """Add the seconds since the previous mark to `phase`."""
        now = time.perf_counter()
        seconds[phase] = seconds.get(phase, 0.0) + now - last[0]
        last[0] = now

    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:  # g++ for the host library beside the nvcc builds
        host_lib = pool.submit(lambda: (native.build(), time.perf_counter() - t0))
        logs = _build.build_all()
        lib_path, lib_s = host_lib.result()
    log(f"build: {len(logs)} source(s) in {time.perf_counter() - t0:.1f} s; the host library "
        f"{os.path.basename(lib_path)} ({', '.join(s.name for s in native.SOURCES)}, g++) in {lib_s:.1f} s")
    report_build(logs)
    mark("build")
    if "leftovers" in phases:
        leftovers_phase()
        mark("leftovers")

    model = params = None
    serve_t = 352
    loaded = None
    ft_ckpt = written = None
    on_ckpt = {"tfds", "scripts", "robot", "finetune"}  # the phases that read the published-layout 7B
    if phases & {"load", "serve", "spec", "parallel", "train", "int8", "int4", "qlora", "variants"} | on_ckpt:
        model, params = build_7b(SEED)
        if "load" in phases:  # every later phase serves and trains the weights loaded through load_vla
            model, params, loaded = load_phase(model, params, keep_ckpt=bool(phases & on_ckpt))
            ft_ckpt, written = loaded.pop("ckpt_dir", None), loaded["write"]
        elif phases & on_ckpt:
            import tempfile

            os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
            ft_ckpt = tempfile.mkdtemp(prefix="smoke_ckpt_", dir=os.path.join(ROOT, "build"))
            written = write_published_checkpoint(model, params, ft_ckpt)
        ids, _ = model.pad_prompt([model.prepare_prompt_ids(INSTRUCTIONS[0])])
        serve_t = ids.shape[1] + model.num_patches
        log(f"serving prefill length: {ids.shape[1]}-token prompt bucket + {model.num_patches} patches = {serve_t}")
        mark("load")
    timing_rows, max_err, bwd_timing, bwd_err, bwd_readings, int4_checks, cold = [], None, None, None, None, None, None
    quantize_errs = int8_checks = None
    if "kernels" in phases:
        timing_rows, max_err = check_kernels(serve_t)
        bwd_timing, bwd_err, bwd_readings = check_backward_kernels()
        int4_checks = check_int4_kernels()
        quantize_errs = check_quantize_and_route()
        int8_checks = check_int8_gemv()
    if phases & {"kernels", "cold"}:
        cold = cold_timings("this checkout" if os.path.abspath(args.package_root) == ROOT else args.package_root)
        mark("kernels")
    moe = None
    if "moe" in phases:
        moe = moe_phase()
        mark("moe")
    ring = None
    if "ring" in phases:
        ring = ring_phase()
        mark("ring")

    served = parallel = None
    spec = {}
    if "serve" in phases:
        served = serve_kind(model, params, "bf16", {"flash_fwd": N_LAYERS_7B})
        mark("serve")
    if "spec" in phases:
        spec["bf16"] = spec_phase(model, params, "bf16", int4=False)
        mark("spec")
    if "parallel" in phases:
        parallel = parallel_phase(model, params, (served or {}).get("median_ms", float("nan")))
        mark("parallel")
    if model is not None:
        model.graphs.clear()
        release_memory()

    trained = None
    if "train" in phases:
        trained = train_adapters(model, params, SEED, "train", TRAIN_STEPS,
                                 {"flash_fwd": 2 * N_LAYERS_7B, "flash_bwd_dq": N_LAYERS_7B,
                                  "flash_bwd_dkv": N_LAYERS_7B}, dots_steps=DOTS_STEPS, resume_check=True)
        model.graphs.clear()  # the merged weights' predict captured its own
        release_memory()
        mark("train")

    served8 = None
    if "int8" in phases:
        from bridgelang_tpu_torch.ops.quant import quantize_llm_int8

        from bridgelang_tpu_torch.training.trainer import tree_map

        # The bf16 decoder quantized one matrix at a time, then parked in host
        # memory for this phase, so that the card holds what int8 serving holds.
        t0 = time.perf_counter()
        params8 = dict(params, llm=quantize_llm_int8(params["llm"]))
        torch.cuda.synchronize()
        log(f"int8: decoder quantized in {time.perf_counter() - t0:.1f} s; decoder + embedding + head "
            f"{tensor_gb(params8['llm']):.2f} GB (bf16: {tensor_gb(params['llm']):.2f} GB)")
        params = dict(params, llm=tree_map(lambda t: t.cpu(), params["llm"]))
        release_memory()
        model8 = w8a8_model(model, w8a8=True)
        served8 = serve_kind(model8, params8, "int8", INT8_PER_PREDICT)
        served8.update(int8_routes(model8, params8))
        prof = served8["profile"]
        share = (ACTION_DIM - 1) * served8["decode_gemv_ms_per_step"] / prof["device_ms"]
        served8["decode_gemv_share"] = share
        served8["direct_copy_share"] = prof["direct_copy_ms"] / prof["device_ms"]
        log(f"int8 serve: model {served8['model_gb']:.2f} GB (decoder + embedding + head {served8['llm_gb']:.2f} GB), "
            f"peak {max(served8['warmup_peak_gb'].values()):.2f} GB after the warm-up; the decode's int8 GEMVs, "
            f"timed alone, {(ACTION_DIM - 1) * served8['decode_gemv_ms_per_step']:.2f} ms of a predict's "
            f"{prof['device_ms']:.2f} ms of device time ({100 * share:.1f}%); in the profile ATen's direct_copy "
            f"kernels take {prof['direct_copy_ms']:.2f} ms ({100 * served8['direct_copy_share']:.1f}%; bf16: "
            f"{(served or {}).get('profile', {}).get('direct_copy_ms', float('nan')):.2f} ms)")
        if "spec" in phases:
            spec["int8"] = spec_phase(model8, params8, "int8", int4=False)
        model8.graphs.clear()
        del model8, params8
        release_memory()
        params = dict(params, llm=tree_map(lambda t: t.to("cuda"), params["llm"]))
        mark("int8")

    kv8_7b = None
    if "variants" in phases:  # the int8 KV cache on the bf16 7B, before int4 packs it
        t_variants = time.perf_counter()
        kv8_7b = kv_cache_int8(model, params, "7B")
        t_variants = time.perf_counter() - t_variants
        mark("variants")

    served4 = qlora = None
    if phases & {"int4", "qlora"}:
        from bridgelang_tpu_torch.ops.quant import quantize_llm_int4

        # The bf16 decoder packed one matrix at a time; the bf16 leaves go with `params`.
        t0 = time.perf_counter()
        params = dict(params, llm=quantize_llm_int4(params["llm"], group=INT4_GROUP))
        torch.cuda.synchronize()
        release_memory()
        log(f"int4: decoder packed (group {INT4_GROUP}) in {time.perf_counter() - t0:.1f} s; decoder + int8 "
            f"embedding and head {tensor_gb(params['llm']):.2f} GB, card holds {torch.cuda.memory_allocated() / 1e9:.2f} GB")
        model4 = w8a8_model(model, w8a8=True)
        if "int4" in phases:
            served4 = serve_kind(model4, params, "int4", INT4_PER_PREDICT)
            if "spec" in phases:
                spec["int4"] = spec_phase(model4, params, "int4", int4=True)
            model4.graphs.clear()
            release_memory()
        if "qlora" in phases:
            qlora = train_adapters(w8a8_model(model, w8a8=False), params, SEED, "qlora", QLORA_STEPS,
                                   {"flash_fwd": 2 * N_LAYERS_7B, "flash_bwd_dq": N_LAYERS_7B,
                                    "flash_bwd_dkv": N_LAYERS_7B, "int4_mm": 2 * INT4_PER_PASS},
                                   serve_model=model4)
        model4.graphs.clear()
        del model4
        mark("int4, qlora")
    del model, params
    release_memory()

    variants = None
    if "variants" in phases:
        t0 = time.perf_counter()
        variants = {"kv8_7b": kv8_7b, "phi": phi_phase(), "mistral": mistral_phase()}
        variants["seconds"] = t_variants + time.perf_counter() - t0
        log(f"variants: the phase took {variants['seconds']:.1f} s")
        mark("variants")

    tfds = scripts = robot = None
    if "tfds" in phases:  # before finetune, which deletes the published 7B
        tfds = tfds_phase(ft_ckpt)
        mark("tfds")
    if "scripts" in phases:
        scripts = scripts_phase(ft_ckpt)
        mark("scripts")
    if "robot" in phases:
        robot = robot_phase(ft_ckpt, written)
        mark("robot")
    if ft_ckpt and "finetune" not in phases:
        import shutil

        shutil.rmtree(ft_ckpt, ignore_errors=True)
        mark("cleanup")

    tuned = None
    if "finetune" in phases:
        tuned = finetune_phase(ft_ckpt, (trained or {}).get("dots", {}).get("peak_memory_gb", TRAIN_DOTS_PEAK_GB),
                               mesh="mesh" in phases)
        mark("finetune")
        if "mesh" in tuned:
            seconds["finetune"] -= tuned["mesh"]["phase_s"]
            seconds["mesh"] = tuned["mesh"]["phase_s"]
    if tfds and tuned:
        a, b = tfds["finetune"], tuned["lora"]
        log(f"host wait per batch, median of the profiled steps: TFDS (JPEGs decoded in the batch workers) "
            f"{a['median_data_wait_ms']:.1f} ms, native store (raw frames) {b['median_data_wait_ms']:.1f} ms; step "
            f"{a['median_step_ms']:.1f} vs {b['median_step_ms']:.1f} ms; {smi}")

    pretrained = None
    if "pretrain" in phases:  # after finetune: the 7B's align save is ~30 GB
        pretrained = pretrain_phase()
        mark("pretrain")

    parity = None
    if "parity" in phases:
        parity = parity_card_vs_cpu(SEED, spec="spec" in phases)
        mark("parity")
    seconds = {k: round(v, 1) for k, v in seconds.items() if v >= 0.05}
    log(f"seconds per phase: {json.dumps(seconds)}; total {sum(seconds.values()):.1f} s")

    if timing_rows:
        zero = dict.fromkeys(KERNEL_NAMES, 0)
        by_path = {"serve": (served or {}).get("launches", zero), "train": (trained or {}).get("launches", zero),
                   "int8_serve": (served8 or {}).get("launches", zero),
                   "int4_serve": (served4 or {}).get("launches", zero), "qlora": (qlora or {}).get("launches", zero),
                   "parallel": (parallel or {}).get("launches", zero), "load": (loaded or {}).get("launches", zero),
                   "finetune": (tuned or {}).get("launches", zero), "tfds": (tfds or {}).get("launches", zero),
                   "scripts": (scripts or {}).get("launches", zero), "robot": (robot or {}).get("launches", zero),
                   "pretrain": (pretrained or {}).get("launches", zero),
                   "ring_blocks": (ring or {}).get("launches", zero),
                   "mesh_finetune": (tuned or {}).get("mesh", {}).get("launches", zero),
                   **{f"mesh_deploy {k}": d["launches"] for k, d in (tuned or {}).get("mesh", {}).get("deploy", {}).items()},
                   **{f"spec_{kind}": result["launches"] for kind, result in spec.items()}}
        if variants:
            phi = variants["phi"]
            by_path.update(kv8_7b=variants["kv8_7b"]["launches"], kv8_phi=phi["kv8"]["launches"],
                           phi_serve=phi["serve"]["launches"], phi_lora=phi["lora"]["launches"],
                           phi_int4=phi["int4"]["launches"], phi_qlora=phi["qlora"]["launches"],
                           mistral=variants["mistral"]["launches"])

        def launches(name):
            return {path: counts[name] for path, counts in by_path.items()}

        # serving shape, B=1: the device-side time (a captured graph), the event window beside it
        row = dict(timing_rows[0], ms=cold["flash_fwd"]["device_ms"], library_ms=cold["flash_fwd"]["library_device_ms"],
                   max_abs_err=max_err)
        entry = kernel_entry("flash_fwd", "bridgelang_tpu_torch/csrc/flash_fwd.cu",
                             "bridgelang_tpu/ops/flash_attention.py:59", launches("flash_fwd"), row,
                             shape=row["shape"], event_ms=row["kernel_ms"], library_event_ms=timing_rows[0]["library_ms"],
                             d80_device=cold["flash_fwd_d80"], timings=timing_rows,
                             tensor_parallel_device={k: cold[k] for k in cold if k.startswith("flash_fwd_h")},
                             note="ms and library_ms: device time per launch from a captured CUDA graph of "
                                  "back-to-back launches (inputs warm in L2, as the prefill leaves them); event_ms, "
                                  "library_event_ms and the timings: CUDA events around calls, the earlier series")
        serve_keys = ("median_ms", "prefill_ms", "decode_ms_per_token", "batch4_ms", "batch4_passes", "passes",
                      "max_memory_gb", "profile", "eager", "replay_event_ms", "warmup_peak_gb", "capture_s")
        if served:
            entry["serve"] = {k: served[k] for k in serve_keys}
        if served8:
            entry["int8_serve"] = {k: served8[k] for k in serve_keys + (
                "model_gb", "llm_gb", "proj", "int8_product", "int8_gemv", "decode_gemv_ms_per_step",
                                 "decode_cast_ms_per_step", "decode_gemv_share")}
        if spec:
            entry["spec"] = spec
        if parallel:
            entry["parallel"] = parallel
        if trained:
            entry["train"] = trained
        if parity:
            entry["parity"] = parity
        if loaded:
            entry["load"] = {k: v for k, v in loaded.items() if k != "launches"}
        if tuned:
            entry["finetune"] = {k: v for k, v in tuned.items() if k not in ("launches", "mesh")}
            if "mesh" in tuned:
                entry["mesh"] = {k: v for k, v in tuned["mesh"].items() if k != "launches"}
        if tfds:
            entry["tfds"] = {k: v for k, v in tfds.items() if k != "launches"}
        if variants:
            entry["variants"] = variants
        if ring:
            entry["ring"] = dict(cases=ring["cases"], block=ring["blocks"], tensor_rank=ring["tensor_rank"],
                                 note="the virtual ring: n blocks of one B=2 T=2304 bf16 sequence through the ring's "
                                      "block functions (the kernels' fp32 outputs) on one card; block and "
                                      "tensor_rank: the kernels at one ring block (n=8; bf16 and fp32 outputs, *_f32) "
                                      "and at a tensor=2 rank's LoRA step, CUDA events")
        if scripts:
            entry["scripts"] = {k: v for k, v in scripts.items() if k != "launches"}
        if robot:
            entry["robot"] = {k: v for k, v in robot.items() if k != "launches"}
        t2304 = None
        if pretrained:
            entry["pretrain"] = {k: v for k, v in pretrained.items() if k not in ("launches", "kernels_t2304")}
            t2304 = pretrained["kernels_t2304"]
            entry["t2304"] = dict(
                max_abs_err=t2304["worst"]["fwd"], plain_ms_b2=t2304["plain_fwd_ms_b2"], checks=t2304["checks"],
                **{stage: dict(shape=x["shape"], lengths=x["lengths"], ms=x["fwd_ms"], library_ms=x["fwd_library_ms"],
                               bound_ms=x["fwd_bound"][0], bound_by=x["fwd_bound"][1])
                   for stage, x in t2304["timings"].items()},
                note="flash_fwd at the pretraining length, B=16 with each stage's first micro-batch's fused "
                     "lengths: CUDA events around calls; library: SDPA's memory-efficient kernel with the "
                     "equivalent boolean mask; plain_ms_b2: the plain forward at B=2 (the check's shape)")
        entries = [entry]
        for name, line, ms_key, err in (("flash_bwd_dq", "bridgelang_tpu/ops/flash_attention.py:116", "dq_ms", "dq"),
                                        ("flash_bwd_dkv", "bridgelang_tpu/ops/flash_attention.py:156", "dkv_ms", "dkv")):
            bt = bwd_timing["train_b16"]
            bound, bound_by = bt["bounds"][err]
            timing = dict(max_abs_err=bwd_err[err], ms=bt[ms_key], plain_ms=bt["plain_ms"],
                          bound_ms=bound, bound_by=bound_by, library_ms=bt["library_ms"])
            extra_t2304 = {}
            if t2304:
                extra_t2304["t2304"] = dict(
                    max_abs_err=t2304["worst"][err], tolerance_use=t2304["worst"]["use"],
                    plain_ms_b2=t2304["plain_bwd_ms_b2"],
                    **{stage: dict(shape=x["shape"], ms=x[ms_key], library_ms=x["bwd_library_ms"],
                                   bound_ms=x["bwd_bounds"][err][0], bound_by=x["bwd_bounds"][err][1])
                       for stage, x in t2304["timings"].items()},
                    note="medians of interleaved rounds at B=16 T=2304 with each stage's first micro-batch's "
                         "lengths; library_ms: SDPA's memory-efficient autograd backward (dq, dk, dv together); "
                         "plain_ms_b2: the plain backward at B=2")
            if ring:
                extra_t2304["ring"] = {key: dict(shape=x["shape"], ms=x["ms"][err], plain_ms=x["ms"]["plain_bwd"],
                                                 library_ms=x["ms"]["library_bwd"], bound=x["bounds"][err],
                                                 f32_ms=x["ms"].get(err + "_f32"),
                                                 f32_bound=x["bounds"].get(err + "_f32"),
                                                 f32_checks=x["f32_checks"])
                                       for key, x in (*ring["blocks"].items(), ("tensor_rank", ring["tensor_rank"]))}
            entries.append(kernel_entry(
                name, "bridgelang_tpu_torch/csrc/flash_bwd.cu", line, launches(name), timing, **extra_t2304,
                tolerance_use=max(r[w]["use"] for r in bwd_readings.values()
                                  for w in ({"dq": ("dq",), "dkv": ("dk", "dv")}[err])),
                shape=bt["shape"], library_backend=bt["library_backend"],
                library_unpinned=bt["unpinned"],
                readings=bt["readings"][err if err == "dq" else "dkv"] + bt["readings"]["sdpa"],
                d80={k: bwd_timing["phi_train_b16"][k] for k in ("shape", ms_key, "plain_ms", "library_ms", "bounds")},
                note=f"ms and library_ms: medians of {BWD_ROUNDS} interleaved rounds (readings: the kernel's, then "
                     "SDPA's); plain_ms and library_ms compute dq, dk and dv together; d80: the same at Phi-2's "
                     "LoRA shape (head dim 80)"))
        # headline shapes: w_gate at decode (the most launched a8 shape) and at the QLoRA M
        a8_cold = {f"{sh} M={m}": r for (sh, m), r in cold["int4_mm_a8"].items()}
        for name, line, mode, m, key in (("int4_mm_a8", "bridgelang_tpu/ops/int4_matmul.py:114", "a8", 1, "a8"),
                                         ("int4_mm", "bridgelang_tpu/ops/int4_matmul.py:60", "bfloat16", 5632, "float")):
            rows = [r for r in int4_checks["rows"] if r["mode"] == mode]
            head = next(r for r in rows if r["m"] == m and r["n"] == 11008)
            timing = dict(head, ms=head["kernel_ms"], max_abs_err=int4_checks["worst"][key][0])
            extra = {"tolerance_use": int4_checks["worst"][key][1], "shape": head["shape"], "timings": rows,
                     "blocked": [b for b in int4_checks["blocked"] if (" a8 " in b["case"]) == (mode == "a8")]}
            if name == "int4_mm_a8":
                c = a8_cold[f"w_gate M={m}"]
                timing.update(ms=c["device_ms"], library_ms=c["library_device_ms"])
                extra.update(event_ms=head["kernel_ms"], library_event_ms=head["library_ms"], cold=a8_cold,
                             note="ms and library_ms: device time per launch, cold L2: a captured CUDA graph of "
                                  "launches rotating over weight copies of 100 MB or more in all (cold); event_ms, "
                                  "library_event_ms and the timings' kernel_ms: CUDA events around back-to-back "
                                  "wrapper calls on one weight, the earlier series")
            if name == "int4_mm_a8" and served4:
                extra["int4_serve"] = {k: served4[k] for k in serve_keys + ("model_gb", "llm_gb")}
            if name == "int4_mm":
                extra["phi"] = [r for r in rows if r["case"].startswith("phi")]
                if qlora:
                    extra["qlora"] = qlora
            entries.append(kernel_entry(name, "bridgelang_tpu_torch/csrc/int4_matmul.cu", line, launches(name),
                                        timing, **extra))
        qz = cold["quantize_a8"]
        entries.append(kernel_entry(
            "quantize_a8", "bridgelang_tpu_torch/csrc/int4_matmul.cu",
            "bridgelang_tpu/ops/int4_matmul.py:114 (helper of int4_mm_a8, no TPU kernel of its own: XLA fuses "
            "bridgelang_tpu/ops/quant.py quantize_activations_per_token into the jitted program)",
            launches("quantize_a8"),
            dict(qz[1], ms=qz[1]["device_ms"], plain_ms=qz[1]["plain_device_ms"], library_ms=None,
                 max_abs_err=max(quantize_errs["codes"], quantize_errs["scales"])),
            shape=qz[1]["shape"], event_ms=qz[1]["event_ms"], plain_event_ms=qz[1]["plain_ms"], timings=qz,
            codes_max_abs_err=quantize_errs["codes"], scales_max_abs_err=quantize_errs["scales"],
            route_max_abs_err=quantize_errs["route"],
            note="max_abs_err: the larger of max|codes err| and max|scales err| against "
                 "quantize_activations_per_token (random, zero, tie and NaN rows, bf16 and fp32); route_max_abs_err: "
                 "the w4a8 route against its plain composition; ms, plain_ms: device time per launch (captured CUDA graph); bound: M K 2 bytes read, M K + 4 M "
                 "written"))
        head = next(r for r in int8_checks["rows"] if r["case"] == "w_gate" and r["m"] == 1)
        entries.append(kernel_entry(
            "int8_gemv", "bridgelang_tpu_torch/csrc/int8_matmul.cu",
            "none (the JAX package's int8 route casts the weight inside one XLA fusion: models/llm/llama.py "
            "_block.proj, lm_logits)", launches("int8_gemv"),
            dict(head, ms=head["kernel_ms"], max_abs_err=int8_checks["worst"][0]),
            tolerance_use=int8_checks["worst"][1], shape=head["shape"], timings=int8_checks["rows"],
            m_limit=int8_checks["m_limit"],
            int8_serve=served8 and {k: served8[k] for k in ("int8_gemv", "decode_gemv_ms_per_step",
                                                             "decode_cast_ms_per_step")},
            note="ms, plain_ms, library_ms: device time per launch, cold L2 (a captured CUDA graph rotating over "
                 "weight copies of 100 MB or more); plain: the cast route (codes cast to bf16, F.linear, the "
                 "scale); library: F.linear over bf16 weights cast ahead of time; bound: bytes"))
        print(json.dumps({"kernels": entries}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
