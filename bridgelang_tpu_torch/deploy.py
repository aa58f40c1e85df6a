"""REST serving entry point of the torch port.

    python -m bridgelang_tpu_torch.deploy --checkpoint /ckpts/openvla-7b [--port 8000] \
        [--tokenizer_path DIR] [--quantize_int8 true] [--quantize_int4 false] [--int4_group 128] \
        [--max_batch 4] [--batch_window_ms 6] [--device cuda] [--warmup true] \
        [--speculative_default true] [--speculative_margin 0.25] [--parallel_decode false] \
        [--kv_cache_int8 false] [--mesh_spec tensor=2] [--int4_shards 1]
    python -m bridgelang_tpu_torch.deploy --random_init_for_smoke true
    torchrun --nproc_per_node 2 -m bridgelang_tpu_torch.deploy --checkpoint /ckpts/openvla-7b --mesh_spec tensor=2

Mirrors scripts/deploy.py (`DeployConfig`): every field is accepted under
its name, with its default. `--checkpoint` is a local directory in the HF
OpenVLA layout (config.json + *.safetensors + dataset_statistics.json,
`models/load.load_vla`); another id raises, naming the files to pre-stage.
The quantization switches act while the checkpoint loads: `--quantize_int8`
(the default) quantizes the decoder to int8, `--quantize_int4` packs it to
int4 with groups of `--int4_group` input rows instead, and either turns on
the w8a8 serving posture. `--random_init_for_smoke true` serves a tiny
random-weight model instead (as scripts/deploy.py does), quantized the same
way. `--warmup` captures the predict graphs of every batch bucket (and the
speculative pair) before listening. At batch 1 the server decodes
speculatively by default (`--speculative_default`, gated at
`--speculative_margin`); `--parallel_decode` serves the one-forward parallel
decode instead (models fine-tuned for it) and turns the speculative default
off. `--kv_cache_int8 true` decodes over the int8 KV cache (half the bytes
of the bf16 cache) and turns the speculative default off too. The device
defaults to CUDA and the command fails without a card unless `--device cpu`
(or `--force_cpu true`) is given.

GET /healthz answers {"status": "ok"}; GET /stats the request, error and
model-pass counts and, from the server's spans and counters
(util/profiling.py): `latency_ms` (p50 / p90 / p99 / last of the last 512
requests), `stages_ms` (count, p50 and p99 of each span: serve:parse,
serve:wait, serve:pass, serve:respond, predict:prepare, graphs:copy_in,
graphs:replay, predict:wait, predict:unpack), `passes_by_rows`, `windows`
(the batcher's windows closed full / at the deadline / by shutdown),
`graph_captures` (graphs built since listening; after `--warmup` a capture
here is a graph built on a live request) and `memory` (per card, live and
peak GB).

`--mesh_spec` ("tensor=N", "replica=R,tensor=T") serves over a device mesh:
one process per device, started by torchrun (`--nproc_per_node` = the mesh's
size; torchrun's WORLD_SIZE / RANK / LOCAL_RANK, MASTER_ADDR / MASTER_PORT,
or DIST_INIT_METHOD for another rendezvous such as file:///path), each on
cuda:LOCAL_RANK. A single process with `--mesh_spec` serves a mesh of one
device (its collectives run on one rank). Every rank loads the checkpoint,
keeps its blocks (parallel/sharding.SERVING_RULES: Megatron column / row
splits of the decoder, the vocab-split head) and captures the same graphs;
rank 0 serves HTTP and leads each predict, the others follow it
(serving/mesh.py). The checks are scripts/deploy.py's: `tensor` must divide
the head counts; `--quantize_int4` with tensor > 1 needs `--int4_shards`
equal to it (a shard-blocked pack), and the shard-local shapes pass the
card's int4 kernel rule (`ops/int4_matmul.int4_tp_fallback_matmuls`), else
the deploy is refused. `--allow_int4_tp_fallback true` serves those shapes
through the dequantizing fallback on the CPU only: on a CUDA device no
product leaves the kernel, so the flag is refused there with the rule's
message (the 7B at tensor=4 serves int8 instead).
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
    ap.add_argument("--checkpoint", default="openvla-7b", help="local HF-layout checkpoint directory")
    ap.add_argument("--tokenizer_path", default=None)
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--unnorm_key", default=None)
    ap.add_argument("--random_init_for_smoke", type=_bool, default=False)
    ap.add_argument("--max_batch", type=int, default=1)
    ap.add_argument("--batch_window_ms", type=float, default=6.0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--force_cpu", type=_bool, default=False, help="the same as --device cpu")
    ap.add_argument("--quantize_int8", type=_bool, default=True)
    ap.add_argument("--quantize_int4", type=_bool, default=False, help="overrides --quantize_int8")
    ap.add_argument("--int4_group", type=int, default=128)
    ap.add_argument("--int4_shards", type=int, default=1,
                    help="shard-blocked int4 packing for a tensor-parallel mesh (= its tensor size)")
    ap.add_argument("--mesh_spec", default="", help='serve over a device mesh, e.g. "tensor=2" (torchrun)')
    ap.add_argument("--allow_int4_tp_fallback", type=_bool, default=False,
                    help="CPU only: serve int4 shards the kernel rule refuses through the dequant fallback")
    ap.add_argument("--kv_cache_int8", type=_bool, default=False,
                    help="decode over the int8 KV cache (turns the speculative default off)")
    ap.add_argument("--warmup", type=_bool, default=True)
    ap.add_argument("--speculative_default", type=_bool, default=True)
    ap.add_argument("--speculative_margin", type=float, default=0.25)
    ap.add_argument("--parallel_decode", type=_bool, default=False)
    return ap.parse_args(argv)


def smoke_llm_config():
    """The smoke model's 2-layer 128-wide Llama."""
    from bridgelang_tpu_torch.models.llm.llama import LLMConfig

    return LLMConfig(vocab_size=32000, padded_vocab_size=32064, dim=128, n_layers=2, n_heads=4, n_kv_heads=4,
                     intermediate_size=256)


def build_smoke_model(device: torch.device):
    """The tiny random-weight OpenVLA that scripts/deploy.py serves for smoke
    tests: 64 px single tower, 2-layer 128-wide Llama, fp32."""
    from bridgelang_tpu_torch.models.llm.tokenizer import get_tokenizer
    from bridgelang_tpu_torch.models.vision.vit import ViTConfig
    from bridgelang_tpu_torch.models.vla import OpenVLA
    from bridgelang_tpu_torch.models.vlm import VLMConfig
    from bridgelang_tpu_torch.ops.image_ops import ImageTowerSpec, ImageTransformConfig

    tiny_vit = ViTConfig(image_size=64, patch_size=8, width=64, depth=4, num_heads=4, mlp_dim=128)
    vcfg = dataclasses.replace(VLMConfig(), llm=smoke_llm_config(), vision_override=tiny_vit)
    stats = {"bridge_orig": {"action": {"q01": [-0.1] * 7, "q99": [0.1] * 7, "mask": [True] * 6 + [False]}}}
    model = OpenVLA(vcfg, stats, tokenizer=get_tokenizer(None), dtype=torch.float32, device=device)
    model.image_transform = ImageTransformConfig("resize-naive", (ImageTowerSpec(size=64),))
    gen = torch.Generator(device=model.device).manual_seed(0)
    return model, model.init_params(gen)


def quantize_for_serving(model, params, quantize_int8: bool, quantize_int4: bool, int4_group: int,
                         int4_shards: int = 1):
    """The decoder quantized as asked (int4 over int8, packed shard-blocked
    for `int4_shards` ranks), and the model with w8a8 on when either is (the
    JAX `load_vla` serving posture). Returns (model, params); the float
    decoder leaves go with the old params."""
    if not (quantize_int8 or quantize_int4):
        return model, params
    from bridgelang_tpu_torch.models.vla import OpenVLA
    from bridgelang_tpu_torch.ops.quant import quantize_llm_int4, quantize_llm_int8

    shards = int4_shards if quantize_int4 else 1
    llm = (quantize_llm_int4(params["llm"], group=int4_group, n_shards=shards) if quantize_int4
           else quantize_llm_int8(params["llm"]))
    cfg = dataclasses.replace(model.cfg, llm=dataclasses.replace(model.cfg.llm, w8a8=True, int4_shards=shards))
    served = OpenVLA(cfg, model.norm_stats, tokenizer=model.tokenizer, dtype=model.dtype, device=model.device)
    served.image_transform = model.image_transform
    return served, dict(params, llm=llm)


def load_for_serving(args: argparse.Namespace, device: torch.device):
    """(model, params) as the arguments ask: the smoke model, or the
    checkpoint loaded through `load_vla` (quantized while it loads) with the
    tokenizer of `--tokenizer_path`."""
    int4_shards = args.int4_shards if args.quantize_int4 else 1
    if args.random_init_for_smoke:
        return quantize_for_serving(*build_smoke_model(device), args.quantize_int8, args.quantize_int4,
                                    args.int4_group, int4_shards)
    from bridgelang_tpu_torch.models.llm.tokenizer import get_tokenizer
    from bridgelang_tpu_torch.models.load import load_vla

    model, params = load_vla(args.checkpoint, quantize_int8=args.quantize_int8, quantize_int4=args.quantize_int4,
                             int4_group=args.int4_group, int4_shards=int4_shards, device=device)
    model.tokenizer = get_tokenizer(args.tokenizer_path)
    return model, params


def check_mesh_args(args: argparse.Namespace, llm_cfg, tensor: int, device: torch.device) -> None:
    """scripts/deploy.py's checks of a mesh deploy, with the card's int4 rule.
    Raises SystemExit with the reason."""
    if llm_cfg.n_heads % tensor or llm_cfg.n_kv_heads % tensor:
        raise SystemExit(f"tensor={tensor} does not divide the head counts ({llm_cfg.n_heads}/{llm_cfg.n_kv_heads}).")
    if not (args.quantize_int4 and tensor > 1):
        return
    if args.int4_shards != tensor:
        raise SystemExit(f"--quantize_int4 with tensor={tensor} needs --int4_shards {tensor} (shard-blocked packing; "
                         f"see ops/quant.py::pack_int4). Got --int4_shards {args.int4_shards}.")
    from bridgelang_tpu_torch.ops.int4_matmul import int4_tp_fallback_matmuls

    fallback = int4_tp_fallback_matmuls(llm_cfg, args.int4_group, tensor)
    if not fallback:
        return
    msg = (f"int4 + tensor={tensor}: shard-local {', '.join(fallback)} fail the card's int4 kernel rule "
           "(N/2 a multiple of 64, a group a multiple of 128; ops/int4_matmul.cuda_kernel_shape_ok). Serve int8 "
           "at this geometry (the 7B's MLP at tensor=4)")
    if device.type == "cuda" and args.allow_int4_tp_fallback:
        raise SystemExit(msg + "; --allow_int4_tp_fallback is refused on a CUDA device: no product leaves the kernel.")
    if device.type == "cuda":
        raise SystemExit(msg + ".")
    if not args.allow_int4_tp_fallback:
        raise SystemExit(msg + ", or pass --allow_int4_tp_fallback true to serve through the CPU fallback.")
    print(f"[serve] {msg}; serving through the CPU's dequantizing fallback", flush=True)


def build_server(args: argparse.Namespace):
    """The VLAServer that `main` runs (the predict graphs warmed up first
    when `--warmup`). With `--mesh_spec` this process joins the process
    group first (one rank per device) and serves its blocks of the weights;
    only rank 0 warms up (the others replay its predicts in `main`)."""
    from bridgelang_tpu_torch._device import resolve_device
    from bridgelang_tpu_torch.serving.server import VLAServer
    from bridgelang_tpu_torch.util.compile_cache import warmup_predict

    if args.force_cpu and args.device not in (None, "cpu"):
        raise ValueError(f"--force_cpu true contradicts --device {args.device}")
    device = resolve_device("cpu" if args.force_cpu else args.device)
    mesh = None
    if args.mesh_spec:
        from bridgelang_tpu_torch.parallel.mesh import make_mesh, mesh_sizes

        mesh = make_mesh(args.mesh_spec, device.type)
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
        check_mesh_args(args, _llm_config(args), mesh_sizes(mesh)["tensor"], device)
    model, params = load_for_serving(args, device)
    if mesh is not None:
        params = model.use_mesh(mesh, params, int4_shards=args.int4_shards if args.quantize_int4 else 1)
    model.parallel_decode = args.parallel_decode
    if args.kv_cache_int8:
        model.cache_dtype = torch.int8  # the server then turns its speculative default off
    server = VLAServer(model, params, default_unnorm_key=args.unnorm_key, max_batch=args.max_batch,
                       batch_window_ms=args.batch_window_ms, speculative_default=args.speculative_default,
                       speculative_margin=args.speculative_margin, device=device)
    if args.warmup and is_leader(model):
        dt = warmup_predict(model, params, max_batch=args.max_batch, unnorm_key=args.unnorm_key,
                            speculative=server.speculative_default and args.max_batch <= 1,
                            margin_threshold=args.speculative_margin)
        print(f"[serve] predicts for batch buckets <= {max(args.max_batch, 1)} warmed up in {dt:.1f} s", flush=True)
    return server


def _llm_config(args: argparse.Namespace):
    """The decoder's config before any weight is read (the mesh checks)."""
    if args.random_init_for_smoke:
        return smoke_llm_config()
    from bridgelang_tpu_torch.models.load import load_vla

    shell, _ = load_vla(args.checkpoint, load_weights=False, device="cpu")
    return shell.cfg.llm


def is_leader(model) -> bool:
    """Whether this process serves HTTP: no mesh, or rank 0 of it."""
    return model.mesh_predictor is None or model.mesh_predictor.rank == 0


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    server = build_server(args)
    mesh = server.model.mesh_predictor
    if not is_leader(server.model):
        mesh.follow(server.params)
        return
    what = "a random smoke model" if args.random_init_for_smoke else args.checkpoint
    if mesh is not None:
        print(f"[serve] rank 0 of {mesh.world} leads the mesh {server.model.serving_mesh.shape}", flush=True)
    print(f"[serve] serving {what} on {args.host}:{args.port}", flush=True)
    try:
        server.run(args.host, args.port)
    finally:
        if mesh is not None:
            mesh.stop()


if __name__ == "__main__":
    main()
