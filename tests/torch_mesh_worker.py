"""One rank of a gloo process group for the port's multi-rank CPU tests.

    python tests/torch_mesh_worker.py JOB RANK WORLD STORE OUT

JOB is a torch file the test wrote: {"suite": name, ...inputs}; the ranks
meet through the file store STORE; rank 0 writes its results to OUT (a
torch file). This module imports the port and torch only, never JAX: the
tests compute the JAX references in their own process and compare.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import Any, Dict

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bridgelang_tpu_torch.parallel.mesh import initialize_distributed, make_mesh  # noqa: E402


class StubTokenizer:
    """The tests' tiny Llama-like tokenizer (tests/helpers.StubTokenizer): BOS=1."""

    vocab_size = 512
    pad_token_id = 512

    def __call__(self, text):
        ids = [1] + [2 + (ord(c) % 200) for c in text[:20]]

        class R:
            input_ids = ids

        return R()


def build_vla(spec: Dict[str, Any], norm_stats, w8a8: bool = False, int4_shards: int = 1):
    """The port's tiny OpenVLA of a test: fp32, the towers and the decoder of `spec`."""
    from bridgelang_tpu_torch.models.llm.llama import LLMConfig
    from bridgelang_tpu_torch.models.vision.vit import ViTConfig
    from bridgelang_tpu_torch.models.vla import OpenVLA
    from bridgelang_tpu_torch.models.vlm import VLMConfig
    from bridgelang_tpu_torch.ops.image_ops import ImageTowerSpec, ImageTransformConfig

    llm = LLMConfig(**spec["llm"], w8a8=w8a8, int4_shards=int4_shards)
    towers = tuple(ViTConfig(**v) for v in spec["towers"])
    cfg = dataclasses.replace(VLMConfig(), llm=llm, vision_override=towers if len(towers) > 1 else towers[0],
                              attention_impl=spec.get("attention_impl"))
    model = OpenVLA(cfg, norm_stats, tokenizer=StubTokenizer(), dtype=torch.float32, device="cpu",
                    prompt_bucket=spec.get("prompt_bucket", 32))
    model.image_transform = ImageTransformConfig("resize-naive", tuple(
        ImageTowerSpec(*t) for t in spec["transform"]) if "transform" in spec else tuple(
        ImageTowerSpec(size=v["image_size"]) for v in spec["towers"]))
    return model


# --- suites --------------------------------------------------------------------------


def suite_serving(job, rank: int) -> Dict[str, Any]:
    """Each variant on each mesh: greedy actions and ids of a batch, a
    speculative tick, a parallel chunk (variants that ask for it)."""
    out: Dict[str, Any] = {}
    for mesh_spec in job["meshes"]:
        mesh = make_mesh(mesh_spec, "cpu")
        for v in job["variants"]:
            model = build_vla(job["model"], job["norm_stats"], w8a8=v.get("w8a8", False),
                              int4_shards=v.get("int4_shards", 1))
            if v.get("kv_cache_int8"):
                model.cache_dtype = torch.int8
            params = torch.load(v["params"], weights_only=True)
            local = model.use_mesh(mesh, params, int4_shards=v.get("int4_shards", 1))
            if rank != 0:
                model.mesh_predictor.follow(local)
                continue
            key = f"{mesh_spec}|{v['name']}"
            tp = model.cfg.llm.tp
            tp.launches = 0
            acts, ids = model.predict_action_batch(local, job["images"], job["instructions"], return_tokens=True)
            res = {"actions": acts, "ids": ids, "collectives": tp.launches}
            if v.get("speculative"):
                act, tok = model.predict_action_speculative(local, job["images"][0], job["instructions"][0],
                                                            draft_tokens=np.asarray(job["draft"], np.int32))
                res.update(spec_action=act, spec_ids=tok)
            if v.get("parallel"):
                res["chunk"] = model.predict_action_chunk(local, job["images"][0], job["instructions"][0],
                                                          horizon=job["horizon"])
            out[key] = res
            model.mesh_predictor.stop()
    return out


def suite_spmd(job, rank: int) -> Dict[str, Any]:
    """Shard-local kernels on a tensor=world mesh, against the whole
    products the test computes with the JAX package: int4 column- and
    row-parallel products and their input gradients (`matmul_int4`,
    `matmul_int4_a8`), flash attention split over heads and over the batch
    (forward and gradients); the batch rows and a dataset shard of this rank."""
    from bridgelang_tpu_torch.ops.flash_attention import flash_attention
    from bridgelang_tpu_torch.ops.int4_matmul import matmul_int4, matmul_int4_a8
    from bridgelang_tpu_torch.parallel.collectives import make_tensor_parallel
    from bridgelang_tpu_torch.parallel.sharding import shard_batch

    world = dist.get_world_size()
    mesh = make_mesh(f"tensor={world}", "cpu")
    tp = make_tensor_parallel(mesh, {})
    out: Dict[str, Any] = {}
    x = torch.as_tensor(job["x"])
    for name, fn in (("int4", matmul_int4), ("int4_a8", matmul_int4_a8)):
        # column-parallel: a shard-blocked pack, this rank's block of columns
        packed, scales = torch.as_tensor(job["col_packed"]), torch.as_tensor(job["col_scales"])
        w2, ns = packed.shape[1] // world, scales.shape[1] // world
        xc = x.clone().requires_grad_(True)
        y = fn(tp.copy(xc), packed[:, rank * w2:(rank + 1) * w2].contiguous(),
               scales[:, rank * ns:(rank + 1) * ns].contiguous())
        (y * torch.as_tensor(job["g_col"])[..., rank * ns:(rank + 1) * ns]).sum().backward()
        out[f"{name}/col"] = tp.gather(y.detach(), -1)
        out[f"{name}/col_dx"] = xc.grad
        # row-parallel: this rank's K rows with their scale groups, the partials summed
        packed, scales = torch.as_tensor(job["row_packed"]), torch.as_tensor(job["row_scales"])
        k, g = packed.shape[0] // world, scales.shape[0] // world
        xr = tp.block(x.clone()).contiguous().requires_grad_(True)
        y = fn(xr, packed[rank * k:(rank + 1) * k].contiguous(), scales[rank * g:(rank + 1) * g].contiguous(),
               row_tp=tp)
        (y * torch.as_tensor(job["g_row"])).sum().backward()
        out[f"{name}/row"] = y.detach()
        out[f"{name}/row_dx"] = tp.gather(xr.grad, -1)
    # flash attention over this rank's heads, and over this rank's batch rows
    q, kk, v = (torch.as_tensor(job[n]).requires_grad_(True) for n in ("q", "k", "v"))
    lengths = torch.as_tensor(job["lengths"])
    g = torch.as_tensor(job["g_attn"])
    hq, hk, b = q.shape[2] // world, kk.shape[2] // world, q.shape[0] // world
    for split, sl in (("heads", lambda t, h: t[:, :, rank * h:(rank + 1) * h]),
                      ("batch", lambda t, h: t[rank * b:(rank + 1) * b])):
        for t in (q, kk, v):
            t.grad = None
        o, _ = flash_attention(sl(q, hq), sl(kk, hk), sl(v, hk), lengths=lengths if split == "heads" else
                               lengths[rank * b:(rank + 1) * b], causal=True)
        (o * sl(g, hq)).sum().backward()
        dim = 2 if split == "heads" else 0
        out[f"flash/{split}"] = tp.gather(o.detach(), dim)
        for n, t in (("dq", q), ("dk", kk), ("dv", v)):
            out[f"flash/{split}/{n}"] = tp.gather(sl(t.grad, hq if n == "dq" else hk).contiguous(), dim)
    # the rows of a global batch this rank reads, gathered back
    dmesh = make_mesh(f"fsdp={world}", "cpu")
    rows = shard_batch(dmesh, {"ids": torch.as_tensor(job["batch_ids"])})["ids"]
    out["batch_rows"] = tp.gather(rows.contiguous(), 0)
    out["batch_rows_rank"] = rows
    # a dataset's trajectories: each rank reads every n-th (vla/datasets/rlds RldsReader)
    from bridgelang_tpu_torch.vla.datasets.rlds.dataset import RldsReader

    reader = RldsReader(lambda split, start=0: iter(range(start, 10)), "train", lambda t: t, {},
                        dist.get_world_size(), dist.get_rank())
    mine = torch.tensor(list(reader.trajectories()))
    out["trajectories"] = [t.tolist() for t in tp.gather(mine[None], 0)]
    return out


_MESHES: Dict[str, Any] = {}


def _gathered(x: torch.Tensor, group, size: int) -> list:
    """Every rank of `group`'s `x` (same shape), in group rank order."""
    out = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(out, x.contiguous(), group=group)
    return out


def _train_case(job, case, model):
    """One training case on its mesh: steps over this rank's rows, the
    metrics and the whole parameters after each step. A case may name a
    parameter file of its own (`params`), train the LoRA adapters only
    (`lora`), and ask for the embedding block of every rank (`embed_blocks`,
    in global rank order); on a mesh with tensor > 1 each rank's adapters
    are compared with its tensor peers' after the steps."""
    from bridgelang_tpu_torch.parallel.fsdp import MeshTraining, full_params
    from bridgelang_tpu_torch.parallel.mesh import mesh_sizes
    from bridgelang_tpu_torch.parallel.sharding import shard_batch
    from bridgelang_tpu_torch.training import trainer as T
    from bridgelang_tpu_torch.training.checkpointing import CheckpointManager
    from bridgelang_tpu_torch.training.lora import lora_trainable_mask

    if case["mesh"] not in _MESHES:  # a DeviceMesh per shape: its groups are made once
        _MESHES[case["mesh"]] = make_mesh(case["mesh"], "cpu")
    mesh = _MESHES[case["mesh"]]
    params = torch.load(case.get("params", job["params"]), weights_only=True)
    if case.get("lora"):
        mask = lora_trainable_mask(params)
    else:
        mask = model.trainable_mask(params, case["stage"]) if case.get("stage") else None
    opt = T.make_optimizer(T.OptimConfig(**case["optim"]), params, trainable_mask=mask,
                           grad_accum_steps=case.get("accum", 1))
    mt = MeshTraining.for_params(mesh, params, case.get("strategy", "full-shard"))
    ring_passes = []
    if case.get("attention_impl"):
        from bridgelang_tpu_torch.ops import ring_attention

        model = build_vla(dict(job["model"], attention_impl=case["attention_impl"]), job["norm_stats"])
        forward = ring_attention.ring_forward

        def counted(*a, **k):
            ring_passes.append(1)
            return forward(*a, **k)

        ring_attention.ring_forward = counted  # this process runs one case at a time
    step = T.make_vla_train_step(model, opt, trainable_mask=mask, compute_dtype=torch.float32,
                                 image_transform=model.image_transform, mesh=mt)
    state = T.init_train_state(mt.shard(params), opt, trainable_mask=mask, mesh=mt)
    if case.get("embed_blocks"):  # this rank's block of the embedding as sharded, every rank's
        out = {"embed_blocks": _gathered(state.params["llm"]["embed"].detach(), dist.group.WORLD,
                                         dist.get_world_size())}
    else:
        out = {}
    if case.get("restore"):
        state = CheckpointManager(case["restore"]).restore(CheckpointManager(case["restore"]).latest(), state, mesh=mt)
        out["restored"] = T.tree_map(lambda t: t.detach().clone(), full_params(mt, state.params))
    metrics = []
    for batch in case["batches"]:
        local = shard_batch(mesh, {k: torch.as_tensor(v) for k, v in batch.items() if k != "dataset_names"})
        state, m = step(state, local)
        metrics.append({k: float(v) for k, v in m.items() if v.dim() == 0})
        if case.get("save") and state.step == 1:  # the state after the first step
            CheckpointManager(case["save"]).save(state, step=state.step, epoch=0, loss=metrics[-1]["loss"], mesh=mt)
            out["saved"] = T.tree_map(lambda t: t.detach().clone(), full_params(mt, state.params))
    out.update(metrics=metrics, params=full_params(mt, state.params))
    if case.get("attention_impl"):
        ring_attention.ring_forward = forward
        out["ring_passes"] = len(ring_passes)
    tensor = mesh_sizes(mesh)["tensor"]
    adapters = [t.detach().reshape(-1) for lp in state.params["llm"]["layers"] for k, t in lp.items() if "_lora_" in k]
    if tensor > 1 and adapters:
        peers = _gathered(torch.cat(adapters), mesh.get_group("tensor"), tensor)
        out["adapters_equal_over_tensor"] = all(torch.equal(p, peers[0]) for p in peers)
    return out


def suite_train(job, rank: int) -> Dict[str, Any]:
    """Train steps on meshes (parallel/fsdp.MeshTraining) from the same whole
    parameters and global batches as the JAX reference."""
    model = build_vla(job["model"], job["norm_stats"])
    out = {}
    for case in job["cases"]:
        res = _train_case(job, case, model)
        if rank == 0:
            out[case["name"]] = res
    return out


class GlobalRows:
    """A dataset whose batches are the global batches of a one-rank run,
    each data rank taking its rows (`shard_batch`'s layout), so that a mesh
    run and a one-rank run train on the same global batches. The rows of
    the first batch are kept in `seen`."""

    def __init__(self, ds, rank: int, world: int, seen: list):
        self.ds, self.rank, self.world, self.seen = ds, rank, world, seen

    def __getattr__(self, name):
        return getattr(self.ds, name)

    def _rows(self, batch):
        k = len(batch["dataset_names"]) // self.world
        rows = {name: v[self.rank * k:(self.rank + 1) * k] for name, v in batch.items()}
        if not self.seen:
            self.seen.append(np.asarray(rows["input_ids"]).copy())
        return rows

    def __iter__(self):
        return self._wrap(iter(self.ds))

    def batches(self, state=None):
        return self._wrap(self.ds.batches(state))

    def _wrap(self, it):
        rows = self._rows

        class Rows:  # the stream's own methods (close, state) pass through
            def __iter__(self):
                return self

            def __next__(self):
                return rows(next(it))

            def __getattr__(self, name):
                return getattr(it, name)

        return Rows()


def _patch_entry_points(job, rank: int, world: int, asked: list) -> None:
    """The tiny configs under the real ids and the tiny transform (as the
    one-rank run in the test's process), and the RLDS data read as one rank
    reads it (no per-process sharding, the global batch) with each data
    rank keeping its rows: the data shard the entry point asks for says
    which (`asked` gets it, the per-rank batch size and the first rows)."""
    import functools

    from bridgelang_tpu_torch.models import vlm as tvlm
    from bridgelang_tpu_torch.models.llm import llama as tllama
    from bridgelang_tpu_torch.models.vision import vit as tvit
    from bridgelang_tpu_torch.ops.image_ops import ImageTowerSpec, ImageTransformConfig
    from bridgelang_tpu_torch.vla import materialize
    from bridgelang_tpu_torch.vla.datasets.rlds import dataset as rds

    tvit.VIT_CONFIGS["dinov2-vit-l"] = tvit.ViTConfig(**job["dino"])
    tvit.VIT_CONFIGS["siglip-vit-so400m"] = tvit.ViTConfig(**job["sig"])
    tllama.LLM_CONFIGS["llama2-7b-pure"] = tllama.LLMConfig(**job["llm"])
    tiny = ImageTransformConfig("resize-naive", tuple(ImageTowerSpec(*t) for t in job["transform"]))
    tvlm.transform_config_for_backbone = lambda *a: tiny
    rds.rlds_reader = functools.partial(rds.rlds_reader, shard_by_process=False)
    real = materialize.get_vla_dataset_and_collator

    def global_rows(*a, batch_size, shuffle_buffer_size, data_shard, **k):
        count, index = data_shard
        scale = count if job.get("scale_shuffle") else 1  # train.main divides the buffer by the data ranks
        ds, tok, coll = real(*a, batch_size=batch_size * count, shuffle_buffer_size=shuffle_buffer_size * scale, **k)
        seen = []
        asked.append({"data_shard": tuple(data_shard), "batch_size": batch_size, "rows": seen})
        return GlobalRows(ds, index, count, seen), tok, coll

    materialize.get_vla_dataset_and_collator = global_rows


def _losses():
    """Record every train step's loss (the trainer's step wrapped)."""
    from bridgelang_tpu_torch.training import trainer

    losses, make = [], trainer.make_vla_train_step

    def recording(*a, **k):
        step = make(*a, **k)

        def run(state, batch):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            return state, m

        return run

    trainer.make_vla_train_step = recording
    return losses


def suite_entry(job, rank: int) -> Dict[str, Any]:
    """finetune.main, train.main and pretrain.run on a mesh of every rank,
    fsdp and then tensor, each on the global batches of the one-rank run;
    what each rank's pipelines asked for and read, from every rank."""
    from bridgelang_tpu_torch import finetune, pretrain, train
    from bridgelang_tpu_torch.conf import DatasetConfig, ModelConfig, parse_cli

    world = dist.get_world_size()
    os.environ["HOME"] = job["home"]
    out: Dict[str, Any] = {}
    asked: list = []
    _patch_entry_points(job, rank, world, asked)
    losses = _losses()
    spec = job["pretrain"]
    model = dataclasses.replace(ModelConfig.get(spec["model"][0]), **spec["model"][1])
    data = dataclasses.replace(DatasetConfig.get(spec["dataset"][0]), **spec["dataset"][1])
    for axis in ("fsdp", "tensor"):
        mesh = f"{axis}={world}"
        key = "" if axis == "fsdp" else "|tensor"
        job["scale_shuffle"] = False
        fields = dict(job["finetune"], **{"--run_root_dir": job["finetune"]["--run_root_dir"] + key})
        run = finetune.main(parse_cli(finetune.FinetuneConfig, _argv(fields) + ["--mesh_shape", mesh]))
        out["finetune" + key], out["finetune_run" + key] = list(losses), str(run)
        losses.clear()
        job["scale_shuffle"] = True
        fields = dict(job["train"], **{"--run_root_dir": job["train"]["--run_root_dir"] + key})
        train.main(parse_cli(train.TrainConfig, _argv(fields) + ["--vla.mesh_shape", mesh]))
        out["train" + key] = list(losses)
        losses.clear()
        base = dict(spec["fields"], run_root_dir=spec["fields"]["run_root_dir"] + key)
        if axis == "tensor":  # one data rank: the per-device batch the one-rank run's tensor reference takes
            model = dataclasses.replace(model, **spec["tensor_model"])
        cfg = pretrain.PretrainConfig(model=model, dataset=data, **dict(base, mesh_shape=mesh))
        pretrain.run(cfg, pretrain.vlm_config(cfg.model))
        out["pretrain" + key] = list(losses)
        losses.clear()
    everyone = [None] * world
    dist.all_gather_object(everyone, asked)
    out["asked"] = everyone  # per rank: finetune fsdp, train fsdp, finetune tensor, train tensor
    return out


def _argv(fields: Dict[str, str]) -> list:
    return [x for kv in fields.items() for x in kv]


def suite_ring(job, rank: int) -> Dict[str, Any]:
    """Ring attention on a fsdp=world mesh, for each case of global q, k, v
    and an output cotangent g (in the case's `dtype`, float32 by default):
    `ring_attention` on this rank's block of time
    and `ring_attention_sharded` on this rank's rows, outputs and input
    gradients gathered back into whole tensors; the error of a length the
    ring does not divide; the decoder's "ring" on a mesh whose fsdp axis has
    one rank against its default attention; the rotations a ring pass makes."""
    from bridgelang_tpu_torch.models.llm import llama
    from bridgelang_tpu_torch.ops.ring_attention import ring_attention, ring_attention_sharded
    from bridgelang_tpu_torch.parallel.collectives import Ring, all_gather_dim, collective_launches

    world = dist.get_world_size()
    mesh = make_mesh(f"fsdp={world}", "cpu")
    ring = Ring.of(mesh, "fsdp")
    out: Dict[str, Any] = {}
    for case in job["cases"]:
        dtype = getattr(torch, case.get("dtype", "float32"))
        q, k, v, g = (torch.as_tensor(case[n]).to(dtype) for n in ("q", "k", "v", "g"))
        causal, res = case["causal"], {}
        for layout, dim in (("blocks", 1), ("rows", 0)):
            n = q.shape[dim] // world
            mine = [x.narrow(dim, rank * n, n).clone().requires_grad_(True) for x in (q, k, v)]
            before = collective_launches()
            if layout == "blocks":
                o = ring_attention(*mine, ring, causal)
            else:
                o = ring_attention_sharded(*mine, mesh, "fsdp", causal)
            res[f"{layout}/collectives"] = collective_launches() - before
            (o * g.narrow(dim, rank * n, n)).sum().backward()
            for name, t in zip(("o", "dq", "dk", "dv"), (o.detach(), *(x.grad for x in mine))):
                res[f"{layout}/{name}"] = all_gather_dim(t.contiguous(), dim, dist.group.WORLD, world)
        out[case["name"]] = res
    q = torch.as_tensor(job["cases"][0]["q"])
    try:
        ring_attention_sharded(q[:, :-1], q[:, :-1], q[:, :-1], mesh, "fsdp")
    except ValueError as e:
        out["indivisible"] = str(e)
    # the decoder's dispatch at fsdp = 1: replica = world
    flat = make_mesh(f"replica={world}", "cpu")
    cfg = llama.TensorParallelLLMConfig.of(llama.LLMConfig(**job["llm"]), None, mesh=flat)
    g = torch.Generator().manual_seed(5)
    params = llama.init_llm_params(g, cfg)
    x = torch.randn((2, 16, cfg.dim), generator=g)
    pos = torch.arange(16).expand(2, 16)
    mask = torch.ones((2, 1, 16, 16), dtype=torch.bool).tril()
    lengths = torch.tensor([16, 11], dtype=torch.int32)
    ring_h, _ = llama.llm_forward(params, cfg, x, pos, mask, lengths=lengths, attention="ring")
    flash_h, _ = llama.llm_forward(params, cfg, x, pos, mask, lengths=lengths)
    out["axis_of_one_is_flash"] = torch.equal(ring_h, flash_h)
    return out


def suite_grad_sync(job, rank: int) -> Dict[str, Any]:
    """The gradient sync's bucketed all-reduce (parallel/fsdp.
    _coalesced_all_reduce) against one flat all-reduce per dtype of the same
    tensors (several dtypes, views that are not contiguous), at bucket sizes
    whose bounds fall inside tensors: whether every element and stride is
    equal, and the all-reduces each made. With `steps` (a group of one
    rank): MeshTraining steps at fsdp=1 with buckets smaller than most
    leaves against the same steps without a mesh in this process, the
    losses and the parameters after."""
    from bridgelang_tpu_torch.parallel import fsdp
    from bridgelang_tpu_torch.parallel.collectives import all_reduce_, collective_launches

    g = torch.Generator().manual_seed(7 + rank)
    tensors = []
    for shape, dtype, transposed in job["tensors"]:
        t = torch.randn(shape, generator=g, dtype=torch.float64).to(getattr(torch, dtype))
        tensors.append(t.transpose(0, 1) if transposed else t)
    want: Dict[torch.dtype, torch.Tensor] = {}
    for dtype in dict.fromkeys(t.dtype for t in tensors):
        want[dtype] = all_reduce_(torch.cat([t.reshape(-1) for t in tensors if t.dtype == dtype]), dist.group.WORLD)
    out: Dict[str, Any] = {"buckets": {}}
    saved = fsdp.ALL_REDUCE_BUCKET_BYTES
    for bucket in job["bucket_bytes"]:
        got = [t.clone() for t in tensors]
        before = collective_launches()
        fsdp.ALL_REDUCE_BUCKET_BYTES = bucket
        try:
            fsdp._coalesced_all_reduce(got, dist.group.WORLD)
        finally:
            fsdp.ALL_REDUCE_BUCKET_BYTES = saved
        offsets, equal = dict.fromkeys(want, 0), True
        for t, t0 in zip(got, tensors):
            at, n = offsets[t.dtype], t.numel()
            equal = equal and t.stride() == t0.stride() and torch.equal(t.reshape(-1), want[t.dtype][at:at + n])
            offsets[t.dtype] = at + n
        out["buckets"][bucket] = dict(equal=equal, collectives=collective_launches() - before)
    if job.get("steps"):
        out.update(_one_rank_steps(job))
    return out


def _one_rank_steps(job) -> Dict[str, Any]:
    """MeshTraining at fsdp=1 (every collective on this one rank) with the
    sync's buckets at job["step_bucket_bytes"], and the same steps without a
    mesh: each one's losses and parameters after the steps."""
    from bridgelang_tpu_torch.parallel import fsdp
    from bridgelang_tpu_torch.training import trainer as T

    model = build_vla(job["model"], job["norm_stats"])
    runs = {}
    for name in ("mesh", "plain"):
        params = torch.load(job["params"], weights_only=True)
        opt = T.make_optimizer(T.OptimConfig(**job["optim"]), params)
        mt = fsdp.MeshTraining.for_params(make_mesh("fsdp=1", "cpu"), params) if name == "mesh" else None
        step = T.make_vla_train_step(model, opt, compute_dtype=torch.float32, image_transform=model.image_transform,
                                     mesh=mt)
        state = T.init_train_state(mt.shard(params) if mt else params, opt, mesh=mt)
        losses = []
        saved, fsdp.ALL_REDUCE_BUCKET_BYTES = fsdp.ALL_REDUCE_BUCKET_BYTES, job["step_bucket_bytes"]
        try:
            for batch in job["steps"]:
                state, m = step(state, {k: torch.as_tensor(v) for k, v in batch.items() if k != "dataset_names"})
                losses.append(float(m["loss"]))
        finally:
            fsdp.ALL_REDUCE_BUCKET_BYTES = saved
        runs[name] = (losses, T.tree_leaves(fsdp.full_params(mt, state.params)))
    (ml, mp), (pl, pp) = runs["mesh"], runs["plain"]
    return {"losses": {"mesh": ml, "plain": pl},
            "params_equal": len(mp) == len(pp) and all(torch.equal(a, b) for a, b in zip(mp, pp))}


SUITES = {"serving": suite_serving, "spmd": suite_spmd, "train": suite_train, "entry": suite_entry,
          "ring": suite_ring, "grad_sync": suite_grad_sync}


def run_group(job: Dict[str, Any], world: int, tmp, timeout: float = 600.0) -> Dict[str, Any]:
    """Start `world` ranks of this module on `job` (a gloo group meeting in
    a file store under `tmp`) and return rank 0's results. Each rank gets
    one CPU thread (the compute is small and the test workers share the
    cores); any rank's failure raises with its output."""
    return start_group(job, world, tmp, timeout)()


def start_group(job: Dict[str, Any], world: int, tmp, timeout: float = 600.0):
    """`run_group` without the wait: the ranks start, and the returned
    function waits for them and gives rank 0's results (the caller computes
    its references meanwhile)."""
    import subprocess
    from pathlib import Path

    tmp = Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    job_path, store, out = tmp / "job.pt", tmp / "store", tmp / "out.pt"
    torch.save(job, job_path)
    env = {k: v for k, v in os.environ.items() if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                                                            "MASTER_PORT", "DIST_INIT_METHOD")}
    env.update(OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    logs = [open(tmp / f"rank{r}.log", "w+") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(job_path), str(r), str(world), str(store),
                               str(out)], env=env, stdout=logs[r], stderr=subprocess.STDOUT) for r in range(world)]

    def finish() -> Dict[str, Any]:
        try:
            rcs = [p.wait(timeout=timeout) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        if any(rcs):
            text = []
            for r, f in enumerate(logs):
                f.seek(0)
                text.append(f"--- rank {r} (rc {rcs[r]}) ---\n" + f.read()[-4000:])
            raise RuntimeError("a rank failed:\n" + "\n".join(text))
        return torch.load(out, weights_only=False)

    return finish


def main() -> None:
    job_path, rank, world, store, out_path = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]
    job = torch.load(job_path, weights_only=False)
    if job.get("from_env"):  # torchrun's variables, as a launcher sets them
        os.environ.update(WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank), DIST_INIT_METHOD=f"file://{store}")
        initialize_distributed(device_type="cpu", timeout_s=120)
    else:
        initialize_distributed(f"file://{store}", world, rank, device_type="cpu", timeout_s=120)
    torch.manual_seed(0)
    torch.set_num_threads(1)
    out = SUITES[job["suite"]](job, rank)
    if rank == 0:
        torch.save(out, out_path)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
