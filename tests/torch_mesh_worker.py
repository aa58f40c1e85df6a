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
    cfg = dataclasses.replace(VLMConfig(), llm=llm, vision_override=towers if len(towers) > 1 else towers[0])
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


def _train_case(job, case, model):
    """One training case on its mesh: steps over this rank's rows, the
    metrics and the whole parameters after each step."""
    from bridgelang_tpu_torch.parallel.fsdp import MeshTraining, full_params
    from bridgelang_tpu_torch.parallel.sharding import shard_batch
    from bridgelang_tpu_torch.training import trainer as T
    from bridgelang_tpu_torch.training.checkpointing import CheckpointManager

    mesh = make_mesh(case["mesh"], "cpu")
    params = torch.load(job["params"], weights_only=True)
    mask = model.trainable_mask(params, case["stage"]) if case.get("stage") else None
    opt = T.make_optimizer(T.OptimConfig(**case["optim"]), params, trainable_mask=mask,
                           grad_accum_steps=case.get("accum", 1))
    mt = MeshTraining.for_params(mesh, params, case.get("strategy", "full-shard"))
    step = T.make_vla_train_step(model, opt, trainable_mask=mask, compute_dtype=torch.float32,
                                 image_transform=model.image_transform, mesh=mt)
    state = T.init_train_state(mt.shard(params), opt, trainable_mask=mask, mesh=mt)
    if case.get("restore"):
        state = CheckpointManager(case["restore"]).restore(CheckpointManager(case["restore"]).latest(), state, mesh=mt)
        out = {"restored": T.tree_map(lambda t: t.detach().clone(), full_params(mt, state.params))}
    else:
        out = {}
    metrics = []
    for batch in case["batches"]:
        local = shard_batch(mesh, {k: torch.as_tensor(v) for k, v in batch.items() if k != "dataset_names"})
        state, m = step(state, local)
        metrics.append({k: float(v) for k, v in m.items() if v.dim() == 0})
        if case.get("save") and state.step == 1:  # the state after the first step
            CheckpointManager(case["save"]).save(state, step=state.step, epoch=0, loss=metrics[-1]["loss"], mesh=mt)
            out["saved"] = T.tree_map(lambda t: t.detach().clone(), full_params(mt, state.params))
    out.update(metrics=metrics, params=full_params(mt, state.params))
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
    each rank taking its rows (`shard_batch`'s layout), so that a mesh run
    and a one-rank run train on the same global batches."""

    def __init__(self, ds, rank: int, world: int):
        self.ds, self.rank, self.world = ds, rank, world

    def __getattr__(self, name):
        return getattr(self.ds, name)

    def _rows(self, batch):
        k = len(batch["dataset_names"]) // self.world
        return {name: v[self.rank * k:(self.rank + 1) * k] for name, v in batch.items()}

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


def _patch_entry_points(job, rank: int, world: int) -> None:
    """The tiny configs under the real ids and the tiny transform (as the
    one-rank run in the test's process), and the RLDS data read as one rank
    reads it (no per-process sharding, the global batch) with each rank
    keeping its rows."""
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

    def global_rows(*a, batch_size, shuffle_buffer_size, **k):
        scale = world if job.get("scale_shuffle") else 1  # train.main divides the buffer by the world size
        ds, tok, coll = real(*a, batch_size=batch_size * world, shuffle_buffer_size=shuffle_buffer_size * scale, **k)
        return GlobalRows(ds, rank, world), tok, coll

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
    """finetune.main, train.main and pretrain.run on a mesh of every rank
    (fsdp), each on the global batches of the one-rank run."""
    from bridgelang_tpu_torch import finetune, pretrain, train
    from bridgelang_tpu_torch.conf import parse_cli

    world = dist.get_world_size()
    os.environ["HOME"] = job["home"]
    out: Dict[str, Any] = {}
    _patch_entry_points(job, rank, world)
    losses = _losses()
    run = finetune.main(parse_cli(finetune.FinetuneConfig, job["finetune"] + ["--mesh_shape", f"fsdp={world}"]))
    out["finetune"], out["finetune_run"] = list(losses), str(run)
    losses.clear()
    job["scale_shuffle"] = True
    train.main(parse_cli(train.TrainConfig, job["train"] + ["--vla.mesh_shape", f"fsdp={world}"]))
    out["train"] = list(losses)
    losses.clear()
    from bridgelang_tpu_torch.conf import DatasetConfig, ModelConfig

    spec = job["pretrain"]
    model = dataclasses.replace(ModelConfig.get(spec["model"][0]), **spec["model"][1])
    data = dataclasses.replace(DatasetConfig.get(spec["dataset"][0]), **spec["dataset"][1])
    cfg = pretrain.PretrainConfig(model=model, dataset=data, **dict(spec["fields"], mesh_shape=f"fsdp={world}"))
    pretrain.run(cfg, pretrain.vlm_config(cfg.model))
    out["pretrain"] = list(losses)
    return out


SUITES = {"serving": suite_serving, "spmd": suite_spmd, "train": suite_train, "entry": suite_entry}


def run_group(job: Dict[str, Any], world: int, tmp, timeout: float = 600.0) -> Dict[str, Any]:
    """Start `world` ranks of this module on `job` (a gloo group meeting in
    a file store under `tmp`) and return rank 0's results. Each rank gets
    one CPU thread (the compute is small and the test workers share the
    cores); any rank's failure raises with its output."""
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
