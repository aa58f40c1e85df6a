"""Training on a mesh (parallel/fsdp.py) vs the JAX package's sharded step, on the CPU.

A tiny VLA (one 2-block tower, the 2-layer GQA Llama of
tests/test_torch_training.py over the real vocabulary) is initialised by the
JAX package and converted; the JAX train step runs jitted on its 8-device mesh
(`param_shardings`, `batch_sharding`), the port's in gloo groups of 4 and 2
ranks spawned once each (tests/torch_mesh_worker.py, no JAX in the ranks),
every rank on its rows of the same global batches, fp32 compute.

* every float leaf trained (lr 1e-5, AdamW with decay): loss and fp64 grad
  norm per step at rtol 1e-5, every leaf after 2 steps at atol 1e-5, for
  fsdp=2, replica=2 x fsdp=2, ddp (replica=4) and ZeRO-2 (fsdp=4,
  shard-grad-op). The learning rate is small because Adam's first steps
  move an entry by ~lr whatever its gradient's size, so a gradient that
  rounds to another sign moves it by 2 lr;
* the align stage (projector only): the frozen leaves bit-equal to the
  start, the projector and the losses as the port's unsharded steps (which
  tests/test_torch_training.py holds to JAX), atol / rtol 1e-5;
* accumulation: 2 half batches with grad_accum_steps=2 equal one unsharded
  step on the whole batch (clip off; atol 2e-4, the JAX test's, over an
  update of at most lr = 5e-5 per entry);
* seed determinism: the same run twice gives the same losses, bit for bit;
* a checkpoint written by 4 ranks (replica=2 x fsdp=2) restores on 2 ranks
  (fsdp=2) and in one process without a mesh: the leaves bit-equal to the
  saved ones, and the next step as JAX's next step (rtol 1e-5);
* ring attention (`attention_impl="ring"`, over fsdp) at fsdp=2, fsdp=4 and
  fsdp=2 x tensor=2 against JAX's ring step on replica=2 x fsdp=4 (its
  shard_map under the ambient mesh), every float leaf trained, as above;
* tensor parallelism: tensor=2, fsdp=2 x tensor=2 (full-shard) and
  replica=2 x tensor=2 (shard-grad-op), each with every float leaf trained
  and with LoRA adapters (r=4) alone, against JAX's step on
  replica=1 x fsdp=4 x tensor=2, as above; the adapters bit-equal across
  tensor peers after the steps; the embedding rows each rank of
  fsdp=2 x tensor=2 holds equal to JAX's addressable shard of its device;
  the checkpoint fsdp=2 x tensor=2 wrote after its first step restores on
  tensor=2, on fsdp=2 and in one process without a mesh, bit-equal, with the
  next step as JAX's.

* the gradient sync's bucketed all-reduce (parallel/fsdp.py, a bounded
  staging buffer per dtype in place of one flat copy of every gradient) on
  2 ranks: every element equal to one flat all-reduce per dtype (fp32,
  bf16, fp64; transposed views), with bucket bounds inside tensors; and on
  one rank, fsdp=1 steps with buckets that split leaves bit-equal to the
  steps without a mesh (losses and parameters).

The entry points on a mesh: tests/test_torch_parallel_entry_points.py.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bridgelang_tpu.models.llm.llama import LLMConfig as JLLMConfig
from bridgelang_tpu.models.llm.tokenizer import ByteFallbackTokenizer as JTokenizer
from bridgelang_tpu.models.vision.vit import ViTConfig as JViTConfig
from bridgelang_tpu.models.vla import OpenVLA as JOpenVLA
from bridgelang_tpu.models.vlm import VLMConfig as JVLMConfig
from bridgelang_tpu.ops import image_ops as jimg
from bridgelang_tpu.parallel.mesh import make_mesh as jmake_mesh
from bridgelang_tpu.parallel.sharding import batch_sharding, param_shardings
from bridgelang_tpu.training import lora as jlora
from bridgelang_tpu.training import trainer as jtrainer
from bridgelang_tpu_torch.convert import params_from_jax
from bridgelang_tpu_torch.training import trainer as ttrainer
from bridgelang_tpu_torch.training.checkpointing import CheckpointManager
from tests.helpers import TINY_NORM_STATS
from tests.test_torch_training import LLM, _batches, _np, _numpy_adapters, _with_adapters
from tests.torch_mesh_worker import start_group

TOWER = dict(image_size=32, patch_size=8, width=32, depth=2, num_heads=4, mlp_dim=64, use_cls_token=False)
TRANSFORM = ((32, jimg.INCEPTION_MEAN, jimg.INCEPTION_STD),)
FULL = dict(learning_rate=1e-5, weight_decay=0.01, max_grad_norm=1.0)
NO_CLIP = dict(learning_rate=5e-5, max_grad_norm=1e9)
ALIGN = dict(learning_rate=5e-3, max_grad_norm=1.0)
TP_MESH = "replica=1,fsdp=4,tensor=2"  # the JAX package's tensor-parallel training mesh (its test_parallel_training)


def _jax_steps(jmodel, jparams, optim, batches, mask=None, accum=1, mesh_shape="replica=2,fsdp=4,tensor=1"):
    """JAX steps on its 8-device mesh (the ambient mesh, which its ring
    attention reads) -> (metrics per step, params after)."""
    mesh = jmake_mesh(mesh_shape)
    opt = jtrainer.make_optimizer(jtrainer.OptimConfig(**optim), jparams, trainable_mask=mask, grad_accum_steps=accum)
    step = jax.jit(jtrainer.make_vla_train_step(jmodel, opt, trainable_mask=mask, compute_dtype=jnp.float32,
                                                image_transform=jmodel.image_transform))
    state = jtrainer.init_train_state(jax.device_put(jparams, param_shardings(mesh, jparams)), opt,
                                      trainable_mask=mask)
    metrics = []
    for b in batches:
        with jax.sharding.set_mesh(mesh):
            state, m = step(state, jax.device_put({k: jnp.asarray(v) for k, v in b.items() if k != "dataset_names"},
                                                  batch_sharding(mesh)))
        metrics.append({k: float(v) for k, v in m.items() if np.ndim(v) == 0})
    return metrics, params_from_jax(_np(state.params))


def _port_steps(tmodel, params_file, optim, batches, stage=None, accum=1):
    """The port's steps in this process, without a mesh."""
    params = torch.load(params_file, weights_only=True)
    mask = tmodel.trainable_mask(params, stage) if stage else None
    opt = ttrainer.make_optimizer(ttrainer.OptimConfig(**optim), params, trainable_mask=mask, grad_accum_steps=accum)
    step = ttrainer.make_vla_train_step(tmodel, opt, trainable_mask=mask, compute_dtype=torch.float32,
                                        image_transform=tmodel.image_transform)
    state = ttrainer.init_train_state(params, opt, trainable_mask=mask)
    metrics = []
    for b in batches:
        state, m = step(state, {k: torch.as_tensor(v) for k, v in b.items() if k != "dataset_names"})
        metrics.append({k: float(v) for k, v in m.items() if v.dim() == 0})
    return metrics, state.params


def _leaves(tree):
    return ttrainer.tree_leaves(tree)


def _assert_params_close(got, want, atol):
    for g, w in zip(_leaves(got), _leaves(want)):
        np.testing.assert_allclose(g.detach().float().numpy(), w.detach().float().numpy(), atol=atol, rtol=0)


@pytest.fixture(scope="module")
def pair():
    """(JAX model, its params, the port's model) of the tiny VLA."""
    import dataclasses

    from tests.torch_mesh_worker import build_vla

    jcfg = dataclasses.replace(JVLMConfig(), llm=JLLMConfig(**LLM), vision_override=JViTConfig(**TOWER))
    jmodel = JOpenVLA(jcfg, TINY_NORM_STATS, tokenizer=JTokenizer(), dtype=jnp.float32)
    jmodel.image_transform = jimg.ImageTransformConfig("resize-naive", tuple(jimg.ImageTowerSpec(*t) for t in TRANSFORM))
    return jmodel, jmodel.init_params(jax.random.key(0)), build_vla(_spec(), TINY_NORM_STATS)


def _spec():
    return {"llm": LLM, "towers": [TOWER], "transform": [list(t) for t in TRANSFORM]}


@pytest.fixture(scope="module")
def trained(pair, tmp_path_factory):
    jmodel, jparams, tmodel = pair
    tmp = tmp_path_factory.mktemp("training")
    params_file = tmp / "params.pt"
    torch.save(params_from_jax(_np(jparams)), params_file)
    _, b1 = _batches(8, seed=31)
    _, b2 = _batches(8, seed=32)
    jb1, _ = _batches(8, seed=31)
    jb2, _ = _batches(8, seed=32)
    halves = [{k: (v[:4] if k != "dataset_names" else v[:4]) for k, v in b1.items()},
              {k: (v[4:] if k != "dataset_names" else v[4:]) for k, v in b1.items()}]
    lora_file = tmp / "lora.pt"
    jlora_params = dict(jparams, llm=_with_adapters(jparams["llm"], _numpy_adapters(jparams["llm"], 4, 41, 0.02)))
    torch.save(params_from_jax(_np(jlora_params)), lora_file)
    ckpt, ckpt_tp = tmp / "ckpt", tmp / "ckpt_tp"
    job = {"suite": "train", "model": _spec(), "norm_stats": TINY_NORM_STATS, "params": str(params_file)}
    lora = dict(lora=True, params=str(lora_file))
    four = [dict(name="full|replica=2,fsdp=2", mesh="replica=2,fsdp=2", optim=FULL, batches=[b1, b2],
                 save=str(ckpt)),  # saved after its first step
            dict(name="full|ddp", mesh="replica=4", optim=FULL, batches=[b1, b2]),
            dict(name="full|zero2", mesh="fsdp=4", strategy="shard-grad-op", optim=FULL, batches=[b1, b2]),
            dict(name="ring|fsdp=4", mesh="fsdp=4", attention_impl="ring", optim=FULL, batches=[b1, b2]),
            dict(name="ring|fsdp=2,tensor=2", mesh="fsdp=2,tensor=2", attention_impl="ring", optim=FULL,
                 batches=[b1, b2]),
            dict(name="full|fsdp=2,tensor=2", mesh="fsdp=2,tensor=2", optim=FULL, batches=[b1, b2], embed_blocks=True,
                 save=str(ckpt_tp)),
            dict(name="full|replica=2,tensor=2 zero2", mesh="replica=2,tensor=2", strategy="shard-grad-op",
                 optim=FULL, batches=[b1, b2]),
            dict(name="lora|fsdp=2,tensor=2", mesh="fsdp=2,tensor=2", optim=FULL, batches=[b1, b2], **lora),
            dict(name="lora|replica=2,tensor=2 zero2", mesh="replica=2,tensor=2", strategy="shard-grad-op",
                 optim=FULL, batches=[b1, b2], **lora)]
    two = [dict(name="full|fsdp=2", mesh="fsdp=2", optim=FULL, batches=[b1, b2]),
           dict(name="full|fsdp=2 again", mesh="fsdp=2", optim=FULL, batches=[b1, b2]),
           dict(name="align", mesh="fsdp=2", stage="align", optim=ALIGN, batches=[b1, b2]),
           dict(name="accum", mesh="fsdp=2", optim=NO_CLIP, accum=2, batches=halves),
           dict(name="ring|fsdp=2", mesh="fsdp=2", attention_impl="ring", optim=FULL, batches=[b1, b2]),
           dict(name="full|tensor=2", mesh="tensor=2", optim=FULL, batches=[b1, b2]),
           dict(name="lora|tensor=2", mesh="tensor=2", optim=FULL, batches=[b1, b2], **lora)]
    restores = [dict(name="restore", mesh="fsdp=2", optim=FULL, batches=[b2], restore=str(ckpt)),
                dict(name="restore tp|tensor=2", mesh="tensor=2", optim=FULL, batches=[b2], restore=str(ckpt_tp)),
                dict(name="restore tp|fsdp=2", mesh="fsdp=2", optim=FULL, batches=[b2], restore=str(ckpt_tp))]
    # Both groups run while the references are computed; then 2 ranks restore what the 4 ranks saved.
    finish4 = start_group(dict(job, cases=four), 4, tmp / "w4")
    finish2 = start_group(dict(job, cases=two), 2, tmp / "w2")
    ring_model = copy.copy(jmodel)
    ring_model.attention_impl = "ring"
    refs = {  # the JAX sharded step
        "full": _jax_steps(jmodel, jparams, FULL, [jb1, jb2]),
        "ring": _jax_steps(ring_model, jparams, FULL, [jb1, jb2]),
        "full_tp": _jax_steps(jmodel, jparams, FULL, [jb1, jb2], mesh_shape=TP_MESH),
        "lora_tp": _jax_steps(jmodel, jlora_params, FULL, [jb1, jb2], mask=jlora.lora_trainable_mask(jlora_params),
                              mesh_shape=TP_MESH),
    }
    # the stage and accumulation cases against the port's unsharded step
    refs.update(align=_port_steps(tmodel, params_file, ALIGN, [b1, b2], stage="align"),
                accum=_port_steps(tmodel, params_file, NO_CLIP, [b1]))
    outs = finish4()
    finish_restores = start_group(dict(job, cases=restores), 2, tmp / "w2r")
    outs.update(finish2())
    outs.update(finish_restores())
    return pair, refs, outs, (params_file, ckpt, ckpt_tp, b2)


def _assert_steps_match(got, ref):
    want_metrics, want_params = ref
    assert len(got["metrics"]) == len(want_metrics)
    for g, w in zip(got["metrics"], want_metrics):
        for key in ("loss", "grad_norm", "l1_loss"):
            np.testing.assert_allclose(g[key], w[key], rtol=1e-5, err_msg=key)
        np.testing.assert_allclose(g["action_accuracy"], w["action_accuracy"], atol=1e-6)
    _assert_params_close(got["params"], want_params, atol=1e-5)


@pytest.mark.parametrize("case", ["full|fsdp=2", "full|replica=2,fsdp=2", "full|ddp", "full|zero2"])
def test_sharded_train_steps_match_jax(trained, case):
    _, refs, outs, _ = trained
    _assert_steps_match(outs[case], refs["full"])


@pytest.mark.parametrize("case", ["ring|fsdp=2", "ring|fsdp=4", "ring|fsdp=2,tensor=2"])
def test_ring_attention_train_steps_match_jax(trained, case):
    _, refs, outs, _ = trained
    _assert_steps_match(outs[case], refs["ring"])
    assert outs[case]["ring_passes"] > 0


@pytest.mark.parametrize("case", ["full|tensor=2", "full|fsdp=2,tensor=2", "full|replica=2,tensor=2 zero2",
                                  "lora|tensor=2", "lora|fsdp=2,tensor=2", "lora|replica=2,tensor=2 zero2"])
def test_tensor_parallel_train_steps_match_jax(trained, case):
    _, refs, outs, _ = trained
    got = outs[case]
    _assert_steps_match(got, refs["lora_tp" if case.startswith("lora") else "full_tp"])
    if case.startswith("lora"):
        assert got["adapters_equal_over_tensor"] is True


def test_embedding_blocks_are_jax_addressable_shards(trained):
    """fsdp=2 x tensor=2: the embedding's rows split over ("fsdp", "tensor"),
    fsdp major. Each rank's block equals the shard JAX places on the device
    at the same mesh position."""
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as JP

    (_, jparams, _), _, outs, _ = trained
    devices = np.array(jax.devices()[:4]).reshape(1, 2, 2)
    mesh = Mesh(devices, ("replica", "fsdp", "tensor"))
    arr = jax.device_put(jparams["llm"]["embed"], NamedSharding(mesh, JP(("fsdp", "tensor"), None)))
    shards = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
    blocks = outs["full|fsdp=2,tensor=2"]["embed_blocks"]  # before the steps, in global rank order
    for rank, device in enumerate(devices.reshape(-1)):  # ranks are row-major over the mesh, as the devices
        assert blocks[rank].shape[0] == jparams["llm"]["embed"].shape[0] // 4
        np.testing.assert_array_equal(blocks[rank].numpy(), shards[device])


def test_frozen_leaves_stay_fixed_on_a_mesh(trained):
    (jmodel, jparams, tmodel), refs, outs, _ = trained
    start = params_from_jax(_np(jparams))
    got = outs["align"]["params"]
    for name in ("vision", "llm"):
        for g, s in zip(_leaves(got[name]), _leaves(start[name])):
            assert torch.equal(g, s)
    _assert_params_close(got["projector"], refs["align"][1]["projector"], atol=1e-5)
    for g, w in zip(outs["align"]["metrics"], refs["align"][0]):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5)


def test_accumulation_equals_the_large_batch_on_a_mesh(trained):
    _, refs, outs, _ = trained
    got = outs["accum"]
    assert len(got["metrics"]) == 2
    _assert_params_close(got["params"], refs["accum"][1], atol=2e-4)


def test_training_on_a_mesh_is_seed_deterministic(trained):
    _, _, outs, _ = trained
    assert outs["full|fsdp=2"]["metrics"] == outs["full|fsdp=2 again"]["metrics"]
    for a, b in zip(_leaves(outs["full|fsdp=2"]["params"]), _leaves(outs["full|fsdp=2 again"]["params"])):
        assert torch.equal(a, b)


def test_checkpoint_restores_at_another_world_size(trained):
    """Saved by replica=2 x fsdp=2 after step 1, restored on fsdp=2 and in
    one process without a mesh; both take step 2 as JAX does."""
    (jmodel, jparams, tmodel), refs, outs, (params_file, ckpt, _, b2) = trained
    saved = outs["full|replica=2,fsdp=2"]["saved"]  # the whole leaves when the 4 ranks saved
    for a, b in zip(_leaves(outs["restore"]["restored"]), _leaves(saved)):
        assert torch.equal(a, b)
    want_metrics, want_params = refs["full"]
    np.testing.assert_allclose(outs["restore"]["metrics"][0]["loss"], want_metrics[1]["loss"], rtol=1e-5)
    _assert_params_close(outs["restore"]["params"], want_params, atol=1e-5)

    # one process, no mesh: the sharded checkpoint into whole tensors
    params = torch.load(params_file, weights_only=True)
    opt = ttrainer.make_optimizer(ttrainer.OptimConfig(**FULL), params)
    step = ttrainer.make_vla_train_step(tmodel, opt, compute_dtype=torch.float32, image_transform=tmodel.image_transform)
    state = ttrainer.init_train_state(params, opt)
    mgr = CheckpointManager(ckpt)
    state = mgr.restore(mgr.latest(), state)
    assert state.step == 1 and state.opt_state["count"] == 1
    for a, b in zip(_leaves(state.params), _leaves(saved)):
        assert torch.equal(a.detach(), b)
    state, m = step(state, {k: torch.as_tensor(v) for k, v in b2.items() if k != "dataset_names"})
    np.testing.assert_allclose(float(m["loss"]), want_metrics[1]["loss"], rtol=1e-5)
    _assert_params_close(state.params, want_params, atol=1e-5)
    assert not torch.distributed.is_initialized()



def test_two_axis_checkpoint_restores_at_other_mesh_shapes(trained):
    """Saved by fsdp=2 x tensor=2 after step 1, restored on tensor=2, on
    fsdp=2 and in one process without a mesh: the leaves bit-equal to the
    saved ones, and step 2 as JAX's on its tensor-parallel mesh.
    inspect_checkpoint reads the two-axis run."""
    from bridgelang_tpu_torch import inspect_checkpoint

    (jmodel, jparams, tmodel), refs, outs, (params_file, _, ckpt_tp, b2) = trained
    saved = outs["full|fsdp=2,tensor=2"]["saved"]
    want_metrics, want_params = refs["full_tp"]
    for case in ("restore tp|tensor=2", "restore tp|fsdp=2"):
        for a, b in zip(_leaves(outs[case]["restored"]), _leaves(saved)):
            assert torch.equal(a, b), case
        np.testing.assert_allclose(outs[case]["metrics"][0]["loss"], want_metrics[1]["loss"], rtol=1e-5)
        _assert_params_close(outs[case]["params"], want_params, atol=1e-5)

    params = torch.load(params_file, weights_only=True)
    opt = ttrainer.make_optimizer(ttrainer.OptimConfig(**FULL), params)
    step = ttrainer.make_vla_train_step(tmodel, opt, compute_dtype=torch.float32,
                                        image_transform=tmodel.image_transform)
    state = ttrainer.init_train_state(params, opt)
    mgr = CheckpointManager(ckpt_tp)
    state = mgr.restore(mgr.latest(), state)
    assert state.step == 1 and state.opt_state["count"] == 1
    for a, b in zip(_leaves(state.params), _leaves(saved)):
        assert torch.equal(a.detach(), b)
    state, m = step(state, {k: torch.as_tensor(v) for k, v in b2.items() if k != "dataset_names"})
    np.testing.assert_allclose(float(m["loss"]), want_metrics[1]["loss"], rtol=1e-5)
    _assert_params_close(state.params, want_params, atol=1e-5)
    summary = inspect_checkpoint.main(inspect_checkpoint.InspectConfig(path=str(ckpt_tp), device="cpu"))
    assert summary["tensors"] > 0 and "params" in summary["by_prefix"] and "opt_state" in summary["by_prefix"]
    assert not torch.distributed.is_initialized()


# (shape, dtype, transposed): 2 x 163 fp32 elements split by every bucket below
GRAD_SYNC_TENSORS = [((3, 5), "float32", False), ((7, 11), "float32", True), ((0,), "float32", False),
                     ((4, 9), "bfloat16", False), ((5, 6), "bfloat16", True), ((13,), "float64", False),
                     ((6, 9), "float32", False)]
GRAD_SYNC_BUCKETS = [4, 28, 64, 1 << 20]  # bytes: one element of fp32 ... everything in one bucket


def test_bucketed_gradient_sync_equals_the_flat_all_reduce(tmp_path):
    job = {"suite": "grad_sync", "tensors": GRAD_SYNC_TENSORS, "bucket_bytes": GRAD_SYNC_BUCKETS}
    out = start_group(job, 2, tmp_path)()
    for bucket, r in out["buckets"].items():
        assert r["equal"], f"bucket of {bucket} bytes"
    counts = {b: out["buckets"][b]["collectives"] for b in GRAD_SYNC_BUCKETS}
    # one bucket per dtype, and fp32's transposed view closes its bucket early: 2 + 1 + 1
    assert counts[1 << 20] == 4 and counts[4] > counts[28] > counts[64] > counts[1 << 20]


def test_one_rank_mesh_steps_with_split_buckets_are_bit_equal(pair, tmp_path):
    """fsdp=1 with 1 KiB buckets (most of the tiny VLA's leaves span several)
    against the steps without a mesh, in one gloo process: losses and
    parameters bit for bit."""
    _, jparams, _ = pair
    params_file = tmp_path / "params.pt"
    torch.save(params_from_jax(_np(jparams)), params_file)
    _, b1 = _batches(8, seed=31)
    _, b2 = _batches(8, seed=32)
    job = {"suite": "grad_sync", "tensors": [], "bucket_bytes": [], "model": _spec(), "norm_stats": TINY_NORM_STATS,
           "params": str(params_file), "optim": FULL, "steps": [b1, b2], "step_bucket_bytes": 1024}
    out = start_group(job, 1, tmp_path / "w1")()
    assert out["losses"]["mesh"] == out["losses"]["plain"]
    assert out["params_equal"]
