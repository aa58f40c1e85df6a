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
  saved ones, and the next step as JAX's next step (rtol 1e-5).

The entry points on a mesh: tests/test_torch_parallel_entry_points.py.
"""

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
from bridgelang_tpu.training import trainer as jtrainer
from bridgelang_tpu_torch.convert import params_from_jax
from bridgelang_tpu_torch.training import trainer as ttrainer
from bridgelang_tpu_torch.training.checkpointing import CheckpointManager
from tests.helpers import TINY_NORM_STATS
from tests.test_torch_training import LLM, _batches, _np
from tests.torch_mesh_worker import run_group

TOWER = dict(image_size=32, patch_size=8, width=32, depth=2, num_heads=4, mlp_dim=64, use_cls_token=False)
TRANSFORM = ((32, jimg.INCEPTION_MEAN, jimg.INCEPTION_STD),)
FULL = dict(learning_rate=1e-5, weight_decay=0.01, max_grad_norm=1.0)
NO_CLIP = dict(learning_rate=5e-5, max_grad_norm=1e9)
ALIGN = dict(learning_rate=5e-3, max_grad_norm=1.0)


def _jax_steps(jmodel, jparams, optim, batches, mask=None, accum=1):
    """JAX steps on its 8-device mesh -> (metrics per step, params after)."""
    mesh = jmake_mesh("replica=2,fsdp=4,tensor=1")
    opt = jtrainer.make_optimizer(jtrainer.OptimConfig(**optim), jparams, trainable_mask=mask, grad_accum_steps=accum)
    step = jax.jit(jtrainer.make_vla_train_step(jmodel, opt, trainable_mask=mask, compute_dtype=jnp.float32,
                                                image_transform=jmodel.image_transform))
    state = jtrainer.init_train_state(jax.device_put(jparams, param_shardings(mesh, jparams)), opt,
                                      trainable_mask=mask)
    metrics = []
    for b in batches:
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
    refs = {  # the JAX sharded step; the stage and accumulation cases against the port's unsharded step
        "full": _jax_steps(jmodel, jparams, FULL, [jb1, jb2]),
        "align": _port_steps(tmodel, params_file, ALIGN, [b1, b2], stage="align"),
        "accum": _port_steps(tmodel, params_file, NO_CLIP, [b1]),
    }
    ckpt = tmp / "ckpt"
    job = {"suite": "train", "model": _spec(), "norm_stats": TINY_NORM_STATS, "params": str(params_file)}
    four = [dict(name="full|replica=2,fsdp=2", mesh="replica=2,fsdp=2", optim=FULL, batches=[b1, b2],
                 save=str(ckpt)),  # saved after its first step
            dict(name="full|ddp", mesh="replica=4", optim=FULL, batches=[b1, b2]),
            dict(name="full|zero2", mesh="fsdp=4", strategy="shard-grad-op", optim=FULL, batches=[b1, b2])]
    two = [dict(name="full|fsdp=2", mesh="fsdp=2", optim=FULL, batches=[b1, b2]),
           dict(name="full|fsdp=2 again", mesh="fsdp=2", optim=FULL, batches=[b1, b2]),
           dict(name="align", mesh="fsdp=2", stage="align", optim=ALIGN, batches=[b1, b2]),
           dict(name="accum", mesh="fsdp=2", optim=NO_CLIP, accum=2, batches=halves),
           dict(name="restore", mesh="fsdp=2", optim=FULL, batches=[b2], restore=str(ckpt))]
    outs = run_group(dict(job, cases=four), 4, tmp / "w4")
    outs.update(run_group(dict(job, cases=two), 2, tmp / "w2"))
    return pair, refs, outs, (params_file, ckpt, b2)


@pytest.mark.parametrize("case", ["full|fsdp=2", "full|replica=2,fsdp=2", "full|ddp", "full|zero2"])
def test_sharded_train_steps_match_jax(trained, case):
    _, refs, outs, _ = trained
    want_metrics, want_params = refs["full"]
    got = outs[case]
    for g, w in zip(got["metrics"], want_metrics):
        for key in ("loss", "grad_norm", "l1_loss"):
            np.testing.assert_allclose(g[key], w[key], rtol=1e-5, err_msg=key)
        np.testing.assert_allclose(g["action_accuracy"], w["action_accuracy"], atol=1e-6)
    _assert_params_close(got["params"], want_params, atol=1e-5)


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
    (jmodel, jparams, tmodel), refs, outs, (params_file, ckpt, b2) = trained
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

