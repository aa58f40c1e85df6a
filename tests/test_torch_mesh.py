"""The port's mesh, sharding rules and shard-local kernels vs the JAX package.

CPU only. The pure functions (mesh parsing, the multi-node plan, the
strategies, the rules over a 7B-shaped tree, `int4_row_shardable`, the card
int4 audit) are compared with the JAX package's in this process. The
collective paths run in a gloo group of 2 ranks spawned once for the file
(tests/torch_mesh_worker.py, which imports no JAX; the ranks bootstrap from
torchrun's variables through `initialize_distributed`), against the JAX
package's products on its 8-device mesh:

* int4 column-parallel (a shard-blocked pack, one block per rank) and
  row-parallel (K rows per rank, partials summed) products, `matmul_int4`
  and `matmul_int4_a8`, and their input gradients: rtol 1e-5 and atol 1e-5
  of the largest value (fp32 sums in another order: the row partials meet in
  an all-reduce, the column gradients too);
* flash attention split over heads (GQA groups kept) and over batch rows,
  forward and gradients against the JAX kernel in interpret mode: atol 1e-5;
* the rows of a global batch each rank takes, and a dataset's per-rank
  trajectories: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

from bridgelang_tpu.models.llm.llama import LLM_CONFIGS as JLLM_CONFIGS
from bridgelang_tpu.models.vlm import PrismaticVLM as JVLM
from bridgelang_tpu.models.vlm import VLMConfig as JVLMConfig
from bridgelang_tpu.ops import int4_matmul as jint4
from bridgelang_tpu.ops import quant as jq
from bridgelang_tpu.ops.flash_attention import flash_attention as jflash
from bridgelang_tpu.parallel import mesh as jmesh
from bridgelang_tpu.parallel import sharding as jsh
from bridgelang_tpu_torch.models.llm.llama import LLM_CONFIGS
from bridgelang_tpu_torch.models.vlm import PrismaticVLM, VLMConfig
from bridgelang_tpu_torch.ops import int4_matmul as tint4
from bridgelang_tpu_torch.parallel import mesh as tmesh
from bridgelang_tpu_torch.parallel import sharding as tsh
from bridgelang_tpu_torch.training.lora import merge_lora
from tests.torch_mesh_worker import run_group

WORLD = 2


def test_parse_mesh_shape_matches_jax():
    for spec, n in ((None, 8), ("replica=2,fsdp=4", 8), ("replica=2,fsdp=-1,tensor=2", 8), ("tensor=2", 2),
                    ("fsdp=1", 1), ("replica=1,fsdp=1,tensor=4", 4)):
        assert tmesh.parse_mesh_shape(spec, n) == jmesh.parse_mesh_shape(spec, n)
    for bad, n, err in (("replica=3", 8, AssertionError), ("1,1", 1, ValueError), ("fsdp=-1,tensor=-1", 4,
                                                                                      AssertionError)):
        with pytest.raises(err):
            jmesh.parse_mesh_shape(bad, n)
        with pytest.raises(err):
            tmesh.parse_mesh_shape(bad, n)


def test_hybrid_plan_and_strategies_match_jax():
    for shape, slices in (((2, 4, 1), 2), ((4, 2, 2), 2), ((3, 2, 1), 2), ((2, 4, 1), 1)):
        assert tmesh.hybrid_mesh_plan(shape, slices) == jmesh.hybrid_mesh_plan(shape, slices)
    for strategy in ("fsdp-full-shard", "fsdp-shard-grad-op", "ddp"):
        for n, per in ((8, None), (64, 8), (4, 2)):
            assert tmesh.strategy_mesh_spec(strategy, n, per) == jmesh.strategy_mesh_spec(strategy, n, per)
    with pytest.raises(ValueError):
        tmesh.strategy_mesh_spec("zero9", 8)


def _jax_tree_7b():
    """The JAX 7B VLA's parameter shapes (no memory) and its PARAM_RULES specs by path."""
    shapes = jax.eval_shape(JVLM(JVLMConfig(), dtype=jnp.bfloat16).init_params, jax.random.key(0))
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    return {jsh.path_str(p): tuple(leaf.shape) for p, leaf in flat}


def _port_tree_7b():
    """The port's 7B VLA tree on the meta device: the towers' and the
    projector's parameters as their modules name them, the decoder's leaves
    with the shapes `load_vla` checks."""
    from bridgelang_tpu_torch.models.load import _expected_llm_shapes

    model = PrismaticVLM(VLMConfig(), device="cpu")  # the default: DINOv2 + SigLIP, Llama-2 7B
    meta = lambda shape: torch.empty(shape, device="meta")  # noqa: E731
    shapes = _expected_llm_shapes(model.cfg.llm)
    layer_keys = ("wq", "wk", "wv", "wo", "attn_norm", "w_gate", "w_up", "w_down", "mlp_norm")
    llm = {k: meta(shapes[k]) for k in ("embed", "final_norm", "lm_head")}
    llm["layers"] = [{k: meta(shapes[k]) for k in layer_keys} for _ in range(model.cfg.llm.n_layers)]
    return {"vision": {n: meta(p.shape) for n, p in model.vision_module.named_parameters()},
            "projector": {n: meta(p.shape) for n, p in model.projector.named_parameters()},
            "llm": llm}


def test_rules_cover_every_leaf_of_a_7b_tree_as_jax():
    """Every leaf of the port's 7B tree names a JAX leaf whose shape, with the
    stacked layer axis dropped and the port's transposes applied, is the
    port leaf's; its port spec is JAX's `spec_for_path` spec carried the same
    way, under PARAM_RULES and SERVING_RULES; and every JAX leaf is reached."""
    jtree = _jax_tree_7b()
    reached = set()
    params = _port_tree_7b()
    n = 0
    for path, leaf, parent in tsh._walk(params):
        jpath, stacked, perm = tsh.jax_path_of(path, leaf, parent)
        assert jpath in jtree, (path, jpath)
        jshape = jtree[jpath][1:] if stacked else jtree[jpath]
        assert tuple(jshape[j] for j in perm) == tuple(leaf.shape), (path, jpath, jshape, perm)
        for rules in (jsh.PARAM_RULES, jsh.SERVING_RULES):
            jspec = list(jsh.spec_for_path(jpath, len(jtree[jpath]), rules))
            jspec = jspec[1:] if stacked else jspec
            port_rules = tsh.PARAM_RULES if rules is jsh.PARAM_RULES else tsh.SERVING_RULES
            assert tuple(tsh.port_spec(path, leaf, port_rules, parent)) == tuple(jspec[j] for j in perm), path
        reached.add(jpath)
        n += 1
    assert reached == set(jtree) and n == 939  # 32 x 9 decoder leaves, 3 more, 648 tower and projector leaves
    # the rules are the JAX package's, entry for entry
    for mine, theirs in ((tsh.PARAM_RULES, jsh.PARAM_RULES), (tsh.SERVING_RULES, jsh.SERVING_RULES)):
        assert [(p, tuple(s)) for p, s in mine] == [(p, tuple(s)) for p, s in theirs]
    assert (tsh.LORA_RULE[0], tuple(tsh.LORA_RULE[1])) == (jsh.LORA_RULE[0], tuple(jsh.LORA_RULE[1]))
    for path, nd in (("llm/layers/wq", 3), ("llm/embed", 2), ("whatever/strange", 2), ("vision/x/patch_embed/kernel", 4)):
        assert tuple(tsh.spec_for_path(path, nd)) == tuple(jsh.spec_for_path(path, nd))


def test_int4_row_shardable_grid_matches_jax():
    for k in (128, 256, 512, 4096, 5504, 11008, 13824):
        for groups in (1, 2, 4, 8, 16, 32, 43, 86, 108):
            for d in (1, 2, 3, 4, 5, 8):
                assert tint4.int4_row_shardable(k, groups, d) == jint4.int4_row_shardable(k, groups, d)


def test_card_rule_int4_audit_and_where_it_differs_from_jax():
    """The port audits shard-local int4 shapes with the card's kernel rule
    (N/2 % 64, group % 128), the JAX package with the TPU's (N % 256)."""
    cases = {("llama2-7b-pure", 2): [], ("llama2-7b-pure", 4): ["w_gate", "w_up"],
             ("llama2-13b-pure", 2): [], ("llama2-13b-pure", 4): [],
             ("phi-2-3b", 2): [], ("phi-2-3b", 4): []}
    jax_cases = {("llama2-7b-pure", 2): ["w_gate", "w_up"], ("llama2-13b-pure", 2): [],
                 ("llama2-13b-pure", 4): ["w_gate", "w_up"]}
    for (name, t), want in cases.items():
        assert sorted(tint4.int4_tp_fallback_matmuls(LLM_CONFIGS[name], 128, t)) == want, (name, t)
    for (name, t), want in jax_cases.items():
        assert sorted(jint4.int4_tp_fallback_matmuls(JLLM_CONFIGS[name], 128, t)) == want
    # 7B at tensor=4: w_down's 86 groups do not split in 4, so it is replicated (and passes whole)
    assert not tint4.int4_row_shardable(11008, 86, 4) and tint4.int4_row_shardable(4096, 32, 4)


def test_merge_lora_into_shard_blocked_base_matches_jax():
    rng = np.random.default_rng(5)
    w = rng.normal(size=(256, 512)).astype(np.float32)
    a = (rng.normal(size=(256, 4)) * 0.05).astype(np.float32)
    b = (rng.normal(size=(4, 512)) * 0.05).astype(np.float32)
    q_b, s_b = jq._quantize4_2d(jnp.asarray(w), group=128, n_shards=2)
    from bridgelang_tpu.training.lora import merge_lora as jmerge

    jm = jmerge({"layers": {"wq": q_b[None], "wq_scale4": s_b[None], "wq_lora_a": jnp.asarray(a)[None],
                            "wq_lora_b": jnp.asarray(b)[None]}}, int4_shards=2)
    tm = merge_lora({"layers": [{"wq": torch.from_numpy(np.array(q_b)),
                                 "wq_scale4": torch.from_numpy(np.asarray(s_b, np.float32)).to(torch.bfloat16),
                                 "wq_lora_a": torch.from_numpy(a.T.copy()), "wq_lora_b": torch.from_numpy(b.T.copy())}]},
                    int4_shards=2)
    np.testing.assert_array_equal(tm["layers"][0]["wq"].numpy(), np.asarray(jm["layers"]["wq"][0]))
    np.testing.assert_array_equal(tm["layers"][0]["wq_scale4"].float().numpy(),
                                  np.asarray(jm["layers"]["wq_scale4"][0], np.float32))


# --- the spawned group ----------------------------------------------------------------


K, N_COL, N_ROW = 512, 512, 256


@pytest.fixture(scope="module")
def spmd(tmp_path_factory):
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 4, K)).astype(np.float32)
    wc = rng.normal(size=(K, N_COL)).astype(np.float32)
    wr = rng.normal(size=(K, N_ROW)).astype(np.float32)
    col_p, col_s = jq._quantize4_2d(jnp.asarray(wc), group=128, n_shards=WORLD)
    row_p, row_s = jq._quantize4_2d(jnp.asarray(wr), group=128)
    b, t, h, hkv, d = 2, 16, 4, 2, 16
    q, k, v = (rng.normal(size=(b, t, n, d)).astype(np.float32) for n in (h, hkv, hkv))
    job = {
        "suite": "spmd", "from_env": True, "x": x,
        "col_packed": np.asarray(col_p), "col_scales": np.asarray(col_s, np.float32),
        "row_packed": np.asarray(row_p), "row_scales": np.asarray(row_s, np.float32),
        "g_col": rng.normal(size=(2, 4, N_COL)).astype(np.float32),
        "g_row": rng.normal(size=(2, 4, N_ROW)).astype(np.float32),
        "q": q, "k": k, "v": v, "lengths": np.array([16, 11], np.int32),
        "g_attn": rng.normal(size=(b, t, h, d)).astype(np.float32),
        "batch_ids": np.arange(8 * 3).reshape(8, 3),
    }
    # bf16 scales cross as fp32 numbers (exact) and go back to bf16 in the worker
    job_t = dict(job)
    for key in ("col_scales", "row_scales"):
        job_t[key] = torch.from_numpy(job[key]).to(torch.bfloat16)
    out = run_group(job_t, WORLD, tmp_path_factory.mktemp("spmd"))
    return job, (col_p, col_s, row_p, row_s), out


def _close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * max(1.0, float(np.abs(want).max())))


def test_int4_column_and_row_parallel_products_and_grads_match_jax(spmd):
    job, (col_p, col_s, row_p, row_s), out = spmd
    mesh = jmesh.make_mesh(f"replica={8 // WORLD},fsdp=1,tensor={WORLD}")
    x = jnp.asarray(job["x"])
    for name, fn in (("int4", jint4.matmul_int4), ("int4_a8", jint4.matmul_int4_a8)):
        for kind, p, s, g, shards, row in (("col", col_p, col_s, job["g_col"], WORLD, False),
                                           ("row", row_p, row_s, job["g_row"], WORLD, True)):
            xs = jax.device_put(x, NamedSharding(mesh, JP(None, None, "tensor" if row else None)))
            ps = jax.device_put(p, NamedSharding(mesh, JP("tensor", None) if row else JP(None, "tensor")))
            ss = jax.device_put(s, NamedSharding(mesh, JP("tensor", None) if row else JP(None, "tensor")))

            def loss(a, _fn=fn, _p=ps, _s=ss, _sh=shards, _row=row, _g=g):
                return (_fn(a, _p, _s, _sh, _row) * _g).sum()

            y = jax.jit(lambda a, _fn=fn, _p=ps, _s=ss, _sh=shards, _row=row: _fn(a, _p, _s, _sh, _row))(xs)
            dx = jax.jit(jax.grad(loss))(xs)
            _close(out[f"{name}/{kind}"].numpy(), y)
            _close(out[f"{name}/{kind}_dx"].numpy(), dx)


def test_flash_attention_split_over_heads_and_batch_matches_jax(spmd):
    job, _, out = spmd
    q, k, v = (jnp.asarray(job[n]) for n in ("q", "k", "v"))
    lengths = jnp.asarray(job["lengths"])
    g = jnp.asarray(job["g_attn"])

    def f(q, k, v):
        return jflash(q, k, v, lengths=lengths, causal=True)

    o, vjp = jax.vjp(f, q, k, v)
    dq, dk, dv = vjp(g)
    for split in ("heads", "batch"):
        np.testing.assert_allclose(out[f"flash/{split}"].numpy(), np.asarray(o), atol=1e-5)
        for n, want in (("dq", dq), ("dk", dk), ("dv", dv)):
            np.testing.assert_allclose(out[f"flash/{split}/{n}"].numpy(), np.asarray(want), atol=1e-5)


def test_ranks_bootstrap_from_env_and_read_their_rows(spmd):
    """The ranks joined through torchrun's variables (`initialize_distributed`
    with no arguments); each took its rows of the global batch (rank-major,
    the JAX batch sharding over the data axes) and every n-th trajectory."""
    job, _, out = spmd
    np.testing.assert_array_equal(out["batch_rows"].numpy(), job["batch_ids"])
    np.testing.assert_array_equal(out["batch_rows_rank"].numpy(), job["batch_ids"][:4])
    assert out["trajectories"] == [list(range(r, 10, WORLD)) for r in range(WORLD)]
