"""Ring attention (ops/ring_attention.py) vs the JAX package's, on the CPU.

The port's ring runs in gloo groups of 2 and 4 ranks spawned once each
(tests/torch_mesh_worker.py, no JAX in the ranks), against JAX
`ring_attention_sharded` on a Mesh of as many of its virtual devices, with
gradients through `jax.grad` of the shard_map: causal, non-causal and GQA
(8 query heads over 2 KV heads), each rank holding its block of time
(`ring_attention`) and, through the all-to-all of the decoder's layout, its
rows of whole sequences (`ring_attention_sharded`). o, dq, dk and dv at
atol 2e-5, the JAX test's tolerance (tests/test_ring_attention.py): both
sides are fp32, summed in another order. A length the ring does not divide
raises, as in the JAX package.

In bf16 (causal and GQA, head dim 64, on 2 and 4 ranks and the virtual ring
at n = 2 and 4): the port's ring keeps each block's o and gradients in fp32
and casts once. JAX's bf16 ring computes each block in fp32 and casts its o
once, so the port's o is within FWD_ATOL["bfloat16"] of JAX's bf16 ring.
Its gradients are not cast once: autodiff casts each block's cotangents of
the bf16 q, k and v to bf16 and sums them over the ring in bf16, which puts
JAX's bf16 ring 5-6 GRAD_TOL from its own fp32 arithmetic. So the port's
gradients are held under GRAD_TOL (one bf16 ulp plus 1e-3 rms) of JAX's
ring run in fp32 on the same bf16 values and cast once, and no further from
it than JAX's bf16 ring is.

In this process: the virtual ring's block functions (n blocks of one
sequence on one device, what the card check runs) against
`flash_attention_plain` and its backward over the whole sequence; and the
decoder's "ring" without a mesh, which is its default attention bit for bit
(the same in the ranks on a mesh whose fsdp axis has one rank) and equals
JAX's fallback at 2e-5.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from bridgelang_tpu.models.llm import llama as jllama
from bridgelang_tpu.ops.ring_attention import ring_attention_sharded as jring
from bridgelang_tpu_torch.models.llm import llama as tllama
from bridgelang_tpu_torch.ops.flash_attention import flash_attention_bwd_plain, flash_attention_plain
from bridgelang_tpu_torch.ops.ring_attention import virtual_ring_backward, virtual_ring_forward
from chip_smoke import FWD_ATOL, grad_tolerance_use
from tests.torch_mesh_worker import run_group

ATOL = 2e-5
LLM = dict(vocab_size=64, padded_vocab_size=64, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, intermediate_size=96)
# name: (causal, b, t, h, hkv, d)
CASES = {"causal": (True, 4, 32, 4, 4, 16), "non_causal": (False, 4, 32, 4, 4, 16), "gqa": (True, 4, 32, 8, 2, 16)}
BF16_CASES = {"bf16_causal": (True, 4, 64, 4, 4, 64), "bf16_gqa": (True, 4, 64, 8, 2, 64)}


def _inputs(name: str, seed: int):
    causal, b, t, h, hkv, d = {**CASES, **BF16_CASES}[name]
    rng = np.random.default_rng(seed)
    q, g = (rng.normal(size=(b, t, h, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.normal(size=(b, t, hkv, d)).astype(np.float32) for _ in range(2))
    if name in BF16_CASES:  # values bf16 holds exactly, so both sides start from the same inputs
        q, k, v, g = (torch.from_numpy(x).bfloat16().float().numpy() for x in (q, k, v, g))
    return causal, q, k, v, g


def _jax_ring(world: int, causal: bool, q, k, v, g, dtype=jnp.float32):
    """JAX's ring over `world` virtual devices on inputs cast to `dtype`: o
    and (dq, dk, dv) of sum(o * g), as float32 numpy arrays."""
    mesh = Mesh(np.array(jax.devices()[:world]), ("sp",))
    fn = functools.partial(jring, mesh=mesh, axis_name="sp", causal=causal)

    def loss(a, b, c):
        o = fn(a, b, c)
        return jnp.sum(o * jnp.asarray(g, dtype)), o

    (_, o), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(
        *(jnp.asarray(x, dtype) for x in (q, k, v)))
    return [np.asarray(x.astype(jnp.float32)) for x in (o, *grads)]


@pytest.fixture(scope="module", params=[2, 4], ids=lambda w: f"world{w}")
def ring_run(request, tmp_path_factory):
    world = request.param
    cases = []
    for i, name in enumerate(CASES):
        causal, q, k, v, g = _inputs(name, seed=10 * world + i)
        cases.append(dict(name=name, causal=causal, q=q, k=k, v=v, g=g))
    for i, name in enumerate(BF16_CASES):
        causal, q, k, v, g = _inputs(name, seed=70 + 10 * world + i)
        cases.append(dict(name=name, causal=causal, q=q, k=k, v=v, g=g, dtype="bfloat16"))
    job = {"suite": "ring", "cases": cases, "llm": LLM}
    outs = run_group(job, world, tmp_path_factory.mktemp(f"ring{world}"))
    refs = {c["name"]: _jax_ring(world, c["causal"], c["q"], c["k"], c["v"], c["g"]) for c in cases}
    refs.update({c["name"] + "/bf16": _jax_ring(world, c["causal"], c["q"], c["k"], c["v"], c["g"], jnp.bfloat16)
                 for c in cases if "dtype" in c})
    return world, refs, outs


def _assert_bf16_matches_jax(got, jax_bf16, jax_f32):
    """got: the port's (o, dq, dk, dv) bf16 tensors; jax_bf16: JAX's bf16
    ring's, jax_f32: JAX's ring in fp32 on the same bf16 values (float32
    arrays). o within FWD_ATOL of JAX's bf16 o; each gradient under GRAD_TOL
    of JAX's fp32 one cast to bf16, and no further from it than JAX's bf16
    ring's gradient."""
    o, *grads = got
    np.testing.assert_allclose(o.float().numpy(), jax_bf16[0], atol=FWD_ATOL["bfloat16"], rtol=0, err_msg="o")
    for what, a, jb, jf in zip(("dq", "dk", "dv"), grads, jax_bf16[1:], jax_f32[1:]):
        assert a.dtype == torch.bfloat16, what
        once = torch.from_numpy(jf).bfloat16()
        use, jax_use = grad_tolerance_use(a, once), grad_tolerance_use(torch.from_numpy(jb), once)
        assert use <= 1.0 and use <= jax_use, f"{what}: {use:.3g} of GRAD_TOL (JAX's bf16 ring: {jax_use:.3g})"


@pytest.mark.parametrize("layout", ["blocks", "rows"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_ring_on_ranks_matches_jax(ring_run, name, layout):
    world, refs, outs = ring_run
    want, got = refs[name], outs[name]
    for what, w in zip(("o", "dq", "dk", "dv"), want):
        np.testing.assert_allclose(got[f"{layout}/{what}"].numpy(), w, atol=ATOL, rtol=0, err_msg=what)
    # the forward: n - 1 rotations of (k, v); the rows layout adds 3 all-to-alls in and 1 out
    assert got[f"{layout}/collectives"] == world - 1 + (4 if layout == "rows" else 0)


@pytest.mark.parametrize("layout", ["blocks", "rows"])
@pytest.mark.parametrize("name", sorted(BF16_CASES))
def test_bf16_ring_on_ranks_matches_jax(ring_run, name, layout):
    """bf16 on 2 and 4 gloo ranks against JAX's ring over as many virtual devices."""
    world, refs, outs = ring_run
    got = outs[name]
    _assert_bf16_matches_jax([got[f"{layout}/{what}"] for what in ("o", "dq", "dk", "dv")], refs[name + "/bf16"],
                             refs[name])


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", sorted(BF16_CASES))
def test_bf16_virtual_ring_matches_jax(name, n):
    """The virtual ring's n blocks in bf16 (one device, the ranks' block
    functions) against JAX's bf16 ring over n virtual devices."""
    causal, q, k, v, g = _inputs(name, seed=80 + n)
    jax_bf16, jax_f32 = (_jax_ring(n, causal, q, k, v, g, dtype) for dtype in (jnp.bfloat16, jnp.float32))
    q, k, v, g = (torch.from_numpy(x).bfloat16() for x in (q, k, v, g))
    o, lse = virtual_ring_forward(q, k, v, n, causal)
    grads = virtual_ring_backward(q, k, v, o, lse, g, n, causal)
    _assert_bf16_matches_jax([o.to(q.dtype), *grads], jax_bf16, jax_f32)


def test_ring_refuses_a_length_it_does_not_divide(ring_run):
    world, _, outs = ring_run
    assert "multiple of the 'fsdp' axis size" in outs["indivisible"]
    with pytest.raises(ValueError, match="multiple of the 'fsdp' axis size"):
        mesh = Mesh(np.array(jax.devices()[:world]), ("fsdp",))
        x = jnp.ones((1, 31, 2, 16), jnp.float32)
        with jax.sharding.set_mesh(mesh):
            jllama.full_attention(x, x, x, jnp.ones((1, 1, 31, 31), bool), impl="ring")


def test_ring_over_an_axis_of_one_rank_is_the_default_attention(ring_run):
    _, _, outs = ring_run
    assert outs["axis_of_one_is_flash"] is True


@pytest.mark.parametrize("n", [1, 2, 3, 4])
@pytest.mark.parametrize("name", sorted(CASES))
def test_virtual_ring_blocks_match_the_whole_sequence(name, n):
    causal, q, k, v, g = (x if isinstance(x, bool) else torch.from_numpy(x) for x in _inputs(name, seed=n))
    t = q.shape[1] - q.shape[1] % n
    q, k, v, g = (x[:, :t] for x in (q, k, v, g))
    o, lse = virtual_ring_forward(q, k, v, n, causal)
    po, plse = flash_attention_plain(q, k, v, causal=causal)
    torch.testing.assert_close(o, po, atol=ATOL, rtol=0)
    torch.testing.assert_close(lse, plse, atol=ATOL, rtol=0)
    got = virtual_ring_backward(q, k, v, o, lse, g, n, causal)
    want = flash_attention_bwd_plain(q, k, v, po, plse, g, causal=causal)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=ATOL, rtol=0)


def test_ring_off_mesh_is_the_default_attention_and_jax_fallback():
    """Without a mesh the decoder's "ring" is its flash path bit for bit,
    and the JAX package's "ring" (no ambient mesh: its XLA path) within 2e-5."""
    from bridgelang_tpu_torch.convert import llm_params_from_jax

    jcfg = jllama.LLMConfig(**LLM)
    jparams = jllama.init_llm_params(jax.random.key(3), jcfg)
    params = llm_params_from_jax(jax.tree.map(np.asarray, jparams))
    cfg = tllama.LLMConfig(**LLM)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 16, LLM["dim"])).astype(np.float32)
    mask = np.tril(np.ones((16, 16), bool))[None, None].repeat(2, 0)
    pos = np.broadcast_to(np.arange(16), (2, 16))
    ring, _ = tllama.llm_forward(params, cfg, torch.from_numpy(x), torch.from_numpy(pos.copy()),
                                 torch.from_numpy(mask), attention="ring")
    flash, _ = tllama.llm_forward(params, cfg, torch.from_numpy(x), torch.from_numpy(pos.copy()),
                                  torch.from_numpy(mask))
    assert torch.equal(ring, flash)
    want, _ = jllama.llm_forward(jparams, jcfg, jnp.asarray(x), jnp.asarray(pos), jnp.asarray(mask),
                                 attention_impl="ring")
    np.testing.assert_allclose(ring.numpy(), np.asarray(want), atol=ATOL, rtol=0)
