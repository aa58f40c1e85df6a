"""The decoder variants' leftovers in the port against the JAX package and
the `tokenizers` library, on the CPU: Phi-2's ByteLevel BPE tokenizer, a
Mistral-config VLA through export and `load_vla`, and QLoRA over an int4
Phi base.

* Tokenizer: a tiny ByteLevel BPE trained here by `tokenizers` 0.22 (with
  and without `add_prefix_space`, the GPT-2 regex, a special
  "<|endoftext|>" and a whitespace-run added token, as Phi-2's file has);
  the port's reader from its tokenizer.json gives the library's ids and
  decodes, exactly, and adds <PAD> after the added tokens (the JAX
  package's convention through AutoTokenizer).
* Mistral: a tiny 2-layer GQA Mistral VLA (window 8, below every prompt)
  under the real ids, exported by each package and loaded by both: the
  same greedy ids from each of the four (exporter, loader) pairs, fp32,
  exactly. The port's export writes the window (`text_config.sliding_window`)
  and its loader takes it from there; the JAX export drops it and its loader
  takes the registry's (ROADMAP.md Queue 3).
* Phi QLoRA: the int4 Phi VLA of tests/test_torch_decoder_variants.py
  (dim 256, group 128, the JAX Pallas kernels in interpret mode) with r=4
  fp32 adapters on its six projections drawn in numpy (B too): one step's
  loss within 1e-5 relative of the JAX package's and the adapter gradients
  within 1e-4 of max |g| (the chip smoke's card-vs-CPU rule); the merge
  bit-equal to the JAX merge and, dequantized, within half a quantization
  step of W + B A (plus the bf16 rounding of the stored scale, 2^-8 of it
  per step of a code).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bridgelang_tpu.models.llm.llama as jllama
import bridgelang_tpu_torch.models.llm.llama as tllama
from bridgelang_tpu.extern.hf_export import export_checkpoint as jax_export
from bridgelang_tpu.models import load as jload
from bridgelang_tpu.models.llm.tokenizer import ByteFallbackTokenizer as JTokenizer
from bridgelang_tpu.models.vision.vit import ViTConfig as JViTConfig
from bridgelang_tpu.models.vla import OpenVLA as JOpenVLA
from bridgelang_tpu.models.vlm import VLMConfig as JVLMConfig
from bridgelang_tpu.ops import image_ops as jimg
from bridgelang_tpu.training import lora as jlora
from bridgelang_tpu.training import trainer as jtrainer
from bridgelang_tpu.vla import action_tokenizer as jat
from bridgelang_tpu.vla.datasets import datasets as jds
from bridgelang_tpu_torch.convert import llm_params_from_jax, params_from_jax
from bridgelang_tpu_torch.extern.hf_export import export_checkpoint as port_export
from bridgelang_tpu_torch.models import load as tload
from bridgelang_tpu_torch.models.llm.prompting import build_vla_prompt
from bridgelang_tpu_torch.models.llm.tokenizer import ByteFallbackTokenizer, get_tokenizer
from bridgelang_tpu_torch.models.vision.vit import ViTConfig
from bridgelang_tpu_torch.models.vla import OpenVLA, norm_stats_from_json
from bridgelang_tpu_torch.models.vlm import VLMConfig
from bridgelang_tpu_torch.ops import quant as tq
from bridgelang_tpu_torch.training import lora as tlora
from bridgelang_tpu_torch.training import trainer as ttrainer
from bridgelang_tpu_torch.vla import action_tokenizer as tat
from bridgelang_tpu_torch.vla.datasets import datasets as tds
from tests.helpers import TINY_NORM_STATS
from tests.test_torch_decoder_variants import PHI_INT4, _jphi, _vla_pair
from tests.test_torch_load import DINO, SIG, frames, patch_registries, set_transform

# --- the ByteLevel tokenizer ----------------------------------------------------------------

PHI_CHAT = "<|endoftext|>Input: put the spoon  on the towel\nOutput: "  # the phi prompter's turn, its BOS in the text
BYTE_TEXTS = [PHI_CHAT, build_vla_prompt("pick up the red block", llm_family="phi"),
              " leading space", "it's you'll  \t x", "é中 unicode ✓ bytes 123 4.5", "", " ", "a",
              "x<|endoftext|>y", "tabs\t\tand   spaces   ", "I'M 'S 're  z \x1f q", "  \n\n  end\n"]


def _byte_level_tokenizer(tmp_path, add_prefix_space: bool):
    tokenizers = pytest.importorskip("tokenizers")
    from tokenizers import AddedToken, decoders, models, pre_tokenizers, processors, trainers

    tok = tokenizers.Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=add_prefix_space)
    tok.decoder = decoders.ByteLevel()
    tok.post_processor = processors.ByteLevel(trim_offsets=False)
    trainer = trainers.BpeTrainer(vocab_size=420, special_tokens=["<|endoftext|>"],
                                  initial_alphabet=pre_tokenizers.ByteLevel.alphabet())
    tok.train_from_iterator(BYTE_TEXTS * 10, trainer)
    tok.add_tokens([AddedToken("  ", normalized=True), AddedToken("\t\t", normalized=False)])
    (tmp_path / "tok").mkdir()
    tok.save(str(tmp_path / "tok" / "tokenizer.json"))
    return tok, tmp_path / "tok"


@pytest.mark.parametrize("add_prefix_space", [False, True])
def test_byte_level_tokenizer_matches_tokenizers(tmp_path, add_prefix_space):
    ref, path = _byte_level_tokenizer(tmp_path, add_prefix_space)
    ours = get_tokenizer(str(path))
    assert ours.pad_token_id == ref.get_vocab_size() and ours.id_to_token[ours.pad_token_id] == "<PAD>"
    assert ours.bos_token_id == ours.eos_token_id == ref.token_to_id("<|endoftext|>")
    for text in BYTE_TEXTS:
        want = ref.encode(text).ids
        assert ours(text).input_ids == want, text
        for skip in (True, False):
            assert ours.decode(want, skip_special_tokens=skip) == ref.decode(want, skip_special_tokens=skip), text
    assert ours.encode(PHI_CHAT)[0] == ref.token_to_id("<|endoftext|>")  # parsed out of the text
    bad = [ref.token_to_id("Ġ"), ref.token_to_id("a")] + ref.encode("é").ids[:1]  # a cut UTF-8 sequence
    assert ours.decode(bad) == ref.decode(bad)


def test_byte_level_gpt2_split_matches_the_regex():
    regex = pytest.importorskip("regex")
    from bridgelang_tpu_torch.models.llm.tokenizer import _gpt2_split

    pattern = regex.compile(r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+""")
    rng = np.random.default_rng(0)
    alphabet = list("ab Z9'sltrvmd\t\n\r.,;é中✓  ١_-") + ["'s", "'ll", "  ", "\x1f"]
    texts = BYTE_TEXTS + ["".join(rng.choice(alphabet, size=int(rng.integers(0, 40)))) for _ in range(200)]
    for text in texts:
        assert _gpt2_split(text) == pattern.findall(text), repr(text)


# --- Mistral through export and load_vla ------------------------------------------------------

MISTRAL = dict(vocab_size=32000, padded_vocab_size=32064, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
               intermediate_size=128, sliding_window=8)
MISTRAL_IDS = dict(vision_backbone_id="dinosiglip-vit-so-224px", llm_backbone_id="mistral-v0.1-7b-pure",
                   arch_specifier="no-align+fused-gelu-mlp")


@pytest.fixture
def mistral_registries(monkeypatch):
    patch_registries(monkeypatch)
    monkeypatch.setitem(jllama.LLM_CONFIGS, "mistral-v0.1-7b-pure", jllama.LLMConfig(**MISTRAL))
    monkeypatch.setitem(tllama.LLM_CONFIGS, "mistral-v0.1-7b-pure", tllama.LLMConfig(**MISTRAL))


def _mistral_pair(seed: int = 51):
    """The JAX tiny Mistral VLA (its head's action columns scaled so that
    decoding lands in the action range) and its conversion into the port."""
    jcfg = dataclasses.replace(JVLMConfig(**MISTRAL_IDS), llm=jllama.LLMConfig(**MISTRAL),
                               vision_override=(JViTConfig(**DINO), JViTConfig(**SIG)))
    jm = JOpenVLA(jcfg, TINY_NORM_STATS, tokenizer=JTokenizer(), dtype=jnp.float32)
    set_transform(jm, "fused")
    jp = jm.init_params(jax.random.key(seed))
    jp["llm"]["lm_head"] = jp["llm"]["lm_head"].at[:, 31744:32000].multiply(8.0)
    tcfg = dataclasses.replace(VLMConfig(**MISTRAL_IDS), llm=tllama.LLMConfig(**MISTRAL),
                               vision_override=(ViTConfig(**DINO), ViTConfig(**SIG)))
    tm = OpenVLA(tcfg, norm_stats_from_json(TINY_NORM_STATS), tokenizer=ByteFallbackTokenizer(), dtype=torch.float32,
                 device="cpu")
    set_transform(tm, "fused")
    return jm, jp, tm, params_from_jax(jax.tree.map(np.asarray, jp))


def _greedy_ids(model, params, ids, mask, pixels):
    if isinstance(model, JOpenVLA):
        return np.asarray(model.generate_greedy(params, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(pixels),
                                                max_new_tokens=7))
    return model.generate_greedy(params, *(torch.from_numpy(a) for a in (ids, mask, pixels)), max_new_tokens=7).numpy()


def test_mistral_vla_through_both_exports_and_loaders(mistral_registries, tmp_path):
    jm, jp, tm, tp = _mistral_pair()
    dirs = {"jax": jax_export(jm, jp, tmp_path / "jax"), "port": port_export(tm, tp, tmp_path / "port")}
    import json

    jtext = json.loads((dirs["jax"] / "config.json").read_text())["text_config"]
    ptext = json.loads((dirs["port"] / "config.json").read_text())["text_config"]
    assert "sliding_window" not in jtext and jtext["model_type"] == "llama"
    assert ptext == dict(jtext, model_type="mistral", sliding_window=8)

    ids, mask = tm.pad_prompt([tm.prepare_prompt_ids(t) for t in ("pick up the red block", "open the drawer")])
    assert mask.sum(axis=1).min() > 8, "the window binds inside every prompt"
    pixels = np.array(jimg.preprocess_batch(jnp.asarray(np.stack(frames(2, seed=52))), jm.image_transform))
    want = _greedy_ids(jm, jp, ids, mask, pixels)
    assert ((want >= 31744) & (want < 32000)).mean() > 0.5 and not np.array_equal(want[0], want[1])
    no_window = dataclasses.replace(jm.cfg, llm=dataclasses.replace(jm.cfg.llm, sliding_window=None))
    assert not np.array_equal(_greedy_ids(JOpenVLA(no_window, TINY_NORM_STATS, dtype=jnp.float32), jp, ids, mask,
                                           pixels), want), "the window must change the ids here"
    for exporter, path in dirs.items():
        m1, p1 = jload.load_vla(str(path), dtype=jnp.float32)
        m2, p2 = tload.load_vla(str(path), dtype=torch.float32, device="cpu")
        for m, p in ((m1, p1), (m2, p2)):
            set_transform(m, "fused")
            assert m.cfg.llm.sliding_window == 8 and m.cfg.llm.n_kv_heads == 2, exporter
            np.testing.assert_array_equal(_greedy_ids(m, p, ids, mask, pixels), want, err_msg=exporter)


def test_mistral_window_survives_the_port_export_only(mistral_registries, monkeypatch, tmp_path):
    """A model whose window differs from its registry id's: the port's
    export carries it into the port's loader; the JAX export and loader
    take the registry's."""
    jm, jp, tm, tp = _mistral_pair()
    path = port_export(tm, tp, tmp_path / "port")
    other = dict(MISTRAL, sliding_window=64)
    monkeypatch.setitem(jllama.LLM_CONFIGS, "mistral-v0.1-7b-pure", jllama.LLMConfig(**other))
    monkeypatch.setitem(tllama.LLM_CONFIGS, "mistral-v0.1-7b-pure", tllama.LLMConfig(**other))
    assert tload.load_vla(str(path), load_weights=False, device="cpu")[0].cfg.llm.sliding_window == 8
    assert jload.load_vla(str(path), load_weights=False)[0].cfg.llm.sliding_window == 64
    jpath = jax_export(jm, jp, tmp_path / "jax")
    assert tload.load_vla(str(jpath), load_weights=False, device="cpu")[0].cfg.llm.sliding_window == 64


# --- QLoRA over an int4 Phi base ------------------------------------------------------------

PHI_PROJ = ("wq", "wk", "wv", "wo", "w_up", "w_down")
RANK = 4


@pytest.fixture(scope="module")
def phi_int4_qlora():
    """The int4 Phi pair with numpy-drawn adapters (JAX layout over the
    packed base: A [L, in, r], B [L, r, out], out twice the packed width)."""
    jmodel, jparams, tmodel, _ = _vla_pair(_jphi(**PHI_INT4), seed=60, quantize="int4")
    rng = np.random.default_rng(61)
    layers = dict(jparams["llm"]["layers"])
    for name in PHI_PROJ:
        n_layers, d_in, packed_w = layers[name].shape
        layers[name + "_lora_a"] = jnp.asarray(rng.normal(size=(n_layers, d_in, RANK)) * RANK ** -0.5, jnp.float32)
        layers[name + "_lora_b"] = jnp.asarray(rng.normal(size=(n_layers, RANK, 2 * packed_w)) * 0.02, jnp.float32)
    jp = dict(jparams, llm=dict(jparams["llm"], layers=layers))
    return jmodel, jp, tmodel, params_from_jax(jax.tree.map(np.asarray, jp))


def _phi_batch():
    jt = jds.RLDSBatchTransform(jat.ActionTokenizer(JTokenizer()), JTokenizer(), llm_family="phi")
    tt = tds.RLDSBatchTransform(tat.ActionTokenizer(ByteFallbackTokenizer()), ByteFallbackTokenizer(), llm_family="phi")
    jb = jds.PaddedCollatorForActionPrediction(max_length=112, pad_token_id=51200)(
        list(jds.DummyDataset(jt, n=2, seed=62, image_hw=(32, 32))))
    tb = tds.PaddedCollatorForActionPrediction(max_length=112, pad_token_id=51200)(
        list(tds.DummyDataset(tt, n=2, seed=62, image_hw=(32, 32))))
    np.testing.assert_array_equal(tb["input_ids"], jb["input_ids"])
    return jb, tb


def test_phi_qlora_step_loss_and_grads_match_jax(phi_int4_qlora):
    """One QLoRA step's loss and adapter gradients: the train steps' loss
    (forward_hidden with full remat, the chunked CE) differentiated in the
    adapters on each side."""
    jmodel, jp, tmodel, tp = phi_int4_qlora
    lp = tp["llm"]["layers"][0]
    assert "w_gate" not in lp and sorted(k for k in lp if k.endswith("_lora_a")) == sorted(f"{p}_lora_a" for p in PHI_PROJ)
    assert lp["w_up_lora_b"].shape == (lp["w_up"].shape[1] * 2, RANK) and lp["w_up_scale4"] is not None
    jb, tb = _phi_batch()
    vocab = jmodel.cfg.llm.vocab_size
    j_centers, t_centers = jat.make_bins(256)[1], tat.make_bins(256)[1]
    pixels = np.array(jimg.preprocess_batch(jnp.asarray(jb["frames"]), jmodel.image_transform)) if "frames" in jb \
        else np.asarray(jb["pixel_values"])

    adapter_keys = [k for k in jp["llm"]["layers"] if "_lora_" in k]

    def jloss(adapters):
        params = dict(jp, llm=dict(jp["llm"], layers=dict(jp["llm"]["layers"], **adapters)))
        hidden, labels = jmodel.forward_hidden(params, jnp.asarray(jb["input_ids"]), jnp.asarray(jb["attention_mask"]),
                                               jnp.asarray(pixels), jnp.asarray(jb["labels"]), remat=True)
        loss, _ = jtrainer.chunked_ce_and_metrics(params["llm"], jmodel.cfg.llm, hidden, labels, vocab - 257,
                                                  jnp.asarray(j_centers))
        return loss

    j_loss, j_grads = jax.value_and_grad(jloss)({k: jp["llm"]["layers"][k] for k in adapter_keys})
    tree = dict(jax.tree.map(np.asarray, jp["llm"]), layers={**jax.tree.map(np.asarray, jp["llm"]["layers"]),
                                                             **{k: np.asarray(v) for k, v in j_grads.items()}})
    want = llm_params_from_jax(tree)["layers"]

    leaves = [(i, k) for i, layer in enumerate(tp["llm"]["layers"]) for k in layer if "_lora_" in k]
    for i, k in leaves:
        tp["llm"]["layers"][i][k].requires_grad_(True)
    hidden, labels = tmodel.forward_hidden(tp, *(torch.from_numpy(np.asarray(a)) for a in (
        tb["input_ids"], tb["attention_mask"], pixels, tb["labels"])), remat=True, remat_policy="full")
    t_loss, _ = ttrainer.chunked_ce_and_metrics(tp["llm"], tmodel.cfg.llm, hidden, labels, vocab - 257,
                                                torch.as_tensor(t_centers, dtype=torch.float32))
    t_grads = torch.autograd.grad(t_loss, [tp["llm"]["layers"][i][k] for i, k in leaves])
    for i, k in leaves:
        tp["llm"]["layers"][i][k].requires_grad_(False)

    np.testing.assert_allclose(float(t_loss.detach()), float(j_loss), rtol=1e-5)
    g_max = max(float(np.abs(want[i][k].numpy()).max()) for i, k in leaves)
    g_err = max(float((g - want[i][k]).abs().max()) for (i, k), g in zip(leaves, t_grads))
    assert g_max > 0 and g_err <= 1e-4 * g_max, (g_err, g_max)
    assert all(float(g.abs().max()) > 0 for g in t_grads), "every adapter has a gradient"


def test_phi_qlora_merge_matches_jax_and_the_plain_formula(phi_int4_qlora):
    _, jp, _, tp = phi_int4_qlora
    merged = tlora.merge_lora(tp["llm"])
    jmerged = llm_params_from_jax(jax.tree.map(np.asarray, jlora.merge_lora(jp["llm"])))
    for i, (lp, mp, jmp) in enumerate(zip(tp["llm"]["layers"], merged["layers"], jmerged["layers"])):
        assert not any("_lora_" in k for k in mp) and "w_gate" not in mp
        for name in PHI_PROJ:
            assert torch.equal(mp[name], jmp[name]) and torch.equal(mp[name + "_scale4"], jmp[name + "_scale4"])
            group = lp[name].shape[0] // lp[name + "_scale4"].shape[0]
            plain = (tq.dequant_int4(lp[name], lp[name + "_scale4"], dtype=torch.float32)
                     + (lp[name + "_lora_b"] @ lp[name + "_lora_a"]).t())  # W + B A, [in, out]
            got = tq.dequant_int4(mp[name], mp[name + "_scale4"], dtype=torch.float32)
            # half a step of the stored bf16 scale, plus what its rounding (bf16's
            # unit roundoff, 2^-8 relative) moves a code of up to 7 steps; 8 for
            # the fp32 scale the codes were rounded against
            step = mp[name + "_scale4"].float().repeat_interleave(group, dim=0)
            assert ((got - plain).abs() <= step * (0.5 + 8 * 2.0 ** -8) + 1e-7).all(), (i, name)
            assert not torch.equal(mp[name], lp[name]), "the adapters moved the packed weights"
        for name in ("bq", "bk", "bv", "bo", "b_up", "b_down", "attn_norm_bias"):
            assert mp[name] is lp[name]
