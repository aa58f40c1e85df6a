"""The DeepSeek-V2 cell's benchmark pieces on the CPU: the configuration
against the port's registry, the seeded weights against the port's layout,
a tiny run of the act_moe driver (sound, traced, and its controls), the
yardstick's new numbers, and pinned numbers of the two older
configurations' draws and yardsticks, which the new files leave alone."""

from __future__ import annotations

import copy
import json
import time

import pytest
import torch

import tiny
import portside
import weights
import weights_moe
import yardstick
import yardstick_moe

BENCH, ROOT = tiny.BENCH, tiny.ROOT
CELL = "dsv2lite-bf16-act-1robot"


def full_config() -> dict:
    return json.loads((BENCH / "configs" / "dsv2lite-vla.json").read_text())


def tiny_config() -> dict:
    """The configuration with its towers and widths cut for the CPU: 3
    layers (a dense one, two MoE), 8 experts top-3, one shared, YaRN on."""
    cfg = copy.deepcopy(full_config())
    port = cfg["port"]
    port["registry_check"] = False
    port["towers"] = [copy.deepcopy(tiny.DINO), copy.deepcopy(tiny.SIGLIP)]
    port["llm"].update(dim=64, n_layers=3, n_heads=4, n_kv_heads=4, intermediate_size=128, kv_lora_rank=32,
                       qk_nope_head_dim=16, qk_rope_head_dim=16, v_head_dim=16, n_routed_experts=8,
                       n_shared_experts=1, moe_intermediate_size=32, num_experts_per_tok=3)
    cfg["serving"] = dict(cfg["serving"], dtype="float32")
    return cfg


def tiny_mix() -> dict:
    return tiny.traffic("act-1robot-moe", trace={"start_s": 0.2, "seconds": 0.5})


def run(cfg, seconds=1.5, trace=False, limits=None, **extra):
    import harness

    over = {"config": cfg, "traffic": tiny_mix(), "limits": dict(tiny.LOOSE, **(limits or {})), **extra}
    return harness.run_cell(ROOT, CELL, 5, seconds, trace, time.perf_counter(), device="cpu", overrides=over)


def test_the_configuration_is_the_ports_registered_decoder():
    cfg = full_config()
    vlm = portside.vlm_config(cfg)  # with the registry check
    assert vlm.llm_backbone_id == "deepseek-v2-lite-pure" and vlm.llm.n_moe_layers == 26
    catalog = cfg["decoder_source_config"]
    assert all(cfg[k] == v for k, v in catalog.items())  # the catalog's numbers at the top level too
    llm = cfg["port"]["llm"]
    assert (llm["dim"], llm["n_layers"], llm["kv_lora_rank"]) == (catalog["hidden_size"], catalog["num_hidden_layers"],
                                                                 catalog["kv_lora_rank"])
    assert llm["yarn_factor"] == catalog["rope_scaling"]["factor"] and cfg["reduced"] == []


def test_the_weights_have_the_ports_layout():
    from drivers import act_moe  # noqa: F401  (a module of its own directory)

    cfg = tiny_config()
    model = portside.build_model(cfg, torch.float32, "cpu")
    params = weights_moe.make_weights(cfg, 3, torch.float32, "cpu")
    portside.check_layout(model, params)
    act_moe.check_decoder_layout(model, params)
    again = weights_moe.make_weights(cfg, 3, torch.float32, "cpu")
    assert torch.equal(params["llm"]["layers"][2]["we_down"], again["llm"]["layers"][2]["we_down"])
    slab = params["llm"]["layers"][1]["we_gate"]  # [E, I_e, D]: fan-in D, every expert alike
    assert abs(float(slab.std()) * 64 ** 0.5 - 1.0) < 0.05


def test_a_tiny_run_is_correct_and_traced():
    out = run(tiny_config(), seconds=3.0, trace=True)
    assert out["correct"], out["checks"]
    assert out["readings"]["logit_gap_max"] < 1e-3  # fp32 on both sides
    assert out["readings"]["moe_err_max"] < 1e-5  # the plain experts in fp32 against the reference's
    assert out["attempted"] > 0 and out["failed"] == 0


CONTROL_READING = {"norm_topk": "logit_gap_max", "no_shared": "logit_gap_max", "fp8_experts": "moe_err_max"}


@pytest.mark.parametrize("variant", list(CONTROL_READING))
def test_the_controls_read_above_the_program(variant):
    """The structural controls move the served ids; the fp8 experts move the
    logits less than the top two ids lie apart, and are seen by the routed
    experts' own comparison."""
    reading = CONTROL_READING[variant]
    sound = run(tiny_config(), seconds=0.8)["readings"][reading]
    control = run(tiny_config(), seconds=0.8, reference_variant=variant)["readings"][reading]
    assert control > 10 * max(sound, 1e-6)


def test_the_yardstick_counts_the_routed_and_shared_experts_only():
    cfg = full_config()
    llm = cfg["port"]["llm"]
    moe_layer = yardstick_moe.layer_matmul_params(llm, 1)
    attn = 16 * 192 * 2048 + 576 * 2048 + 16 * 256 * 512 + 2048 * 16 * 128
    assert moe_layer == attn + 64 * 2048 + 8 * 3 * 2048 * 1408
    assert yardstick_moe.layer_matmul_params(llm, 0) == attn + 3 * 2048 * 10944
    flops = yardstick_moe.act_useful_flops(cfg, 329, 7)
    assert 1.85e12 < flops < 1.95e12  # 2.24 B weights a token over 329 rows, the towers, 6 decode steps
    # a prefill that touches every expert reads every expert's weights: 26 layers x 64 x 3 x 1408 x 2048 x 2 B
    uniform = [[33] * 64] * 26
    prefill_only = yardstick_moe.moe_pass_bound_s(llm, uniform, 1)
    # plus each launch's rows read and written once: 2112 picks x (2048 + 1408) per launch, two launches
    acts = 2 * 2112 * (2048 + 1408)
    assert prefill_only == pytest.approx(26 * (64 * 3 * 1408 * 2048 + acts) * 2 / yardstick.HBM_BYTES_PER_S)
    step = (yardstick_moe.moe_pass_bound_s(llm, uniform, 7) - prefill_only) / 6
    assert step == pytest.approx(26 * (6 * 3 * 1408 * 2048 + 2 * 6 * (2048 + 1408)) * 2 / yardstick.HBM_BYTES_PER_S)
    assert yardstick_moe.mla_flash_bound_s(1, 352, 352, 16, 192, 128, [331]) == pytest.approx(
        (352 * 16 * 320 * 2 + 331 * 16 * 320 * 2 + 4 * 16 * 352 + 4) / yardstick.HBM_BYTES_PER_S)


def test_the_older_configurations_read_as_before():
    """Pinned at the commit that added this cell: the new files change no
    draw or yardstick number of the two older configurations."""
    mistral = json.loads((BENCH / "configs" / "mistral7b-vla.json").read_text())
    phi = json.loads((BENCH / "configs" / "phi2-vla.json").read_text())
    assert yardstick.act_useful_flops(mistral, 329, 7) == pytest.approx(PINNED["mistral_act"], rel=1e-12)
    assert yardstick.act_useful_flops(phi, 329, 7) == pytest.approx(PINNED["phi_act"], rel=1e-12)
    assert 1e3 * yardstick.flash_fwd_bound_s(1, 352, 352, 32, 8, 128, [331], 4096) == pytest.approx(
        PINNED["mistral_flash_ms"], rel=1e-12)
    assert 1e3 * yardstick.flash_fwd_bound_s(1, 352, 352, 32, 32, 80, [331]) == pytest.approx(PINNED["phi_flash_ms"],
                                                                                             rel=1e-12)
    assert yardstick.lora_step_useful_flops(2_600_000_000, 20_000_000, 800_000_000, 11_000, 16_000) == PINNED["lora"]
    for name in ("mistral7b-vla", "phi2-vla"):
        w = weights.make_weights(tiny.config(name), 3, torch.float32, "cpu")
        sums = [float(w["llm"]["layers"][1]["wq"].double().sum()), float(w["vision"]["featurizer.pos_embed"].sum())]
        assert sums == pytest.approx(PINNED[name], rel=1e-9)


PINNED = {"mistral_act": 5112699809792.0, "phi_act": 2099518304256.0, "mistral_flash_ms": 0.002139702686567164,
          "phi_flash_ms": 0.002101188059701493, "lora": 141320000000000.0,
          "mistral7b-vla": [8.615264621491406, 0.25628650188446045],
          "phi2-vla": [-19.759190653416226, 0.25628650188446045]}
