"""The port's training checkpoints against the JAX package's checkpointing.

Names, parsing, `save_sidecars` and `validate_resume` equal the JAX
functions (same strings, same JSON, raising the same exception types in the
same cases). The port's own format (torch.save, read with weights_only) is
held to: a save/restore round trip of a tiny LoRA `TrainState` is bit-exact,
and one step from the restored state equals one step from the uninterrupted
state bit for bit (CPU); `only_trainable_mask` drops the frozen leaves;
retention and the `latest-checkpoint.txt` marker work.
"""

import json

import numpy as np
import pytest
import torch

from bridgelang_tpu.training import checkpointing as jck
from bridgelang_tpu_torch.training import checkpointing as tck


@pytest.mark.parametrize("step,epoch,loss", [(0, 0, 0.0), (1234, 3, 0.12345), (999999, 99, 12.5), (7, 1, 3.99996)])
def test_names_and_parsing_equal_jax(step, epoch, loss):
    name = tck.checkpoint_name(step, epoch, loss)
    assert name == jck.checkpoint_name(step, epoch, loss)
    assert tck.parse_checkpoint_name("run/checkpoints/" + name) == jck.parse_checkpoint_name("run/checkpoints/" + name)
    with pytest.raises(ValueError):
        tck.parse_checkpoint_name("step-x-epoch-1")
    with pytest.raises(ValueError):
        jck.parse_checkpoint_name("step-x-epoch-1")


def _lora_run(seed=0):
    """A tiny VLA (deploy's smoke model, fp32, CPU) with r=4 adapters, its
    optimizer, a train step and a fixed batch."""
    from bridgelang_tpu_torch.deploy import build_smoke_model
    from bridgelang_tpu_torch.training.lora import add_lora_params, lora_trainable_mask
    from bridgelang_tpu_torch.training.trainer import OptimConfig, init_train_state, make_optimizer, make_vla_train_step

    model, params = build_smoke_model(torch.device("cpu"))
    params = dict(params, llm=add_lora_params(torch.Generator().manual_seed(seed + 1), params["llm"], rank=4))
    mask = lora_trainable_mask(params)
    opt = make_optimizer(OptimConfig(learning_rate=5e-2), params, trainable_mask=mask)
    state = init_train_state(params, opt, trainable_mask=mask)
    step = make_vla_train_step(model, opt, trainable_mask=mask, compute_dtype=torch.float32,
                               image_transform=model.image_transform, remat=False)
    rng = np.random.default_rng(seed)
    b, t = 2, 24
    ids = np.full((b, t), model.cfg.llm.pad_token_id, np.int64)
    msk = np.zeros((b, t), np.int64)
    lbl = np.full((b, t), -100, np.int64)
    for i in range(b):
        ids[i, 0] = 1
        ids[i, 1:8] = rng.integers(3, 250, 7)
        ids[i, 8:15] = rng.integers(31744, 32000, 7)
        msk[i, :15] = 1
        lbl[i, 8:15] = ids[i, 8:15]
    batch = {"input_ids": torch.from_numpy(ids), "attention_mask": torch.from_numpy(msk),
             "labels": torch.from_numpy(lbl),
             "frames": torch.from_numpy(rng.integers(0, 256, (b, 64, 64, 3), dtype=np.uint8))}
    return model, state, step, batch, mask


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v for k, sub in tree.items() for k2, v in _flat(sub, f"{prefix}.{k}").items()}
    if isinstance(tree, list):
        return {k2: v for i, sub in enumerate(tree) for k2, v in _flat(sub, f"{prefix}[{i}]").items()}
    return {prefix: tree}


def _assert_state_equal(a, b):
    fa, fb = _flat({"p": a.params, "o": a.opt_state}), _flat({"p": b.params, "o": b.opt_state})
    assert set(fa) == set(fb)
    for k in fa:
        if isinstance(fa[k], torch.Tensor):
            assert fa[k].dtype == fb[k].dtype and torch.equal(fa[k], fb[k]), k
        else:
            assert fa[k] == fb[k], k
    assert a.step == b.step


def test_lora_state_round_trip_and_resume_step_bit_exact(tmp_path):
    model, state, step, batch, mask = _lora_run()
    for _ in range(2):
        state, _ = step(state, batch)
    mgr = tck.CheckpointManager(tmp_path / "run", keep=3)
    path = mgr.save(state, step=2, epoch=0, loss=1.5, only_trainable_mask=mask)
    assert path.name == "step-000002-epoch-00-loss=1.5000" and mgr.latest() == path

    # frozen leaves dropped: the file holds the adapters, moments and step only
    saved = torch.load(path / tck.STATE_FILE, weights_only=True)
    flat = _flat(saved["params"])
    assert all((v is None) == ("_lora_" not in k) for k, v in flat.items())
    assert saved["step"] == 2 and saved["opt_state"]["count"] == 2

    # restore into a fresh state (the same base, other adapters, zero moments): bit-exact
    _, fresh, step2, _, _ = _lora_run(seed=5)
    restored = mgr.restore(path, fresh)
    _assert_state_equal(restored, state)

    # one more step from each: equal losses and adapters, bit for bit
    state, m_a = step(state, batch)
    restored, m_b = step2(restored, batch)
    assert float(m_a["loss"]) == float(m_b["loss"])
    _assert_state_equal(restored, state)


def test_restore_rejects_other_structures(tmp_path):
    _, state, _, _, mask = _lora_run()
    mgr = tck.CheckpointManager(tmp_path, keep=0)
    path = mgr.save(state, 1, 0, 2.0, only_trainable_mask=mask)
    _, other, _, _, _ = _lora_run()
    other.params["llm"]["layers"][0]["wq_lora_a"] = torch.zeros(3, 3)
    with pytest.raises(ValueError, match="wq_lora_a"):
        mgr.restore(path, other)


def test_retention_and_latest_marker(tmp_path):
    _, state, _, _, _ = _lora_run()
    mgr = tck.CheckpointManager(tmp_path / "run", keep=2)
    paths = [mgr.save(state, s, 0, 1.0) for s in (5, 10, 15)]
    left = sorted(p.name for p in (tmp_path / "run" / "checkpoints").iterdir())
    assert left == [paths[1].name, paths[2].name]
    assert (tmp_path / "run" / "latest-checkpoint.txt").read_text() == paths[2].name
    assert mgr.latest() == paths[2]
    (tmp_path / "run" / "latest-checkpoint.txt").write_text("step-000099-epoch-00-loss=1.0000")  # stale marker
    assert mgr.latest() == paths[2]
    assert not list((tmp_path / "run" / "checkpoints").rglob("*.tmp"))


@pytest.mark.parametrize("shards", [1, 2])
def test_save_sidecars_writes_the_jax_files(tmp_path, shards):
    cfg = {"vla_id": "debug", "use_quantization": True, "quantization_bits": 4, "int4_shards": shards, "lr": 5e-4}
    stats = {"bridge_orig": {"action": {"q01": np.array([-0.1, 0.2], np.float32), "mask": np.array([True, False]),
                                        "num": np.int64(3)}}}
    jck.save_sidecars(tmp_path / "j", cfg, stats)
    tck.save_sidecars(tmp_path / "t", cfg, stats)
    for name in ("config.json", "dataset_statistics.json"):
        assert (tmp_path / "t" / name).read_text() == (tmp_path / "j" / name).read_text(), name
    assert tck.load_dataset_statistics(tmp_path / "t" / "dataset_statistics.json") == \
        jck.load_dataset_statistics(tmp_path / "j" / "dataset_statistics.json")


def _resume_case(root, layout, int4):
    run = root / "run"
    ck = run / "checkpoints" / "step-000010-epoch-01-loss=0.5000"
    ck.mkdir(parents=True)
    cfg = {"use_quantization": int4, "quantization_bits": 4, "int4_shards": 2}
    if layout is not None:
        cfg["int4_pack_layout"] = layout
    (run / "config.json").write_text(json.dumps(cfg))
    return ck


@pytest.mark.parametrize("layout,int4", [("out-paired-lobias/v2+shardblocked-2", True), ("out-paired-lobias/v2", True),
                                         (None, True), ("old/v1", False)])
@pytest.mark.parametrize("step,epoch", [(10, 1), (11, 1), (10, 2)])
def test_validate_resume_raises_where_jax_raises(tmp_path, layout, int4, step, epoch):
    ck = _resume_case(tmp_path, layout, int4)
    try:
        jck.validate_resume(ck, step, epoch)
        want = None
    except (AssertionError, ValueError) as e:
        want = type(e)
    if want is None:
        tck.validate_resume(ck, step, epoch)
    else:
        with pytest.raises(want):
            tck.validate_resume(ck, step, epoch)
