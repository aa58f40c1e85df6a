"""The port's config registries and CLI binding against the JAX package's.

`ModelConfig`, `VLAConfig` and `DatasetConfig`: the same ids, and for each id
`config_to_dict` equal field for field; `parse_cli` on the argv cases of
tests/test_conf.py gives equal configs and raises where the JAX one raises.
Exact equality throughout (host-only dataclasses).
"""

import json
from dataclasses import dataclass, field

import pytest

import bridgelang_tpu.conf as jconf
import bridgelang_tpu_torch.conf as tconf


@pytest.mark.parametrize("family", ["ModelConfig", "VLAConfig", "DatasetConfig"])
def test_registry_equal_id_for_id(family):
    """Id for id, but for the port's own model ids (a decoder the JAX package lacks)."""
    jcls, tcls = getattr(jconf, family), getattr(tconf, family)
    own = ("prism-deepseekv2lite-dinosiglip+16b",) if family == "ModelConfig" else ()
    assert set(own) <= set(tcls.available()) and not set(own) & set(jcls.available())
    assert [c for c in tcls.available() if c not in own] == jcls.available()
    for choice in jcls.available():
        assert tconf.config_to_dict(tcls.get(choice)) == jconf.config_to_dict(jcls.get(choice)), choice
    assert tconf.config_to_dict(tcls()) == jconf.config_to_dict(jcls())


def _train_cfg(pkg):
    @dataclass
    class TrainCfg:
        vla: pkg.VLAConfig = field(default_factory=lambda: pkg.VLAConfig.get("debug"))
        run_root_dir: str = "runs"
        seed: int = 7
        note: str = "x"

    return TrainCfg


ARGV_CASES = [
    ["--vla.type", "prism-dinosiglip-224px+mx-bridge", "--vla.per_device_batch_size", "8", "--seed=42"],
    ["--vla.max_steps", "10", "--vla.image_aug", "true", "--run_root_dir", "/tmp/r"],
    ["--vla.type=siglip-224px+mx-bridge", "--vla.learning_rate=3e-4", "--vla.mesh_shape", "none"],
    [],
]
BAD_ARGV = [["--bogus", "1"], ["--seed"], ["seed", "1"], ["--vla.type", "no-such-id"]]


@pytest.mark.parametrize("argv", ARGV_CASES)
def test_parse_cli_equal(argv):
    want = jconf.parse_cli(_train_cfg(jconf), list(argv))
    got = tconf.parse_cli(_train_cfg(tconf), list(argv))
    assert tconf.config_to_dict(got) == jconf.config_to_dict(want)


@pytest.mark.parametrize("argv", BAD_ARGV)
def test_parse_cli_raises_where_jax_raises(argv):
    with pytest.raises(Exception) as jexc:
        jconf.parse_cli(_train_cfg(jconf), list(argv))
    with pytest.raises(type(jexc.value)):
        tconf.parse_cli(_train_cfg(tconf), list(argv))


def test_save_config_same_json(tmp_path):
    jconf.save_config(jconf.VLAConfig.get("debug"), tmp_path / "j.json")
    tconf.save_config(tconf.VLAConfig.get("debug"), tmp_path / "t.json")
    assert json.loads((tmp_path / "t.json").read_text()) == json.loads((tmp_path / "j.json").read_text())
