"""The port's seeding and rank-aware logging against the JAX package's.

`set_global_seed` leaves Python's and numpy's generators in the same state
as the JAX package's (exact draws), and its worker-init function seeds a
worker the same way; `root_key` is a torch.Generator on an explicit device.
`initialize_overwatch` has the JAX facade (rank helpers, INFO on rank 0 only);
the rank and world size come from torch.distributed when a group exists.
"""

import logging
import random

import numpy as np
import pytest
import torch

from bridgelang_tpu.overwatch import initialize_overwatch as j_overwatch
from bridgelang_tpu.util import seeding as jseed
from bridgelang_tpu_torch.overwatch import initialize_overwatch as t_overwatch
from bridgelang_tpu_torch.util import seeding as tseed


def _draws():
    return random.random(), np.random.random(3).tolist()


@pytest.mark.parametrize("seed", [0, 7, 2**31])
def test_set_global_seed_draws_equal_jax(seed):
    jseed.set_global_seed(seed)
    want = _draws()
    fn = tseed.set_global_seed(seed, get_worker_init_fn=True)
    assert _draws() == want
    assert torch.initial_seed() == seed
    jfn = jseed.set_global_seed(seed, get_worker_init_fn=True)
    for worker in (0, 3):
        jfn(worker)
        want = _draws()
        fn(worker)
        assert _draws() == want
    with pytest.raises(ValueError):
        tseed.set_global_seed(-1)


def test_root_key_is_a_seeded_generator():
    a = torch.randn(4, generator=tseed.root_key(3, "cpu"))
    assert torch.equal(a, torch.randn(4, generator=tseed.root_key(3, "cpu")))
    assert not torch.equal(a, torch.randn(4, generator=tseed.root_key(3, "cpu", process_unique=True)))
    assert tseed.root_key(3, "cpu").device.type == "cpu"


def test_overwatch_facade_and_ranks(monkeypatch, caplog):
    j, t = j_overwatch("j-test"), t_overwatch("t-test")
    names = ("rank", "world_size", "is_rank_zero", "rank_zero_only", "local_zero_first", "rank_zero_info",
             "debug", "info", "warning", "error", "critical")
    assert all(callable(getattr(j, n)) and callable(getattr(t, n)) for n in names)
    assert (t.rank(), t.world_size(), t.is_rank_zero()) == (j.rank(), j.world_size(), j.is_rank_zero()) == (0, 1, True)
    assert t.rank_zero_only(lambda: 5)() == 5
    with t.local_zero_first():
        pass
    t.logger.propagate = True
    with caplog.at_level(logging.INFO, logger="t-test"):
        t.info("rank zero speaks")
        # a process group of 2 in which this process is rank 1: INFO is dropped, ERROR kept
        monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
        monkeypatch.setattr(torch.distributed, "get_rank", lambda: 1)
        monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
        assert (t.rank(), t.world_size(), t.is_rank_zero()) == (1, 2, False)
        assert t.rank_zero_only(lambda: 5)() is None
        t.info("rank one is quiet")
        t.error("rank one errs")
    messages = [r.getMessage() for r in caplog.records if r.name == "t-test"]
    assert messages == ["rank zero speaks", "rank one errs"]
