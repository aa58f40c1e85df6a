"""Rank-aware logging ("overwatch"), the port's copy of
bridgelang_tpu/overwatch/overwatch.py.

INFO on process 0, ERROR elsewhere. The rank and world size come from
`torch.distributed` when a process group is initialized, else 0 and 1; they
are read per record, so a logger made at import time follows a process group
initialized later. Making a logger initializes nothing.
"""

from __future__ import annotations

import logging
import sys
from contextlib import contextmanager
from functools import wraps
from typing import Any, Callable, Iterator

import torch

_FORMAT = "%(asctime)s | %(levelname)-7s | %(name)s >> %(message)s"
_DATEFMT = "%m/%d %H:%M:%S"


def _distributed() -> bool:
    return torch.distributed.is_available() and torch.distributed.is_initialized()


def _process_index() -> int:
    return torch.distributed.get_rank() if _distributed() else 0


def _process_count() -> int:
    return torch.distributed.get_world_size() if _distributed() else 1


class Overwatch:
    """Logger facade with rank helpers."""

    def __init__(self, name: str) -> None:
        self.logger = logging.getLogger(name)
        if not logging.getLogger().handlers and not self.logger.handlers:
            handler = logging.StreamHandler(sys.stdout)
            handler.setFormatter(logging.Formatter(_FORMAT, datefmt=_DATEFMT))
            self.logger.addHandler(handler)
            self.logger.propagate = False
        self.logger.setLevel(logging.INFO)
        self.logger.addFilter(lambda rec: _process_index() == 0 or rec.levelno >= logging.ERROR)
        for lvl in ("debug", "info", "warning", "error", "critical"):
            setattr(self, lvl, getattr(self.logger, lvl))

    def rank(self) -> int:
        return _process_index()

    def world_size(self) -> int:
        return _process_count()

    def is_rank_zero(self) -> bool:
        return _process_index() == 0

    def rank_zero_only(self, fn: Callable[..., Any]) -> Callable[..., Any]:
        @wraps(fn)
        def wrapper(*args: Any, **kwargs: Any) -> Any:
            return fn(*args, **kwargs) if self.is_rank_zero() else None

        return wrapper

    @contextmanager
    def local_zero_first(self) -> Iterator[None]:
        """Process 0 runs the body first (a download, a cache build); the
        others wait at a barrier, then run it."""
        if not _distributed():
            yield
            return
        if self.is_rank_zero():
            yield
            torch.distributed.barrier()
        else:
            torch.distributed.barrier()
            yield

    def rank_zero_info(self, msg: str, *args: Any) -> None:
        if self.is_rank_zero():
            self.logger.info(msg, *args)


def initialize_overwatch(name: str) -> Overwatch:
    return Overwatch(name)
