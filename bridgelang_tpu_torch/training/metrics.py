"""Training metrics: tracker protocol, JSONL sink, W&B sink, smoothed windows.

Counterpart of bridgelang_tpu/training/metrics.py (`Tracker`,
`JSONLinesTracker`, `WeightsBiasesTracker`, `Metrics`, `VLAMetrics`), kept as
the port's own host-only copy. The W&B sink raises when `wandb` is not
installed instead of silently logging nowhere.
"""

from __future__ import annotations

import json
import time
from collections import defaultdict, deque
from pathlib import Path
from typing import Any, Dict, Optional, Protocol, Union


class Tracker(Protocol):
    def write_hyperparameters(self, hparams: Dict[str, Any]) -> None: ...

    def write(self, global_step: int, metrics: Dict[str, Any]) -> None: ...

    def finalize(self) -> None: ...


class JSONLinesTracker:
    """<run_id>.jsonl with one line per push (rank 0 only, by the caller)."""

    def __init__(self, run_id: str, run_dir: Union[str, Path], hparams: Optional[Dict[str, Any]] = None):
        self.run_id, self.run_dir = run_id, Path(run_dir)
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self.hparams = hparams or {}
        self._fh = open(self.run_dir / f"{run_id}.jsonl", "a", buffering=1)

    def write_hyperparameters(self, hparams: Optional[Dict[str, Any]] = None) -> None:
        with open(self.run_dir / "run-metrics.jsonl", "a") as f:
            f.write(json.dumps({"run_id": self.run_id, "hparams": hparams or self.hparams}, default=str) + "\n")

    def write(self, global_step: int, metrics: Dict[str, Any]) -> None:
        self._fh.write(json.dumps({"step": global_step, **metrics}, default=float) + "\n")

    def finalize(self) -> None:
        self._fh.close()


class WeightsBiasesTracker:
    """W&B sink; raises ImportError when `wandb` is not installed."""

    def __init__(self, run_id: str, run_dir: Union[str, Path], hparams: Optional[Dict[str, Any]] = None,
                 project: str = "bridgelang-tpu", entity: Optional[str] = None, group: Optional[str] = None):
        try:
            import wandb
        except ImportError as e:
            raise ImportError("the W&B tracker needs the `wandb` package; use the jsonl tracker without it") from e
        self._wandb = wandb
        self._run = wandb.init(project=project, entity=entity, group=group, name=run_id, dir=str(run_dir),
                               config=hparams)

    def write_hyperparameters(self, hparams: Optional[Dict[str, Any]] = None) -> None:
        if hparams:
            self._wandb.config.update(hparams, allow_val_change=True)

    def write(self, global_step: int, metrics: Dict[str, Any]) -> None:
        self._wandb.log(metrics, step=global_step)

    def finalize(self) -> None:
        self._wandb.finish()


def build_trackers(kinds, run_id: str, run_dir: Union[str, Path], hparams: Optional[Dict[str, Any]] = None):
    table = {"jsonl": JSONLinesTracker, "wandb": WeightsBiasesTracker}
    trackers = [table[k](run_id, run_dir, hparams) for k in kinds]
    for t in trackers:
        t.write_hyperparameters(hparams)
    return trackers


class Metrics:
    """Smoothed-window VLM training metrics."""

    def __init__(self, trackers, run_id: str, window_size: int = 128, is_rank_zero: bool = True):
        self.trackers = list(trackers)
        self.run_id = run_id
        self.is_rank_zero = is_rank_zero
        self.global_step = 0
        self.start_time = time.time()
        self.step_start = time.time()
        self.windows = defaultdict(lambda: deque(maxlen=window_size))

    def commit(self, *, global_step: Optional[int] = None, lr: Optional[float] = None, **scalars) -> None:
        if global_step is not None:
            self.global_step = global_step
        if lr is not None:
            self.windows["lr"].append(lr)
        for k, v in scalars.items():
            self.windows[k].append(float(v))

    def _smoothed(self) -> Dict[str, float]:
        return {k: sum(win) / len(win) for k, win in self.windows.items() if win}

    def push(self) -> str:
        step_time = time.time() - self.step_start
        self.step_start = time.time()
        sm = self._smoothed()
        payload = {f"train/{k}": v for k, v in sm.items()}
        payload["train/step_time"] = step_time
        if self.is_rank_zero:
            for t in self.trackers:
                t.write(self.global_step, payload)
        loss = sm.get("loss", float("nan"))
        lr = sm.get("lr", 0.0)
        return f"=>> [Step {self.global_step:06d}] Loss {loss:.4f} | LR {lr:.2e} | {step_time*1e3:.0f} ms/step"

    def finalize(self) -> None:
        for t in self.trackers:
            t.finalize()


class VLAMetrics(Metrics):
    """Adds action accuracy / L1 and per-dataset breakdowns."""

    def __init__(self, trackers, run_id: str, window_size: int = 128, is_rank_zero: bool = True,
                 resume_step: int = 0, resume_epoch: int = 0):
        super().__init__(trackers, run_id, window_size, is_rank_zero)
        self.global_step = resume_step
        self.epoch = resume_epoch
        self.per_dataset = defaultdict(lambda: defaultdict(lambda: deque(maxlen=window_size)))

    def commit_for_dataset(self, dataset_name: str, **scalars) -> None:
        for k, v in scalars.items():
            self.per_dataset[dataset_name][k].append(float(v))

    def push(self) -> str:
        base = super().push()
        if self.is_rank_zero and self.per_dataset:
            payload = {f"train-{ds}/{k}": sum(win) / len(win)
                       for ds, wins in self.per_dataset.items() for k, win in wins.items() if win}
            if payload:
                for t in self.trackers:
                    t.write(self.global_step, payload)
        sm = self._smoothed()
        acc = sm.get("action_accuracy", float("nan"))
        l1 = sm.get("l1_loss", float("nan"))
        return base + f" | Acc {acc:.3f} | L1 {l1:.4f}"
