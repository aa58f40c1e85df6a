"""Checkpoint inspector: tensors, shapes, dtypes, bytes and sidecar metadata.

    python -m bridgelang_tpu_torch.inspect_checkpoint --path /ckpts/openvla-7b [--filter llm] [--limit 40]

Counterpart of scripts/inspect_checkpoint.py, over the checkpoint layouts
the port reads and writes:

  * HF OpenVLA directories (config.json + model*.safetensors [+
    dataset_statistics.json]), read through the port's own
    `util/safetensors_io` (headers only);
  * the port's run dirs, `<run>/checkpoints/step-*/state.pt`
    (`training/checkpointing.py`; the latest step), or one step directory,
    read with `torch.load(..., map_location="cpu", weights_only=True,
    mmap=True)`: the tensors stay mapped on disk and nothing is copied to a
    device. The JAX package's Orbax run dirs are refused with a message.

Every field of the JAX script's `InspectConfig` under its name and default,
plus `--device`: the entry points' device rule (CUDA unless `--device cpu`;
it raises without a card), though no tensor goes to it.
"""

from __future__ import annotations

import json
import math
from collections import defaultdict
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

from bridgelang_tpu_torch.conf import parse_cli

Row = Tuple[str, Tuple[int, ...], str, int]  # name, shape, dtype, bytes


@dataclass
class InspectConfig:
    path: str = ""
    filter: Optional[str] = None  # substring filter on tensor names
    limit: int = 40               # max tensor rows printed (0 = all)
    device: Optional[str] = None  # cuda (default) | cpu


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KB", "MB", "GB"):
        if n < 1024:
            return f"{n:.1f} {unit}"
        n /= 1024
    return f"{n:.1f} TB"


def _summarize(rows: List[Row], cfg: InspectConfig) -> Dict[str, Any]:
    """Print the rows (filtered, at most cfg.limit) and the per-prefix
    totals -> {"tensors", "bytes", "by_prefix": {prefix: [count, bytes]}}."""
    by_prefix = defaultdict(lambda: [0, 0])  # prefix -> [count, bytes]
    total = [0, 0]
    shown = matched = 0
    for name, shape, dtype, nbytes in rows:
        prefix = name.split(".")[0].split("/")[0]
        by_prefix[prefix][0] += 1
        by_prefix[prefix][1] += nbytes
        total[0] += 1
        total[1] += nbytes
        if cfg.filter and cfg.filter not in name:
            continue
        matched += 1
        if not cfg.limit or shown < cfg.limit:
            print(f"  {name:70s} {str(shape):24s} {dtype:10s} {_fmt_bytes(nbytes)}")
            shown += 1
    hidden = matched - shown
    if hidden > 0:
        print(f"  ... {hidden} more (raise --limit or use --filter)")
    print("\nper top-level module:")
    for prefix, (count, nbytes) in sorted(by_prefix.items(), key=lambda kv: -kv[1][1]):
        print(f"  {prefix:20s} {count:5d} tensors  {_fmt_bytes(nbytes)}")
    print(f"  {'TOTAL':20s} {total[0]:5d} tensors  {_fmt_bytes(total[1])}")
    return {"tensors": total[0], "bytes": total[1], "by_prefix": {k: list(v) for k, v in by_prefix.items()}}


def hf_rows(ckpt_dir: Path) -> List[Row]:
    """One row per tensor of every `*.safetensors` file, from the headers;
    the dtype as the file names it (f32, bf16, i8, ...)."""
    from bridgelang_tpu_torch.util.safetensors_io import _NAMES, SafetensorsFile

    rows = []
    for f in sorted(ckpt_dir.glob("*.safetensors")):
        sf = SafetensorsFile(f)
        for name in sf.keys():
            dtype, shape = sf.dtype_shape(name)
            shape = tuple(shape)
            rows.append((name, shape, _NAMES[dtype].lower(), dtype.itemsize * math.prod(shape)))
    return sorted(rows)


def state_rows(state_file: Path) -> List[Row]:
    """One row per tensor of a port `state.pt`, named by its path through
    the containers ("params/llm/layers/0/wq"); None leaves (frozen tensors a
    LoRA checkpoint drops) and numbers are skipped."""
    import torch

    state = torch.load(state_file, map_location="cpu", weights_only=True, mmap=True)
    rows: List[Row] = []

    def walk(node, path):
        if isinstance(node, torch.Tensor):
            rows.append(("/".join(path), tuple(node.shape), str(node.dtype).replace("torch.", ""),
                         node.element_size() * node.numel()))
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + [str(k)])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + [str(i)])

    walk(state, [])
    return sorted(rows)


def inspect_hf(ckpt_dir: Path, cfg: InspectConfig) -> Dict[str, Any]:
    files = sorted(ckpt_dir.glob("*.safetensors"))
    print(f"[inspect] HF-format checkpoint: {len(files)} safetensors file(s)")
    summary = _summarize(hf_rows(ckpt_dir), cfg)
    for sidecar in ("config.json", "dataset_statistics.json"):
        p = ckpt_dir / sidecar
        if p.exists():
            obj = json.loads(p.read_text())
            print(f"\n{sidecar}: {len(obj)} top-level keys: {list(obj)[:12]}")
    return summary


def inspect_state(step_dir: Path, cfg: InspectConfig) -> Dict[str, Any]:
    from bridgelang_tpu_torch.training.checkpointing import STATE_FILE

    print(f"[inspect] torch checkpoint: {step_dir.name}/{STATE_FILE}")
    return _summarize(state_rows(step_dir / STATE_FILE), cfg)


def main(cfg: InspectConfig) -> Dict[str, Any]:
    """Inspect cfg.path -> the summary of `_summarize`."""
    from bridgelang_tpu_torch._device import resolve_device
    from bridgelang_tpu_torch.training.checkpointing import STATE_FILE

    resolve_device(cfg.device)
    path = Path(cfg.path)
    if not path.exists():
        raise SystemExit(f"no such path: {path}")
    if list(path.glob("*.safetensors")):
        return inspect_hf(path, cfg)
    if (path / STATE_FILE).exists():
        return inspect_state(path, cfg)
    if (path / "checkpoints").exists():
        ckpts = sorted(p for p in (path / "checkpoints").glob("step-*") if (p / STATE_FILE).exists())
        if not ckpts:
            raise SystemExit(f"{path}/checkpoints holds no step-*/{STATE_FILE}")
        return inspect_state(ckpts[-1], cfg)
    if (path / "_METADATA").exists() or (path / "_CHECKPOINT_METADATA").exists():
        raise SystemExit(f"{path}: an Orbax checkpoint of the JAX package; inspect it with "
                         "scripts/inspect_checkpoint.py (the port's run dirs hold state.pt files)")
    raise SystemExit(f"{path}: neither HF safetensors nor a run dir of state.pt checkpoints")


if __name__ == "__main__":
    main(parse_cli(InspectConfig))
