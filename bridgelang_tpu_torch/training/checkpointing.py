"""Training checkpoints in torch's own format, with the JAX package's sidecars.

Counterpart of bridgelang_tpu/training/checkpointing.py. The JAX package
writes Orbax checkpoints; the port writes one `state.pt` per checkpoint
directory: `torch.save` of {"step", "params", "opt_state"} in plain
containers (dicts, lists, tensors, numbers, None: no pickled class of the
port), read back with `weights_only=True`, and beside it, for a run that
reads a data stream, `data_state.pt` (the stream's state, so that a resumed
run reads on where the checkpoint stopped). A run dir of one package is not
read by the other. Shared with the JAX package: the naming contract
`step-XXXXXX-epoch-XX-loss=Y.YYYY` under `<run_dir>/checkpoints/`, the
`latest-checkpoint.txt` marker, retention, the config.json /
dataset_statistics.json sidecars with the int4 pack layout, and
`validate_resume`.

The optimizer state is saved (the reference's FSDP path drops it); with
`only_trainable_mask` the frozen parameters are dropped (saved as None), as
the reference's `only_trainable` default, and `restore` keeps the target's.

A run on a mesh (`mesh`, a parallel/fsdp.MeshTraining) writes sharded state
instead: `<step dir>/dcp/`, a `torch.distributed.checkpoint` directory in
which every rank writes its blocks (each leaf a DTensor with its placements,
a replicated leaf written once) under the keys "params/llm/layers/0/wq",
"opt_state/mu/0", "step", ... No rank gathers the state, which the 7B's
fine-tuning stage would not fit. `restore` reads it into any target: a mesh
of another size (DCP reshards the blocks) or whole tensors in one process.
Each rank's data stream state goes beside it (`data_state-<rank>-of-<n>.pt`);
a resume at another world size starts its streams afresh.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import torch

from bridgelang_tpu_torch.ops.quant import pack_layout_tag
from bridgelang_tpu_torch.training.trainer import TrainState

CKPT_DIR_RE = re.compile(r"step-(\d+)-epoch-(\d+)-loss=([0-9.]+)")
STATE_FILE = "state.pt"
DATA_STATE_FILE = "data_state.pt"
SHARDED_DIR = "dcp"  # a mesh run's sharded state (torch.distributed.checkpoint)


def checkpoint_name(step: int, epoch: int, loss: float) -> str:
    """The reference's naming contract (train.py:146-148), which resume
    validation parses."""
    return f"step-{step:06d}-epoch-{epoch:02d}-loss={loss:.4f}"


def parse_checkpoint_name(name: str) -> Tuple[int, int, float]:
    m = CKPT_DIR_RE.search(str(name))
    if not m:
        raise ValueError(f"Un-parsable checkpoint name {name!r}")
    return int(m.group(1)), int(m.group(2)), float(m.group(3))


def _rank() -> int:
    return torch.distributed.get_rank() if torch.distributed.is_available() and torch.distributed.is_initialized() else 0


def _world() -> int:
    dist = torch.distributed
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def _trainable_mask(params):
    """Which leaves train: init_train_state marks them requires_grad."""
    if isinstance(params, dict):
        return {k: _trainable_mask(v) for k, v in params.items()}
    if isinstance(params, list):
        return [_trainable_mask(v) for v in params]
    return params.requires_grad


def _sharded_state(state: TrainState, mesh, keep_mask=None) -> Dict[str, Any]:
    """The flat DCP state dict of `state` on `mesh`: params (the leaves
    `keep_mask` marks, all without it) and the optimizer state as DTensors
    over this rank's tensors, numbers as they are; or, without a mesh, the
    same keys over whole tensors."""
    from bridgelang_tpu_torch.parallel.fsdp import flat_state

    def leaf(t, spec):
        if mesh is None:
            return t.detach()
        return mesh.dtensor(t.detach(), spec, whole=not mesh.shards_params)

    sd: Dict[str, Any] = {"step": int(state.step)}
    keep = [True] * len(flat_state("", state.params)) if keep_mask is None else [
        bool(m) for _, m in flat_state("", keep_mask)]
    specs = flat_state("", mesh.specs) if mesh is not None else [(None, None)] * len(keep)
    for (key, t), (_, spec), k in zip(flat_state("params", state.params), specs, keep):
        if k:
            sd[key] = leaf(t, spec)
    opt_specs = mesh.leaf_specs(_trainable_mask(state.params)) if mesh is not None else None
    for key, value in flat_state("opt_state", state.opt_state):
        if isinstance(value, torch.Tensor):
            i = int(key.rsplit("/", 1)[1])
            sd[key] = value if mesh is None else mesh.dtensor(value, opt_specs[i])
        else:
            sd[key] = value
    return sd


def _set_path(tree, key: str, value):
    """tree[...][...] = value along a "a/b/0/c" key; returns the tree."""
    parts = key.split("/")
    node = tree
    for p in parts[:-1]:
        node = node[int(p)] if isinstance(node, list) else node[p]
    last = parts[-1]
    if isinstance(node, list):
        node[int(last)] = value
    else:
        node[last] = value
    return tree


def sharded_metadata(step_dir) -> Dict[str, Any]:
    """{key: (global shape, dtype)} of a sharded checkpoint's tensors (numbers skipped)."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint.metadata import TensorStorageMetadata

    meta = dcp.FileSystemReader(str(Path(step_dir) / SHARDED_DIR)).read_metadata()
    return {k: (tuple(v.size), v.properties.dtype) for k, v in meta.state_dict_metadata.items()
            if isinstance(v, TensorStorageMetadata)}


def _drop_frozen(params, mask):
    """`params` with each leaf whose mask is False replaced by None."""
    if isinstance(params, dict):
        return {k: _drop_frozen(v, mask[k]) for k, v in params.items()}
    if isinstance(params, list):
        return [_drop_frozen(v, m) for v, m in zip(params, mask)]
    return params.detach() if bool(mask) else None


def _copy_into(target, saved, where: str = "state"):
    """Copy `saved` into `target` in place (tensors) or take it (numbers);
    a None in `saved` keeps the target's leaf. Structure, shape and dtype
    must agree."""
    if isinstance(target, dict):
        if not isinstance(saved, dict) or set(saved) != set(target):
            raise ValueError(f"{where}: keys differ from the checkpoint's")
        return {k: _copy_into(target[k], saved[k], f"{where}.{k}") for k in target}
    if isinstance(target, list):
        if not isinstance(saved, list) or len(saved) != len(target):
            raise ValueError(f"{where}: length differs from the checkpoint's")
        return [_copy_into(t, s, f"{where}[{i}]") for i, (t, s) in enumerate(zip(target, saved))]
    if saved is None:
        return target
    if isinstance(target, torch.Tensor):
        if not isinstance(saved, torch.Tensor) or saved.shape != target.shape or saved.dtype != target.dtype:
            raise ValueError(f"{where}: {getattr(saved, 'dtype', type(saved))} {list(getattr(saved, 'shape', []))} "
                             f"in the checkpoint, {target.dtype} {list(target.shape)} in the target")
        with torch.no_grad():
            target.copy_(saved)
        return target
    return saved


class CheckpointManager:
    """Checkpoints of one run under `<run_dir>/checkpoints/`, keeping the
    newest `keep` (0 keeps all)."""

    def __init__(self, run_dir, keep: int = 5):
        self.run_dir = Path(run_dir)
        self.ckpt_root = self.run_dir / "checkpoints"
        self.ckpt_root.mkdir(parents=True, exist_ok=True)
        self.keep = keep

    def _sorted(self):
        return sorted(self.ckpt_root.glob("step-*"), key=lambda p: parse_checkpoint_name(p.name)[0])

    def _enforce_retention(self) -> None:
        if not self.keep:
            return
        ckpts = self._sorted()
        for old in ckpts[: max(0, len(ckpts) - self.keep)]:
            shutil.rmtree(old, ignore_errors=True)

    def save(self, state: TrainState, step: int, epoch: int, loss: float,
             only_trainable_mask: Optional[Any] = None, data_state: Optional[Dict[str, Any]] = None,
             mesh=None) -> Path:
        """Save params, optimizer state and step (the frozen params dropped
        when `only_trainable_mask` is given), and with `data_state` the data
        stream's state (`data_state.pt`, read by `load_data_state`). Each
        file is written under a temporary name and renamed, the state last,
        so a checkpoint is whole or absent. With `mesh` every rank calls this
        and writes its blocks (`dcp/`) and its data stream's state; rank 0
        writes the marker after all ranks are done."""
        path = self.ckpt_root / checkpoint_name(step, epoch, loss)
        if mesh is not None:
            return self._save_sharded(path, state, only_trainable_mask, data_state, mesh)
        params = state.params if only_trainable_mask is None else _drop_frozen(state.params, only_trainable_mask)
        payload = {"step": int(state.step), "params": params, "opt_state": state.opt_state}
        if _rank() == 0:
            path.mkdir(parents=True, exist_ok=True)
            files = ([(DATA_STATE_FILE, data_state)] if data_state is not None else []) + [(STATE_FILE, payload)]
            for name, obj in files:
                tmp = path / (name + ".tmp")
                torch.save(obj, tmp)
                os.replace(tmp, path / name)
            (self.run_dir / "latest-checkpoint.txt").write_text(path.name)
            self._enforce_retention()
        return path

    def _save_sharded(self, path: Path, state: TrainState, keep_mask, data_state, mesh) -> Path:
        import torch.distributed as dist
        import torch.distributed.checkpoint as dcp

        if _rank() == 0:
            path.mkdir(parents=True, exist_ok=True)
        dist.barrier()
        dcp.save(_sharded_state(state, mesh, keep_mask), checkpoint_id=str(path / SHARDED_DIR))
        if data_state is not None:
            name = f"data_state-{_rank()}-of-{_world()}.pt"
            torch.save(data_state, path / (name + ".tmp"))
            os.replace(path / (name + ".tmp"), path / name)
        dist.barrier()
        if _rank() == 0:
            (self.run_dir / "latest-checkpoint.txt").write_text(path.name)
            self._enforce_retention()
        return path

    def restore(self, path, target_state: TrainState, mesh=None) -> TrainState:
        """The checkpoint's values copied into `target_state`'s tensors in
        place (their devices kept); leaves saved as None keep the target's.
        A sharded checkpoint (`dcp/`) restores into a target on `mesh` (this
        rank's blocks; any mesh size) or, without one, into whole tensors.
        Returns the target state."""
        if (Path(path) / SHARDED_DIR).exists():
            return self._restore_sharded(Path(path), target_state, mesh)
        if mesh is not None:
            raise ValueError(f"{path} holds a one-process checkpoint ({STATE_FILE}); restore it without a mesh")
        saved = torch.load(Path(path) / STATE_FILE, map_location="cpu", weights_only=True)
        target_state.params = _copy_into(target_state.params, saved["params"], "params")
        target_state.opt_state = _copy_into(target_state.opt_state, saved["opt_state"], "opt_state")
        target_state.step = int(saved["step"])
        return target_state

    @staticmethod
    def _restore_sharded(path: Path, target_state: TrainState, mesh) -> TrainState:
        import torch.distributed.checkpoint as dcp

        saved_keys = set(dcp.FileSystemReader(str(path / SHARDED_DIR)).read_metadata().state_dict_metadata)
        full = _sharded_state(target_state, mesh)
        sd = {k: v for k, v in full.items() if k in saved_keys}  # frozen leaves a LoRA run dropped keep the target's
        dcp.load(sd, checkpoint_id=str(path / SHARDED_DIR), no_dist=mesh is None)
        with torch.no_grad():
            for key, value in sd.items():
                target = full[key]
                if isinstance(value, torch.Tensor):
                    local = value.to_local() if hasattr(value, "to_local") else value
                    dest = target.to_local() if hasattr(target, "to_local") else target
                    if local.data_ptr() != dest.data_ptr():
                        dest.copy_(local)
                elif key == "step":
                    target_state.step = int(value)
                else:
                    _set_path(target_state.opt_state, key[len("opt_state/"):], value)
        return target_state

    @staticmethod
    def load_data_state(path) -> Optional[Dict[str, Any]]:
        """The data stream's state saved with the checkpoint at `path` (a
        mesh run's: this rank's, when the world size is the run's), or None
        if it holds none."""
        file = Path(path) / DATA_STATE_FILE
        if not file.exists():
            file = Path(path) / f"data_state-{_rank()}-of-{_world()}.pt"
        return torch.load(file, map_location="cpu", weights_only=True) if file.exists() else None

    def latest(self) -> Optional[Path]:
        marker = self.run_dir / "latest-checkpoint.txt"
        if marker.exists():
            p = self.ckpt_root / marker.read_text().strip()
            if p.exists():
                return p
        ckpts = self._sorted()
        return ckpts[-1] if ckpts else None


def _jsonable(obj):
    """numpy arrays / scalars and tensors -> lists / numbers (statistics
    trees carry arrays)."""
    import numpy as np

    if isinstance(obj, torch.Tensor):
        obj = obj.detach().cpu().numpy()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (np.floating, np.integer, np.bool_)):
        return obj.item()
    return str(obj)


def save_sidecars(run_dir, config: Dict[str, Any], dataset_statistics: Optional[Dict[str, Any]] = None) -> None:
    """config.json (with the int4 pack layout, the shard count included, so
    a resume can check it) and dataset_statistics.json in the run dir
    (reference train.py:133-138, 203-204)."""
    run_dir = Path(run_dir)
    run_dir.mkdir(parents=True, exist_ok=True)
    config = {**config, "int4_pack_layout": pack_layout_tag(config.get("int4_shards", 1))}
    with open(run_dir / "config.json", "w") as f:
        json.dump(config, f, indent=2, default=str)
    if dataset_statistics is not None:
        with open(run_dir / "dataset_statistics.json", "w") as f:
            json.dump(dataset_statistics, f, indent=2, default=_jsonable)


def load_dataset_statistics(path) -> Dict[str, Any]:
    """A dataset_statistics.json of either package or the reference (one
    schema, so published checkpoints' stats work)."""
    with open(path) as f:
        return json.load(f)


def validate_resume(checkpoint_path, resume_step: int, resume_epoch: int) -> None:
    """The checkpoint's name must carry the claimed step and epoch
    (AssertionError otherwise, as the JAX package and the reference), and a
    quantized-int4 run's recorded pack layout must be this build's
    (ValueError: restored packed weights would be permuted silently)."""
    step, epoch, _ = parse_checkpoint_name(Path(checkpoint_path).name)
    if step != resume_step:
        raise AssertionError(f"checkpoint step {step} != resume_step {resume_step}")
    if epoch != resume_epoch:
        raise AssertionError(f"checkpoint epoch {epoch} != resume_epoch {resume_epoch}")
    ckpt = Path(checkpoint_path)
    candidates = [ckpt.parent / "config.json", ckpt.parent.parent / "config.json"]
    cfg_file = next((c for c in candidates if c.exists()), None)
    if cfg_file is None:
        return
    with open(cfg_file) as f:
        run_cfg = json.load(f)
    recorded = run_cfg.get("int4_pack_layout")
    expected = pack_layout_tag(run_cfg.get("int4_shards", 1))
    quantized4 = run_cfg.get("use_quantization") and run_cfg.get("quantization_bits") == 4
    if quantized4 and recorded != expected:
        raise ValueError(
            f"checkpoint was written with int4 pack layout {recorded!r}, this build would read it as {expected!r} "
            "— re-quantize from the source checkpoint instead of resuming (restored packed weights would be "
            "permuted)."
        )
