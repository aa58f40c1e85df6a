"""RLDS trajectory pipeline on the host, without TensorFlow: restructure ->
statistics -> normalize -> trajectory transforms -> frames -> weighted
interleave -> shuffle buffer -> frame transforms.

Counterpart of bridgelang_tpu/vla/datasets/rlds/dataset.py, which builds the
same stages on tf.data. A single dataset's stages are `Pipeline`s: re-iterable
lazy sequences of numpy dicts (`map`, `filter`, `repeat`, `flat_map`).
The mixture is a `FrameStream`: one reader's state machine over the
datasets' trajectories, the weighted draw and the shuffle buffer, whose
state (each dataset's cursor, the generators, the buffer as references to
frames) is saved with a checkpoint and restored by reading the buffer's
trajectories again, not the stream before them. Randomness comes from
generators seeded by `seed`: the mixture's draws, the shuffle, one
augmentation seed per frame drawn in order, and per trajectory a generator
for the random trajectory transforms. The frame transforms (resize,
augmentation) run where the batches are made, in `RLDSDataset`'s worker
processes.

Datasets are read through a `builder`: a callable taking a split ("train",
or "train[:N%]" when no validation split exists) and an optional `start`
(the split's first trajectory to read) and returning an iterator of
trajectory dicts. Without one, `<data_dir>/<name>` is opened by its layout
(`tfds_reader.open_builder`): a TFDS directory through
`tfds_reader.TfdsBuilder`, a native episode store through
`native_loader.NativeEpisodeBuilder`. The JAX signatures'
`num_parallel_reads` and `num_parallel_calls` are accepted and ignored: the
port's parallelism is `RLDSDataset`'s worker processes.
"""

from __future__ import annotations

import inspect
import itertools
import json
import os
from functools import partial
from typing import Any, Callable, Dict, Iterator, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from bridgelang_tpu_torch.vla.datasets.rlds import obs_transforms, tfds_reader, traj_transforms
from bridgelang_tpu_torch.vla.datasets.rlds.utils import goal_relabeling, task_augmentation
from bridgelang_tpu_torch.vla.datasets.rlds.utils.data_utils import (
    AUTOTUNE,
    NormalizationType,
    get_dataset_statistics,
    normalize_action_and_proprio,
    pprint_data_mixture,
)


def auto_workers() -> int:
    """Worker processes for AUTOTUNE: half the host's cores, at most 4 (a
    batch of 16 256x256 frames takes ~0.6 s of one core; a 7B LoRA step
    ~0.8 s), leaving the training loop a core."""
    return max(1, min(4, (os.cpu_count() or 2) // 2))


class Pipeline:
    """A re-iterable lazy sequence: iterating calls `make()` for a fresh
    iterator, so a stage can be read again (statistics, then training) or
    repeated forever."""

    def __init__(self, make: Callable[[], Iterator[Any]]):
        self._make = make

    def __iter__(self) -> Iterator[Any]:
        return iter(self._make())

    def map(self, fn: Callable[[Any], Any]) -> "Pipeline":
        return Pipeline(lambda: map(fn, self))

    def filter(self, fn: Callable[[Any], bool]) -> "Pipeline":
        return Pipeline(lambda: filter(fn, self))

    def flat_map(self, fn: Callable[[Any], Iterator[Any]]) -> "Pipeline":
        return Pipeline(lambda: itertools.chain.from_iterable(map(fn, self)))

    def repeat(self) -> "Pipeline":
        def forever():
            while True:
                empty = True
                for x in self:
                    empty = False
                    yield x
                if empty:
                    return

        return Pipeline(forever)


def _rng(seed: Optional[int], *salt: int) -> np.random.Generator:
    return np.random.default_rng(None if seed is None else [seed, *salt])


def _seeded_map(dataset: Pipeline, fn, seed: Optional[int], salt: int, **kwargs) -> Pipeline:
    """`fn(traj, rng=...)` over `dataset`, one generator per pass."""
    def run():
        rng = _rng(seed, salt)
        return (fn(t, rng=rng, **kwargs) for t in dataset)

    return Pipeline(run)


class RldsReader:
    """One dataset's split as canonical, normalized trajectories, read
    trajectory by trajectory: `trajectories(start)` reads this process's
    share of the split from its `start`-th trajectory on."""

    def __init__(self, builder, split: str, prepare: Callable[[Dict[str, Any]], Dict[str, Any]],
                 statistics: Dict[str, Any], n_proc: int = 1, proc_idx: int = 0):
        self.builder, self.split, self.prepare, self.statistics = builder, split, prepare, statistics
        self.n_proc, self.proc_idx = n_proc, proc_idx

    def trajectories(self, start: int = 0) -> Iterator[Dict[str, Any]]:
        first = self.proc_idx + start * self.n_proc
        raw = self.builder(self.split, start=first) if first else self.builder(self.split)
        return map(self.prepare, itertools.islice(raw, 0, None, self.n_proc))


def make_dataset_from_rlds(name: str, data_dir: Optional[str] = None, **kwargs) -> Tuple[Pipeline, Dict[str, Any]]:
    """One dataset as canonical trajectories (JAX dataset.py:44-236), and its
    statistics; the arguments are `rlds_reader`'s."""
    reader = rlds_reader(name, data_dir, **kwargs)
    return Pipeline(reader.trajectories), reader.statistics


def rlds_reader(
    name: str,
    data_dir: Optional[str] = None,
    *,
    train: bool,
    standardize_fn: Optional[Callable[[Dict[str, Any]], Dict[str, Any]]] = None,
    shuffle: bool = True,
    image_obs_keys: Mapping[str, Optional[str]] = None,
    depth_obs_keys: Mapping[str, Optional[str]] = None,
    proprio_obs_key: Optional[str] = None,
    state_obs_keys: Optional[Sequence[Optional[str]]] = None,
    language_key: Optional[str] = None,
    action_proprio_normalization_type: NormalizationType = NormalizationType.BOUNDS_Q99,
    dataset_statistics: Optional[Union[str, Dict[str, Any]]] = None,
    absolute_action_mask: Optional[Sequence[bool]] = None,
    action_normalization_mask: Optional[Sequence[bool]] = None,
    num_parallel_reads: int = AUTOTUNE,
    num_parallel_calls: int = AUTOTUNE,
    builder=None,
    shard_by_process: bool = True,
    data_shard: Optional[Tuple[int, int]] = None,
) -> RldsReader:
    """One dataset's trajectories, each

        {observation: {image_<new>, depth_<new>, proprio}, task: {language_instruction},
         action: float32 [T, D], dataset_name, absolute_action_mask}

    normalized with the dataset's statistics (loaded from a path or dict, or
    computed over the split with the sha256 cache). With several processes
    (torch.distributed), each reads every n-th trajectory; the statistics
    span them all. `data_shard` (n, index) names the share (a mesh's data
    ranks); without it a process group's world size and rank do. `shuffle` is accepted for the JAX signature: the builder
    reads in its own order."""
    image_obs_keys = image_obs_keys or {}
    depth_obs_keys = depth_obs_keys or {}
    if builder is None:
        builder = tfds_reader.open_builder(data_dir, name)
    if not callable(builder) or hasattr(builder, "as_dataset"):
        raise TypeError(f"{name}: a tensorflow_datasets builder cannot be read without TensorFlow; pass no builder "
                        "(the TFDS directory is read by tfds_reader) or a callable builder(split) -> trajectories")

    def restructure(traj: Dict[str, Any]) -> Dict[str, Any]:
        traj = dict(traj, observation=dict(traj["observation"]))
        if standardize_fn is not None:
            traj = standardize_fn(traj)
        traj_len = len(traj["action"])
        old_obs = traj["observation"]
        new_obs = {}
        for new, old in image_obs_keys.items():
            new_obs[f"image_{new}"] = np.repeat(b"", traj_len) if old is None else old_obs[old]
        for new, old in depth_obs_keys.items():
            new_obs[f"depth_{new}"] = np.repeat(b"", traj_len) if old is None else old_obs[old]
        if state_obs_keys:
            new_obs["proprio"] = np.concatenate(
                [np.zeros((traj_len, 1), np.float32) if key is None else np.asarray(old_obs[key], np.float32)
                 for key in state_obs_keys], axis=1)
        elif proprio_obs_key is not None:
            new_obs["proprio"] = np.asarray(old_obs[proprio_obs_key], np.float32)
        task = {}
        if language_key is not None:
            task["language_instruction"] = traj.pop(language_key)
        out = {
            "observation": new_obs,
            "task": task,
            "action": np.asarray(traj["action"], np.float32),
            "dataset_name": np.repeat(name.encode(), traj_len),
        }
        if absolute_action_mask is not None:
            out["absolute_action_mask"] = np.tile(np.asarray(absolute_action_mask, bool)[None], (traj_len, 1))
        return out

    split = "train" if train else ("val" if _has_split(builder, "val") else "train[:5%]")
    n_proc, proc_idx = 1, 0
    if shard_by_process and data_shard is not None:
        n_proc, proc_idx = data_shard
    elif shard_by_process and torch.distributed.is_available() and torch.distributed.is_initialized():
        n_proc, proc_idx = torch.distributed.get_world_size(), torch.distributed.get_rank()
    unsharded = Pipeline(lambda: builder(split)).map(restructure)
    if isinstance(dataset_statistics, str):
        with open(dataset_statistics) as f:
            dataset_statistics = json.load(f)
    elif dataset_statistics is None:
        deps = [
            name,
            str(split),
            inspect.getsource(standardize_fn) if standardize_fn is not None else "",
            str(proprio_obs_key),
            str(state_obs_keys),
        ]
        dataset_statistics = get_dataset_statistics(unsharded, hash_dependencies=deps)
    dataset_statistics = _tree_np(dataset_statistics)
    if action_normalization_mask is not None:
        dataset_statistics["action"]["mask"] = np.asarray(action_normalization_mask, dtype=bool)

    normalize = partial(normalize_action_and_proprio, metadata=dataset_statistics,
                        normalization_type=action_proprio_normalization_type)
    return RldsReader(builder, split, lambda traj: normalize(restructure(traj)), dataset_statistics, n_proc, proc_idx)


def _has_split(builder, split: str) -> bool:
    try:
        return split in builder.info.splits
    except Exception:
        return False


def _tree_np(stats: Any) -> Any:
    if isinstance(stats, dict):
        return {k: _tree_np(v) for k, v in stats.items()}
    if isinstance(stats, (list, tuple)):
        return np.asarray(stats)
    return stats


def apply_trajectory_transforms(
    dataset: Pipeline,
    *,
    train: bool,
    goal_relabeling_strategy: Optional[str] = None,
    goal_relabeling_kwargs: Optional[Dict[str, Any]] = None,
    window_size: int = 1,
    future_action_window_size: int = 0,
    subsample_length: Optional[int] = None,
    skip_unlabeled: bool = False,
    max_action: Optional[float] = None,
    max_proprio: Optional[float] = None,
    task_augment_strategy: Optional[str] = None,
    task_augment_kwargs: Optional[Dict[str, Any]] = None,
    num_parallel_calls: int = AUTOTUNE,
    seed: Optional[int] = None,
) -> Pipeline:
    """Filters and trajectory-level transforms (JAX dataset.py:256-312), the
    random ones drawing from one generator seeded by `seed`."""
    if skip_unlabeled:
        dataset = dataset.filter(
            lambda t: bool(np.any(traj_transforms.string_lengths(t["task"]["language_instruction"]) != 0)))
    if max_action is not None:
        dataset = dataset.filter(lambda t: bool(np.all(np.abs(t["action"]) <= max_action)))
    if max_proprio is not None:
        dataset = dataset.filter(lambda t: "proprio" not in t["observation"]
                                 or bool(np.all(np.abs(t["observation"]["proprio"]) <= max_proprio)))
    dataset = dataset.map(traj_transforms.add_pad_mask_dict)

    if goal_relabeling_strategy is not None:
        fn = goal_relabeling.GOAL_RELABELING_FUNCTIONS[goal_relabeling_strategy]
        dataset = _seeded_map(dataset, fn, seed, 1, **(goal_relabeling_kwargs or {}))
    if train and task_augment_strategy is not None:
        fn = task_augmentation.TASK_AUGMENT_FUNCTIONS[task_augment_strategy]
        dataset = _seeded_map(dataset, fn, seed, 2, **(task_augment_kwargs or {}))
    dataset = dataset.map(partial(traj_transforms.chunk_act_obs, window_size=window_size,
                                  future_action_window_size=future_action_window_size))
    if train and subsample_length is not None:
        dataset = _seeded_map(dataset, traj_transforms.subsample, seed, 3, subsample_length=subsample_length)
    return dataset


def _frames_of(traj: Dict[str, Any]) -> Iterator[Dict[str, Any]]:
    """A trajectory's frames, each array a copy: a view would keep the whole
    trajectory alive while one of its frames waits in the shuffle buffer."""
    def take(x, i):
        v = x[i]
        return v.copy() if isinstance(v, np.ndarray) else v

    for i in range(len(traj["action"])):
        yield traj_transforms.tree_map(lambda x, i=i: take(x, i), traj)


def flatten_to_frames(dataset: Pipeline, num_parallel_calls: int = AUTOTUNE) -> Pipeline:
    """Trajectories -> their frames, in order."""
    return dataset.flat_map(_frames_of)


def _map_window(fn, obs: Dict[str, Any]) -> Dict[str, Any]:
    """A per-image fn over the [window, ...] leading dim of the image_* and
    depth_* keys."""
    keys = [k for k in obs if k.startswith("image_") or k.startswith("depth_")]
    if not keys:
        return obs
    steps = [fn({k: obs[k][i] for k in keys}) for i in range(len(obs[keys[0]]))]
    out = dict(obs)
    for k in steps[0]:
        out[k] = np.stack([s[k] for s in steps], axis=0)
    return out


def frame_transform(frame: Dict[str, Any], *, train: bool, image_augment_kwargs=None, resize_size=None,
                    depth_resize_size=None, aug_seed: Optional[int] = None) -> Dict[str, Any]:
    """One frame: resize its images (and task images), then, when training
    with `image_augment_kwargs`, augment them with draws from a generator
    seeded by `aug_seed` (JAX dataset.py:335-366)."""
    frame = dict(frame)
    resize = partial(obs_transforms.decode_and_resize, resize_size=resize_size, depth_resize_size=depth_resize_size)
    frame["observation"] = _map_window(resize, frame["observation"])
    task = frame.get("task", {})
    if any(k.startswith("image_") for k in task):
        task_imgs = {k: v for k, v in task.items() if k.startswith("image_") or k.startswith("depth_")}
        frame["task"] = dict(task, **resize(task_imgs))
    if train and image_augment_kwargs:
        generator = torch.Generator().manual_seed(int(aug_seed))
        frame["observation"] = _map_window(
            partial(obs_transforms.augment, generator=generator, augment_kwargs=image_augment_kwargs),
            frame["observation"])
    return frame


def transform_pair(pair: Tuple[Dict[str, Any], int], **frame_transform_kwargs) -> Dict[str, Any]:
    """`frame_transform` of a stream's (frame, augmentation seed) pair."""
    frame, aug_seed = pair
    return frame_transform(frame, aug_seed=aug_seed, **frame_transform_kwargs)


def apply_frame_transforms(
    dataset: Pipeline,
    *,
    train: bool,
    image_augment_kwargs: Optional[Union[Dict, Mapping]] = None,
    resize_size: Optional[Union[Tuple[int, int], Dict[str, Tuple[int, int]]]] = None,
    depth_resize_size: Optional[Union[Tuple[int, int], Dict[str, Tuple[int, int]]]] = None,
    num_parallel_calls: int = AUTOTUNE,
    seed: Optional[int] = None,
) -> Pipeline:
    """Per-frame resize and augmentation, each frame's augmentation seed
    drawn in order from `seed`."""
    fn = partial(frame_transform, train=train, image_augment_kwargs=image_augment_kwargs,
                 resize_size=resize_size, depth_resize_size=depth_resize_size)

    def run():
        rng = _rng(seed, 4)
        return (fn(frame, aug_seed=int(rng.integers(2 ** 62))) for frame in dataset)

    return Pipeline(run)


def make_single_dataset(
    dataset_kwargs: Dict[str, Any],
    *,
    train: bool,
    traj_transform_kwargs: Optional[Dict[str, Any]] = None,
    frame_transform_kwargs: Optional[Dict[str, Any]] = None,
) -> Pipeline:
    """One dataset at the trajectory level (JAX dataset.py:427-441); the
    frame-level chunk filter does not apply here."""
    dataset_kwargs = {k: v for k, v in dataset_kwargs.items() if k != "chunk_filter_fn"}
    dataset, statistics = make_dataset_from_rlds(train=train, **dataset_kwargs)
    dataset = apply_trajectory_transforms(dataset, train=train, **(traj_transform_kwargs or {}))
    dataset.dataset_statistics = statistics
    return dataset


class _Source:
    """Dataset `index` of a mixture, one trajectory at a time: its reader,
    then the trajectory transforms, each trajectory's random ones drawing
    from a generator seeded by (seed, index, epoch, trajectory), so that a
    trajectory read again gives the same frames."""

    def __init__(self, index: int, kwargs: Dict[str, Any], *, train: bool,
                 traj_transform_kwargs: Optional[Dict[str, Any]], seed: Optional[int]):
        self.index, self.train, self.seed = index, train, seed
        self.chunk_filter_fn = kwargs.get("chunk_filter_fn")
        self.reader = rlds_reader(train=train, **{k: v for k, v in kwargs.items() if k != "chunk_filter_fn"})
        self.traj_transform_kwargs = traj_transform_kwargs or {}

    def frames(self, traj: Dict[str, Any], epoch: int, t: int) -> List[Dict[str, Any]]:
        seed = None
        if self.seed is not None:
            seed = int(np.random.SeedSequence([self.seed, self.index, epoch, t]).generate_state(1)[0])
        one = Pipeline(lambda: iter([traj]))
        frames = list(flatten_to_frames(apply_trajectory_transforms(one, train=self.train, seed=seed,
                                                                   **self.traj_transform_kwargs)))
        return [f for f in frames if self.chunk_filter_fn(f)] if self.chunk_filter_fn is not None else frames


class FrameStream:
    """The mixture's frames as (frame, augmentation seed) pairs, in order:
    each dataset's trajectories repeat epoch after epoch; each input frame
    comes from dataset i with probability weights[i]; a tf.data-style
    shuffle buffer of `buffer_size` frames emits a random slot and refills
    it; each emitted frame gets the next augmentation seed.

    Its state is each dataset's cursor (epoch, trajectory, frame of the next
    input), the three generators' states, and the buffer as references
    [dataset, epoch, trajectory, frame]. `take_delta()` gives what changed
    since its last call (the buffer slots written, the cursors, the
    generators); a `StreamState` adds the deltas up. A stream made with a
    state goes on exactly where that state left off: it reads the
    trajectories its buffer refers to, one at a time, not the stream that
    came before them."""

    def __init__(self, sources: Sequence[_Source], weights: Sequence[float], buffer_size: int,
                 seed: Optional[int], state: Optional[Dict[str, Any]] = None, names: Sequence[str] = ()):
        self.sources, self.p = list(sources), np.asarray(weights, np.float64)
        self.buffer_size = max(1, int(buffer_size))
        self.identity = {"datasets": list(names), "buffer_size": self.buffer_size, "seed": seed}
        self.rngs = {"mixture": _rng(seed, 5), "shuffle": _rng(seed, 6), "augment": _rng(seed, 4)}
        self.cursors = [[0, 0, 0] for _ in self.sources]
        self.buffer: List[Any] = []
        self.refs: List[Tuple[int, int, int, int]] = []
        self._journal: List[Tuple[int, Tuple[int, int, int, int]]] = []
        self._open: List[Any] = [None] * len(self.sources)  # (trajectory iterator, frames of the current one)
        self._epoch_frames = [0] * len(self.sources)
        if state is not None:
            self._restore(state)

    def _restore(self, state: Dict[str, Any]) -> None:
        saved = {k: state[k] for k in self.identity}
        if saved != self.identity:
            raise ValueError(f"the data state was saved for {saved}, this stream is {self.identity}")
        self.cursors = [[int(x) for x in c] for c in state["cursors"]]
        self._epoch_frames = [int(c[1] > 0 or c[2] > 0) for c in self.cursors]
        for name, rng in self.rngs.items():
            rng.bit_generator.state = state["rngs"][name]
        refs = np.asarray(state["refs"], np.int64).reshape(-1, 4)
        self.refs = [tuple(r) for r in refs.tolist()]
        self.buffer = [None] * len(refs)
        order = np.lexsort((refs[:, 3], refs[:, 2], refs[:, 1], refs[:, 0]))
        for (d, epoch, t), slots in itertools.groupby(order.tolist(), key=lambda s: self.refs[s][:3]):
            source = self.sources[d]
            frames = source.frames(next(source.reader.trajectories(start=t)), epoch, t)
            for s in slots:
                self.buffer[s] = frames[self.refs[s][3]]

    def _pull(self, d: int) -> Tuple[Tuple[int, int, int, int], Dict[str, Any]]:
        source, cursor = self.sources[d], self.cursors[d]
        while True:
            it, frames = self._open[d] or (None, None)
            if frames is None:
                if it is None:
                    it = source.reader.trajectories(start=cursor[1])
                traj = next(it, None)
                if traj is None:  # the split's end: the next epoch
                    if not self._epoch_frames[d]:
                        raise ValueError(f"dataset {self.identity['datasets'][d:d + 1]} yields no frame")
                    self.cursors[d] = cursor = [cursor[0] + 1, 0, 0]
                    self._open[d], self._epoch_frames[d] = None, 0
                    continue
                frames = source.frames(traj, cursor[0], cursor[1])
                self._open[d] = (it, frames)
            if cursor[2] < len(frames):
                ref = (d, *cursor)
                cursor[2] += 1
                self._epoch_frames[d] += 1
                return ref, frames[ref[3]]
            cursor[1], cursor[2] = cursor[1] + 1, 0
            self._open[d] = (it, None)

    def _next_input(self) -> Tuple[Tuple[int, int, int, int], Dict[str, Any]]:
        d = 0 if len(self.sources) == 1 else int(self.rngs["mixture"].choice(len(self.sources), p=self.p))
        return self._pull(d)

    def next_pair(self) -> Tuple[Dict[str, Any], int]:
        while len(self.buffer) < self.buffer_size:
            ref, frame = self._next_input()
            self._journal.append((len(self.buffer), ref))
            self.buffer.append(frame)
            self.refs.append(ref)
        ref, frame = self._next_input()
        i = int(self.rngs["shuffle"].integers(self.buffer_size)) if self.buffer_size > 1 else 0
        out, self.buffer[i], self.refs[i] = self.buffer[i], frame, ref
        self._journal.append((i, ref))
        return out, int(self.rngs["augment"].integers(2 ** 62))

    def take_delta(self) -> Dict[str, Any]:
        delta = {"slots": np.array([s for s, _ in self._journal], np.int64),
                 "refs": np.array([r for _, r in self._journal], np.int64).reshape(-1, 4),
                 "cursors": [list(c) for c in self.cursors],
                 "rngs": {name: rng.bit_generator.state for name, rng in self.rngs.items()}}
        self._journal = []
        return delta


class StreamState:
    """A FrameStream's state as its consumer knows it: the state it started
    from plus the deltas of the batches taken since. `as_dict()` is what a
    checkpoint saves (tensors, lists, numbers, strings: torch.load with
    weights_only reads it) and `FrameStream(..., state=)` continues from."""

    def __init__(self, identity: Dict[str, Any], state: Optional[Dict[str, Any]] = None):
        self.identity = identity
        self.refs = np.zeros((0, 4), np.int64) if state is None else np.array(state["refs"], np.int64).reshape(-1, 4)
        self.cursors = None if state is None else state["cursors"]
        self.rngs = None if state is None else state["rngs"]

    def apply(self, delta: Dict[str, Any]) -> None:
        slots = delta["slots"]
        if len(slots) and slots.max() >= len(self.refs):
            self.refs = np.concatenate([self.refs, np.zeros((slots.max() + 1 - len(self.refs), 4), np.int64)])
        self.refs[slots] = delta["refs"]
        self.cursors, self.rngs = delta["cursors"], delta["rngs"]

    def as_dict(self) -> Dict[str, Any]:
        return {**self.identity, "refs": torch.from_numpy(self.refs.copy()), "cursors": self.cursors,
                "rngs": self.rngs}


class InterleavedFrames:
    """A mixture as make_interleaved_dataset makes it: the datasets'
    statistics, the sample weights and the length, a `FrameStream` for each
    pass (`stream(state)`), and `transform`, the frame transform of the
    stream's pairs. Plain data, so that a process can take it and make its
    own stream. Iterating yields transformed frames (lists of `batch_size`
    of them with a batch size)."""

    def __init__(self, dataset_kwargs_list, sample_weights, *, train: bool, shuffle_buffer_size: int,
                 traj_transform_kwargs, frame_transform_kwargs, batch_size: Optional[int], seed: Optional[int],
                 dataset_statistics: Dict[str, Any], true_length: int):
        self.dataset_kwargs_list, self.sample_weights = dataset_kwargs_list, sample_weights
        self.train, self.shuffle_buffer_size, self.seed = train, shuffle_buffer_size, seed
        self.traj_transform_kwargs, self.batch_size = traj_transform_kwargs, batch_size
        self.dataset_statistics, self.true_length = dataset_statistics, true_length
        self.transform = partial(transform_pair, train=train, **{
            k: v for k, v in (frame_transform_kwargs or {}).items() if k != "num_parallel_calls"})

    @property
    def names(self) -> List[str]:
        return [kw["name"] for kw in self.dataset_kwargs_list]

    def stream(self, state: Optional[Dict[str, Any]] = None) -> FrameStream:
        sources = [_Source(i, dict(kw, dataset_statistics=self.dataset_statistics[kw["name"]]), train=self.train,
                           traj_transform_kwargs=self.traj_transform_kwargs, seed=self.seed)
                   for i, kw in enumerate(self.dataset_kwargs_list)]
        return FrameStream(sources, self.sample_weights, self.shuffle_buffer_size, self.seed, state, self.names)

    def new_state(self, state: Optional[Dict[str, Any]] = None) -> StreamState:
        return StreamState({"datasets": self.names, "buffer_size": max(1, int(self.shuffle_buffer_size)),
                            "seed": self.seed}, state)

    def __iter__(self) -> Iterator[Any]:
        stream = self.stream()
        frames = (self.transform(stream.next_pair()) for _ in itertools.count())
        return frames if self.batch_size is None else _batched(frames, self.batch_size)


def make_interleaved_dataset(
    dataset_kwargs_list: List[Dict[str, Any]],
    sample_weights: Optional[Sequence[float]] = None,
    *,
    train: bool,
    shuffle_buffer_size: int,
    traj_transform_kwargs: Optional[Dict[str, Any]] = None,
    frame_transform_kwargs: Optional[Dict[str, Any]] = None,
    balance_weights: bool = False,
    traj_transform_threads: Optional[int] = None,
    traj_read_threads: Optional[int] = None,
    batch_size: Optional[int] = None,
    seed: Optional[int] = None,
) -> InterleavedFrames:
    """Weighted mixture of datasets (JAX dataset.py:457-533): per-dataset
    trajectory pipelines -> frames -> repeat -> weighted sampling -> shuffle
    buffer -> frame transforms -> optional batches (lists of frames).
    Attributes: dataset_statistics (per dataset), sample_weights (normalized,
    balanced by frame counts with `balance_weights`), true_length (frames
    before the most-weighted dataset repeats). The JAX thread counts
    (`traj_transform_threads`, `traj_read_threads`) must stay None: the
    port's parallelism is RLDSDataset's worker processes."""
    if traj_transform_threads is not None or traj_read_threads is not None:
        raise ValueError("traj_transform_threads / traj_read_threads: the port reads with one process per stream "
                         "and transforms in RLDSDataset's worker processes (num_workers)")
    sample_weights = list(sample_weights) if sample_weights else [1.0] * len(dataset_kwargs_list)
    assert len(sample_weights) == len(dataset_kwargs_list)

    all_statistics, lengths = {}, []
    for kwargs in dataset_kwargs_list:
        _, stats = make_dataset_from_rlds(train=train, **{k: v for k, v in kwargs.items() if k != "chunk_filter_fn"})
        all_statistics[kwargs["name"]] = stats
        lengths.append(int(stats["num_transitions"]))
    if balance_weights:
        sample_weights = list(np.asarray(sample_weights) * np.asarray(lengths))
    total = sum(sample_weights)
    sample_weights = [w / total for w in sample_weights]
    dataset_len = int(min(length / weight for length, weight in zip(lengths, sample_weights) if weight > 0))

    frames = InterleavedFrames(
        dataset_kwargs_list, sample_weights, train=train, shuffle_buffer_size=shuffle_buffer_size,
        traj_transform_kwargs=traj_transform_kwargs, frame_transform_kwargs=frame_transform_kwargs,
        batch_size=batch_size, seed=seed, dataset_statistics=all_statistics, true_length=dataset_len)
    print(pprint_data_mixture(dataset_kwargs_list, sample_weights))
    return frames


def _batched(it: Iterator[Any], n: int) -> Iterator[List[Any]]:
    while True:
        chunk = list(itertools.islice(it, n))
        if len(chunk) < n:
            return
        yield chunk
