"""VLA dataset wrappers: RLDS frame -> training example -> fixed-shape batch.

Counterpart of bridgelang_tpu/vla/datasets/datasets.py (`RLDSBatchTransform`,
`PaddedCollatorForActionPrediction`, `DummyDataset`), kept as the port's own
host-only copy. The transform emits raw uint8 frames and token ids; image
normalization runs on the device inside the train step. Action tokens are
appended numerically (prompt ids + [29871] + action ids + EOS), as in the
JAX package. `RLDSDataset` and `EpisodicRLDSDataset` read through the
port's TF-free pipeline (vla/datasets/rlds/dataset.py), from a `builder` per
dataset (by default the directory's layout picks it: a TFDS directory or a
native episode store, rlds/tfds_reader.open_builder);
`RLDSDataset` yields collated batches made in worker processes from one
frame stream, and saves and restores that stream's state.
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import multiprocessing
import queue
import traceback
import weakref
from functools import partial
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

from bridgelang_tpu_torch.models.llm.prompting import get_prompt_builder
from bridgelang_tpu_torch.models.vlm import IGNORE_INDEX, LLAMA_EMPTY_TOKEN
from bridgelang_tpu_torch.vla.action_tokenizer import ActionTokenizer

EOS_TOKEN_ID = 2  # Llama </s>


@dataclasses.dataclass
class RLDSBatchTransform:
    action_tokenizer: ActionTokenizer
    base_tokenizer: Any  # callable(str) -> ids (HF tokenizer or stand-in)
    llm_family: str = "llama2-pure"
    predict_stop_token: bool = True
    image_key: str = "image_primary"
    # Tokenize the current action plus the next chunk-1 as one flat span.
    action_chunk: int = 1

    def __call__(self, rlds_batch: Dict[str, Any]) -> Dict[str, Any]:
        """One RLDS frame -> {frames, input_ids, labels, dataset_name}."""
        dataset_name = _to_str(rlds_batch["dataset_name"])
        action = np.asarray(rlds_batch["action"])  # [window+future, dim]
        action = action[: self.action_chunk] if self.action_chunk > 1 else action[0]
        img = np.asarray(rlds_batch["observation"][self.image_key][0])
        lang = _to_str(rlds_batch["task"]["language_instruction"])

        builder = get_prompt_builder(self.llm_family)
        builder.add_turn("human", f"What action should the robot take to {lang.lower()}?")
        prompt_text = builder.get_prompt()

        prompt_ids = _encode(self.base_tokenizer, prompt_text)
        if prompt_ids[-1] != LLAMA_EMPTY_TOKEN:
            prompt_ids = np.concatenate([prompt_ids, [LLAMA_EMPTY_TOKEN]])
        action_ids = self.action_tokenizer.encode_to_ids(action).reshape(-1)
        input_ids = np.concatenate([prompt_ids, action_ids, [EOS_TOKEN_ID]]).astype(np.int32)

        # Loss only on the action tokens (+ EOS unless predict_stop_token is off).
        labels = np.full_like(input_ids, IGNORE_INDEX)
        labels[-(len(action_ids) + 1):] = input_ids[-(len(action_ids) + 1):]
        if not self.predict_stop_token:
            labels[-1] = IGNORE_INDEX

        return {"frames": img, "input_ids": input_ids, "labels": labels, "dataset_name": dataset_name}


def _to_str(x: Any) -> str:
    if isinstance(x, bytes):
        return x.decode("utf-8")
    if isinstance(x, np.ndarray):
        return _to_str(x.item() if x.ndim == 0 else x.flat[0])
    return str(x)


def _encode(tokenizer: Any, text: str) -> np.ndarray:
    if hasattr(tokenizer, "encode"):
        ids = tokenizer.encode(text)
    else:
        out = tokenizer(text)
        ids = out.input_ids if hasattr(out, "input_ids") else out["input_ids"]
    ids = np.asarray(ids)
    return ids[0] if ids.ndim > 1 else ids


@dataclasses.dataclass
class PaddedCollatorForActionPrediction:
    """Fixed-shape batch assembly: right-pad token ids and labels to
    `max_length`, stack uint8 frames, carry dataset names. Examples longer
    than `max_length` are dropped with a warning and their slots refilled
    from kept ones, so supervision stays complete and shapes static."""

    max_length: int = 64
    pad_token_id: int = 32000
    padding_side: str = "right"  # the fused-BOS layout requires right padding

    def __post_init__(self):
        assert self.padding_side == "right", "PrismaticVLM requires right padding"
        self._n_dropped = 0

    def __call__(self, examples: List[Dict[str, Any]]) -> Dict[str, Any]:
        kept = [ex for ex in examples if len(ex["input_ids"]) <= self.max_length]
        n_over = len(examples) - len(kept)
        if n_over:
            self._n_dropped += n_over
            if self._n_dropped <= 10 or self._n_dropped % 1000 == 0:
                logging.getLogger(__name__).warning(
                    "Dropped %d example(s) longer than max_length=%d (total dropped: %d) "
                    "— raise the collator max_length if this is common",
                    n_over, self.max_length, self._n_dropped,
                )
        if not kept:
            longest = max(len(ex["input_ids"]) for ex in examples)
            raise ValueError(
                f"every example in the batch exceeds max_length={self.max_length} "
                f"(longest: {longest}); raise the collator max_length"
            )
        examples = kept + [kept[i % len(kept)] for i in range(n_over)]

        b = len(examples)
        ids = np.full((b, self.max_length), self.pad_token_id, np.int32)
        labels = np.full((b, self.max_length), IGNORE_INDEX, np.int32)
        mask = np.zeros((b, self.max_length), np.int32)
        for i, ex in enumerate(examples):
            seq = ex["input_ids"]
            ids[i, : len(seq)] = seq
            labels[i, : len(seq)] = ex["labels"]
            mask[i, : len(seq)] = 1
        return {
            "input_ids": ids,
            "labels": labels,
            "attention_mask": mask,
            "frames": np.stack([ex["frames"] for ex in examples]),
            "dataset_names": [ex["dataset_name"] for ex in examples],
        }


class RLDSDataset:
    """Interleaved RLDS frames -> collated fixed-shape batches (JAX
    datasets.py:158-272), with the JAX constructor and augmentation kwargs.
    `builder_factory(name)` gives each dataset's builder; without one each
    `<data_root_dir>/<name>` is read by its layout (a TFDS directory or a
    native store: rlds/tfds_reader.open_builder). `seed` makes the
    frame order and the augmentation repeatable (None: fresh randomness per
    iteration). `data_shard` (count, index): read every count-th trajectory
    from the index-th, this rank's share on a mesh (the data rank, so that
    tensor peers read the same frames); None: the process group's world size
    and rank, when there is one.

    `batches(state)` yields the batches from the start, or from where a
    saved `state()` of an earlier iterator left off. One frame stream
    (dataset.FrameStream: read, interleave, shuffle buffer) runs in a reader
    process, whatever the number of workers, so the host holds one shuffle
    buffer; `num_workers` worker processes (None: half the host's cores, at
    most 4; started with `spawn`) make batch k, k + n, ... from its frames
    (resize, augmentation, batch transform, collator), off the training
    loop's interpreter (threads in this process slowed a 7B LoRA step by
    ~40 % on an 8-core host). With 0 the stream runs in this process and the
    batches are made as they are asked for. The processes need a picklable
    builder factory, batch transform and collator."""

    def __init__(
        self,
        data_root_dir: str,
        data_mix: str,
        batch_transform: RLDSBatchTransform,
        collator: PaddedCollatorForActionPrediction,
        batch_size: int,
        *,
        shuffle_buffer_size: int = 256_000,
        train: bool = True,
        image_aug: bool = False,
        resize_resolution: Tuple[int, int] = (224, 224),
        load_camera_views: Tuple[str, ...] = ("primary",),
        builder_factory: Optional[Callable[[str], Any]] = None,
        traj_transform_threads: Optional[int] = None,
        traj_read_threads: Optional[int] = None,
        future_action_window_size: int = 0,
        seed: Optional[int] = None,
        num_workers: Optional[int] = None,
        data_shard: Optional[Tuple[int, int]] = None,
    ):
        from bridgelang_tpu_torch.vla.datasets.rlds.dataset import make_interleaved_dataset
        from bridgelang_tpu_torch.vla.datasets.rlds.oxe.materialize import (
            get_oxe_dataset_kwargs_and_weights, resolve_mixture)

        self.batch_transform = batch_transform
        self.collator = collator
        self.batch_size = batch_size
        self.num_workers = num_workers

        per_dataset_kwargs, weights = get_oxe_dataset_kwargs_and_weights(
            data_root_dir, resolve_mixture(data_mix), load_camera_views=load_camera_views)
        for kw in per_dataset_kwargs:
            if builder_factory is not None:
                kw["builder"] = builder_factory(kw["name"])
            if data_shard is not None:
                kw["data_shard"] = data_shard

        frame_transform_kwargs: Dict[str, Any] = {"resize_size": resize_resolution}
        if image_aug:
            frame_transform_kwargs["image_augment_kwargs"] = {
                "random_resized_crop": {"scale": [0.9, 0.9], "ratio": [1.0, 1.0]},
                "random_brightness": [0.2],
                "random_contrast": [0.8, 1.2],
                "random_saturation": [0.8, 1.2],
                "random_hue": [0.05],
                "augment_order": ["random_resized_crop", "random_brightness", "random_contrast",
                                  "random_saturation", "random_hue"],
            }
        self.dataset = make_interleaved_dataset(
            per_dataset_kwargs,
            weights,
            train=train,
            shuffle_buffer_size=shuffle_buffer_size,
            traj_transform_kwargs={"window_size": 1, "future_action_window_size": future_action_window_size,
                                   "skip_unlabeled": True, "goal_relabeling_strategy": None},
            frame_transform_kwargs=frame_transform_kwargs,
            balance_weights=True,
            traj_transform_threads=traj_transform_threads,
            traj_read_threads=traj_read_threads,
            seed=seed,
        )
        self.dataset_statistics = self.dataset.dataset_statistics
        self.sample_weights = self.dataset.sample_weights
        self.true_length = self.dataset.true_length

    def batches(self, state: Optional[Dict[str, Any]] = None) -> "StreamBatches":
        """The batches from the start, or from where `state` (an earlier
        iterator's `state()`) left off."""
        from bridgelang_tpu_torch.vla.datasets.rlds.dataset import auto_workers

        n = auto_workers() if self.num_workers is None else self.num_workers
        return StreamBatches(self.dataset, self.batch_transform, self.collator, self.batch_size, state, n)

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        return self.batches()

    def __len__(self) -> int:
        if self.true_length is None:
            raise TypeError("Streaming dataset without known length")
        return self.true_length


def _make_batch(transform, batch_transform, collator, pairs) -> Dict[str, Any]:
    return collator([batch_transform(transform(p)) for p in pairs])


class StreamBatches:
    """Collated batches of an InterleavedFrames stream, made in this process
    (`n_workers` 0) or by a reader process and `n_workers` batch workers.
    `state(n)` is the stream's state after the first n batches this
    iterator gave (by default all of them): what a checkpoint saves.
    `close()` (also on garbage collection) stops the processes."""

    def __init__(self, frames, batch_transform, collator, batch_size: int, state: Optional[Dict[str, Any]],
                 n_workers: int):
        self._make = partial(_make_batch, frames.transform, batch_transform, collator)
        self.batch_size = batch_size
        self._state = frames.new_state(state)
        self._deltas: List[Dict[str, Any]] = []
        self._taken = self._applied = 0
        self._procs: List[Any] = []
        if n_workers == 0:
            self._stream = frames.stream(state)
            self._finalizer = None
            return
        ctx = multiprocessing.get_context("spawn")
        self._stop = ctx.Event()
        self._inboxes = [ctx.Queue(maxsize=2) for _ in range(n_workers)]  # held: a child unpickles them late
        self._outboxes = [ctx.Queue(maxsize=2) for _ in range(n_workers)]
        self._procs = [ctx.Process(target=_read_frames, args=(frames, state, batch_size, self._inboxes, self._stop),
                                   name="frame-reader", daemon=True)]
        self._procs += [ctx.Process(target=_make_batches, args=(self._make, inbox, outbox, self._stop),
                                    name=f"batch-worker-{i}", daemon=True)
                        for i, (inbox, outbox) in enumerate(zip(self._inboxes, self._outboxes))]
        for p in self._procs:
            p.start()
        self._finalizer = weakref.finalize(self, _stop_processes, self._stop, self._procs)

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, Any]:
        if not self._procs:
            batch = self._make([self._stream.next_pair() for _ in range(self.batch_size)])
            delta = self._stream.take_delta()
        else:
            batch, delta = self._receive(self._outboxes[self._taken % len(self._outboxes)])
        self._deltas.append(delta)
        self._taken += 1
        return batch

    def _receive(self, outbox):
        while True:
            try:
                item = outbox.get(timeout=1.0)
            except queue.Empty:
                dead = [p for p in self._procs if p.exitcode is not None]
                if dead:
                    raise RuntimeError(f"data process {dead[0].name} exited with code {dead[0].exitcode}")
                continue
            if isinstance(item, _Failure):
                raise RuntimeError(f"data process {item.where} failed:\n{item.trace}")
            return item

    def state(self, n_batches: Optional[int] = None) -> Dict[str, Any]:
        n = self._taken if n_batches is None else n_batches
        if not self._applied <= n <= self._taken:
            raise ValueError(f"state after {n} batches: {self._taken} taken, the state is past batch {self._applied}")
        for delta in self._deltas[: n - self._applied]:
            self._state.apply(delta)
        del self._deltas[: n - self._applied]
        self._applied = n
        return self._state.as_dict()

    def close(self) -> None:
        if self._finalizer is not None:
            self._finalizer()


@dataclasses.dataclass
class _Failure:
    where: str
    trace: str


def _put(q, item, stop) -> bool:
    while not stop.is_set():
        try:
            q.put(item, timeout=0.5)
            return True
        except queue.Full:
            continue
    return False


def _get(q, stop):
    while not stop.is_set():
        try:
            return q.get(timeout=0.5)
        except queue.Empty:
            continue
    return None


def _read_frames(frames, state, batch_size: int, inboxes, stop) -> None:
    """The reader process: the frame stream's pairs, batch k to worker k % n
    with the stream's delta after it."""
    k = 0
    try:
        stream = frames.stream(state)
        for k in itertools.count():
            pairs = [stream.next_pair() for _ in range(batch_size)]
            if not _put(inboxes[k % len(inboxes)], (pairs, stream.take_delta()), stop):
                break
    except BaseException:  # noqa: BLE001 (handed to the training process, by the worker of batch k first)
        failure = _Failure("frame-reader", traceback.format_exc())
        for i in range(len(inboxes)):
            _put(inboxes[(k + i) % len(inboxes)], failure, stop)
    for q in inboxes:
        q.cancel_join_thread()


def _make_batches(make, inbox, outbox, stop) -> None:
    """A batch worker: pairs -> a collated batch, the delta passed along."""
    try:
        while True:
            item = _get(inbox, stop)
            if item is None:
                break
            if isinstance(item, _Failure):
                _put(outbox, item, stop)
                break
            pairs, delta = item
            if not _put(outbox, (make(pairs), delta), stop):
                break
    except BaseException:  # noqa: BLE001 (handed to the training process)
        _put(outbox, _Failure(multiprocessing.current_process().name, traceback.format_exc()), stop)
    outbox.cancel_join_thread()


def _stop_processes(stop, procs) -> None:
    stop.set()
    for p in procs:
        p.join(timeout=5)
        if p.is_alive():
            p.terminate()
            p.join()


class EpisodicRLDSDataset:
    """Whole trajectories, one list of transformed frames each (JAX
    datasets.py:275-298); `builder` as for RLDSDataset. Encoded frames (a
    TFDS dataset's images) are decoded and not resized, as TFDS hands them
    to the JAX package."""

    def __init__(self, data_root_dir: str, dataset_name: str, batch_transform: RLDSBatchTransform,
                 train: bool = True, builder=None):
        from bridgelang_tpu_torch.vla.datasets.rlds.dataset import (
            apply_trajectory_transforms, make_dataset_from_rlds)
        from bridgelang_tpu_torch.vla.datasets.rlds.oxe.materialize import make_oxe_dataset_kwargs

        kwargs = make_oxe_dataset_kwargs(dataset_name, data_root_dir)
        kwargs.pop("chunk_filter_fn", None)
        if builder is not None:
            kwargs["builder"] = builder
        ds, self.dataset_statistics = make_dataset_from_rlds(train=train, **kwargs)
        self.dataset = apply_trajectory_transforms(ds, train=train, window_size=1)
        self.batch_transform = batch_transform

    def __iter__(self) -> Iterator[List[Dict[str, Any]]]:
        from bridgelang_tpu_torch.vla.datasets.rlds.dataset import frame_transform
        from bridgelang_tpu_torch.vla.datasets.rlds.traj_transforms import tree_map

        for traj in self.dataset:
            yield [self.batch_transform(frame_transform(tree_map(lambda x, i=i: x[i], traj), train=False))
                   for i in range(len(traj["action"]))]


class DummyDataset:
    """Synthetic VLA dataset: random 7-DoF actions and uint8 frames from
    `seed`, one fixed instruction. The fixture for end-to-end training runs."""

    def __init__(self, batch_transform: RLDSBatchTransform, n: int = 64, seed: int = 0,
                 image_hw: Tuple[int, int] = (224, 224)):
        self.batch_transform = batch_transform
        self.n = n
        self.rng = np.random.default_rng(seed)
        self.image_hw = image_hw

    def __len__(self) -> int:
        return self.n

    def __iter__(self):
        for _ in range(self.n):
            frame = {
                "dataset_name": "dummy_dataset",
                "action": self.rng.uniform(-1, 1, size=(1, 7)).astype(np.float32),
                "observation": {
                    "image_primary": self.rng.integers(0, 255, size=(1, *self.image_hw, 3), dtype=np.uint8)
                },
                "task": {"language_instruction": b"do something spectacular"},
            }
            yield self.batch_transform(frame)
