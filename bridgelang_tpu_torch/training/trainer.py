"""Trainer: optimizer, loss, metrics and the VLA train step.

Counterpart of bridgelang_tpu/training/trainer.py. The JAX step is one
jitted program; here it is an eager PyTorch step with the same parts in the
same order: bf16 (or `compute_dtype`) forward through the frozen base and the
trainable tensors, chunked-CE loss and action metrics, backward, global-norm
clip, AdamW update, with frames preprocessed on the device inside the step.

The optimizer follows optax's semantics, not torch.optim's:
`optax.chain(clip_by_global_norm(max_norm), adamw(schedule, b1, b2, eps=1e-8,
weight_decay, mask=ndim >= 2))` with the mask taken in the JAX layout
(decay_flags), optionally inside `optax.MultiSteps`. It keeps moments for
the trainable tensors only, and reads the learning rate schedule at its
0-based update count.

Parameters update IN PLACE (the JAX step returns new ones): a train step
changes the trainable tensors of `state.params` and the moments in
`state.opt_state`. Trainable tensors get `requires_grad`; frozen ones get no
gradient buffer.

On a mesh (`mesh`, a parallel/fsdp.MeshTraining) the same step runs on
every rank over its rows of the global batch: the state holds this rank's
blocks (FSDP) or whole tensors (ZeRO-2, data parallelism), each a tensor
block where the rules split a leaf over `tensor`, the forward gathers what
it reads over `fsdp` and runs the decoder tensor-parallel, the loss divides
by the global token count (the LM head's vocabulary blocks gathered per
chunk, so the loss and the argmax are the unsharded ones), the gradients
are summed over the data ranks (the adapters' also over `tensor`), the
global norm sums fp64 squares, and AdamW updates the local tensors.

Over a packed-int4 base (QLoRA) the frozen projections run through the int4
kernels (`matmul_int4`, with `w8a8` off) and their input gradient through a
transient dequantization. Under "dots" remat the int4 kernel's output is not
kept: its launch is no aten `mm`, so the backward recomputes it, as "full"
does.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import re
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from bridgelang_tpu_torch.models.llm.llama import lm_logits
from bridgelang_tpu_torch.models.vlm import IGNORE_INDEX, PrismaticVLM
from bridgelang_tpu_torch.ops.image_ops import preprocess_batch
from bridgelang_tpu_torch.util import profiling
from bridgelang_tpu_torch.vla.action_tokenizer import make_bins

Params = Any
CE_CHUNK = 128  # sequence chunk of the LM head in the loss: peak logits [B, 128, vocab]
# The device marks of a CUDA train step, and the times they give its train:step span.
STEP_MARKS = ("start", "forward", "backward", "optimizer")
STEP_TIMES = {"forward_ms": ("start", "forward"), "backward_ms": ("forward", "backward"),
              "optimizer_ms": ("backward", "optimizer")}


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    """Optimization hyperparameters (the JAX `OptimConfig`)."""

    learning_rate: float = 2e-5
    weight_decay: float = 0.0
    max_grad_norm: float = 1.0
    lr_scheduler_type: str = "constant"  # | "linear-warmup+cosine-decay"
    warmup_ratio: float = 0.03
    total_steps: int = 100_000
    b1: float = 0.9
    b2: float = 0.999


@dataclasses.dataclass
class TrainState:
    step: int
    params: Params
    opt_state: Dict[str, Any]


def make_lr_schedule(cfg: OptimConfig) -> Callable[[int], float]:
    """count (0-based update count) -> learning rate, with optax's
    constant_schedule / warmup_cosine_decay_schedule(0, lr, warmup,
    total_steps, 0) values."""
    if cfg.lr_scheduler_type == "constant":
        return lambda count: cfg.learning_rate
    if cfg.lr_scheduler_type == "linear-warmup+cosine-decay":
        warmup = max(1, int(cfg.total_steps * cfg.warmup_ratio))
        decay = cfg.total_steps - warmup

        def schedule(count: int) -> float:
            if count < warmup:
                return cfg.learning_rate * count / warmup
            t = min(count - warmup, decay)
            return cfg.learning_rate * 0.5 * (1.0 + math.cos(math.pi * t / decay))

        return schedule
    raise ValueError(f"Unknown lr scheduler {cfg.lr_scheduler_type!r}")


# --- parameter trees ---------------------------------------------------------------


def tree_leaves(tree) -> List[Any]:
    """Leaves of nested dicts / lists, in insertion order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def trainable_tensors(params: Params, trainable_mask: Optional[Params]) -> List[torch.Tensor]:
    """The tensors to train, in a fixed order: those the mask marks, or every
    floating-point tensor without a mask. Integer tensors (packed int4 and
    int8 weights) never train: a mask that marks one raises."""
    return [p for p, m in zip(tree_leaves(params), trainable_marks(params, trainable_mask)) if m]


def trainable_marks(params: Params, trainable_mask: Optional[Params]) -> List[bool]:
    """Per leaf (tree_leaves order): whether trainable_tensors takes it."""
    leaves = tree_leaves(params)
    if trainable_mask is None:
        return [p.is_floating_point() for p in leaves]
    flags = tree_leaves(trainable_mask)
    if len(flags) != len(leaves):
        raise ValueError(f"trainable_mask has {len(flags)} leaves, params {len(leaves)}")
    bad = [p for p, m in zip(leaves, flags) if m and not p.is_floating_point()]
    if bad:
        raise ValueError(f"trainable_mask marks {len(bad)} integer (quantized) tensors, which cannot train; "
                         "train adapters over a quantized base (training.lora.lora_trainable_mask)")
    return [bool(m) for m in flags]


# --- optimizer ---------------------------------------------------------------------


class AdamW:
    """Global-norm clip + AdamW (+ gradient accumulation) with optax's rules.

    * clip: scale by max_norm / norm only when norm >= max_norm (optax
      `clip_by_global_norm`; not clip_grad_norm_'s norm + 1e-6);
    * Adam: mu_hat / (sqrt(nu_hat) + eps), bias-corrected at count + 1;
    * decoupled decay wd * p on the tensors `decay` marks (decay_flags),
      added to the update before the learning rate scales it;
    * `grad_accum_steps` > 1: optax.MultiSteps; the running mean of the
      micro-batch gradients goes through clip + Adam on every k-th call, and
      the other calls leave the parameters and moments as they are.
    """

    def __init__(self, cfg: OptimConfig, decay: List[bool], grad_accum_steps: int = 1, eps: float = 1e-8):
        self.cfg = cfg
        self.schedule = make_lr_schedule(cfg)
        self.decay = decay
        self.k = grad_accum_steps
        self.eps = eps

    def init(self, params: List[torch.Tensor]) -> Dict[str, Any]:
        if len(params) != len(self.decay):
            raise ValueError(f"optimizer built for {len(self.decay)} tensors, got {len(params)}")
        zeros = lambda: [torch.zeros_like(p) for p in params]  # noqa: E731
        state = {"count": 0, "mu": zeros(), "nu": zeros(), "mini_step": 0}
        if self.k > 1:
            state["acc"] = zeros()
        return state

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor], state: Dict[str, Any], params: List[torch.Tensor],
               norm_fn: Callable[[List[torch.Tensor]], torch.Tensor] = None) -> None:
        """Apply one step IN PLACE to `params` and `state`; `grads` may be
        scaled in place by the clip. `norm_fn` is the clip's global norm
        (`global_norm`; on a mesh the one that sums every rank's blocks)."""
        grads = [g.to(p.dtype) for g, p in zip(grads, params)]
        if self.k > 1:
            n = state["mini_step"]
            acc = state["acc"]
            for a, g in zip(acc, grads):
                a.mul_(n).add_(g).div_(n + 1)  # running mean, as optax.MultiSteps
            if n < self.k - 1:
                state["mini_step"] = n + 1
                return
            state["mini_step"] = 0
            grads = [a.clone() for a in acc]
            for a in acc:
                a.zero_()
        cfg = self.cfg
        norm = (norm_fn or global_norm)(grads)
        scale = torch.where(norm < cfg.max_grad_norm, torch.ones_like(norm), cfg.max_grad_norm / norm)
        torch._foreach_mul_(grads, scale)
        mu, nu = state["mu"], state["nu"]
        torch._foreach_lerp_(mu, grads, 1.0 - cfg.b1)  # b1 * mu + (1 - b1) * g
        torch._foreach_mul_(nu, cfg.b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - cfg.b2)
        count = state["count"] + 1
        bc1, bc2 = 1.0 - cfg.b1 ** count, 1.0 - cfg.b2 ** count
        lr = self.schedule(state["count"])
        for p, m, v, wd in zip(params, mu, nu, self.decay):
            u = (m / bc1) / ((v / bc2).sqrt_() + self.eps)
            if wd and cfg.weight_decay:
                u.add_(p, alpha=cfg.weight_decay)
            p.add_(u, alpha=-lr)
        state["count"] = count


_VIT_BLOCK = re.compile(r"(^|\.)blocks\.\d+\.")


def decay_flags(params: Params) -> List[bool]:
    """Per leaf (tree_leaves order): whether AdamW decays it. The JAX package
    decays the leaves of rank >= 2 in its layout, where each layer stack (the
    LLM's `layers`, a ViT's `blocks`) is one tensor with a leading layer axis.
    So every per-layer tensor here decays, its norms and biases included, and
    any other tensor decays when ndim >= 2."""

    def walk(tree, stacked: bool) -> List[bool]:
        if isinstance(tree, dict):
            return [f for k, v in tree.items()
                    for f in walk(v, stacked or k == "layers" or _VIT_BLOCK.search(k) is not None)]
        if isinstance(tree, (list, tuple)):
            return [f for v in tree for f in walk(v, stacked)]
        return [stacked or tree.ndim >= 2]

    return walk(params, False)


def make_optimizer(cfg: OptimConfig, params: Params, trainable_mask: Optional[Params] = None,
                   grad_accum_steps: int = 1) -> AdamW:
    """AdamW over the trainable tensors only (frozen tensors get no moments),
    decaying those decay_flags marks."""
    marks = trainable_marks(params, trainable_mask)
    return AdamW(cfg, [d for d, m in zip(decay_flags(params), marks) if m], grad_accum_steps)


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of squares) over all tensors, as an fp32 scalar. The sums
    accumulate in fp64: torch's fp32 norm on the CPU drifts by ~5e-4
    relative over an LM head's 2M entries (XLA's, which optax uses, does
    not)."""
    norms = [torch.linalg.vector_norm(t, dtype=torch.float64) for t in tensors]
    return torch.linalg.vector_norm(torch.stack(norms)).float()


def init_train_state(params: Params, optimizer: AdamW, trainable_mask: Optional[Params] = None,
                     mesh=None) -> TrainState:
    """Marks the trainable tensors `requires_grad` and builds their moments
    (on a mesh, a parallel/fsdp.MeshTraining: `params` is what this rank
    keeps, `mesh.shard(whole params)`, and the moments are this rank's
    blocks). Raises on inference tensors (made under torch.inference_mode),
    which autograd cannot record."""
    bad = [i for i, p in enumerate(tree_leaves(params)) if p.is_inference()]
    if bad:
        raise ValueError(f"{len(bad)} parameter tensors are inference tensors; make them outside inference_mode")
    trainable = trainable_tensors(params, trainable_mask)
    for p in trainable:
        p.requires_grad_(True)
    if mesh is not None:
        trainable = mesh.optimizer_params(trainable, mesh.leaf_specs(trainable_marks(params, trainable_mask)))
    return TrainState(step=0, params=params, opt_state=optimizer.init(trainable))


# --- loss + metrics ----------------------------------------------------------------


def cross_entropy_ignore_index(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token CE over non-IGNORE positions, fp32."""
    shift_logits = logits[:, :-1].float()
    shift_labels = labels[:, 1:].long()
    valid = shift_labels != IGNORE_INDEX
    logp = torch.log_softmax(shift_logits, dim=-1)
    tok_lp = logp.gather(-1, shift_labels.clamp(min=0)[..., None])[..., 0]
    return -(tok_lp * valid).sum() / valid.sum().clamp(min=1)


def _action_stats(preds: torch.Tensor, gt: torch.Tensor, action_token_begin_idx: int, centers: torch.Tensor,
                  vocab_size: int):
    """Per-example (correct, count, l1 sum) over action-token targets."""
    a_mask = gt > action_token_begin_idx
    n = centers.shape[0]
    cont_pred = centers[torch.clamp(vocab_size - preds.long() - 1, 0, n - 1)]
    cont_gt = centers[torch.clamp(vocab_size - gt.long() - 1, 0, n - 1)]
    correct = ((preds == gt) & a_mask).sum(dim=1)
    l1 = ((cont_pred - cont_gt).abs() * a_mask).sum(dim=1)
    return correct, a_mask.sum(dim=1), l1


def _metrics(correct, count, l1) -> Dict[str, torch.Tensor]:
    denom = count.sum().clamp(min=1)
    ex_denom = count.clamp(min=1)
    return {
        "action_accuracy": correct.sum() / denom,
        "l1_loss": l1.sum() / denom,
        "per_example_accuracy": correct / ex_denom,
        "per_example_l1": l1 / ex_denom,
    }


def vla_metrics_on_device(logits: torch.Tensor, labels: torch.Tensor, action_token_begin_idx: int,
                          bin_centers, vocab_size: int) -> Dict[str, torch.Tensor]:
    """Action-token accuracy and continuous-action L1, overall and per example."""
    centers = torch.as_tensor(bin_centers, dtype=torch.float32, device=logits.device)
    preds = logits[:, :-1].argmax(dim=-1)
    return _metrics(*_action_stats(preds, labels[:, 1:], action_token_begin_idx, centers, vocab_size))


def _ce_chunk(llm_params, cfg_llm, hc, yc, action_token_begin_idx, centers):
    logits = lm_logits(llm_params, hc, cfg_llm).float()
    valid = yc != IGNORE_INDEX
    logp = torch.log_softmax(logits, dim=-1)
    tok_lp = logp.gather(-1, yc.clamp(min=0)[..., None])[..., 0]
    nll = -(tok_lp * valid).sum()
    preds = logits.argmax(dim=-1)
    return (nll, valid.sum(), *_action_stats(preds, yc, action_token_begin_idx, centers, cfg_llm.vocab_size))


def chunked_ce_and_metrics(llm_params: Params, cfg_llm, hidden: torch.Tensor, labels: torch.Tensor,
                           action_token_begin_idx: int, bin_centers, chunk: int = CE_CHUNK, mesh=None
                           ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Cross entropy + action metrics without the [B, F, vocab] logits: the
    LM head runs per sequence chunk under torch.utils.checkpoint, so the
    peak logits tensor is [B, chunk, vocab] in both passes. The same values
    as the dense path (fp32 log-softmax). On a mesh (rows of the global batch
    on each rank) the loss is this rank's NLL over the global token count,
    whose sum over the ranks is the global loss, and the metrics are the
    global batch's."""
    centers = torch.as_tensor(bin_centers, dtype=torch.float32, device=hidden.device)
    h, y = hidden[:, :-1], labels[:, 1:].long()
    t = h.shape[1]
    n = -(-t // chunk)
    h = F.pad(h, (0, 0, 0, n * chunk - t))
    y = F.pad(y, (0, n * chunk - t), value=IGNORE_INDEX)
    parts = [
        checkpoint(_ce_chunk, llm_params, cfg_llm, h[:, i * chunk:(i + 1) * chunk], y[:, i * chunk:(i + 1) * chunk],
                   action_token_begin_idx, centers, use_reentrant=False)
        for i in range(n)
    ]
    nll, count, correct, a_count, l1 = (torch.stack(x).sum(dim=0) for x in zip(*parts))
    if mesh is not None:
        count = mesh.sum_(count)
        correct, a_count, l1 = (mesh.concat_rows(x) for x in (correct, a_count, l1))
    return nll / count.clamp(min=1), _metrics(correct, a_count, l1)


# --- train step --------------------------------------------------------------------


def make_vla_train_step(
    model: PrismaticVLM,
    optimizer: AdamW,
    trainable_mask: Optional[Params] = None,
    n_action_bins: int = 256,
    compute_dtype: torch.dtype = torch.bfloat16,
    image_transform=None,
    remat: bool = True,
    remat_policy: Optional[str] = None,
    parallel_decode_objective: bool = False,
    mesh=None,
) -> Callable[[TrainState, Dict[str, torch.Tensor]], Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """The VLA train step. Batch keys (tensors on the model's device):
    input_ids, attention_mask, labels, and either normalized `pixel_values`
    or raw uint8 `frames` [B, H, W, 3], which `image_transform` turns into
    pixels on the device inside the step. fp32 tensors run cast to
    `compute_dtype`; gradients come back in the trainable tensors' dtype
    (fp32 adapters give fp32 gradients) for clip + update.

    `parallel_decode_objective` trains the parallel action objective
    (`PrismaticVLM.forward_hidden(parallel_actions=True)`): the fine-tuned
    model serves with `generate_parallel`. Loss and metrics are unchanged.

    The step updates `state` IN PLACE and returns it with the metrics:
    loss, grad_norm (before clipping), action_accuracy, l1_loss,
    per_example_accuracy, per_example_l1 (device tensors).

    `mesh` (a parallel/fsdp.MeshTraining): the step runs on this rank's
    rows of the global batch over the state `init_train_state(mesh=mesh)`
    made, the decoder on the mesh's tensor blocks (`MeshTraining.bind`);
    the metrics are the global batch's on every rank.

    Spans (util/profiling): `train:step` from entry to return (the step
    never waits for the card), with `train:forward` (cast, preprocessing,
    forward, chunked CE), `train:backward` (autograd.grad, and on a mesh the
    gradients' reduction) and `train:optimizer` (global norm, AdamW). On a
    card, device marks at the same boundaries give the step's span
    `STEP_TIMES` (ms) once the card has passed them, read at a later step's
    entry or by `profiling.spans`, never waited for."""
    _, bin_centers = make_bins(n_action_bins)
    if mesh is not None:
        model = mesh.bind(model)
    vocab_size = model.cfg.llm.vocab_size
    action_begin = vocab_size - (n_action_bins + 1)

    def cast(p):
        return p.to(compute_dtype) if p.dtype == torch.float32 else p

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        profiling.resolve()
        marks = profiling.DeviceMarks(STEP_MARKS) if batch["input_ids"].is_cuda else None
        with profiling.span("train:step") as rec, profiling.marking(marks):
            profiling.mark("start")
            with profiling.span("train:forward"):
                trainable = trainable_tensors(state.params, trainable_mask)
                if mesh is None:
                    compute_params = tree_map(cast, state.params)
                else:
                    specs = mesh.leaf_specs(trainable_marks(state.params, trainable_mask))
                    compute_params = mesh.compute_params(state.params, cast)
                if "pixel_values" in batch:
                    pixel_values = batch["pixel_values"]
                else:
                    if image_transform is None:
                        raise ValueError("raw frames need an image_transform")
                    pixel_values = preprocess_batch(batch["frames"], image_transform, dtype=compute_dtype)
                hidden, fused_labels = model.forward_hidden(
                    compute_params, batch["input_ids"], batch["attention_mask"], pixel_values, batch["labels"],
                    remat=remat, remat_policy=remat_policy, parallel_actions=parallel_decode_objective,
                )
                loss, metrics = chunked_ce_and_metrics(compute_params["llm"], model.cfg.llm, hidden, fused_labels,
                                                       action_begin, bin_centers, mesh=mesh)
            profiling.mark("forward")
            with profiling.span("train:backward"):
                grads = list(torch.autograd.grad(loss, trainable))
                if mesh is not None:
                    grads = mesh.sync_grads(grads, specs)
            profiling.mark("backward")
            with profiling.span("train:optimizer"):
                if mesh is None:
                    gnorm = global_norm(grads)
                    optimizer.update(grads, state.opt_state, trainable)
                else:
                    norm_fn = functools.partial(mesh.global_norm, specs=specs)
                    gnorm = norm_fn(grads)
                    optimizer.update(grads, state.opt_state, mesh.optimizer_params(trainable, specs), norm_fn)
                    mesh.after_update(trainable, specs)
                    loss = mesh.sum_(loss)
            profiling.mark("optimizer")
            state.step += 1
        if marks is not None:
            profiling.resolve_later(marks, rec, STEP_TIMES)
        return state, dict(metrics, loss=loss.detach(), grad_norm=gnorm)

    return train_step
