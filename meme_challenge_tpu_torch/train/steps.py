"""Train and eval steps.

Counterpart of ``meme_challenge_tpu/train/steps.py``. PyTorch runs eagerly,
so a "step" is a Python function over device tensors, not a compiled
program:

- :func:`make_train_step`: one optimizer step over an ``[accum, B, ...]``
  batch. Per micro-batch a backward, the gradients summed in micro order
  and divided by ``accum`` (reference train_template.py:89-109); or, with
  ``fuse_accum``, one forward and backward over the flattened ``[accum·B]``
  batch whose loss is the mean of the per-micro masked means. Losses and
  probabilities stay on the device: a step fetches nothing to the host.
- :func:`make_train_multi_step` runs ``--steps_per_dispatch`` steps as a
  plain loop (``--dispatch_unroll`` has nothing to unroll): the numbers are
  those of single steps, because every step's dropout generator is made
  from (seed, optimizer step) (``core/seeding.dropout_generator``).
- Host batches stay numpy until :func:`to_device`, the trainer boundary:
  tensors on the device there, ``img_feat`` still fp16 as stored (the model
  upcasts it).
- ``gather_micro`` assembles a micro-batch on the device from the whole
  dataset's device-resident arrays plus a batch of indices
  (``--device_resident_data``).
- :class:`EvalPipeline` keeps each batch's probabilities on the device and
  fetches them once per pass, or oldest-first beyond a window. CUDA runs a
  stream's work in order, so the JAX package's chain token is not needed.
- :func:`make_fold_train_step` is the same step over F folds at once (a
  ``models.uniter.FoldStack``, batches ``[F, accum, B, ...]``): the body of
  the JAX ``_train_step_body`` under ``vmap`` over folds, as the JAX
  fold-parallel trainer runs it. :func:`fold_gather` is its
  device-resident gather through each fold's local→global row table.

Each phase runs inside a named host range (``observability.span``):
``meme.step`` around a train step, holding ``meme.step.forward``,
``meme.step.backward`` and ``meme.step.optimizer``; ``meme.eval.forward``,
``meme.eval.fetch``, ``meme.loader.stack`` and ``meme.upload``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from meme_challenge_tpu_torch.core.seeding import dropout_generator
from meme_challenge_tpu_torch.train.observability import span

# batch keys the model reads; in eval everything else (ids, labels,
# sample_mask) stays on the host
MODEL_INPUT_KEYS = ("input_ids", "position_ids", "txt_mask", "img_feat",
                    "img_pos_feat", "img_mask")
# what a train step reads besides the model inputs (or the indices)
TRAIN_KEYS = ("labels", "sample_mask")


def to_device(arrays: Dict[str, np.ndarray], device,
              keys=MODEL_INPUT_KEYS) -> Dict[str, torch.Tensor]:
    """Numpy arrays of ``keys`` (those present) → tensors on ``device``,
    dtypes as stored."""
    with span("meme.upload"):
        return {k: torch.from_numpy(np.ascontiguousarray(arrays[k]))
                .to(device)
                for k in keys if k in arrays and arrays[k] is not None}


@dataclass
class TrainState:
    """The model (its parameters), the optimizer state and the optimizer
    steps taken (a host int)."""
    model: torch.nn.Module
    opt_state: dict
    step: int = 0


def create_train_state(model: torch.nn.Module, optimizer) -> TrainState:
    return TrainState(model, optimizer.init(dict(model.named_parameters())))


def make_train_step(model: torch.nn.Module, loss_fn: Callable, optimizer,
                    accum_steps: int = 1, gather_data: bool = False,
                    fuse_accum: bool = False):
    """One optimizer step: ``train_step(state, batch, generator, data=None)``
    → (state, {"loss": [accum], "probs": [accum, B(, C)]}).

    ``batch`` holds device tensors with leading ``[accum, B]`` dims: the
    model inputs (or ``indices`` with ``gather_data``, gathered from
    ``data`` by :func:`gather_micro`), ``labels`` and ``sample_mask``.
    ``loss_fn(logits, labels, sample_mask)`` → (loss, probs). Dropout draws
    from ``generator``; the parameters and ``state`` are updated in place.
    A zero-mask micro-batch (the padded end of an epoch) has loss 0 and adds
    zero gradients."""
    params = dict(model.named_parameters())

    def forward(batch, generator, data):
        if gather_data:
            batch = gather_micro(data, batch)
        return model(batch, deterministic=False, generator=generator), batch

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: torch.Generator,
                   data: Optional[Dict[str, torch.Tensor]] = None):
        with span("meme.step"):
            return _train_step(state, batch, generator, data)

    def _train_step(state, batch, generator, data):
        for p in params.values():
            p.grad = None
        if fuse_accum and accum_steps > 1:
            with span("meme.step.forward"):
                flat = {k: v.reshape((-1,) + tuple(v.shape[2:]))
                        for k, v in batch.items()}
                logits, flat = forward(flat, generator, data)
                logits = logits.reshape((accum_steps, -1)
                                        + tuple(logits.shape[1:]))
                labels = flat["labels"].reshape(accum_steps, -1)
                masks = flat["sample_mask"].reshape(accum_steps, -1)
                outs = [loss_fn(logits[a], labels[a], masks[a])
                        for a in range(accum_steps)]
                losses = torch.stack([o[0] for o in outs])
                total = losses.mean()
            with span("meme.step.backward"):
                total.backward()
            probs = torch.stack([o[1] for o in outs]).detach()
            losses = losses.detach()
        else:
            losses, probs = [], []
            for a in range(accum_steps):
                with span("meme.step.forward"):
                    micro = {k: v[a] for k, v in batch.items()}
                    logits, micro = forward(micro, generator, data)
                    loss, pr = loss_fn(logits, micro["labels"],
                                       micro["sample_mask"])
                with span("meme.step.backward"):
                    loss.backward()  # sums into .grad in micro order
                losses.append(loss.detach())
                probs.append(pr.detach())
            losses, probs = torch.stack(losses), torch.stack(probs)
        with span("meme.step.optimizer"):
            # a parameter the batch did not reach has a zero gradient, as
            # in JAX
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in params.values()]
            if accum_steps > 1 and not fuse_accum:
                grads = torch._foreach_div(grads, float(accum_steps))
            optimizer.step(params, dict(zip(params, grads)), state.opt_state)
            for p in params.values():
                p.grad = None
        state.step += 1
        return state, {"loss": losses, "probs": probs}

    return train_step


def fold_gather(data, batch: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
    """A fold-stacked micro-batch assembled ON DEVICE: ``data`` is
    ``(shared, table)``, the folds' union corpus ``{key: [N, ...]}`` and
    each fold's local→global row table ``[F, N_max]``; ``batch["indices"]``
    ``[F, ...]`` are rows of each fold's own dataset. Other keys of
    ``batch`` overlay the gathered arrays."""
    shared, table = data
    idx = batch["indices"].long()
    rows = torch.gather(table, 1, idx.reshape(idx.shape[0], -1)).reshape(-1)
    out = {k: v.index_select(0, rows).reshape(tuple(idx.shape)
                                               + tuple(v.shape[1:]))
           for k, v in shared.items()}
    for k, v in batch.items():
        if k != "indices":
            out[k] = v
    return out


def _sum_over(group, tensors: list) -> list:
    """The sum of each tensor over the ranks of ``group``, in one
    all-reduce of their concatenation."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    return [t.view_as(x) for t, x in
            zip(flat.split([x.numel() for x in tensors]), tensors)]


def make_fold_train_step(model, loss_fn: Callable, optimizer,
                         accum_steps: int = 1, gather_data: bool = False,
                         fuse_accum: bool = False, data_group=None):
    """One optimizer step of every fold of a ``FoldStack``:
    ``train_step(state, batch, generators, data=None)`` → (state,
    {"loss": [F, accum], "probs": [F, accum, B(, C)]}).

    ``batch`` holds device tensors ``[F, accum, B, ...]`` (with
    ``gather_data`` the fold-local ``indices``, gathered by
    :func:`fold_gather` from ``data``); fold f's dropout draws from
    ``generators[f]``. Per micro-batch one forward and backward of all
    folds (the folds' losses summed: no parameter is shared, so each fold
    gets its own gradient), the gradients divided by ``accum``; or with
    ``fuse_accum`` one forward and backward over ``[F, accum·B]``, each
    fold's loss the mean of its per-micro masked means, as
    :func:`make_train_step`. ``loss_fn`` keeps the leading axes
    (``losses.py``). The optimizer takes ``folds=F`` (per-fold clipping).

    ``data_group``: the ranks of a ``data`` mesh axis, each holding some rows
    of every micro-batch. Each fold's loss is then its rows' share of the
    whole micro-batch's masked mean (the denominator ``Σmask`` summed over
    the group), and the gradients and losses are summed over the group, so
    every rank steps as the one-process step does."""
    params = model.params
    folds = model.folds

    def forward(batch, generators, data):
        if gather_data:
            batch = fold_gather(data, batch)
        return model(batch, deterministic=False,
                     generators=generators), batch

    def loss_of(logits, labels, mask):
        if data_group is None:
            return loss_fn(logits, labels, mask)
        den = mask.float().sum(-1)
        dist.all_reduce(den, group=data_group)
        return loss_fn(logits, labels, mask, denominator=den)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   generators, data=None):
        with span("meme.step"):
            return _train_step(state, batch, generators, data)

    def _train_step(state, batch, generators, data):
        for p in params.values():
            p.grad = None
        if fuse_accum and accum_steps > 1:
            with span("meme.step.forward"):
                flat = {k: v.reshape((folds, -1) + tuple(v.shape[3:]))
                        for k, v in batch.items()}
                logits, flat = forward(flat, generators, data)
                logits = logits.reshape((folds, accum_steps, -1)
                                        + tuple(logits.shape[2:]))
                losses, probs = loss_of(
                    logits, flat["labels"].reshape(folds, accum_steps, -1),
                    flat["sample_mask"].reshape(folds, accum_steps, -1))
                total = losses.mean(dim=1).sum()
            with span("meme.step.backward"):
                total.backward()
            losses, probs = losses.detach(), probs.detach()
        else:
            losses, probs = [], []
            for a in range(accum_steps):
                with span("meme.step.forward"):
                    micro = {k: v[:, a] for k, v in batch.items()}
                    logits, micro = forward(micro, generators, data)
                    loss, pr = loss_of(logits, micro["labels"],
                                       micro["sample_mask"])
                    total = loss.sum()
                with span("meme.step.backward"):
                    total.backward()  # sums into .grad in micro order
                losses.append(loss.detach())
                probs.append(pr.detach())
            losses, probs = torch.stack(losses, 1), torch.stack(probs, 1)
        with span("meme.step.optimizer"):
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in params.values()]
            if data_group is not None:
                *grads, losses = _sum_over(data_group, grads + [losses])
            if accum_steps > 1 and not fuse_accum:
                grads = torch._foreach_div(grads, float(accum_steps))
            optimizer.step(params, dict(zip(params, grads)), state.opt_state)
            for p in params.values():
                p.grad = None
        state.step += 1
        return state, {"loss": losses, "probs": probs}

    return train_step


def make_train_multi_step(train_step: Callable, seed: int, device):
    """``steps_per_dispatch`` optimizer steps from one stacked chunk
    ``[K, accum, B, ...]``, as a plain loop of ``train_step``: step k draws
    its dropout from ``dropout_generator(seed, state.step)``, the generator
    a single step at that count gets, so chunked and unchunked training are
    equal. Returns (state, {"loss": [K, accum], "probs": [K, accum, ...]})."""

    def multi_step(state: TrainState, batches: Dict[str, torch.Tensor],
                   data: Optional[Dict[str, torch.Tensor]] = None):
        n = next(iter(batches.values())).shape[0]
        outs = []
        for i in range(n):
            gen = dropout_generator(seed, state.step, device)
            state, out = train_step(state, {k: v[i] for k, v in
                                            batches.items()}, gen, data)
            outs.append(out)
        return state, {k: torch.stack([o[k] for o in outs]) for k in outs[0]}

    return multi_step


def stack_for_accum(batches: list) -> Dict[str, np.ndarray]:
    """Stack ``accum`` host micro-batches into one [accum, ...] numpy batch
    (uploaded whole by :func:`to_device`)."""
    with span("meme.loader.stack"):
        return {key: np.stack([np.asarray(b[key]) for b in batches], axis=0)
                for key in batches[0]}


def stack_chunk(chunk: list) -> Dict[str, np.ndarray]:
    """Stack K per-step batches into the [K, ...] input of
    :func:`make_train_multi_step`."""
    return stack_for_accum(chunk)


def chunk_batches(stream, steps_per_dispatch: int):
    """Group a batch stream: ``("chunk", [K batches])`` for each full run
    and ``("single", batch)`` for the tail."""
    pending: list = []
    for item in stream:
        pending.append(item)
        if len(pending) == steps_per_dispatch:
            yield "chunk", pending
            pending = []
    for item in pending:
        yield "single", item


def gather_micro(data: Dict[str, torch.Tensor],
                 micro_batch: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
    """Assemble a micro-batch ON DEVICE from full-dataset arrays + indices.

    All non-``indices`` keys of the micro-batch overlay the gathered arrays.
    """
    idx = micro_batch["indices"].long()
    out = {k: v.index_select(0, idx) for k, v in data.items()}
    for k, v in micro_batch.items():
        if k != "indices":
            out[k] = v
    return out


def make_eval_step(model_apply_eval: Callable, probs_fn: Callable,
                   gather_data: bool = False):
    """Eval step: device batch → probabilities on the device.

    ``model_apply_eval(batch)`` → logits; ``probs_fn(logits)`` →
    probabilities (sigmoid / softmax per loss mode). ``gather_data=True``:
    the step takes ``data`` and the batch carries ``indices``
    (device-resident pipeline)."""

    def eval_step(batch, data=None):
        with span("meme.eval.forward"), torch.inference_mode():
            if gather_data:
                batch = gather_micro(data, batch)
            return probs_fn(model_apply_eval(batch))

    return eval_step


def sigmoid_probs(logits: torch.Tensor) -> torch.Tensor:
    """BCE heads: sigmoid of ``logits[:, 0]`` in fp32 (trainer.py:155-157)."""
    return torch.sigmoid(logits.reshape(logits.shape[0], -1)[:, 0].float())


def softmax_probs(logits: torch.Tensor) -> torch.Tensor:
    """CE heads: fp32 softmax over classes (trainer.py:153-154)."""
    return torch.softmax(logits.float(), dim=-1)


def fetch_all(pending: list) -> list:
    """Drain a pass's in-flight results at one host sync point."""
    with span("meme.eval.fetch"):
        return [p.cpu().numpy() for p in pending]


# in-flight depth for eval passes over HOST-BATCH loaders (each pending
# batch holds device work the host has raced ahead of); index-mode loaders
# upload a few hundred bytes a batch and stay unbounded
EVAL_INFLIGHT_WINDOW = 8


class EvalPipeline:
    """Eval results with a bounded in-flight window.

    ``add`` keeps one batch's device output; once more than ``window`` are
    in flight, the OLDEST is fetched. ``window=None`` disables the bound.
    ``results`` drains the tail and returns every output in add-order.
    """

    def __init__(self, window: Optional[int] = EVAL_INFLIGHT_WINDOW):
        self._window = window
        self._pending: list = []
        self._done: list = []

    def add(self, out: torch.Tensor) -> None:
        self._pending.append(out)
        if (self._window is not None
                and len(self._pending) > self._window):
            with span("meme.eval.fetch"):
                self._done.append(self._pending.pop(0).cpu().numpy())

    def results(self) -> list:
        return self._done + fetch_all(self._pending)
