"""Train and eval steps.

Counterpart of ``meme_challenge_tpu/train/steps.py``. PyTorch runs eagerly,
so a "step" is a Python function over device tensors, not a compiled
program; on a card the single-model train step is captured once as a CUDA
graph and replayed, the closest thing to JAX's compiled step:

- :func:`accumulate`: one optimizer step's device work over an
  ``[accum, B, ...]`` batch, for any forward and per-micro loss. Per
  micro-batch a backward, the gradients summed in micro order and divided
  by ``accum`` (reference train_template.py:89-109); or, with
  ``fuse_accum``, one forward and backward over the flattened ``[accum·B]``
  batch whose loss is the mean of the per-micro masked means. Losses and
  probabilities stay on the device: a step fetches nothing to the host.
  The fine-tune step (:func:`make_train_step`) and the pretraining step
  (``pretrain_driver.PretrainTrainer.step``) both run it.
- :func:`make_train_step`: the fine-tune step. Where :func:`step_captures`
  holds, each input signature (:func:`step_signature`) is captured once
  and replayed (:class:`_StepGraphs`; ``GRAPH_CAPTURES``, ``GRAPH_REPLAYS``
  count them): the host issues a few copies and one graph launch a step
  instead of thousands of kernel launches.
- :func:`steps_per_upload` steps share one upload (``--steps_per_dispatch``;
  ``--dispatch_unroll`` has nothing to unroll): the trainers group their
  host step batches (:func:`chunk_batches`), upload each group at once
  (:func:`upload_steps`) and run its steps one by one. The numbers are
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
``meme.step.backward`` and ``meme.step.optimizer`` (in an eager step, a
captured step's warm-up and its capture) or ``meme.step.replay`` (a
replay); ``meme.eval.forward``, ``meme.eval.fetch``, ``meme.loader.stack``
and ``meme.upload``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

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


def accumulate(params: Dict[str, torch.Tensor],
               batch: Dict[str, torch.Tensor], accum_steps: int,
               fuse_accum: bool, forward: Callable, loss: Callable,
               update: Callable):
    """One optimizer step's device work over an ``[accum, B, ...]`` batch,
    the body of every single-model train step. ``forward(batch)`` →
    (outputs, batch): a tuple of per-sample outputs and the batch as the
    loss reads it; ``loss(outputs, batch)`` → (loss, probs or None) of one
    micro-batch; ``update(grads)`` applies ``{name: gradient}``. A
    parameter the batch did not reach has a zero gradient, as in JAX.
    Returns (losses ``[accum]``, probs ``[accum, ...]`` or None)."""
    for p in params.values():
        p.grad = None
    if fuse_accum and accum_steps > 1:
        def micro(x, a):
            return x.reshape((accum_steps, -1) + tuple(x.shape[1:]))[a]

        with span("meme.step.forward"):
            outputs, flat = forward({k: v.reshape((-1,) + tuple(v.shape[2:]))
                                     for k, v in batch.items()})
            outs = [loss(tuple(micro(o, a) for o in outputs),
                         {k: micro(v, a) for k, v in flat.items()})
                    for a in range(accum_steps)]
            losses = torch.stack([o[0] for o in outs])
            total = losses.mean()
        with span("meme.step.backward"):
            total.backward()
        probs = [o[1] for o in outs]
        losses = losses.detach()
    else:
        losses, probs = [], []
        for a in range(accum_steps):
            with span("meme.step.forward"):
                outputs, micro_batch = forward({k: v[a]
                                                for k, v in batch.items()})
                micro_loss, pr = loss(outputs, micro_batch)
            with span("meme.step.backward"):
                micro_loss.backward()  # sums into .grad in micro order
            losses.append(micro_loss.detach())
            probs.append(pr)
        losses = torch.stack(losses)
    probs = None if probs[0] is None else torch.stack(probs).detach()
    with span("meme.step.optimizer"):
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params.values()]
        if accum_steps > 1 and not fuse_accum:
            # in place: the fresh .grad tensors are the step's own
            torch._foreach_div_(grads, float(accum_steps))
        update(dict(zip(params, grads)))
        for p in params.values():
            p.grad = None
    return losses, probs


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
    zero gradients.

    Where :func:`step_captures` holds (a card, no process group, the fused
    Adam / AdamW update, no recompute), the step is a CUDA graph: the first
    call of each :func:`step_signature` runs eagerly on a side stream and
    captures the step; later calls replay it (:class:`_StepGraphs`), with
    the eager step's numbers bit for bit. ``train_step.eager`` is the step
    without the graph."""
    params = dict(model.named_parameters())

    def loss(outputs, batch):
        return loss_fn(outputs[0], batch["labels"], batch["sample_mask"])

    def run(batch, generator, data, update):
        """The step's device work, ``update(grads)`` the optimizer's:
        (losses, probs)."""
        def forward(batch):
            if gather_data:
                batch = gather_micro(data, batch)
            return (model(batch, deterministic=False,
                          generator=generator),), batch

        return accumulate(params, batch, accum_steps, fuse_accum, forward,
                          loss, update)

    def eager(state: TrainState, batch: Dict[str, torch.Tensor],
              generator: torch.Generator,
              data: Optional[Dict[str, torch.Tensor]] = None):
        losses, probs = run(batch, generator, data, lambda grads:
                            optimizer.step(params, grads, state.opt_state))
        state.step += 1
        return state, {"loss": losses, "probs": probs}

    graphs = _StepGraphs(run, eager, params, optimizer,
                         (accum_steps, fuse_accum, gather_data))
    remat = any(getattr(getattr(m, "config", None), "remat", False)
                for m in model.modules())

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: torch.Generator,
                   data: Optional[Dict[str, torch.Tensor]] = None):
        with span("meme.step"):
            if step_captures(next(iter(params.values())).device, optimizer,
                             params, remat):
                return graphs(state, batch, generator, data)
            return eager(state, batch, generator, data)

    train_step.eager = eager
    return train_step


# CUDA graphs of make_train_step captured and replayed in this process
GRAPH_CAPTURES = 0
GRAPH_REPLAYS = 0


def step_captures(device: torch.device, optimizer, params,
                  remat: bool) -> bool:
    """Whether :func:`make_train_step`'s step on ``device`` is a CUDA graph:
    a card, no process group (a step under one talks to other ranks), the
    fused Adam / AdamW update (``Optimizer.fused``: the other routes pass
    each step's scalars to ``_foreach_*`` ops from the host), and a model
    none of whose modules recomputes its layers in the backward (``remat``:
    the recompute sets its generator's state on the host, which a capture
    does not record)."""
    return (device.type == "cuda"
            and not (dist.is_available() and dist.is_initialized())
            and not remat and optimizer.fused(params))


def step_signature(batch: Dict[str, torch.Tensor], accum_steps: int,
                   fuse_accum: bool, gather_data: bool,
                   data: Optional[Dict[str, torch.Tensor]] = None,
                   generator: Optional[torch.Generator] = None) -> tuple:
    """What one captured step serves: the batch's keys, shapes and dtypes,
    the accumulation and its mode, and, read in place by the graph, the
    device-resident dataset's tensors by address; with or without a
    generator."""
    return (tuple((k, tuple(v.shape), v.dtype)
                  for k, v in sorted(batch.items())),
            accum_steps, fuse_accum, gather_data,
            None if data is None else tuple(
                (k, v.data_ptr(), tuple(v.shape), v.stride(), v.dtype)
                for k, v in sorted(data.items())),
            generator is None)


def _launch_counts() -> tuple:
    """The port's kernel launch counters (``fused_adam.ADAM_LAUNCHES``,
    ``attention.LAUNCHES``, ``attention.ROUTE_LAUNCHES``,
    ``linear.LAUNCHES``) as they stand."""
    from meme_challenge_tpu_torch.ops import attention, fused_adam, linear

    return (fused_adam.ADAM_LAUNCHES, dict(attention.LAUNCHES),
            dict(attention.ROUTE_LAUNCHES), dict(linear.LAUNCHES))


def _launches_since(before: tuple) -> tuple:
    """The launches counted since :func:`_launch_counts` gave ``before``."""
    after = _launch_counts()
    return (after[0] - before[0],) + tuple(
        {k: n - was[k] for k, n in now.items()}
        for now, was in zip(after[1:], before[1:]))


def _add_launches(counts: tuple, sign: int = 1) -> None:
    """Add ``counts`` (from :func:`_launches_since`) to the counters,
    ``sign`` times."""
    from meme_challenge_tpu_torch.ops import attention, fused_adam, linear

    fused_adam.ADAM_LAUNCHES += sign * counts[0]
    for table, delta in zip((attention.LAUNCHES, attention.ROUTE_LAUNCHES,
                             linear.LAUNCHES), counts[1:]):
        for k, n in delta.items():
            table[k] += sign * n


@dataclass
class _Graph:
    """One captured step: its inputs, generator, update scalars and outputs
    (static tensors the replays read and write), and the kernel launches
    the capture recorded, counted again at each replay."""
    graph: object
    inputs: Dict[str, torch.Tensor]
    generator: Optional[torch.Generator]
    sched: torch.Tensor
    losses: torch.Tensor
    probs: torch.Tensor
    launches: tuple


class _StepGraphs:
    """The CUDA graphs of one :func:`make_train_step`, one a
    :func:`step_signature`.

    A new signature is captured once: its call copies the batch into static
    buffers, runs the step eagerly on a side stream (every lazy set-up
    happens outside the capture; this call's step), then captures the same
    step into a private memory pool, dropout from a generator registered
    with the graph and the update's scalars from a device buffer. A replay
    copies the batch into the buffers, writes the update's scalars
    (``Optimizer.prepare``), gives the graph's generator the state of
    ``generator`` and replays, all in stream order, so the host does not
    wait; the generator then takes the graph's advanced state, and the step
    returns copies of the losses and probabilities. The graphs read and
    write the parameters and the moments in place: when one of them moves
    (a resumed state), the graphs are dropped and captured again."""

    def __init__(self, run, eager, params, optimizer, mode):
        self.run, self.eager = run, eager
        self.params, self.optimizer, self.mode = params, optimizer, mode
        self.graphs: Dict[tuple, _Graph] = {}
        self.bound: tuple = ()
        self.stream = None

    def __call__(self, state, batch, generator, data):
        bound = tuple(t.data_ptr() for t in (
            *self.params.values(), *state.opt_state["mu"].values(),
            *state.opt_state["nu"].values()))
        if bound != self.bound:
            self.graphs.clear()
            self.bound = bound
        key = step_signature(batch, *self.mode, data, generator)
        g = self.graphs.get(key)
        if g is None:
            return self._capture(key, state, batch, generator, data)
        return self._replay(g, state, batch, generator)

    def _capture(self, key, state, batch, generator, data):
        global GRAPH_CAPTURES
        device = next(iter(self.params.values())).device
        main = torch.cuda.current_stream(device)
        if self.stream is None:
            self.stream = torch.cuda.Stream(device)
        inputs = {k: torch.empty_like(v, memory_format=torch.contiguous_format)
                  for k, v in batch.items()}
        for k, v in batch.items():
            inputs[k].copy_(v)
        gen = None
        if generator is not None:
            gen = torch.Generator(device)
            gen.set_state(generator.get_state())
        self.stream.wait_stream(main)
        with torch.cuda.stream(self.stream):
            state, out = self.eager(state, inputs, gen, data)
        for t in out.values():
            t.record_stream(main)
        main.wait_stream(self.stream)
        if generator is not None:
            generator.set_state(gen.get_state())

        graph = torch.cuda.CUDAGraph()
        if gen is not None:
            graph.register_generator_state(gen)
        sched = torch.empty(3, dtype=torch.float32, device=device)
        before = _launch_counts()
        with torch.cuda.graph(graph, stream=self.stream):
            losses, probs = self.run(
                inputs, gen, data, lambda grads: self.optimizer.update(
                    self.params, grads, state.opt_state, sched))
        launches = _launches_since(before)
        _add_launches(launches, -1)  # a capture launches nothing
        self.graphs[key] = _Graph(graph, inputs, gen, sched, losses, probs,
                                  launches)
        GRAPH_CAPTURES += 1
        return state, out

    def _replay(self, g: _Graph, state, batch, generator):
        global GRAPH_REPLAYS
        for k, v in batch.items():
            g.inputs[k].copy_(v)
        self.optimizer.prepare(self.params, state.opt_state, out=g.sched)
        if generator is not None:
            g.generator.set_state(generator.get_state())
        with span("meme.step.replay"):
            g.graph.replay()
        if generator is not None:
            generator.set_state(g.generator.get_state())
        state.opt_state["count"] += 1
        state.step += 1
        _add_launches(g.launches)
        GRAPH_REPLAYS += 1
        return state, {"loss": g.losses.clone(), "probs": g.probs.clone()}


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


def stack_for_accum(batches: list) -> Dict[str, np.ndarray]:
    """Stack ``accum`` host micro-batches into one [accum, ...] numpy batch
    (uploaded whole by :func:`to_device`)."""
    with span("meme.loader.stack"):
        return {key: np.stack([np.asarray(b[key]) for b in batches], axis=0)
                for key in batches[0]}


def steps_per_upload(config, index_batches: bool) -> int:
    """The optimizer steps that share one upload (``--steps_per_dispatch``;
    0 = auto: 8 when a step uploads indices, ``index_batches``, of a few
    hundred bytes, 1 when it uploads features)."""
    return config.steps_per_dispatch or (8 if index_batches else 1)


def chunk_batches(stream, steps: int):
    """Group a batch stream into lists of ``steps`` batches, the last list
    shorter when the stream runs out."""
    group: list = []
    for item in stream:
        group.append(item)
        if len(group) == steps:
            yield group
            group = []
    if group:
        yield group


def upload_steps(group: list, device, keys) -> list:
    """The device batches of a group of host step batches, uploaded at
    once: one batch by :func:`to_device`; more stacked into one
    ``[K, ...]`` array (:func:`stack_for_accum`), uploaded whole and
    returned as its K per-step views. Every step's numbers are those of an
    upload of its own."""
    if len(group) == 1:
        return [to_device(group[0], device, keys=keys)]
    batch = to_device(stack_for_accum(group), device, keys=keys)
    return [{k: v[i] for k, v in batch.items()} for i in range(len(group))]


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
