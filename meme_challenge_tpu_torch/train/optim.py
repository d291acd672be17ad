"""Optimizer: the JAX package's optax chain, written out over a dict of
parameters.

Counterpart of ``meme_challenge_tpu/train/optim.py`` (reference
utils/optim_utils.py). The chain, in order:

    clip_by_global_norm → [decay, adam] | [decay, adamax] | [adam, decay]
    | [decay, trace] → scale_updates_by_tree → −lr·schedule(count)

- torch ``Adam``/``Adamax``/``SGD`` weight decay is L2 into the gradient
  (decay before the moment transform); ``adamw`` decays after it. Biases
  and LayerNorm weights get no decay (:func:`no_decay_mask`).
- It is not built from ``torch.optim`` or ``clip_grad_norm_``, which differ
  from optax: ``clip_grad_norm_`` divides by ``norm + 1e-6`` (optax:
  ``g / norm · max_norm``, and only when ``norm >= max_norm``);
  ``torch.optim.Adamax`` adds eps elsewhere (optax: ``max(|g| + eps, b2·nu)``);
  and optax evaluates the schedule at the count *before* the increment, so
  warmup gives LR 0 on the first update.
- Adam moments: fp32 math, storage in ``mu_dtype`` / ``nu_dtype``
  (``scale_by_adam_storage``; ``TrainConfig`` defaults both to bf16). With
  a bf16 ``mu`` and an fp32 ``nu`` optax rounds ``b1·mu`` to bf16 before the
  sum; here that product is fp32 too, a difference of one bf16 rounding.
- The step count lives on the host as an int (it advances once per update
  whatever the data), so bias corrections and the schedule are numpy
  float32 scalars and an update issues no host sync. The fused route reads
  them from the device (:meth:`Optimizer.prepare`), so that a CUDA graph of
  the update replays with each step's values.

Two routes, chosen by :meth:`Optimizer.fused` from the optimizer's own
arguments and the parameters' device and dtype. They share the clip's
factors, the bias corrections and the step size, and nothing of the update:

- ``adam`` / ``adamw`` of one model (``folds=0``, no ``split``) over fp32
  parameters with fp32 or bf16 moments: one hand-written update of every
  leaf, in place (``ops/fused_adam.py``, ``ops/csrc/fused_adam.cu``; its plain
  PyTorch version on the CPU). It is the chain below computed element by
  element in the chain's order, bit for bit. Only the clip's norm stays a
  handful of torch ops.
- everything else (``adamax``, ``sgd``, ``folds=F``, a ``split``):
  :meth:`Optimizer.chain_step`, the ``torch._foreach_*`` ops, one launch per
  operation over all parameters rather than one per parameter.

With ``folds=F`` every parameter carries a leading fold axis ``[F, ...]``
(the fold-parallel trainer's stacked state) and the chain is the optax
chain under JAX's ``vmap`` over folds: the global-norm clip takes one norm
a fold and scales each fold by its own trigger. Everything else is
elementwise, and the folds step in lockstep, so one count serves them all.
Where a ``model`` mesh axis splits some parameters over its ranks
(``split=(names, group)``), their squared sums are added over the group
and every other parameter, whole on each rank, is counted once.
"""
from __future__ import annotations

import re
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from meme_challenge_tpu_torch.ops import fused_adam

_F = np.float32

_NO_DECAY_SUFFIXES = ("bias", "LayerNorm.weight", "img_layer_norm.weight",
                      "pos_layer_norm.weight",
                      # the LayerNorm scales of the pretraining heads
                      # (JAX ``net_ln_scale``; the reference's net.2)
                      "feat_regress.net.2.weight",
                      "region_classifier.net.2.weight")


# the text models' head LayerNorms (flax ``nn.LayerNorm`` ``scale`` in JAX)
# and the RMSNorm scales of the DeepSeek-V3 decoder (models/moe_mla.py)
_HEAD_LN = re.compile(r"(?:^|\.)(?:head_ln_\d+|input_layernorm|"
                      r"post_attention_layernorm|kv_a_layernorm|"
                      r"backbone\.norm)\.weight$")


def no_decay_mask(names) -> Dict[str, bool]:
    """True = apply weight decay. Every ``*bias``, every ``LayerNorm.weight``,
    the image and position LayerNorm weights, the pretraining heads' and the
    text models' head LayerNorm weights and the decoder's RMSNorm scales
    are excluded (reference
    optim_utils.py:16; the JAX package's ``*bias`` / ``*ln_scale`` /
    ``scale`` names);
    ``mask_embedding`` and every matrix and embedding table decay."""
    return {n: not (n.endswith(_NO_DECAY_SUFFIXES) or _HEAD_LN.search(n))
            for n in names}


_LAYER = re.compile(r"(?:^|\.)(?:encoder\.layer|layers)\.(\d+)\.")


def layer_freeze_scales(names, num_layers_freeze: int) -> Dict[str, float]:
    """Per-parameter update scale freezing the first ``num_layers_freeze``
    encoder layers (scale 0), as the JAX package's ``[L, ...]`` mask over
    its stacked layer axis (reference train_pure_text.py:27-32)."""
    out = {}
    for n in names:
        m = _LAYER.search(n)
        out[n] = 0.0 if m and int(m.group(1)) < num_layers_freeze else 1.0
    return out


def head_lr_scales(names, base_lr: float, head_lr: float,
                   head_predicate: Callable[[str], bool]) -> Dict[str, float]:
    """Two-LR grouping: parameters whose name matches ``head_predicate``
    train at ``head_lr`` (reference group_param_func,
    train_pure_text.py:53-58)."""
    rel = head_lr / base_lr
    return {n: rel if head_predicate(n) else 1.0 for n in names}


def _dtype(d) -> Optional[torch.dtype]:
    """A storage dtype from a torch dtype or its name; None (the
    parameter's own dtype) for None or "float32"."""
    if d is None or d == "float32" or d == torch.float32:
        return None
    return getattr(torch, d) if isinstance(d, str) else d


def _fold_scalar(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Per-fold scalars ``[F]`` shaped to broadcast against ``x [F, ...]``."""
    return v.reshape((-1,) + (1,) * (x.dim() - 1))


def _add(xs, ys):
    return torch._foreach_add(xs, ys)


def _mul(xs, c):
    return torch._foreach_mul(xs, c)


class Optimizer:
    """``init(params)`` → state; ``step(params, grads, state)`` updates the
    parameters and the state in place. ``params`` and ``grads`` are dicts
    name → tensor."""

    def __init__(self, name: str, lr: float, schedule_fn: Callable, *,
                 beta1: float = 0.9, beta2: float = 0.999,
                 weight_decay: float = 0.0,
                 max_grad_norm: Optional[float] = None, eps: float = 1e-8,
                 update_scales: Optional[Dict[str, object]] = None,
                 mu_dtype=None, nu_dtype=None, folds: int = 0,
                 split=None):
        if name not in ("adam", "adamax", "adamw", "sgd"):
            raise ValueError("invalid optimizer")
        self.name, self.lr, self.schedule = name, lr, schedule_fn
        self.beta1, self.beta2 = beta1, beta2
        self.weight_decay, self.max_grad_norm, self.eps = (
            weight_decay, max_grad_norm, eps)
        self.update_scales = update_scales
        self.mu_dtype, self.nu_dtype = _dtype(mu_dtype), _dtype(nu_dtype)
        self.folds = folds
        self.split = split
        self._leaves = None  # (names, decay flags, update scales), per names

    def init(self, params: Dict[str, torch.Tensor]) -> dict:
        def zeros(dtype):
            return {n: torch.zeros_like(p, dtype=dtype or p.dtype)
                    for n, p in params.items()}

        state = {"count": 0}
        if self.name in ("adam", "adamw"):
            state.update(mu=zeros(self.mu_dtype), nu=zeros(self.nu_dtype))
        elif self.name == "adamax":
            state.update(mu=zeros(None), nu=zeros(None))
        elif self.beta1:
            state.update(trace=zeros(None))
        return state

    # -------------------------------------------------------- the transforms

    def _clip(self, g, names):
        """optax.clip_by_global_norm: g unchanged below ``max_grad_norm``,
        else ``g / norm · max_norm``; no host sync. With folds, one norm and
        one trigger a fold."""
        div, mul = self._clip_factors(g, names)
        if not self.folds:
            return _mul(torch._foreach_div(g, div), mul)
        div = [_fold_scalar(div, x) for x in g]
        mul = [_fold_scalar(mul, x) for x in g]
        return torch._foreach_mul(torch._foreach_div(g, div), mul)

    def _clip_factors(self, g, names):
        """The clip's ``(div, mul)`` on the device: ``(1, 1)`` below
        ``max_grad_norm``, else ``(norm, max_norm)``; one of each a fold."""
        if not self.folds:
            norm = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(g)))
        else:
            # every fold's slice of every tensor in one foreach call; with
            # a model split, the split tensors first
            cut = ([] if self.split is None else
                   [i for i, n in enumerate(names) if n in self.split[0]])
            order = cut + [i for i in range(len(g)) if i not in set(cut)]
            norms = torch.stack(torch._foreach_norm(
                [g[i][f] for i in order for f in range(self.folds)])).reshape(
                    len(g), self.folds)
            if self.split is None:
                norm = torch.linalg.vector_norm(norms, dim=0)
            else:
                sq = norms.square()
                part = sq[:len(cut)].sum(0)
                dist.all_reduce(part, group=self.split[1])
                norm = torch.sqrt(sq[len(cut):].sum(0) + part)
        trigger = norm < self.max_grad_norm
        one = torch.ones_like(norm)
        return (torch.where(trigger, one, norm),
                torch.where(trigger, one, one * self.max_grad_norm))

    def _decay(self, u, p, names):
        if not self.weight_decay:
            return u
        mask = no_decay_mask(names)
        idx = [i for i, n in enumerate(names) if mask[n]]
        decayed = _add([u[i] for i in idx],
                       _mul([p[i] for i in idx], self.weight_decay))
        u = list(u)
        for i, d in zip(idx, decayed):
            u[i] = d
        return u

    def _corrections(self, count):
        """Adam's bias corrections ``1 − b**count``, in float32."""
        return (float(_F(1.0) - _F(self.beta1) ** _F(count)),
                float(_F(1.0) - _F(self.beta2) ** _F(count)))

    def _step_size(self, count):
        """optax.scale_by_learning_rate: −lr·schedule at the count before
        the increment, in float32."""
        return float(-(_F(self.lr) * _F(self.schedule(count))))

    def _adam(self, g, state, names, count):
        b1, b2 = self.beta1, self.beta2
        c1, c2 = self._corrections(count)
        mu = [state["mu"][n].float() for n in names]
        nu = [state["nu"][n].float() for n in names]
        mu = _add(_mul(mu, b1), _mul(g, 1.0 - b1))
        nu = _add(_mul(nu, b2), _mul(torch._foreach_mul(g, g), 1.0 - b2))
        den = torch._foreach_add(
            torch._foreach_sqrt(torch._foreach_div(nu, c2)), self.eps)
        u = torch._foreach_div(torch._foreach_div(mu, c1), den)
        self._store(state["mu"], names, mu)
        self._store(state["nu"], names, nu)
        return u

    def _adamax(self, g, state, names, count):
        # torch Adamax defaults (0.9, 0.999) whatever beta1/beta2 say:
        # reference optim_utils.py:36-45 builds Adamax without betas
        b1, b2 = 0.9, 0.999
        c1 = float(_F(1.0) - _F(b1) ** _F(count))
        mu = _add(_mul([state["mu"][n] for n in names], b1), _mul(g, 1.0 - b1))
        nu = torch._foreach_maximum(
            torch._foreach_add(torch._foreach_abs(g), self.eps),
            _mul([state["nu"][n] for n in names], b2))
        self._store(state["mu"], names, mu)
        self._store(state["nu"], names, nu)
        return torch._foreach_div(torch._foreach_div(mu, c1), nu)

    @staticmethod
    def _store(slot, names, values):
        for n, v in zip(names, values):
            slot[n] = v.to(slot[n].dtype)

    # ------------------------------------------------------------ the routes

    def fused(self, params: Dict[str, torch.Tensor]) -> bool:
        """Whether :meth:`step` takes the fused update: Adam or AdamW of one
        model (no folds, no split), fp32 or bf16 moments, every parameter
        fp32 on the CPU or a card."""
        return (self.name in ("adam", "adamw") and not self.folds
                and self.split is None
                and self.mu_dtype in (None, torch.bfloat16)
                and self.nu_dtype in (None, torch.bfloat16)
                and next(iter(params.values())).device.type in ("cpu", "cuda")
                and all(p.dtype is torch.float32 for p in params.values()))

    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor], state: dict) -> None:
        """One update of ``params`` in place (optax.apply_updates: p + u),
        by the fused update where :meth:`fused` allows it, else by
        :meth:`chain_step`."""
        if not self.fused(params):
            self.chain_step(params, grads, state)
            return
        self.update(params, grads, state, self.prepare(params, state))
        state["count"] += 1

    def prepare(self, params: Dict[str, torch.Tensor], state: dict,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The step-dependent scalars of the next fused :meth:`step` from
        ``state``'s count, as ``fused_adam.adam_update``'s ``sched``: the
        bias corrections at ``count + 1`` and ``−lr·schedule(count)``, the
        float32 values the chain uses, on the parameters' device. On a card
        they are copied from pinned memory in stream order (the host does
        not wait), into ``out`` where given: the buffer a captured update
        reads."""
        device = next(iter(params.values())).device
        count = state["count"]
        host = torch.tensor([*self._corrections(count + 1),
                             self._step_size(count)], dtype=torch.float32)
        if device.type == "cuda":
            host = host.pin_memory()
        if out is None:
            return host.to(device, non_blocking=True)
        return out.copy_(host, non_blocking=True)

    def update(self, params: Dict[str, torch.Tensor],
               grads: Dict[str, torch.Tensor], state: dict,
               sched: torch.Tensor) -> None:
        """The fused update's device work, ``sched`` from :meth:`prepare`:
        the clip's factors and the kernel. Leaves the count as it is."""
        args, kwargs = self.fused_update(params, grads, state, sched)
        fused_adam.adam_update(*args, **kwargs)

    def fused_update(self, params: Dict[str, torch.Tensor],
                     grads: Dict[str, torch.Tensor], state: dict,
                     sched: torch.Tensor) -> tuple:
        """The ``(args, kwargs)`` of ``fused_adam.adam_update`` for the next
        fused :meth:`step` from ``state``: the leaves, their decay flags and
        update scales, the clip's factors (computed here, on the device),
        and ``sched`` (:meth:`prepare`'s). Leaves ``state`` as it is."""
        names = list(params)
        if self._leaves is None or self._leaves[0] != names:
            mask = no_decay_mask(names)
            self._leaves = (
                names, [bool(self.weight_decay) and mask[n] for n in names],
                [1.0 if self.update_scales is None
                 else float(self.update_scales[n]) for n in names])
        _, decay, scales = self._leaves
        u = [grads[n] for n in names]
        clip = (None if self.max_grad_norm is None
                else self._clip_factors(u, names))
        args = (list(params.values()), u, [state["mu"][n] for n in names],
                [state["nu"][n] for n in names], decay, scales, clip, sched)
        kwargs = dict(b1=self.beta1, b2=self.beta2, eps=self.eps,
                      weight_decay=self.weight_decay,
                      adamw=self.name == "adamw")
        return args, kwargs

    def chain_step(self, params: Dict[str, torch.Tensor],
                   grads: Dict[str, torch.Tensor], state: dict) -> None:
        """One update by the ``_foreach_*`` chain, for every optimizer."""
        names = list(params)
        p = [params[n].detach() for n in names]
        u = [grads[n] for n in names]
        if self.max_grad_norm is not None:
            u = self._clip(u, names)
        count = state["count"]
        if self.name == "adamw":
            u = self._decay(self._adam(u, state, names, count + 1), p, names)
        else:
            u = self._decay(u, p, names)
            if self.name == "adam":
                u = self._adam(u, state, names, count + 1)
            elif self.name == "adamax":
                u = self._adamax(u, state, names, count + 1)
            elif self.beta1:  # torch SGD(momentum=beta1)
                t = _add(u, _mul([state["trace"][n] for n in names],
                                 self.beta1))
                self._store(state["trace"], names, t)
                u = t
        if self.update_scales is not None:
            u = [x * self.update_scales[n] for x, n in zip(u, names)]
        u = _mul(u, self._step_size(count))
        state["count"] = count + 1
        with torch.no_grad():
            torch._foreach_add_(p, u)
