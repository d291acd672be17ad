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
  float32 scalars and an update issues no host sync.

Updates use the ``torch._foreach_*`` ops: one launch per operation over all
parameters rather than one per parameter.

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

_F = np.float32

_NO_DECAY_SUFFIXES = ("bias", "LayerNorm.weight", "img_layer_norm.weight",
                      "pos_layer_norm.weight",
                      # the LayerNorm scales of the pretraining heads
                      # (JAX ``net_ln_scale``; the reference's net.2)
                      "feat_regress.net.2.weight",
                      "region_classifier.net.2.weight")


# the text models' head LayerNorms (flax ``nn.LayerNorm`` ``scale`` in JAX)
_HEAD_LN = re.compile(r"(?:^|\.)head_ln_\d+\.weight$")


def no_decay_mask(names) -> Dict[str, bool]:
    """True = apply weight decay. Every ``*bias``, every ``LayerNorm.weight``,
    the image and position LayerNorm weights, the pretraining heads' and the
    text models' head LayerNorm weights are excluded (reference
    optim_utils.py:16; the JAX package's ``*bias`` / ``*ln_scale`` /
    ``scale`` names);
    ``mask_embedding`` and every matrix and embedding table decay."""
    return {n: not (n.endswith(_NO_DECAY_SUFFIXES) or _HEAD_LN.search(n))
            for n in names}


_LAYER = re.compile(r"(?:^|\.)encoder\.layer\.(\d+)\.")


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
        div = torch.where(trigger, one, norm)
        mul = torch.where(trigger, one, one * self.max_grad_norm)
        if not self.folds:
            return _mul(torch._foreach_div(g, div), mul)
        div = [_fold_scalar(div, x) for x in g]
        mul = [_fold_scalar(mul, x) for x in g]
        return torch._foreach_mul(torch._foreach_div(g, div), mul)

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

    def _adam(self, g, state, names, count):
        b1, b2 = self.beta1, self.beta2
        c1 = float(_F(1.0) - _F(b1) ** _F(count))
        c2 = float(_F(1.0) - _F(b2) ** _F(count))
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

    # ------------------------------------------------------------- the chain

    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor], state: dict) -> None:
        """One update of ``params`` in place (optax.apply_updates: p + u)."""
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
        # optax.scale_by_learning_rate: −lr·schedule at the count before
        # the increment, in float32
        step_size = float(-(_F(self.lr) * _F(self.schedule(count))))
        u = _mul(u, step_size)
        state["count"] = count + 1
        with torch.no_grad():
            torch._foreach_add_(p, u)

