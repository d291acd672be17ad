"""The reference's first optimizer steps of a fine-tune, and its scoring.

:func:`train_steps` follows the recipe's steps from the weights of the
seed: per step the memes the run put into it, the step's dropout drawn
again from the step's generator (:func:`step_generator`, the recipe's
seeding), the loss and its gradient in float32, and :func:`uniter.adam_step`.
It returns what :mod:`portbench.check` compares: each micro-batch's loss,
the probabilities, the norm of each leaf's first gradient as the optimizer
got it (worked out from the first moment after one step) and of each
leaf's change over the steps.

``precision`` and ``fault`` make the controls: the same steps with TF32
products, or with half of each micro-batch left out of the loss.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from portbench.reference import batches, uniter


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The recipe's dropout generator of optimizer step ``step``: seeded
    with 63 bits of numpy's SeedSequence over (seed, step)."""
    ss = np.random.SeedSequence([int(seed) & 0xFFFFFFFFFFFFFFFF, int(step)])
    seed63 = int(ss.generate_state(1, np.uint64)[0]) >> 1
    return torch.Generator(device=torch.device(device)).manual_seed(seed63)


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    names = list(tensors)
    norms = torch.stack([torch.linalg.vector_norm(tensors[n].float())
                         for n in names]).cpu().tolist()
    return dict(zip(names, norms))


def first_gradient(mu: Dict[str, torch.Tensor], p0: Dict[str, torch.Tensor],
                   beta1: float, weight_decay: float) -> Dict[str, float]:
    """Each leaf's norm of the gradient the optimizer took at its first
    step, from the first moment after it: ``mu / (1 − β1)`` less the decay
    ``weight_decay · p0`` on the decayed leaves."""
    out = {}
    for name in mu:
        g = mu[name].float() / (1.0 - beta1)
        if uniter.decays(name):
            g = g - weight_decay * p0[name]
        out[name] = g
    return leaf_norms(out)


def change(params: Dict[str, torch.Tensor], p0: Dict[str, torch.Tensor]
           ) -> Dict[str, float]:
    return leaf_norms({n: params[n].detach() - p0[n] for n in p0})


def _drop(cfg: dict, model: dict, gen) -> uniter.DropoutDraws:
    return uniter.DropoutDraws(
        gen, cfg["hidden_dropout_prob"], cfg["attention_probs_dropout_prob"],
        model.get("dropout_bits_dtype", "uint32") == "uint8",
        bool(model.get("pallas_blocked", False)))


def train_steps(cfg: dict, model: dict, tc: dict, corpus, steps: List[dict],
                seed: int, device, total_steps: int,
                precision: str = "float32",
                fault: Optional[str] = None) -> dict:
    """``steps``: per optimizer step ``ids`` and ``sample_mask``
    ``[accum, B]`` as the run stepped them."""
    with uniter.precision(precision):
        w = uniter.make_weights(cfg, seed, device)
        for t in w.values():
            t.requires_grad_(True)
        state: dict = {}
        losses, probs, grad = [], [], None
        for i, st in enumerate(steps):
            ids = np.asarray(st["ids"])
            accum, B = ids.shape
            mask = torch.as_tensor(np.asarray(st["sample_mask"]),
                                   device=device)
            if fault == "half_batch":
                mask = mask.clone()
                mask[:, B // 2:] = 0
            batch = batches.build(corpus, ids.reshape(-1), tc["max_txt_len"],
                                  tc["max_bb"], device)
            drop = _drop(cfg, model, step_generator(seed, i, device))
            if tc.get("fuse_accum") and accum > 1:
                logit = uniter.logits(w, batch, cfg, drop).reshape(accum, B)
                micro = [uniter.bce_logits(logit[a], batch["labels"].reshape(
                    accum, B)[a], mask[a], tc["pos_wt"]) for a in range(accum)]
                torch.stack(micro).mean().backward()
                step_probs = torch.sigmoid(logit.detach())
            else:
                micro, step_probs = [], []
                for a in range(accum):
                    rows = slice(a * B, (a + 1) * B)
                    part = {k: v[rows] for k, v in batch.items()}
                    logit = uniter.logits(w, part, cfg, drop)
                    loss = uniter.bce_logits(logit, part["labels"], mask[a],
                                             tc["pos_wt"])
                    loss.backward()
                    micro.append(loss)
                    step_probs.append(torch.sigmoid(logit.detach()
                                                    .reshape(-1)))
                step_probs = torch.stack(step_probs)
            losses.append(torch.stack([m.detach() for m in micro]))
            probs.append(step_probs)
            # a leaf no input reached has a zero gradient
            grads = {n: (t.grad if t.grad is not None
                         else torch.zeros_like(t)) for n, t in w.items()}
            if not (tc.get("fuse_accum") and accum > 1):
                grads = {n: g / accum for n, g in grads.items()}
            uniter.adam_step(w, grads, state, tc, total_steps)
            for t in w.values():
                t.grad = None
            if i == 0:
                p0 = uniter.make_weights(cfg, seed, device)
                grad = first_gradient(state["mu"], p0, tc["beta1"],
                                      tc["weight_decay"])
                del p0
        p0 = uniter.make_weights(cfg, seed, device)
        delta = change(w, p0)
    return {"loss": torch.stack(losses).cpu().numpy(),
            "probs": torch.stack(probs).cpu().numpy(),
            "grad": grad, "delta": delta}


def score(cfg: dict, corpus, meme_ids, tc: dict, seed: int, device,
          block: int = 50, precision: str = "float32") -> np.ndarray:
    """Probabilities of ``meme_ids`` from the weights of ``seed`` with
    dropout off, ``block`` memes a forward."""
    out = []
    with uniter.precision(precision), torch.no_grad():
        w = uniter.make_weights(cfg, seed, device)
        for start in range(0, len(meme_ids), block):
            batch = batches.build(corpus, meme_ids[start:start + block],
                                  tc["max_txt_len"], tc["max_bb"], device)
            out.append(torch.sigmoid(uniter.logits(w, batch, cfg)[:, 0])
                       .cpu().numpy())
    return np.concatenate(out)
