"""Ensemble weight search over per-fold prediction CSVs.

Counterpart of ``meme_challenge_tpu/ensemble/ensemble.py`` (reference
utils/ensemble.py): id alignment with missing→−1 masking, weighted mixing in
probability or logit space, the brute-force grid search ({0, 0.5, 1, 2}^F
capped at 10k candidates) and the evolutionary search (population 512 × 100
generations, tournament-3, uniform crossover, Gaussian/scale mutation,
score-seeded init, stagnation reinit), with every candidate scored on the
device in batched calls (``ops/device_metrics.py``).

The brute force and the host EA draw from the same python, numpy and
``RandomState`` streams as the JAX package, so on the same predictions they
pick the same weights. The device EA runs the same operators on the device
from a ``torch.Generator``; its stream is torch's, not JAX's.

    python -m meme_challenge_tpu_torch.ensemble.ensemble \
        --regex_dev 'model_fold_*_dev_seen_*_preds.csv' \
        --regex_test 'model_fold_*_test_seen_preds.csv' [--device cpu]
"""
from __future__ import annotations

import logging
import os
import random
from copy import copy
from itertools import product
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from meme_challenge_tpu_torch.core.artifacts import load_predictions
from meme_challenge_tpu_torch.core.device import resolve_device
from meme_challenge_tpu_torch.core.metrics import aucroc, find_optimal_threshold
from meme_challenge_tpu_torch.ops.device_metrics import (
    ensemble_prediction,
    ensemble_scores,
    ensemble_scores_logit,
)

logger = logging.getLogger("meme_challenge_tpu_torch.ensemble")

# the device EA counts its runs here, so a caller can tell which EA ran
DEVICE_EA_RUNS = {"count": 0}


# ----------------------------------------------------------------- alignment

def align_ids(csv_dicts: List[Dict[str, np.ndarray]]) -> List[dict]:
    """Union-of-ids alignment with missing→−1 (reference ensemble.py:130-141)."""
    all_ids = np.array(sorted({int(e) for d in csv_dicts
                               for e in d["id"].tolist()}))
    aligned = []
    labels = np.full(all_ids.shape[0], -1, dtype=np.int64)
    for d in csv_dicts:
        id_to_row = {int(i): r for r, i in enumerate(d["id"])}
        proba = np.full(all_ids.shape[0], -1.0)
        label = np.full(all_ids.shape[0], -1, dtype=np.int64)
        for r, data_id in enumerate(all_ids):
            row = id_to_row.get(int(data_id))
            if row is not None:
                proba[r] = d["proba"][row]
                label[r] = d["label"][row]
                if "gt" in d:
                    gt = int(d["gt"][row])
                    assert labels[r] in (-1, gt), (
                        "conflicting ground-truth labels for the same id "
                        "across prediction files.")
                    labels[r] = gt
        aligned.append({"orig": d, "id": all_ids, "proba": proba,
                        "label": label})
    for d in aligned:
        d["gt"] = labels
    return aligned


def _on(device, x, dtype=torch.float32) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def create_ensemble_prediction(predictions, weights, on_logits: bool = False,
                               device="cuda") -> np.ndarray:
    """Mix ``predictions`` (``[F, N]`` or a list of F vectors) with
    ``weights`` on ``device``; returns fp32 numpy (semantics of reference
    ensemble.py:157-177)."""
    if isinstance(predictions, list):
        predictions = np.stack(predictions, axis=0)
    device = resolve_device(str(device))
    weights = np.asarray(weights, dtype=np.float64)
    return ensemble_prediction(_on(device, predictions), _on(device, weights),
                               on_logits).cpu().numpy()


def export_csv(csv_dict: dict, csv_file: str) -> None:
    """Column export in dict order (reference ensemble.py:144-155)."""
    csv_dict = {k: v for k, v in csv_dict.items() if k != "orig"}
    header = list(csv_dict.keys())
    lines = [",".join(header)]
    n = len(csv_dict[header[0]])
    for i in range(n):
        cells = []
        for key in header:
            v = csv_dict[key][i]
            cells.append("%f" % v if isinstance(v, (float, np.floating))
                         else "%i" % v)
        lines.append(",".join(cells))
    with open(csv_file, "w") as f:
        f.write("\n".join(lines) + "\n")


# -------------------------------------------------------------- brute force

def brute_force_finder(predictions: np.ndarray, labels: np.ndarray,
                       num_weights: int,
                       weight_range: Sequence[float] = (0.0, 0.5, 1.0, 2.0),
                       max_weights: int = 10000,
                       batch: int = 16384,
                       device="cuda") -> Tuple[float, dict]:
    """Grid search with the reference's candidate enumeration and
    tie-breaking (ensemble.py:180-203), scored on ``device``.

    The default grid (10k tuples ≤ ``batch``) scores in one call of
    ``ensemble_scores``; a larger grid goes in chunks of ``batch``, the tail
    padded by repeating its first tuple and the pad's scores trimmed before
    the argmax, as the JAX package does."""
    device = resolve_device(str(device))
    if (np.log(len(weight_range)) * num_weights) < np.log(2e7):
        weight_tuples = [list(w) for w in product(weight_range,
                                                  repeat=num_weights)]
        if len(weight_tuples) > max_weights:
            logger.info("[Weight search] limiting %i weight tuples to %i",
                        len(weight_tuples), max_weights)
            random.seed(42)
            random.shuffle(weight_tuples)
            weight_tuples = weight_tuples[:max_weights]
    else:
        np.random.seed(42)
        rand_idx = np.random.randint(0, len(weight_range),
                                     size=(max_weights, num_weights))
        weight_tuples = [[weight_range[rand_idx[m, n]]
                          for n in range(num_weights)]
                         for m in range(max_weights)]

    preds_dev = _on(device, predictions)
    labels_dev = _on(device, labels, torch.int64)
    best_score, best_idx = -1.0, None  # flat index into (tuple, space) order
    n_tuples = len(weight_tuples)
    for start in range(0, n_tuples, batch):
        chunk = np.asarray(weight_tuples[start:start + batch], np.float32)
        valid = chunk.shape[0]
        if valid < batch and start > 0:
            chunk = np.concatenate(
                [chunk, np.repeat(chunk[:1], batch - valid, axis=0)])
        scores = ensemble_scores(preds_dev, _on(device, chunk),
                                 labels_dev)[:, :valid].cpu().numpy()
        # enumeration order: tuple-major, logit before prob (strict >)
        flat = scores.T.reshape(-1)  # [(k0,logit),(k0,prob),(k1,logit)...]
        i = int(np.argmax(flat))
        if flat[i] > best_score:
            best_score = float(flat[i])
            best_idx = (start + i // 2, i % 2 == 0)
    tuple_idx, on_logits = best_idx
    best_config = {"weights": list(weight_tuples[tuple_idx]),
                   "on_logits": bool(on_logits)}
    logger.info("[Weight search] best brute-force score %4.2f%% with %s",
                best_score * 100.0, best_config)
    return best_score, best_config


# ------------------------------------------------------------------------ EA

def _seeded_mean(individual_scores, num_weights: int) -> np.ndarray:
    """Score-proportional init means (reference ind_init, ensemble.py:223-232)."""
    scores = np.asarray(individual_scores, np.float64)
    mn, mx = scores.min(), scores.max()
    norm = ((scores - mn + 0.01) / (mx - mn) if mx > mn
            else np.ones(num_weights))
    return norm / norm.sum() * num_weights


def ea_ensemble_finder_device(predictions, labels, num_weights: int,
                              individual_scores: Sequence[float],
                              population_size: int = 512,
                              min_weight: float = 0.0,
                              max_weight: float = 4.0,
                              num_generations: int = 100,
                              cxpb: float = 0.5, mutpb: float = 0.9,
                              seed: int = 42,
                              device="cuda") -> Tuple[float, dict]:
    """The whole EA on ``device``: population, fitness, selection and
    variation stay there, one loop iteration per generation.

    The operators and hyperparameters are those of
    :func:`ea_ensemble_finder`. Every draw comes from a ``torch.Generator``
    on ``device`` seeded with ``seed``: two runs from one seed on one device
    give the same result, but the stream is neither the host EA's
    ``RandomState`` nor the JAX package's PRNG, so the weights it finds
    differ from theirs (the search problem and the budget are the same)."""
    device = resolve_device(str(device))
    DEVICE_EA_RUNS["count"] += 1
    F, P = num_weights, population_size
    preds = _on(device, predictions)
    labels_dev = _on(device, labels, torch.int64)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    seeded_mean = _on(device, _seeded_mean(individual_scores, F))

    def uniform(*shape, lo=0.0, hi=1.0):
        u = torch.rand(shape, generator=gen, device=device)
        return u if (lo, hi) == (0.0, 1.0) else lo + (hi - lo) * u

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=device)

    def fitness(pop):
        return ensemble_scores_logit(preds, pop, labels_dev)

    def init_pop():
        use_gauss = uniform(P) < 0.5
        gauss_pop = 1.0 + 0.3 * normal(P, F)
        seeded_pop = seeded_mean[None, :] + 0.3 * normal(P, F)
        return torch.where(use_gauss[:, None], gauss_pop,
                           seeded_pop).clamp(min_weight, max_weight)

    def tournament(fits, k, tournsize=3):
        asp = torch.randint(0, fits.shape[0], (k, tournsize), generator=gen,
                            device=device)
        return asp.gather(1, fits[asp].argmax(dim=1, keepdim=True))[:, 0]

    def mutate_all(pop):
        use_scale = uniform(P) < 0.2
        scales = uniform(P, lo=0.5, hi=2.0)
        sigma = uniform(P, lo=0.02, hi=0.2)
        gene_sel = uniform(P, F) < 0.8
        noise = normal(P, F) * sigma[:, None]
        scaled = (pop - 1.0) * scales[:, None] + 1.0
        jittered = torch.where(gene_sel, pop + noise, pop)
        out = torch.where(use_scale[:, None], scaled, jittered)
        out = out.clamp(min_weight, max_weight)
        snap = (out < 0.2) & (uniform(P, F) < 0.5)
        return torch.where(snap, 0.0, out)

    def var_and(parents):
        half = P // 2
        do_cx = uniform(half) < cxpb
        gene_mask = (uniform(half, F) < 0.5) & do_cx[:, None]
        a, b = parents[0:2 * half:2], parents[1:2 * half:2]
        off = parents.clone()
        off[0:2 * half:2] = torch.where(gene_mask, b, a)
        off[1:2 * half:2] = torch.where(gene_mask, a, b)
        do_mut = uniform(P) < mutpb
        return torch.where(do_mut[:, None], mutate_all(off), off)

    pop = init_pop()
    fits = fitness(pop)
    hof_idx = fits.argmax()
    hof_ind, hof_fit = pop[hof_idx], fits[hof_idx]
    best_gen = torch.zeros((), dtype=torch.int64, device=device)
    for g in range(num_generations):
        parent_idx = tournament(fits, P)
        offspring = var_and(pop[parent_idx])
        merged = torch.cat([pop, offspring])
        merged_fits = torch.cat([fits, fitness(offspring)])
        sel = tournament(merged_fits, P)
        pop, fits = merged[sel], merged_fits[sel]
        gb = merged_fits.argmax()
        improved = merged_fits[gb] > hof_fit
        hof_fit = torch.where(improved, merged_fits[gb], hof_fit)
        hof_ind = torch.where(improved, merged[gb], hof_ind)
        best_gen = torch.where(improved, g, best_gen)
        # the stagnation reinit (a lax.cond in the JAX package) reads one
        # device flag a generation, which waits for the card. The other
        # form, a fresh population scored every generation and kept by
        # torch.where, adds a fitness call to every generation of a
        # host-bound loop for a branch that runs at most once in 50
        # generations; on an H100 the whole EA measured slower with it
        if bool(g - best_gen >= 50):
            logger.info("[EA/device] population reset (stagnation)")
            pop = init_pop()
            fits = fitness(pop)
            best_gen = torch.full_like(best_gen, g)
    hof_fit = float(hof_fit)
    logger.info("[EA search/device] %i generations, max %4.2f%%",
                num_generations, hof_fit * 100.0)
    return hof_fit, {"weights": [float(w) for w in hof_ind.cpu()],
                     "on_logits": True}


def uniform_crossover_pairs(off: np.ndarray,
                            gene_mask: np.ndarray) -> np.ndarray:
    """In-place uniform crossover over consecutive pairs (DEAP ``cxUniform``
    semantics, reference ensemble.py:252): where ``gene_mask[i]`` is True,
    pair ``(off[2i], off[2i+1])`` swaps that gene. Returns ``off``."""
    half = gene_mask.shape[0]
    # copies, not views: writing the even rows below must not alias the `a`
    # the odd rows read, or the odd offspring collapse to clones of parent b
    a = off[0:2 * half:2].copy()
    b = off[1:2 * half:2].copy()
    off[0:2 * half:2] = np.where(gene_mask, b, a)
    off[1:2 * half:2] = np.where(gene_mask, a, b)
    return off


def ea_ensemble_finder(predictions: np.ndarray, labels: np.ndarray,
                       num_weights: int,
                       individual_scores: Sequence[float],
                       population_size: int = 512,
                       min_weight: float = 0.0, max_weight: float = 4.0,
                       num_generations: int = 100,
                       cxpb: float = 0.5, mutpb: float = 0.9,
                       seed: int = 42, device="cuda") -> Tuple[float, dict]:
    """(μ+λ) EA with the reference's DEAP hyperparameters
    (ensemble.py:235-272); fitness is the logit-space AUROC, one batched
    call on ``device`` per generation.

    The bookkeeping (tournament-3 selection, uniform crossover, the
    reference's mutation: 20 % a global scale around 1, else Gaussian jitter
    σ ~ U(0.02, 0.2) per gene with p 0.8, clip, snap weights below 0.2 to 0
    half the time; score-seeded init) is vectorized numpy over the whole
    population, drawing from ``np.random.RandomState(seed)`` in the JAX
    package's order."""
    device = resolve_device(str(device))
    rs = np.random.RandomState(seed)
    preds_dev = _on(device, predictions)
    labels_dev = _on(device, labels, torch.int64)
    F = num_weights

    def fitness(pop: np.ndarray) -> np.ndarray:
        return ensemble_scores_logit(preds_dev, _on(device, pop),
                                     labels_dev).cpu().numpy()

    def tournament(fit_values: np.ndarray, k: int,
                   tournsize: int = 3) -> np.ndarray:
        asp = rs.randint(0, len(fit_values), (k, tournsize))
        return asp[np.arange(k), np.argmax(fit_values[asp], axis=1)]

    def mutate_all(pop: np.ndarray) -> np.ndarray:
        k = pop.shape[0]
        use_scale = rs.random_sample(k) < 0.2
        scales = rs.uniform(0.5, 2.0, k)
        sigma = rs.uniform(0.02, 0.2, k)
        gene_sel = rs.random_sample((k, F)) < 0.8
        noise = rs.normal(0.0, 1.0, (k, F)) * sigma[:, None]
        scaled = (pop - 1.0) * scales[:, None] + 1.0
        jittered = np.where(gene_sel, pop + noise, pop)
        out = np.where(use_scale[:, None], scaled, jittered)
        out = np.clip(out, min_weight, max_weight)
        snap = (out < 0.2) & (rs.random_sample((k, F)) < 0.5)
        return np.where(snap, 0.0, out)

    def var_and(parents: np.ndarray) -> np.ndarray:
        off = parents.copy()
        half = off.shape[0] // 2
        do_cx = rs.random_sample(half) < cxpb
        gene_mask = (rs.random_sample((half, F)) < 0.5) & do_cx[:, None]
        off = uniform_crossover_pairs(off, gene_mask)
        do_mut = rs.random_sample(off.shape[0]) < mutpb
        return np.where(do_mut[:, None], mutate_all(off), off)

    def new_population() -> np.ndarray:
        seeded_mean = _seeded_mean(individual_scores, F)
        use_gauss = rs.random_sample(population_size) < 0.5
        gauss_pop = rs.normal(1.0, 0.3, (population_size, F))
        seeded_pop = seeded_mean[None, :] + rs.normal(
            0.0, 0.3, (population_size, F))
        pop = np.where(use_gauss[:, None], gauss_pop, seeded_pop)
        return np.clip(pop, min_weight, max_weight)

    population = new_population()
    fits = fitness(population)
    hof_ind = population[int(np.argmax(fits))].copy()
    hof_fit = float(np.max(fits))
    best_score, best_gen = -1.0, 0

    for gen in range(num_generations):
        parent_idx = tournament(fits, k=len(population))
        offspring = var_and(population[parent_idx])
        off_fits = fitness(offspring)  # the one device call per generation
        merged = np.concatenate([population, offspring], axis=0)
        merged_fits = np.concatenate([fits, off_fits])
        sel_idx = tournament(merged_fits, k=population_size)
        population = merged[sel_idx]
        fits = merged_fits[sel_idx]
        gen_best = int(np.argmax(merged_fits))
        if float(merged_fits[gen_best]) > hof_fit:
            hof_fit = float(merged_fits[gen_best])
            hof_ind = merged[gen_best].copy()
        if hof_fit > best_score:
            best_score = hof_fit
            best_gen = gen
        elif (gen - best_gen) >= 50:
            logger.info("[EA] population reset (stagnation)")
            population = new_population()
            fits = fitness(population)
            best_gen = gen
        if (gen + 1) % 20 == 0:
            logger.info("[EA search] %i generations, max %4.2f%%",
                        gen + 1, hof_fit * 100.0)
    return hof_fit, {"weights": [float(w) for w in hof_ind],
                     "on_logits": True}


# ----------------------------------------------------------------- pipeline

def find_ensemble(dev_files: List[str], test_files,
                  weight_range=(0.0, 0.5, 1.0, 2.0),
                  max_weights: int = 10000,
                  run_ea: bool = True,
                  ea_generations: int = 100,
                  ea_impl: str = "auto",
                  device="cuda") -> dict:
    """Search and export (reference find_ensemble, utils/ensemble.py:35-112).
    Returns ``{"score", "config", "threshold"}``.

    ``ea_impl``: "host" (numpy loop, one scoring call on ``device`` per
    generation), "device" (the whole EA on ``device``), or "auto": the device
    EA when ``device`` is a card and ``ea_generations >= 20``, else the host
    EA."""
    device = resolve_device(str(device))
    dev_preds = [load_predictions(f) for f in dev_files]
    dev_preds = align_ids(dev_preds)
    dev_gt = dev_preds[0]["gt"]
    dev_scores = [aucroc(d["orig"]["proba"], d["orig"]["gt"])
                  for d in dev_preds]
    logger.info("Individual scores: %s",
                ", ".join("%4.2f%%" % (100.0 * s) for s in dev_scores))

    output_dir = os.path.dirname(dev_files[0]) or "."
    base = os.path.basename(dev_files[0])
    # file-name parsing of reference ensemble.py:42-48
    if base.endswith("_00_preds.csv"):
        dev_name = "_".join(base.rsplit("_", 4)[-4:-1])
        model_name = base.rsplit("_", 6)[0]
    else:
        dev_name = "_".join(base.rsplit("_", 3)[-3:-1])
        model_name = base.rsplit("_", 5)[0]
    logger.info("Model name: %s", model_name)

    predictions = np.stack([d["proba"] for d in dev_preds], axis=0)
    best_score, best_config = brute_force_finder(
        predictions, dev_gt, num_weights=len(dev_preds),
        weight_range=weight_range, max_weights=max_weights, device=device)
    if run_ea:
        logger.info("Running the weight-search EA...")
        use_device = (ea_impl == "device"
                      or (ea_impl == "auto" and ea_generations >= 20
                          and device.type == "cuda"))
        finder = (ea_ensemble_finder_device if use_device
                  else ea_ensemble_finder)
        ea_score, ea_config = finder(
            predictions, dev_gt, num_weights=len(dev_preds),
            individual_scores=dev_scores, num_generations=ea_generations,
            device=device)
        if ea_score > best_score:
            logger.info("Found better config with EA: %s", ea_config)
            best_score, best_config = ea_score, ea_config

    best_dict = copy(dev_preds[0])
    best_dict["proba"] = create_ensemble_prediction(
        predictions, best_config["weights"], best_config["on_logits"],
        device)
    threshold = find_optimal_threshold(best_dict["proba"], dev_gt)
    logger.info("Binarizing predictions at threshold %4.3f.", threshold)
    best_dict["label"] = (best_dict["proba"] > threshold).astype(np.int32)
    export_csv(best_dict, os.path.join(
        output_dir, model_name + "_" + dev_name + "_ensemble.csv"))
    best_acc = float((best_dict["label"] == dev_gt).mean())
    logger.info("Top %s score: %4.2f%% (acc %4.2f%%)",
                dev_name, best_score * 100.0, best_acc * 100.0)

    if test_files and not isinstance(test_files[0], list):
        test_files = [test_files]
    for test_list in (test_files or []):
        tbase = os.path.basename(test_list[0])
        test_name = "_".join(tbase.rsplit("_", 3)[-3:-1])
        test_model_name = tbase.rsplit("_", 5)[0]
        # test CSVs stack by position, without align_ids, as reference
        # utils/ensemble.py:97-101 does: per-fold test exports share their
        # row order (one loader); a length mismatch means stale files
        # matched the glob, which must fail rather than mis-average
        test_preds = [load_predictions(f) for f in test_list]
        lens = {len(d["proba"]) for d in test_preds}
        assert len(lens) == 1, (
            f"test prediction files for {test_name} have mismatched "
            f"lengths {sorted(lens)} — stale files matching the glob?")
        preds = create_ensemble_prediction(
            [d["proba"] for d in test_preds],
            best_config["weights"], best_config["on_logits"], device)
        test_dict = copy(test_preds[0])
        test_dict["proba"] = preds
        test_dict["label"] = (preds > threshold).astype(np.int32)
        if "gt" in test_dict:
            score = aucroc(test_dict["proba"], test_dict["gt"])
            logger.info("Ensemble score on %s: %4.2f%%",
                        test_name, score * 100.0)
        export_csv(test_dict, os.path.join(
            output_dir, test_model_name + "_" + test_name + "_ensemble.csv"))
    return {"score": best_score, "config": best_config,
            "threshold": threshold}


def main(argv=None):
    """Standalone search (reference utils/ensemble.py:275-285): glob the
    dev and test prediction CSVs and run the brute force and the EA."""
    import argparse
    from glob import glob

    parser = argparse.ArgumentParser()
    parser.add_argument("--regex_dev", type=str, required=True,
                        help="Glob expression for dev csv files")
    parser.add_argument("--regex_test", type=str, nargs="+", default=[],
                        help="Glob expressions for test csv files")
    parser.add_argument("--max_weights", type=int, default=10000)
    parser.add_argument("--no_ea", action="store_true",
                        help="brute-force grid only")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    dev_files = sorted(glob(args.regex_dev))
    assert dev_files, f"no dev files match {args.regex_dev}"
    test_files = []
    for t in args.regex_test:
        matched = sorted(glob(t))
        assert matched, f"no test files match {t}"
        test_files.append(matched)
    return find_ensemble(dev_files, test_files,
                         max_weights=args.max_weights,
                         run_ea=not args.no_ea, device=device)


if __name__ == "__main__":
    logging.basicConfig(
        format="%(asctime)s %(levelname)s %(name)s | %(message)s",
        datefmt="%Y-%m-%d %H:%M:%S", level=logging.INFO)
    main()
