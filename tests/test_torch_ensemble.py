"""PyTorch port, ops/device_metrics.py and ensemble/ensemble.py against the JAX
package: the tie-aware AUROC and the masked mixing of fold predictions
(within 1e-6), the brute-force grid and the host EA (the same weights and
scores from the same python and numpy streams), the device EA run on the
CPU (its own torch stream: seeded, at least the best fold, weights in
range, stagnation reinit), and the search-and-export pipeline, through
``find_ensemble`` and the standalone CLI, writing the same CSVs (the fp32
mixes within a last printed digit)."""
import glob
import logging
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meme_challenge_tpu.core.artifacts import (
    export_predictions,
    load_predictions,
)
from meme_challenge_tpu.ensemble import ensemble as JE
from meme_challenge_tpu.ops import device_metrics as JD
from meme_challenge_tpu_torch.core.metrics import aucroc
from meme_challenge_tpu_torch.ensemble import ensemble as TE
from meme_challenge_tpu_torch.ops import device_metrics as TD

TOL = 1e-6


def _fold_problem(F, N=60, seed=0, missing=True):
    """Fold predictions with 6 decimals, as the CSVs carry them: fold f sees
    its signal through noise of growing scale, and (``missing``) about half
    of every fold's entries are −1, as each crossval fold tests on half of
    dev_seen."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 2, N)
    labels[:2] = [0, 1]
    logit = (2.0 * labels - 1.0) * 1.2
    preds = np.stack([
        np.round(1.0 / (1.0 + np.exp(-(logit + rng.randn(N)
                                       * (0.6 + 0.4 * f)))), 6)
        for f in range(F)])
    if missing:
        preds[rng.rand(F, N) < 0.5] = -1.0
    return preds, labels


def _population(K, F, seed=1):
    rng = np.random.RandomState(seed)
    pop = rng.choice([0.0, 0.5, 1.0, 2.0], size=(K, F)).astype(np.float32)
    pop[0] = 0.0                                # all-zero weights: 0.5
    pop[1] = rng.uniform(0, 4, F)               # off the grid
    return pop


# ------------------------------------------------------------ device metrics

@pytest.mark.parametrize("decimals", [2, 1])
def test_auroc_batched_matches_aucroc_and_jax_with_ties(decimals):
    """Probabilities rounded to 1 or 2 decimals: long tie runs."""
    rng = np.random.RandomState(decimals)
    labels = rng.randint(0, 2, 300)
    probs = np.round(np.clip(0.5 + 0.3 * (labels - 0.5)
                             + 0.25 * rng.randn(16, 300), 0, 1), decimals)
    probs = probs.astype(np.float32)
    ours = TD.auroc_batched(torch.from_numpy(probs),
                            torch.from_numpy(labels)).numpy()
    ref = np.asarray(JD.auroc_batched(jnp.asarray(probs), jnp.asarray(labels)))
    host = np.array([aucroc(p, labels) for p in probs])
    assert ours.shape == (16,) and ours.dtype == np.float32
    np.testing.assert_allclose(ours, ref, atol=TOL, rtol=0)
    np.testing.assert_allclose(ours, host, atol=TOL, rtol=0)
    assert len(np.unique(probs[0])) < 120  # the ties are there
    one = TD.auroc(torch.from_numpy(probs[3]), torch.from_numpy(labels))
    assert abs(float(one) - host[3]) <= TOL


@pytest.mark.parametrize("on_logits", [True, False], ids=["logit", "prob"])
def test_ensemble_prediction_matches_jax(on_logits):
    preds, _ = _fold_problem(5, N=80)
    preds[:, 7] = -1.0                          # missing in every fold
    pop = _population(12, 5)
    t_preds = torch.from_numpy(preds).float()
    ours = TD.ensemble_prediction(t_preds, torch.from_numpy(pop), on_logits)
    assert ours.shape == (12, 80)
    for k in range(12):
        ref = np.asarray(JD.ensemble_prediction(
            jnp.asarray(preds, jnp.float32), jnp.asarray(pop[k]), on_logits))
        np.testing.assert_allclose(ours[k].numpy(), ref, atol=TOL, rtol=0)
        one = TD.ensemble_prediction(t_preds, torch.from_numpy(pop[k]),
                                     on_logits)
        np.testing.assert_allclose(one.numpy(), ours[k].numpy(), atol=TOL,
                                   rtol=0)
    # all-zero weights, or nothing to mix: the placeholder 0.5, which the
    # logit space (as in the reference) passes through the sigmoid
    half = torch.sigmoid(torch.tensor(0.5)) if on_logits else 0.5
    assert (ours[0] == half).all()
    assert ours[2, 7] == half
    np.testing.assert_allclose(
        TE.create_ensemble_prediction(list(preds), pop[3], on_logits, "cpu"),
        JE.create_ensemble_prediction(list(preds), pop[3], on_logits),
        atol=TOL, rtol=0)


def test_ensemble_scores_match_jax():
    preds, labels = _fold_problem(6, N=90)
    pop = _population(40, 6)
    args = (torch.from_numpy(preds), torch.from_numpy(pop),
            torch.from_numpy(labels))
    ours = TD.ensemble_scores(*args).numpy()
    ref = np.asarray(JD.ensemble_scores(jnp.asarray(preds, jnp.float32),
                                        jnp.asarray(pop), jnp.asarray(labels)))
    assert ours.shape == (2, 40)
    np.testing.assert_allclose(ours, ref, atol=TOL, rtol=0)
    np.testing.assert_array_equal(TD.ensemble_scores_logit(*args).numpy(),
                                  ours[0])
    assert not np.array_equal(ours[0], ours[1])  # the spaces differ


# ---------------------------------------------------- brute force, host EA

@pytest.mark.parametrize("F", [3, 7])
def test_brute_force_matches_jax(F):
    """F 3: the whole grid (64 tuples); F 7: 16384 tuples, shuffled by
    random.seed(42) and cut to max_weights; also the padded tail chunk."""
    preds, labels = _fold_problem(F, seed=F)
    ref_score, ref_cfg = JE.brute_force_finder(preds, labels, num_weights=F)
    score, cfg = TE.brute_force_finder(preds, labels, num_weights=F,
                                       device="cpu")
    assert cfg == ref_cfg
    assert abs(score - ref_score) <= TOL
    chunked, cfg2 = TE.brute_force_finder(preds, labels, num_weights=F,
                                          batch=24, device="cpu")
    assert cfg2 == ref_cfg and chunked == score


def test_brute_force_sampling_branch_matches_jax():
    """4^13 tuples exceed 2e7: np.random.seed(42) samples max_weights."""
    preds, labels = _fold_problem(13, N=30, seed=2)
    ref = JE.brute_force_finder(preds, labels, num_weights=13,
                                max_weights=300)
    ours = TE.brute_force_finder(preds, labels, num_weights=13,
                                 max_weights=300, device="cpu")
    assert ours[1] == ref[1] and abs(ours[0] - ref[0]) <= TOL


@pytest.mark.parametrize("F", [3, 7])
def test_host_ea_matches_jax(F):
    preds, labels = _fold_problem(F, seed=10 + F)
    indiv = [aucroc(p[p >= 0], labels[p >= 0]) for p in preds]
    kw = dict(num_weights=F, individual_scores=indiv, population_size=64,
              num_generations=25)
    ref_score, ref_cfg = JE.ea_ensemble_finder(preds, labels, **kw)
    score, cfg = TE.ea_ensemble_finder(preds, labels, device="cpu", **kw)
    assert cfg == ref_cfg
    assert abs(score - ref_score) <= TOL


def test_uniform_crossover_copies_not_aliases(rng):
    parents = rng.rand(16, 5)
    mask = rng.rand(8, 5) < 0.5
    off = TE.uniform_crossover_pairs(parents.copy(), mask)
    a, b = parents[0::2], parents[1::2]
    np.testing.assert_array_equal(off[0::2], np.where(mask, b, a))
    np.testing.assert_array_equal(off[1::2], np.where(mask, a, b))
    np.testing.assert_array_equal(
        off, JE.uniform_crossover_pairs(parents.copy(), mask))


def test_seeded_mean_and_align_ids_match_jax():
    for scores in ([0.6, 0.7, 0.65], [0.5, 0.5]):
        np.testing.assert_array_equal(TE._seeded_mean(scores, len(scores)),
                                      JE._seeded_mean(scores, len(scores)))
    dicts = [{"id": np.array([3, 1, 2]), "proba": np.array([.1, .2, .3]),
              "label": np.array([0, 1, 1]), "gt": np.array([0, 1, 0])},
             {"id": np.array([4, 2]), "proba": np.array([.5, .6]),
              "label": np.array([1, 0]), "gt": np.array([1, 0])}]
    ours, ref = TE.align_ids(dicts), JE.align_ids(dicts)
    for o, r in zip(ours, ref):
        for key in ("id", "proba", "label", "gt"):
            np.testing.assert_array_equal(o[key], r[key])


# --------------------------------------------------------------- device EA

def test_device_ea_on_cpu_is_seeded_and_beats_the_best_fold():
    preds, labels = _fold_problem(4, N=120, seed=5, missing=False)
    indiv = [aucroc(p, labels) for p in preds]
    kw = dict(num_weights=4, individual_scores=indiv, population_size=64,
              num_generations=30, device="cpu")
    before = TE.DEVICE_EA_RUNS["count"]
    score, cfg = TE.ea_ensemble_finder_device(preds, labels, **kw)
    again = TE.ea_ensemble_finder_device(preds, labels, **kw)
    other = TE.ea_ensemble_finder_device(preds, labels, seed=7, **kw)
    assert TE.DEVICE_EA_RUNS["count"] == before + 3
    assert (score, cfg) == again
    assert other[1] != cfg
    assert cfg["on_logits"] is True and len(cfg["weights"]) == 4
    assert all(0.0 <= w <= 4.0 for w in cfg["weights"])
    assert score >= max(indiv) - TOL
    # the returned weights score what the EA says they score
    mixed = TE.create_ensemble_prediction(preds, cfg["weights"], True, "cpu")
    assert abs(aucroc(mixed, labels) - score) <= TOL


def test_device_ea_stagnation_reinit_runs(caplog):
    """Past 50 generations without a better hall of fame the population is
    drawn anew: a tiny problem stops improving early."""
    preds, labels = _fold_problem(3, N=40, seed=6, missing=False)
    with caplog.at_level(logging.INFO, "meme_challenge_tpu_torch.ensemble"):
        score, cfg = TE.ea_ensemble_finder_device(
            preds, labels, num_weights=3, individual_scores=[0.5] * 3,
            population_size=16, num_generations=120, device="cpu")
    assert "population reset (stagnation)" in caplog.text
    assert np.isfinite(score) and len(cfg["weights"]) == 3


# ---------------------------------------------------------------- pipeline

def _write_fold_csvs(root, name, F, N, seed, use_dev):
    """Per-fold dev CSVs (``_dev_seen_XX`` halves when ``use_dev``, else one
    shared dev set with −1-free rows) and two test sets, as the trainer
    writes them."""
    rng = np.random.RandomState(seed)
    ids = 1000 + np.arange(N)
    gt = rng.randint(0, 2, N)
    for f in range(F):
        if use_dev:
            rows = np.sort(rng.choice(N, N // 2, replace=False))
            path = "%s_fold_%d_dev_seen_%02d_preds.csv" % (name, f, f)
        else:
            rows = np.arange(N)
            path = "%s_fold_%d_dev_seen_preds.csv" % (name, f)
        p = np.clip(0.5 + 0.3 * (gt[rows] - 0.5)
                    + (0.15 + 0.05 * f) * rng.randn(len(rows)), 0, 1)
        export_predictions(os.path.join(root, path), ids[rows], p,
                           (p > 0.5).astype(int), gt[rows])
        for t, has_gt in (("test_seen", False), ("dev_unseen", True)):
            q = rng.rand(30)
            export_predictions(
                os.path.join(root, "%s_fold_%d_%s_preds.csv" % (name, f, t)),
                2000 + np.arange(30), q, (q > 0.5).astype(int),
                rng.randint(0, 2, 30) if has_gt else None)


def _assert_same_csv(a, b, threshold):
    """Equal columns, ids and gt; probabilities within 2e-6 (fp32 mixes
    printed to 6 decimals: a last-digit step either way) and labels equal
    away from the threshold."""
    a, b = load_predictions(str(a)), load_predictions(str(b))
    assert list(a) == list(b)
    np.testing.assert_array_equal(a["id"], b["id"])
    if "gt" in a:
        np.testing.assert_array_equal(a["gt"], b["gt"])
    np.testing.assert_allclose(b["proba"], a["proba"], atol=2e-6, rtol=0)
    away = np.abs(a["proba"] - threshold) > 2e-6
    np.testing.assert_array_equal(a["label"][away], b["label"][away])


@pytest.mark.parametrize("use_dev", [True, False],
                         ids=["dev_seen_halves", "shared_dev"])
def test_find_ensemble_matches_jax(tmp_path, use_dev):
    """The brute force and the host EA on written fold CSVs; the dev and
    test ensemble CSVs come out byte-identical, names parsed as the JAX
    package parses them (the ``_00_preds.csv`` branch with use_dev)."""
    out = {}
    for who in ("jax", "port"):
        root = tmp_path / who
        root.mkdir()
        _write_fold_csvs(str(root), "m", 3, 50, 4, use_dev)
        pattern = "_dev_seen_??_preds.csv" if use_dev else "_dev_seen_preds.csv"
        dev = sorted(glob.glob(str(root / ("m_fold_*" + pattern))))
        tests = [sorted(glob.glob(str(root / ("m_fold_*_%s_preds.csv" % t))))
                 for t in ("test_seen", "dev_unseen")]
        kw = dict(run_ea=True, ea_generations=20, ea_impl="host")
        if who == "jax":
            out[who] = JE.find_ensemble(dev, tests, **kw)
        else:
            out[who] = TE.find_ensemble(dev, tests, device="cpu", **kw)
        out[who + "_files"] = sorted(f for f in os.listdir(root)
                                     if f.endswith("_ensemble.csv"))
    assert out["port"]["config"] == out["jax"]["config"]
    assert abs(out["port"]["threshold"] - out["jax"]["threshold"]) <= TOL
    assert abs(out["port"]["score"] - out["jax"]["score"]) <= TOL
    # the dev file's name keeps the fold's "_00" with use_dev (reference
    # file-name parsing)
    dev_name = "m_dev_seen_00_ensemble.csv" if use_dev else (
        "m_dev_seen_ensemble.csv")
    want = sorted([dev_name, "m_dev_unseen_ensemble.csv",
                   "m_test_seen_ensemble.csv"])
    assert out["port_files"] == out["jax_files"] == want
    for name in want:
        _assert_same_csv(tmp_path / "jax" / name, tmp_path / "port" / name,
                         out["jax"]["threshold"])


def test_ensemble_cli_matches_jax(tmp_path):
    """The standalone search (``--no_ea``) with ``--device cpu``."""
    out = {}
    for who, main in (("jax", JE.main), ("port", TE.main)):
        root = tmp_path / who
        root.mkdir()
        _write_fold_csvs(str(root), "cli", 4, 40, 8, True)
        argv = ["--regex_dev", str(root / "cli_fold_*_dev_seen_??_preds.csv"),
                "--regex_test", str(root / "cli_fold_*_test_seen_preds.csv"),
                "--no_ea"]
        if who == "port":
            argv += ["--device", "cpu"]
        out[who] = main(argv)
    assert out["port"]["config"] == out["jax"]["config"]
    assert abs(out["port"]["threshold"] - out["jax"]["threshold"]) <= TOL
    for name in ("cli_dev_seen_00_ensemble.csv",
                 "cli_test_seen_ensemble.csv"):
        _assert_same_csv(tmp_path / "jax" / name, tmp_path / "port" / name,
                         out["jax"]["threshold"])


def test_find_ensemble_picks_the_device_ea(tmp_path):
    """ea_impl "device" runs the device EA on the CPU; "auto" on the CPU
    keeps the host EA, as on a CUDA device it would take the device EA."""
    _write_fold_csvs(str(tmp_path), "m", 3, 40, 9, True)
    dev = sorted(glob.glob(str(tmp_path / "m_fold_*_dev_seen_??_preds.csv")))
    before = TE.DEVICE_EA_RUNS["count"]
    res = TE.find_ensemble(dev, [], ea_generations=20, ea_impl="device",
                           device="cpu")
    assert TE.DEVICE_EA_RUNS["count"] == before + 1
    assert 0.0 <= res["threshold"] <= 1.0
    TE.find_ensemble(dev, [], ea_generations=20, ea_impl="auto",
                     device="cpu")
    assert TE.DEVICE_EA_RUNS["count"] == before + 1


def test_ensemble_cli_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="--device cpu"):
        TE.main(["--regex_dev", "unused"])
