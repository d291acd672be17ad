"""A whole run of a cell at a size the CPU holds, past the look for a card:
sound, it is correct; with the timed path broken underneath, ``correct``
comes out false, once for each fault a one-chip cell can have."""
import pytest

from portbench import harness

SEED = 2 ** 31 + 11


def _run(cell, seconds=0.3):
    return harness.run(cell, SEED, seconds, False, "cpu", 0.0)


@pytest.fixture
def unchanged_state(monkeypatch):
    """A step that returns its state unchanged: the optimizer moves
    nothing."""
    from meme_challenge_tpu_torch.train import optim

    monkeypatch.setattr(optim.Optimizer, "step",
                        lambda self, params, grads, state: None)


@pytest.fixture
def half_batch(monkeypatch):
    """Half of each micro-batch left out of the loss, the mean taken over
    the rest."""
    from meme_challenge_tpu_torch.train import trainer

    make = trainer.make_loss_fn

    def broken(loss_func, pos_wt):
        fn = make(loss_func, pos_wt)

        def loss(logits, labels, mask, denominator=None):
            mask = mask.clone()
            mask[..., mask.shape[-1] // 2:] = 0
            return fn(logits, labels, mask, denominator)
        return loss

    monkeypatch.setattr(trainer, "make_loss_fn", broken)


@pytest.fixture
def altered_train_answer(monkeypatch):
    """The step's probabilities altered where the loss makes them."""
    from meme_challenge_tpu_torch.train import trainer

    make = trainer.make_loss_fn

    def broken(loss_func, pos_wt):
        fn = make(loss_func, pos_wt)

        def loss(*args, **kw):
            value, probs = fn(*args, **kw)
            return value, probs + 1e-2
        return loss

    monkeypatch.setattr(trainer, "make_loss_fn", broken)


def test_fine_tune_sound_run_is_correct(tiny_cell):
    r = _run(tiny_cell("base_ft_fp32"))
    assert r["correct"], r["checks"]
    assert set(r["checks"]) == {"loss_gap", "prob_gap", "grad_gap",
                                "delta_gap"}
    assert list(r)[-1] == "checks"
    assert r["metrics"]["train_samples_per_s"]["value"] > 0


@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch",
                                   "altered_train_answer"])
def test_fine_tune_fault_is_not_correct(tiny_cell, fault, request):
    request.getfixturevalue(fault)
    r = _run(tiny_cell("base_ft_fp32"))
    assert not r["correct"], r["checks"]


def test_fused_bf16_mix_runs_its_path(tiny_cell):
    """The bf16 pair-blocked fused-accumulation mix (kept for a later
    cell) drives its own path and its check compares it with the float32
    reference."""
    r = _run(tiny_cell("large_ft_fp32", traffic="ft_bf16_fused"))
    assert set(r["checks"]) == {"loss_gap", "prob_gap", "grad_gap",
                                "delta_gap"}
    assert 0 < r["checks"]["loss_gap"]["value"] < 0.1
