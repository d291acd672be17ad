"""PyTorch port: the train step as one CUDA graph (``train/steps.py:
make_train_step``, ``_StepGraphs``) and the fused Adam update's scalars read
from a tensor (``train/optim.py: Optimizer.prepare``, ``ops/fused_adam.py``).

On the CPU: a CPU step never captures and is the eager step bit for bit; the
signature a graph is kept under tells apart shapes, dtypes, keys, the
accumulation and its mode, the gathered dataset and a missing generator; the
step captures on a card alone, with no process group, through the fused
Adam / AdamW update and without remat, and the fold-stacked step stays eager;
the plain update reading its scalars from a tensor equals it given the
floats, bit for bit. On a card (marker ``card``; ``python -m pytest
--noconftest -m card tests/test_torch_step_graph.py`` there): replayed steps
equal eager steps bit for bit in both accumulation modes, a new signature
captures once, a moved optimizer state captures again, and the launch
counters count each replay's kernels. This file imports no JAX."""
import numpy as np
import pytest
import torch
import torch.distributed as dist

from meme_challenge_tpu_torch.core.config import UniterConfig
from meme_challenge_tpu_torch.core.seeding import dropout_generator
from meme_challenge_tpu_torch.models.uniter import FoldStack, MemeUniter
from meme_challenge_tpu_torch.ops import (
    attention,
    expert_linear,
    fused_adam,
    linear,
)
from meme_challenge_tpu_torch.train import losses as TL
from meme_challenge_tpu_torch.train import steps
from meme_challenge_tpu_torch.train.optim import Optimizer
from meme_challenge_tpu_torch.train.steps import (
    TrainState,
    create_train_state,
    make_fold_train_step,
    make_train_step,
    step_captures,
    step_signature,
)

TINY = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=64, img_dim=16,
            max_position_embeddings=64, initializer_range=0.2,
            hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)
KEYS = ("input_ids", "position_ids", "txt_mask", "img_feat", "img_pos_feat",
        "img_mask", "labels", "sample_mask")


def _model(device="cpu", seed=0, **cfg):
    torch.manual_seed(seed)
    return MemeUniter(UniterConfig(**{**TINY, **cfg})).to(device).eval()


def _optimizer(name="adam", **kw):
    return Optimizer(name, 1e-2, lambda count: 1.0 / (1 + count),
                     weight_decay=0.1, max_grad_norm=0.5,
                     **{"mu_dtype": "bfloat16", "nu_dtype": "bfloat16", **kw})


def _batch(seed, device="cpu", accum=2, B=3, T=8, R=6):
    """One ``[accum, B, ...]`` device batch; the last meme of each
    micro-batch masked out."""
    rng = np.random.RandomState(seed)
    txt = rng.randint(3, T + 1, (accum, B))
    bb = rng.randint(2, R + 1, (accum, B))
    host = {
        "input_ids": rng.randint(0, 64, (accum, B, T)).astype(np.int32),
        "position_ids": np.tile(np.arange(T, dtype=np.int32), (accum, B, 1)),
        "txt_mask": (np.arange(T) < txt[..., None]).astype(np.int32),
        "img_feat": rng.randn(accum, B, R, 16).astype(np.float16),
        "img_pos_feat": rng.rand(accum, B, R, 7).astype(np.float32),
        "img_mask": (np.arange(R) < bb[..., None]).astype(np.int32),
        "labels": rng.randint(0, 2, (accum, B)).astype(np.int32),
        "sample_mask": np.tile(np.array([1] * (B - 1) + [0], np.int32),
                               (accum, 1)),
    }
    return {k: torch.from_numpy(host[k]).to(device) for k in KEYS}


def _run(step, state, batches, device, seed=7):
    """The steps of ``batches``, each drawing its dropout from
    ``dropout_generator(seed, step)``: (losses, probs) stacked."""
    outs = []
    for b in batches:
        gen = dropout_generator(seed, state.step, device)
        state, out = step(state, b, gen)
        outs.append(out)
    return (torch.stack([o["loss"] for o in outs]),
            torch.stack([o["probs"] for o in outs]))


def _bits(t):
    return t.view({torch.float32: torch.int32, torch.bfloat16: torch.int16}
                  .get(t.dtype, t.dtype))


def _assert_same(a: dict, b: dict, what: str):
    assert a.keys() == b.keys(), what
    for n in a:
        assert a[n].dtype == b[n].dtype, (what, n)
        assert torch.equal(_bits(a[n]), _bits(b[n])), (what, n)


def _assert_same_state(s1: TrainState, s2: TrainState):
    _assert_same(dict(s1.model.named_parameters()),
                 dict(s2.model.named_parameters()), "params")
    for slot in ("mu", "nu"):
        _assert_same(s1.opt_state[slot], s2.opt_state[slot], slot)
    assert s1.opt_state["count"] == s2.opt_state["count"]
    assert s1.step == s2.step


def _graph_counts():
    return steps.GRAPH_CAPTURES, steps.GRAPH_REPLAYS


# ------------------------------------------------------------------ the CPU

@pytest.mark.parametrize("fuse_accum", [False, True],
                         ids=["scan_accum", "fused_accum"])
def test_a_cpu_step_never_captures(fuse_accum):
    """Three steps on the CPU through the fused update: no graph captured or
    replayed, and the numbers of the step's eager body, bit for bit."""
    counts = _graph_counts()
    runs = []
    for eager in (False, True):
        model, opt = _model(), _optimizer()
        state = create_train_state(model, opt)
        step = make_train_step(model, TL.make_loss_fn("bce_logits", 1.8),
                               opt, accum_steps=2, fuse_accum=fuse_accum)
        assert opt.fused(dict(model.named_parameters()))
        runs.append((state, _run(step.eager if eager else step, state,
                                 [_batch(i) for i in range(3)], "cpu")))
    assert _graph_counts() == counts
    (s1, (l1, p1)), (s2, (l2, p2)) = runs
    assert torch.equal(l1, l2) and torch.equal(p1, p2)
    _assert_same_state(s1, s2)


def _signature(batch, accum=2, fuse=False, gather=False, data=None,
               generator=False):
    gen = torch.Generator() if generator is not None else None
    return step_signature(batch, accum, fuse, gather, data, gen)


DATA = {"img_feat": torch.zeros(10, 6, 16), "input_ids": torch.zeros(
    10, 8, dtype=torch.int32)}
# (the signature of a step, that of one a graph of it cannot serve)
SIGNATURE_CASES = {
    "shape": lambda b: (_signature(b), _signature(_batch(0, B=4))),
    "dtype": lambda b: (_signature(b), _signature(
        {**b, "img_feat": b["img_feat"].float()})),
    "keys": lambda b: (_signature(b), _signature(
        {k: v for k, v in b.items() if k != "img_pos_feat"})),
    "accum_steps": lambda b: (_signature(b), _signature(b, accum=4)),
    "fuse_accum": lambda b: (_signature(b), _signature(b, fuse=True)),
    "gather_data": lambda b: (_signature(b), _signature(b, gather=True)),
    "data": lambda b: (_signature(b), _signature(b, data=DATA)),
    "data_moved": lambda b: (_signature(b, data=DATA), _signature(
        b, data={k: v.clone() for k, v in DATA.items()})),
    "no_generator": lambda b: (_signature(b), _signature(b, generator=None)),
}


@pytest.mark.parametrize("case", list(SIGNATURE_CASES))
def test_signature_separates_what_a_graph_fixes(case):
    """A graph serves one signature: another shape, dtype or key set,
    accumulation or mode, gathered dataset (by address) or a missing
    generator is another; other values of the same shapes are not."""
    assert _signature(_batch(0)) == _signature(_batch(1))
    assert (_signature(_batch(0), data=DATA)
            == _signature(_batch(1), data=dict(DATA)))
    ref, other = SIGNATURE_CASES[case](_batch(0))
    assert ref != other


ROUTES = {"adam": (dict(), True), "adamw": (dict(name="adamw"), True),
          "adamw_fp32_moments": (dict(name="adamw", mu_dtype=None,
                                      nu_dtype=None), True),
          "adamax": (dict(name="adamax"), False),
          "sgd": (dict(name="sgd", beta1=0.9), False),
          "folds": (dict(folds=2), False),
          "split": (dict(split=({"linear.bias"}, None)), False)}


@pytest.mark.parametrize("route", list(ROUTES))
def test_the_step_captures_through_the_fused_update_alone(route):
    """On a card, the fused Adam / AdamW update captures; adamax, SGD, a
    fold axis and a model split (the ``_foreach_*`` chain, its scalars
    passed from the host each step) stay eager; on the CPU nothing
    captures, and neither does a model that recomputes its layers."""
    kw, fused = ROUTES[route]
    kw = dict(kw)
    opt = _optimizer(kw.pop("name", "adam"), **kw)
    params = {"linear.weight": torch.zeros(3, 4), "linear.bias":
              torch.zeros(4)}
    if kw.get("folds"):
        params = {n: p[None].expand(2, *p.shape) for n, p in params.items()}
    cuda = torch.device("cuda")
    assert step_captures(cuda, opt, params, False) == fused
    assert not step_captures(torch.device("cpu"), opt, params, False)
    assert not step_captures(cuda, opt, params, True)


def test_no_capture_under_a_process_group(tmp_path):
    """A step in a process that has a process group (a mesh, torchrun)
    stays eager."""
    opt = _optimizer()
    params = {"linear.weight": torch.zeros(3, 4)}
    cuda = torch.device("cuda")
    assert step_captures(cuda, opt, params, False)
    dist.init_process_group("gloo", init_method="file://%s" % (
        tmp_path / "rendezvous"), world_size=1, rank=0)
    try:
        assert not step_captures(cuda, opt, params, False)
    finally:
        dist.destroy_process_group()
    assert step_captures(cuda, opt, params, False)


def test_the_fold_stacked_step_stays_eager():
    """``make_fold_train_step`` (folds in the optimizer: the chain) runs
    eagerly: a step captures and replays nothing."""
    counts = _graph_counts()
    stack = FoldStack.from_models((_model(seed=f) for f in range(2)), 2)
    opt = _optimizer(folds=2)
    assert not step_captures(torch.device("cuda"), opt, stack.params, False)
    state = TrainState(stack, opt.init(stack.params))
    step = make_fold_train_step(stack, TL.make_loss_fn("bce_logits", 1.8),
                                opt, accum_steps=2)
    batch = {k: torch.stack([v, v]) for k, v in _batch(0).items()}
    gens = [dropout_generator(7 + f, 0, "cpu") for f in range(2)]
    state, out = step(state, batch, gens)
    assert out["loss"].shape == (2, 2) and state.step == 1
    assert _graph_counts() == counts


@pytest.mark.parametrize("moments", ["bfloat16", "float32"])
@pytest.mark.parametrize("name", ["adam", "adamw"])
def test_plain_route_with_tensor_scalars_equals_the_float_route(name,
                                                                moments):
    """Three updates through ``adam_update`` with the scalars in a tensor
    (``Optimizer.prepare``) against ``fused_adam_plain`` given the same
    scalars as Python floats (the bias corrections and step size as the
    optimizer computes them): parameters and moments bit for bit."""
    gen = torch.Generator().manual_seed(0)
    shapes = {"a.weight": (7, 5), "a.bias": (5,), "b.LayerNorm.weight": (5,),
              "c.weight": (4099,)}
    opt = _optimizer(name, mu_dtype=moments, nu_dtype=moments)
    start = {n: torch.randn(s, generator=gen) for n, s in shapes.items()}
    p1 = {n: v.clone() for n, v in start.items()}
    p2 = {n: v.clone() for n, v in start.items()}
    s1, s2 = opt.init(p1), opt.init(p2)
    for step in range(3):
        grads = {n: torch.randn(s, generator=gen) * (1.0, 1e-3, 0.5)[step]
                 for n, s in shapes.items()}
        sched = opt.prepare(p1, s1)
        c1, c2 = opt._corrections(s1["count"] + 1)
        assert sched.dtype == torch.float32 and sched.tolist() == [
            c1, c2, opt._step_size(s1["count"])]
        args, kwargs = opt.fused_update(p1, grads, s1, sched)
        fused_adam.adam_update(*args, **kwargs)
        s1["count"] += 1
        args, kwargs = opt.fused_update(p2, grads, s2, sched)
        p, g, mu, nu, decay, scales, clip, _ = args
        fused_adam.fused_adam_plain(
            p, g, mu, nu, decay, scales, clip, b1=kwargs["b1"],
            b2=kwargs["b2"], eps=kwargs["eps"],
            weight_decay=kwargs["weight_decay"], c1=c1, c2=c2,
            step_size=opt._step_size(s2["count"]), adamw=kwargs["adamw"])
        s2["count"] += 1
    _assert_same(p1, p2, "params")
    for slot in ("mu", "nu"):
        _assert_same(s1[slot], s2[slot], slot)


def test_prepare_writes_into_the_buffer_it_is_given():
    """``prepare(out=)`` writes the step's scalars into that tensor (a
    captured update's buffer) and returns it."""
    opt = _optimizer()
    params = {"a.weight": torch.zeros(3)}
    state = opt.init(params)
    state["count"] = 4
    out = torch.full((3,), float("nan"))
    assert opt.prepare(params, state, out=out) is out
    assert out.tolist() == opt.prepare(params, state).tolist()
    assert out.tolist() == [*opt._corrections(5), opt._step_size(4)]


def test_launch_counts_of_a_capture_come_off_and_back():
    """The counters a capture recorded are taken off (a capture launches
    nothing) and added again at each replay."""
    before = steps._launch_counts()
    fused_adam.ADAM_LAUNCHES += 2
    attention.LAUNCHES["fused_attention"] += 3
    attention.ROUTE_LAUNCHES[("fused_attention", "mma_tf32x3")] += 3
    linear.LAUNCHES["forward"] += 5
    linear.LAUNCHES["splitk_sum"] += 1
    expert_linear.LAUNCHES["wgrad"] += 4
    delta = steps._launches_since(before)
    assert delta[0] == 2 and delta[1]["fused_attention"] == 3
    assert delta[3] == {"forward": 5, "dgrad": 0, "wgrad": 0,
                        "splitk_sum": 1}
    assert delta[4] == {"forward": 0, "dgrad": 0, "wgrad": 4}
    steps._add_launches(delta, -1)
    assert steps._launch_counts() == before
    steps._add_launches(delta)
    steps._add_launches(delta, -1)
    assert steps._launch_counts() == before


# ------------------------------------------------------------------ the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: run python -m pytest --noconftest "
                    "-m card tests/test_torch_step_graph.py on one")
    return torch.device("cuda")


def _card_pair(card, fuse_accum, **cfg):
    """Two states from one start on the card, and the step of each: the
    captured step and its eager body."""
    out = []
    for _ in range(2):
        model = _model(card, use_pallas_attention=True, **cfg)
        opt = _optimizer()
        state = create_train_state(model, opt)
        step = make_train_step(model, TL.make_loss_fn("bce_logits", 1.8),
                               opt, accum_steps=2, fuse_accum=fuse_accum)
        out.append((state, step))
    return out


@pytest.mark.card
@pytest.mark.parametrize("fuse_accum", [False, True],
                         ids=["scan_accum", "fused_accum"])
def test_replayed_steps_equal_eager_steps(card, fuse_accum):
    """Four steps replayed (the first captured) against four eager steps
    from the same weights and generators: losses, probabilities,
    parameters and moments bit for bit; one capture, three replays, and
    the launch counters counting as many launches either way."""
    (gs, graphed), (es, eager) = _card_pair(card, fuse_accum)
    batches = [_batch(i, card) for i in range(4)]
    counts, launches = _graph_counts(), steps._launch_counts()
    got = _run(graphed, gs, batches, card)
    mid = steps._launch_counts()
    assert _graph_counts() == (counts[0] + 1, counts[1] + 3)
    want = _run(eager.eager, es, batches, card)
    torch.cuda.synchronize()
    end = steps._launch_counts()
    assert mid[0] - launches[0] == end[0] - mid[0] == 4
    for table in (1, 3):
        assert ({k: n - launches[table][k] for k, n in mid[table].items()}
                == {k: end[table][k] - n for k, n in mid[table].items()})
    assert end[3]["forward"] > mid[3]["forward"]
    for a, b in zip(got, want):
        assert torch.equal(_bits(a), _bits(b))
    _assert_same_state(gs, es)


@pytest.mark.card
def test_a_new_signature_captures_once(card):
    """A second batch shape captures its own graph once; each shape then
    replays its own, and both equal the eager steps."""
    (gs, graphed), (es, eager) = _card_pair(card, False)
    batches = [_batch(i, card, B=3 + i % 2) for i in range(6)]
    counts = _graph_counts()
    got = [_run(graphed, gs, [b], card) for b in batches]
    assert _graph_counts() == (counts[0] + 2, counts[1] + 4)
    want = [_run(eager.eager, es, [b], card) for b in batches]
    for (l1, p1), (l2, p2) in zip(got, want):
        assert torch.equal(_bits(l1), _bits(l2))
        assert torch.equal(_bits(p1), _bits(p2))
    _assert_same_state(gs, es)


@pytest.mark.card
def test_a_moved_state_captures_again(card):
    """Moments replaced by copies (as a resume loads them) move the graph's
    operands: the step captures again and stays equal to the eager one."""
    (gs, graphed), (es, eager) = _card_pair(card, False)
    batches = [_batch(i, card) for i in range(4)]
    counts = _graph_counts()
    _run(graphed, gs, batches[:2], card)
    _run(eager.eager, es, batches[:2], card)
    for slot in ("mu", "nu"):
        gs.opt_state[slot] = {n: v.clone() for n, v in
                              gs.opt_state[slot].items()}
    _run(graphed, gs, batches[2:], card)
    _run(eager.eager, es, batches[2:], card)
    assert _graph_counts() == (counts[0] + 2, counts[1] + 2)
    _assert_same_state(gs, es)


@pytest.mark.card
def test_remat_stays_eager_on_the_card(card):
    """A model that recomputes its layers steps eagerly on the card."""
    (gs, graphed), (es, eager) = _card_pair(card, False, remat=True)
    counts = _graph_counts()
    batches = [_batch(i, card) for i in range(2)]
    got = _run(graphed, gs, batches, card)
    want = _run(eager.eager, es, batches, card)
    assert _graph_counts() == counts
    for a, b in zip(got, want):
        assert torch.equal(_bits(a), _bits(b))
