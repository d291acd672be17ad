"""PyTorch port, the fused Adam / AdamW update (``ops/fused_adam.py``,
``ops/csrc/fused_adam.cu``) and its route in ``train/optim.py``.

On the CPU: the plain version, which the route takes there, is bit for bit
the optimizer's ``_foreach_*`` chain (``Optimizer.chain_step``) over three
steps; the route serves single-model Adam and AdamW over fp32 parameters and
nothing else; a checkpoint taken mid-run resumes bit for bit; a train step
through the route equals one through the chain. On a card (marker ``card``;
``python -m pytest --noconftest -m card tests/test_torch_fused_adam.py``
there): the kernel is bit for bit the chain at UNITER-base's 212 leaves and
at odd-sized and unaligned leaves, one launch a step. This file imports no
JAX."""
import numpy as np
import pytest
import torch

from meme_challenge_tpu_torch.core.config import UniterConfig
from meme_challenge_tpu_torch.models.uniter import MemeUniter
from meme_challenge_tpu_torch.ops import fused_adam
from meme_challenge_tpu_torch.train import losses as TL
from meme_challenge_tpu_torch.train.checkpoint import (
    load_train_state,
    save_train_state,
)
from meme_challenge_tpu_torch.train.optim import Optimizer
from meme_challenge_tpu_torch.train.steps import (
    create_train_state,
    make_train_step,
)

# names that the decay mask tells apart; a 1-element leaf (the head's bias),
# odd sizes and a leaf across the kernel's 4 096-element tile
LEAVES = {"encoder.layer.0.attention.self.query.weight": (7, 5),
          "encoder.layer.0.attention.self.query.bias": (5,),
          "encoder.layer.0.output.LayerNorm.weight": (5,),
          "img_embeddings.img_layer_norm.weight": (3,),
          "img_embeddings.img_linear.weight": (3, 3, 3),
          "word_embeddings.weight": (4099,),
          "linear.bias": (1,)}
MOMENTS = {"bf16": ("bfloat16", "bfloat16"), "fp32": ("float32", "float32"),
           "bf16_fp32": ("bfloat16", "float32"),
           "fp32_bf16": ("float32", "bfloat16")}
# gradient scale a step: the global norm ≈ 60 (the clip at 1.0 engages),
# ≈ 0.06 (it stands aside), then engaged again
GRAD_SCALES = (1.0, 1e-3, 0.5)


def _gen(seed, device="cpu"):
    return torch.Generator(device).manual_seed(seed)


def _leaves(shapes, gen, scale=1.0, device="cpu"):
    return {n: torch.randn(s, generator=gen, device=device) * scale
            for n, s in shapes.items()}


def _bits(t):
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int16)


def _assert_bit_equal(a: dict, b: dict, what: str):
    for n in a:
        assert a[n].dtype == b[n].dtype, (what, n)
        assert torch.equal(_bits(a[n]), _bits(b[n])), (what, n)


def _optimizer(name, moments, scales, clip, names, weight_decay=0.1):
    mu, nu = MOMENTS[moments]
    update_scales = None
    if scales:  # 0 freezes a leaf, 2 speeds one up
        update_scales = {n: (0.0 if "query.weight" in n else
                             2.0 if n == "linear.bias" else 1.0)
                         for n in names}
    return Optimizer(name, 1e-2, lambda count: 1.0 / (1 + count),
                     weight_decay=weight_decay,
                     max_grad_norm=1.0 if clip else None,
                     update_scales=update_scales, mu_dtype=mu, nu_dtype=nu)


def _run_both(opt, shapes, device, steps=3, seed=0):
    """``steps`` updates of the same leaves by ``opt.step`` and by
    ``opt.chain_step`` from copies of one start: (params, state) of each,
    the launches ``step`` made, and whether its moments kept their
    tensors."""
    gen = _gen(seed, device)
    start = _leaves(shapes, gen, device=device)
    fused = {n: v.clone() for n, v in start.items()}
    chain = {n: v.clone() for n, v in start.items()}
    f_state, c_state = opt.init(fused), opt.init(chain)
    moments = {n: f_state["mu"][n] for n in fused}
    launches = fused_adam.ADAM_LAUNCHES
    for step in range(steps):
        grads = _leaves(shapes, gen, GRAD_SCALES[step % 3], device)
        opt.step(fused, grads, f_state)
        opt.chain_step(chain, grads, c_state)
    kept = all(f_state["mu"][n] is moments[n] for n in fused)
    return ((fused, f_state), (chain, c_state),
            fused_adam.ADAM_LAUNCHES - launches, kept)


def _assert_same_run(fused, chain):
    (fp, fs), (cp, cs) = fused, chain
    _assert_bit_equal(fp, cp, "params")
    _assert_bit_equal(fs["mu"], cs["mu"], "mu")
    _assert_bit_equal(fs["nu"], cs["nu"], "nu")
    assert fs["count"] == cs["count"]


# ------------------------------------------------------- the plain version

@pytest.mark.parametrize("clip", [True, False], ids=["clip", "no_clip"])
@pytest.mark.parametrize("scales", [False, True],
                         ids=["no_scales", "scales"])
@pytest.mark.parametrize("moments", list(MOMENTS))
@pytest.mark.parametrize("name", ["adam", "adamw"])
def test_plain_update_equals_the_chain_bit_for_bit(name, moments, scales,
                                                   clip):
    """Three updates of the same leaves, decay through the mask, by the
    route (the plain version on the CPU) and by the chain: parameters and
    moments equal bit for bit, the moments' dtypes kept, one launch a
    step."""
    opt = _optimizer(name, moments, scales, clip, list(LEAVES))
    assert opt.fused(_leaves(LEAVES, _gen(0)))
    fused, chain, launches, kept = _run_both(opt, LEAVES, "cpu")
    _assert_same_run(fused, chain)
    assert launches == 3 and kept
    mu, nu = (getattr(torch, d) for d in MOMENTS[moments])
    assert all(m.dtype == mu for m in fused[1]["mu"].values())
    assert all(v.dtype == nu for v in fused[1]["nu"].values())
    # the run exercised what it names: the decay mask split the leaves, a
    # scale of 0 froze its leaf, and every other leaf moved
    start = _leaves(LEAVES, _gen(0))
    frozen = [n for n in LEAVES if scales and "query.weight" in n]
    for n in LEAVES:
        assert torch.equal(fused[0][n], start[n]) == (n in frozen), n
    assert 0 < sum(opt._leaves[1]) < len(LEAVES)


def test_the_clip_engages_and_stands_aside():
    """GRAD_SCALES's global norms lie on both sides of the clip's 1.0."""
    gen = _gen(0)
    _leaves(LEAVES, gen)
    norms = []
    for scale in GRAD_SCALES:
        g = _leaves(LEAVES, gen, scale)
        norms.append(float(torch.linalg.vector_norm(
            torch.stack([x.norm() for x in g.values()]))))
    assert norms[0] > 1.0 > norms[1] and norms[2] > 1.0


def test_wrapper_refuses_what_the_kernel_does_not_take():
    p = [torch.zeros(4)]
    sched = torch.tensor([0.1, 0.001, -1e-3])
    ok = dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0, adamw=False)
    with pytest.raises(TypeError, match="p must be"):
        fused_adam.adam_update([torch.zeros(4, dtype=torch.float64)],
                               p, p, p, [False], [1.0], None, sched, **ok)
    with pytest.raises(TypeError, match="mu must be"):
        fused_adam.adam_update(p, p, [torch.zeros(4, dtype=torch.float16)],
                               p, [False], [1.0], None, sched, **ok)
    with pytest.raises(ValueError, match="contiguous"):
        fused_adam.adam_update(p, [torch.zeros(4, 2)[:, 0]], p, p, [False],
                               [1.0], None, sched, **ok)
    with pytest.raises(ValueError, match="as many elements"):
        fused_adam.adam_update(p, p, [torch.zeros(5)], p, [False], [1.0],
                               None, sched, **ok)
    with pytest.raises(ValueError, match="n >= 1"):
        fused_adam.adam_update(p, p, p, p, [False, True], [1.0], None, sched,
                               **ok)
    for bad in (sched[:2], sched.double(), torch.zeros(6)[::2]):
        with pytest.raises(ValueError, match="step's scalars"):
            fused_adam.adam_update(p, p, p, p, [False], [1.0], None, bad,
                                   **ok)


# ---------------------------------------------------------------- the route

ROUTE_CASES = {
    "adam": (dict(name="adam", mu_dtype="bfloat16", nu_dtype="bfloat16"),
             True),
    "adamw": (dict(name="adamw"), True),
    "adamax": (dict(name="adamax"), False),
    "sgd": (dict(name="sgd", beta1=0.9), False),
    "folds2": (dict(name="adam", folds=2, mu_dtype="bfloat16",
                    nu_dtype="bfloat16"), False),
    "split": (dict(name="adam", split=({"a.weight"}, None)), False),
    "bf16_params": (dict(name="adam"), False),
    "fp16_moments": (dict(name="adam", mu_dtype="float16"), False),
}


@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_route_serves_single_model_adam_over_fp32_alone(case):
    """Adam and AdamW of one model over fp32 parameters take the fused
    update (a launch a step, the state's tensors kept); adamax, SGD, a fold
    axis, a model split, bf16 parameters and fp16 moments keep the chain
    (no launch, the chain's fresh state tensors)."""
    kw, fused = ROUTE_CASES[case]
    kw = dict(kw)
    name = kw.pop("name")
    folds = kw.get("folds", 0)
    dtype = torch.bfloat16 if case == "bf16_params" else torch.float32
    shapes = {"a.weight": (3, 4), "a.bias": (4,)}
    lead = (folds,) if folds else ()
    gen = _gen(0)
    params = {n: torch.randn(*lead, *s, generator=gen).to(dtype)
              for n, s in shapes.items()}
    opt = Optimizer(name, 1e-2, lambda count: 1.0, weight_decay=0.1,
                    max_grad_norm=1.0, **kw)
    assert opt.fused(params) == fused
    state = opt.init(params)
    slot = "trace" if name == "sgd" else "mu"
    before = dict(state[slot])
    launches = fused_adam.ADAM_LAUNCHES
    for _ in range(2):
        opt.step(params, {n: torch.ones_like(p) for n, p in params.items()},
                 state)
    assert fused_adam.ADAM_LAUNCHES - launches == (2 if fused else 0)
    assert all((state[slot][n] is before[n]) == fused for n in params)
    assert state["count"] == 2


# --------------------------------------------------------- resume, the step

class _Tiny(torch.nn.Module):
    """Linear, LayerNorm, a one-logit head: decayed and undecayed leaves,
    and the head's 1-element bias."""

    def __init__(self, seed):
        super().__init__()
        torch.manual_seed(seed)
        self.dense = torch.nn.Linear(6, 5)
        self.LayerNorm = torch.nn.LayerNorm(5)
        self.linear = torch.nn.Linear(5, 1)

    def forward(self, batch, deterministic=True, generator=None):
        return self.linear(self.LayerNorm(self.dense(batch["x"])))


def _batch(seed, accum=2, B=4):
    rng = np.random.RandomState(seed)
    return {"x": torch.tensor(rng.randn(accum, B, 6).astype(np.float32)),
            "labels": torch.tensor(rng.randint(0, 2, (accum, B))),
            "sample_mask": torch.ones(accum, B, dtype=torch.int32)}


def _trainer_parts(name, seed=0):
    model = _Tiny(seed)
    opt = Optimizer(name, 1e-2, lambda count: 1.0 / (1 + count),
                    weight_decay=0.1, max_grad_norm=0.5,
                    mu_dtype="bfloat16", nu_dtype="bfloat16")
    state = create_train_state(model, opt)
    step = make_train_step(model, TL.make_loss_fn("bce_logits", 1.8), opt,
                           accum_steps=2)
    return state, step


@pytest.mark.parametrize("name", ["adam", "adamw"])
def test_resume_mid_run_is_bit_for_bit(name, tmp_path):
    """Four steps straight, against two steps, a checkpoint, a fresh model,
    optimizer and state loaded from it, and two more steps: the same
    parameters and moments, bit for bit."""
    straight, step = _trainer_parts(name)
    for i in range(4):
        straight, _ = step(straight, _batch(i), None)

    first, step = _trainer_parts(name)
    for i in range(2):
        first, _ = step(first, _batch(i), None)
    path = str(tmp_path / "state.pt")
    save_train_state(path, first, epoch=1)
    resumed, step = _trainer_parts(name, seed=1)
    resumed, epoch = load_train_state(path, resumed)
    assert epoch == 1 and resumed.opt_state["count"] == 2
    launches = fused_adam.ADAM_LAUNCHES
    for i in range(2, 4):
        resumed, _ = step(resumed, _batch(i), None)
    assert fused_adam.ADAM_LAUNCHES - launches == 2
    _assert_bit_equal(dict(straight.model.named_parameters()),
                      dict(resumed.model.named_parameters()), "params")
    for slot in ("mu", "nu"):
        _assert_bit_equal(straight.opt_state[slot], resumed.opt_state[slot],
                          slot)


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_through_the_route_equals_the_chain(accum, monkeypatch):
    """``make_train_step`` (its in-place divide by ``accum`` included) with
    the fused update, against the same steps with the route turned off."""
    def run():
        model = _Tiny(0)
        opt = Optimizer("adam", 1e-2, lambda count: 1.0, weight_decay=0.1,
                        max_grad_norm=0.5, mu_dtype="bfloat16",
                        nu_dtype="bfloat16")
        state = create_train_state(model, opt)
        step = make_train_step(model, TL.make_loss_fn("bce_logits", 1.8),
                               opt, accum_steps=accum)
        for i in range(3):
            state, _ = step(state, _batch(i, accum), None)
        return state

    fused = run()
    monkeypatch.setattr(Optimizer, "fused", lambda self, params: False)
    launches = fused_adam.ADAM_LAUNCHES
    chain = run()
    assert fused_adam.ADAM_LAUNCHES == launches
    _assert_bit_equal(dict(fused.model.named_parameters()),
                      dict(chain.model.named_parameters()), "params")
    for slot in ("mu", "nu"):
        _assert_bit_equal(fused.opt_state[slot], chain.opt_state[slot], slot)


# ------------------------------------------------------------------ the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: run python -m pytest --noconftest "
                    "-m card tests/test_torch_fused_adam.py on one")
    return torch.device("cuda")


def _uniter_base_shapes():
    with torch.device("meta"):
        model = MemeUniter(UniterConfig())
    return {n: tuple(p.shape) for n, p in model.named_parameters()}


def _unaligned(shapes, gen, scale, device, dtype=torch.float32):
    """Each leaf a contiguous view 1-3 elements into a buffer of its own:
    pointers 2 to 12 bytes past a 16-byte boundary."""
    out = {}
    for i, (n, s) in enumerate(shapes.items()):
        size = int(np.prod(s))
        off = 1 + i % 3
        buf = torch.empty(size + off, dtype=dtype, device=device)
        buf[off:] = torch.randn(size, generator=gen, device=device) * scale
        out[n] = buf[off:].view(s)
    return out


ODD = {"w%d.weight" % i: (size,) for i, size in
       enumerate((1, 3, 5, 7, 1000, 4095, 4096, 4097, 12347))}


@pytest.mark.card
@pytest.mark.parametrize("name,moments", [("adam", "bf16"), ("adamw", "fp32"),
                                          ("adam", "bf16_fp32")])
def test_kernel_equals_the_chain_at_uniter_base_leaves(card, name, moments):
    """UNITER-base's 212 leaves at their widths on the card: three updates
    by the kernel and by the chain, bit for bit, one launch a step."""
    shapes = _uniter_base_shapes()
    assert len(shapes) == 212
    opt = _optimizer(name, moments, False, True, list(shapes),
                     weight_decay=1e-3)
    fused, chain, launches, kept = _run_both(opt, shapes, card)
    torch.cuda.synchronize()
    _assert_same_run(fused, chain)
    assert launches == 3 and kept


@pytest.mark.card
@pytest.mark.parametrize("moments", list(MOMENTS))
def test_kernel_equals_the_chain_at_odd_and_unaligned_leaves(card, moments):
    """Odd sizes around the 4 096-element tile, aligned and then unaligned
    (every pointer off its 16-byte boundary), with update scales: the kernel
    equals the chain bit for bit, one launch a step."""
    opt = _optimizer("adam", moments, True, True, list(ODD))
    fused, chain, launches, kept = _run_both(opt, ODD, card)
    _assert_same_run(fused, chain)
    assert launches == 3 and kept

    gen = _gen(3, card)
    mu_dt, nu_dt = (getattr(torch, d) for d in MOMENTS[moments])
    params = _unaligned(ODD, gen, 1.0, card)
    state = {"count": 0, "mu": _unaligned(ODD, gen, 0.01, card, mu_dt),
             "nu": _unaligned(ODD, gen, 0.0001, card, nu_dt)}
    state["nu"] = {n: v.abs() for n, v in state["nu"].items()}
    ref = {n: v.clone() for n, v in params.items()}
    ref_state = {"count": 0,
                 "mu": {n: v.clone() for n, v in state["mu"].items()},
                 "nu": {n: v.clone() for n, v in state["nu"].items()}}
    launches = fused_adam.ADAM_LAUNCHES
    for step in range(3):
        grads = _unaligned(ODD, gen, GRAD_SCALES[step], card)
        opt.step(params, grads, state)
        opt.chain_step(ref, {n: g.clone() for n, g in grads.items()},
                       ref_state)
    assert fused_adam.ADAM_LAUNCHES - launches == 3
    _assert_same_run((params, state), (ref, ref_state))


@pytest.mark.card
def test_kernel_splits_long_leaf_lists(card):
    """More leaves than one launch's table: two launches a step, still bit
    for bit the chain."""
    n = fused_adam.max_leaves() + 7
    shapes = {"w%d.weight" % i: (i % 5 + 1,) for i in range(n)}
    opt = _optimizer("adam", "bf16", False, True, list(shapes))
    fused, chain, launches, kept = _run_both(opt, shapes, card)
    _assert_same_run(fused, chain)
    assert launches == 2 * 3 and kept
