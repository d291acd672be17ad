"""PyTorch port, the encoder's dense layers (``ops/linear.py``,
``ops/csrc/linear_tf32x3.cu``).

On the CPU: the kernel's 3×TF32 arithmetic, emulated (the split's rounding
by bit operations, the three products of each 8 k small terms first, a
stage of 32 k summed apart and added to the running sum), holds float32's
accuracy against float64 at the encoder's depths for the forward, dgrad
and wgrad, and one TF32 product does not; the route (CPU: the plain
version, bfloat16 on a card: ``F.linear``, float32 on a card: the kernel,
which raises on shapes it cannot take); the operator's autograd formula
against ``F.linear`` and the add in float64; ``_DOTS`` and remat's "dots"
policy keep the operator's output; the split plan; the row list (valid rows
first, the count, the counter) and the plan of every count it can hold. On
a card (marker ``card``; ``python -m pytest --noconftest -m card
tests/test_torch_linear.py`` there): the kernel against the plain version
and float64 at UNITER-base's and UNITER-large's shapes, bit for bit from
run to run; over a row list (≈ 49 % valid, all valid, one row) the
listed rows against float64, the others zero, the forward's listed rows
equal to the no-list launch's wherever the plans agree (every product with
an all-valid list), and one captured graph replayed over two masks. This
file imports no JAX."""
import functools
import math

import pytest
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    checkpoint,
    create_selective_checkpoint_contexts,
)

from meme_challenge_tpu_torch.models import uniter as U
from meme_challenge_tpu_torch.ops import linear as L

DEPTHS = (768, 1024, 3072, 4096)  # the encoder's hidden and FFN widths
PRODUCTS = ("forward", "dgrad", "wgrad")


def _tf32(x):
    """x rounded to TF32 as mma_tf32.cuh's ``to_tf32``: the low 13 mantissa
    bits dropped, the magnitude rounded half away from zero."""
    u = x.contiguous().view(torch.int32)
    return ((u + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_truncated(x):
    """x as the tensor core reads an fp32 value as TF32: the low 13 mantissa
    bits ignored."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _split(x):
    hi = _tf32(x)
    return hi, _tf32_truncated(x - hi)


def _mm_3xtf32(a, b):
    """a [M, D] · b [D, N] as the kernel takes it: a_lo·b_hi, a_hi·b_lo,
    a_hi·b_hi for each 8 k in that order into a stage sum of 32 k, each
    stage's sum added to the running sum, all in fp32."""
    (m, d), n = a.shape, b.shape[1]
    a_hi, a_lo = _split(a)
    b_hi, b_lo = _split(b)

    def per_8k(p, q):
        return torch.einsum("mck,ckn->cmn", p.reshape(m, d // 8, 8),
                            q.reshape(d // 8, 8, n))

    terms = per_8k(a_lo, b_hi), per_8k(a_hi, b_lo), per_8k(a_hi, b_hi)
    acc = torch.zeros(m, n)
    for stage in range(d // L.BLOCK_K):
        part = torch.zeros(m, n)
        for c in range(4 * stage, 4 * stage + 4):
            for t in terms:
                part = part + t[c]
        acc = acc + part
    return acc


def _mm_1xtf32(a, b):
    return _tf32(a) @ _tf32(b)


def _operands(product, depth, seed):
    """(a, b, bias) of ``product`` with ``depth`` as its contraction: the
    forward x·Wᵀ + b, dgrad dy·W, wgrad dyᵀ·x, 64 × 64 outputs."""
    g = torch.Generator().manual_seed(seed)
    rows = 64
    if product == "forward":
        x = torch.randn(rows, depth, generator=g)
        w = torch.randn(rows, depth, generator=g) / math.sqrt(depth)
        return x, w.t(), torch.randn(rows, generator=g)
    if product == "dgrad":
        dy = torch.randn(rows, depth, generator=g)
        w = torch.randn(depth, rows, generator=g) / math.sqrt(depth)
        return dy, w, None
    dy = torch.randn(depth, rows, generator=g)
    x = torch.randn(depth, rows, generator=g) / math.sqrt(depth)
    return dy.t(), x, None


def _err(mm, a, b, bias):
    ref = a.double() @ b.double()
    got = mm(a.contiguous(), b.contiguous())
    if bias is not None:
        ref, got = ref + bias.double(), got + bias
    return (got.double() - ref).abs().max().item()


@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("product", PRODUCTS)
def test_3xtf32_holds_fp32_accuracy(product, depth):
    """Against float64, the emulated kernel errs by at most 2× what fp32
    ``F.linear`` errs by on the same operands; one TF32 product errs by
    hundreds of times more."""
    a, b, bias = _operands(product, depth, seed=depth)
    fp32 = _err(torch.matmul, a, b, bias)
    kernel = _err(_mm_3xtf32, a, b, bias)
    assert kernel <= 2.0 * fp32, (kernel, fp32)
    assert _err(_mm_1xtf32, a, b, bias) > 50.0 * fp32


# ---------------------------------------------------------------- the route

@pytest.mark.parametrize("device,dtype,want", [
    ("cpu", torch.float32, "plain"), ("cpu", torch.bfloat16, "plain"),
    ("cuda", torch.bfloat16, "library"), ("cuda", torch.float32, "kernel")])
def test_route_by_device_and_dtype(device, dtype, want):
    for k, n in ((768, 768), (768, 3072), (3072, 768), (1024, 4096)):
        assert L.linear_route(device, dtype, k, n) == want


@pytest.mark.parametrize("k,n", [(770, 768), (768, 770), (6, 8)])
def test_float32_on_a_card_raises_on_shapes_the_kernel_cannot_take(k, n):
    with pytest.raises(ValueError, match="multiples of 4"):
        L.linear_route("cuda", torch.float32, k, n)
    assert L.linear_route("cpu", torch.float32, k, n) == "plain"
    assert L.linear_route("cuda", torch.bfloat16, k, n) == "library"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_takes_the_plain_version_bit_for_bit(dtype):
    """On the CPU the encoder's ``_linear`` is ``F.linear`` then the bias,
    as before the kernel, and the operator is not called."""
    g = torch.Generator().manual_seed(3)
    layer = torch.nn.Linear(12, 8)
    x = torch.randn(2, 5, 12, generator=g).to(dtype)
    calls = dict(L.LAUNCHES)
    got = U._linear(x, layer, dtype)
    want = F.linear(x, layer.weight.to(dtype)) + layer.bias.to(dtype)
    assert got.dtype == dtype
    assert torch.equal(got, want)
    assert L.LAUNCHES == calls


# ----------------------------------------------------- the operator on the CPU

@pytest.mark.parametrize("lead", [(7,), (2, 5)])
@pytest.mark.parametrize("needs", ["all", "input", "params"])
def test_op_gradient_equals_linear_and_add_in_float64(lead, needs):
    g = torch.Generator().manual_seed(5)
    x = torch.randn(*lead, 12, generator=g, dtype=torch.float64)
    w = torch.randn(8, 12, generator=g, dtype=torch.float64)
    b = torch.randn(8, generator=g, dtype=torch.float64)
    wants = {"all": (True, True, True), "input": (True, False, False),
             "params": (False, True, True)}[needs]
    leaves = [t.requires_grad_(r) for t, r in zip((x, w, b), wants)]
    dy = torch.randn(*lead, 8, generator=g, dtype=torch.float64)
    grads = [t for t in leaves if t.requires_grad]
    y = torch.ops.meme.linear_tf32x3(x, w, b)
    got = torch.autograd.grad((y * dy).sum(), grads)
    y_ref = F.linear(x, w) + b
    want = torch.autograd.grad((y_ref * dy).sum(), grads)
    torch.testing.assert_close(y, y_ref, rtol=0, atol=1e-13)
    for gt, wt in zip(got, want):
        torch.testing.assert_close(gt, wt, rtol=0, atol=1e-12)


@pytest.mark.parametrize("needs", ["all", "input", "params"])
def test_op_without_bias_equals_linear_in_float64(needs):
    """A bias of None: the product alone, and its gradients those of
    ``F.linear`` without a bias (none for the missing bias)."""
    g = torch.Generator().manual_seed(7)
    x = torch.randn(2, 5, 12, generator=g, dtype=torch.float64)
    w = torch.randn(8, 12, generator=g, dtype=torch.float64)
    wants = {"all": (True, True), "input": (True, False),
             "params": (False, True)}[needs]
    grads = [t.requires_grad_() for t, r in zip((x, w), wants) if r]
    dy = torch.randn(2, 5, 8, generator=g, dtype=torch.float64)
    y = torch.ops.meme.linear_tf32x3(x, w, None)
    got = torch.autograd.grad((y * dy).sum(), grads)
    y_ref = F.linear(x, w)
    want = torch.autograd.grad((y_ref * dy).sum(), grads)
    torch.testing.assert_close(y, y_ref, rtol=0, atol=1e-13)
    for gt, wt in zip(got, want):
        torch.testing.assert_close(gt, wt, rtol=0, atol=1e-12)
    assert torch.equal(L.linear(x.detach(), w.detach(), None),
                       F.linear(x.detach(), w.detach()))


def _counted(monkeypatch):
    """Counts the calls of the op's plain bodies (``linear_plain``, and
    ``dgrad`` / ``wgrad`` off a card) through monkeypatched wrappers: off a
    card ``LAUNCHES`` counts nothing."""
    calls = {"forward": 0, "dgrad": 0, "wgrad": 0}
    for name, fn in (("forward", L.linear_plain), ("dgrad", L.dgrad),
                     ("wgrad", L.wgrad)):
        def wrapped(*args, _fn=fn, _name=name):
            calls[_name] += 1
            return _fn(*args)
        monkeypatch.setattr(L, "linear_plain" if name == "forward" else name,
                            wrapped)
    return calls


def test_linear_takes_the_op_with_autograd_where_it_routes_there(
        monkeypatch):
    """With the route forced to the kernel, ``linear`` runs the operator
    (its CPU body here) under autograd and its gradients are those of
    ``F.linear`` and the add; without a gradient it calls the op's CUDA
    body directly; the plain bodies add nothing to ``LAUNCHES``."""
    monkeypatch.setattr(L, "linear_route", lambda *a: "kernel")
    calls = _counted(monkeypatch)
    g = torch.Generator().manual_seed(6)
    x = torch.randn(3, 4, 8, generator=g, dtype=torch.float64,
                    requires_grad=True)
    w = torch.randn(12, 8, generator=g, dtype=torch.float64,
                    requires_grad=True)
    b = torch.randn(12, generator=g, dtype=torch.float64, requires_grad=True)
    before = dict(L.LAUNCHES)
    y = L.linear(x, w, b)
    y.square().sum().backward()
    assert calls == {"forward": 1, "dgrad": 1, "wgrad": 1}
    assert L.LAUNCHES == before
    got = x.grad, w.grad, b.grad
    for t in (x, w, b):
        t.grad = None
    (F.linear(x, w) + b).square().sum().backward()
    for gt, wt in zip(got, (x.grad, w.grad, b.grad)):
        torch.testing.assert_close(gt, wt, rtol=0, atol=1e-12)
    direct = []
    monkeypatch.setattr(L, "_forward_cuda", lambda x, w, b, rows: direct.append(
        rows) or F.linear(x, w, b))
    with torch.no_grad():
        assert torch.equal(L.linear(x, w, b), F.linear(x, w, b))
    assert direct == [None] and calls["forward"] == 1


def test_dots_holds_the_op():
    assert L.LINEAR_OP in U._DOTS
    assert U._save_dots(None, L.LINEAR_OP) == \
        torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE


@pytest.mark.parametrize("policy,forwards", [("dots", 1), ("full", 2)])
def test_remat_dots_saves_the_op_output(policy, forwards, monkeypatch):
    """Under remat's "dots" policy (``_save_dots``) the backward reuses the
    operator's output; under "full" it runs the forward again."""
    g = torch.Generator().manual_seed(8)
    x = torch.randn(6, 8, generator=g, requires_grad=True)
    w = torch.randn(4, 8, generator=g, requires_grad=True)
    b = torch.randn(4, generator=g, requires_grad=True)

    def layer(x):
        return torch.tanh(torch.ops.meme.linear_tf32x3(torch.tanh(x), w, b))

    kw = ({"context_fn": functools.partial(
        create_selective_checkpoint_contexts, U._save_dots)}
        if policy == "dots" else {})
    calls = _counted(monkeypatch)
    out = checkpoint(layer, x, use_reentrant=False, **kw)
    out.sum().backward()
    assert calls["forward"] == forwards
    got = x.grad.clone()
    x.grad = None
    layer(x).sum().backward()
    torch.testing.assert_close(got, x.grad, rtol=0, atol=0)


# ------------------------------------------------------------ the split plan

@pytest.mark.parametrize("rows,cols,depth", [
    (2560, 768, 768), (2560, 3072, 768), (2560, 768, 3072),
    (2560, 1024, 1024), (2560, 4096, 1024), (2560, 1024, 4096),
    (768, 768, 2560), (3072, 768, 2560), (768, 3072, 2560),
    (1024, 1024, 2560), (4096, 1024, 2560), (1024, 4096, 2560),
    (7, 12, 20), (300, 200, 100)])
def test_split_plan_covers_the_depth_without_an_empty_split(rows, cols,
                                                           depth):
    splits, per = L.k_splits(rows, cols, depth)
    stages = math.ceil(depth / L.BLOCK_K)
    assert 1 <= splits <= L.MAX_SPLITS
    assert (splits - 1) * per < stages <= splits * per
    if splits > 1:
        assert per >= L.MIN_SPLIT_STAGES
    assert L.k_splits(rows, cols, depth) == (splits, per)


def test_split_plan_fills_the_card():
    """UNITER-base's forward at 2 560 rows fills whole waves and never
    splits (scoring allocates no workspace); the 768 × 768 wgrad (36 tiles)
    and UNITER-large's 1 024-wide outputs (160 tiles) split."""
    for n, k in ((768, 768), (3072, 768), (768, 3072)):
        assert L.k_splits(2560, n, k)[0] == 1
    assert L.k_splits(768, 768, 2560)[0] > 1
    assert L.k_splits(2560, 1024, 4096)[0] > 1


# ------------------------------------------------------------ the row list

def _key_bias(mask):
    """The encoder's additive key bias of a ``[B, S]`` 0/1 mask."""
    return ((1.0 - mask.float()) * U.NEG_INF)[:, None, None, :]


ROW_MASKS = {
    # [text | pad | regions | pad] of three memes
    "gaps": torch.tensor([[1, 1, 1, 0, 0, 1, 1, 0],
                          [1, 0, 0, 0, 1, 1, 1, 1],
                          [1, 1, 1, 1, 1, 0, 0, 0]]),
    "all_valid": torch.ones(2, 5, dtype=torch.int64),
    "cls_only": torch.tensor([[1, 0, 0, 0, 0, 0], [1, 0, 0, 0, 0, 0]]),
}


@pytest.mark.parametrize("name", sorted(ROW_MASKS))
def test_row_list_puts_the_valid_rows_first(name):
    """``row_list``: the count, then the valid rows ascending, then the
    padded ones ascending, as int32; the counter adds the count and the
    rows offered."""
    mask = ROW_MASKS[name]
    flat = mask.reshape(-1)
    valid = [i for i in range(flat.numel()) if flat[i]]
    padded = [i for i in range(flat.numel()) if not flat[i]]
    before = L.listed_rows(torch.device("cpu")).clone()
    rows = L.row_list(_key_bias(mask))
    assert rows.dtype == torch.int32
    assert rows.tolist() == [len(valid)] + valid + padded
    assert (L.listed_rows(torch.device("cpu")) - before).tolist() == [
        len(valid), flat.numel()]


@pytest.mark.parametrize("rows,cols,depth", [
    (2560, 768, 768), (2560, 3072, 768), (2560, 768, 3072),
    (2560, 1024, 1024), (2560, 4096, 1024), (2560, 1024, 4096),
    (300, 200, 100)])
@pytest.mark.parametrize("product", PRODUCTS)
def test_list_plan_holds_every_count(product, rows, cols, depth):
    """The plan of a listed product for each count: at the whole list the
    no-list plan, at each other count the plan of the product it leaves
    (never an empty split), nothing at count 0, and a grid that every
    plan's blocks fit."""
    # (rows, cols, depth) of the product and whether the list is its rows
    shape, listed = {
        "forward": ((rows, cols, depth), True),
        "dgrad": ((rows, depth, cols), True),
        "wgrad": ((cols, depth, rows), False)}[product]
    m, n, k = shape
    plan, blocks, most = L.list_plan(m, n, k, listed)
    unit = L.BLOCK_M if listed else L.BLOCK_K
    length = m if listed else k
    assert len(plan) == math.ceil(length / unit) + 1
    assert plan[-1] == L.k_splits(m, n, k)
    assert plan[0][0] == 1 and (plan[0][1] == 0) == (not listed)
    tiles_n = math.ceil(n / L.BLOCK_N)
    for u, (splits, per) in enumerate(plan[1:], start=1):
        covered = (min(u * unit, m) if listed else m, n,
                   k if listed else u * unit)
        assert (splits, per) == L.k_splits(*covered)
        stages = math.ceil(covered[2] / L.BLOCK_K)
        assert (splits - 1) * per < stages <= splits * per
        tiles = (u if listed else math.ceil(m / L.BLOCK_M)) * tiles_n
        assert tiles * splits <= blocks
    if listed:
        assert math.ceil(m / L.BLOCK_M) * tiles_n <= blocks
    assert most == max(s for s, _ in plan)


# ------------------------------------------------------------------ the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: run python -m pytest --noconftest "
                    "-m card tests/test_torch_linear.py on one")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


CARD_SHAPES = [(2560, 768, 768), (2560, 3072, 768), (2560, 768, 3072),
               (2560, 1024, 1024), (2560, 4096, 1024), (2560, 1024, 4096),
               (300, 200, 100)]


@pytest.mark.card
@pytest.mark.parametrize("m,n,k", CARD_SHAPES)
def test_kernel_against_float64_and_bit_for_bit(card, m, n, k):
    """Forward, dgrad and wgrad at the encoder's shapes: within 2× the
    error of the fp32 plain products against float64, and the same bits on
    a second call."""
    g = torch.Generator(device=card).manual_seed(m + n + k)
    x = torch.randn(m, k, generator=g, device=card)
    w = torch.randn(n, k, generator=g, device=card) / math.sqrt(k)
    b = torch.randn(n, generator=g, device=card)
    dy = torch.randn(m, n, generator=g, device=card)
    cases = {
        "forward": (lambda: torch.ops.meme.linear_tf32x3(x, w, b),
                    L.linear_plain(x, w, b),
                    x.double() @ w.double().t() + b.double()),
        "dgrad": (lambda: L.dgrad(dy, w), dy @ w, dy.double() @ w.double()),
        "wgrad": (lambda: L.wgrad(dy, x), dy.t() @ x,
                  dy.double().t() @ x.double())}
    for name, (fn, plain, ref) in cases.items():
        got = fn()
        again = fn()
        torch.cuda.synchronize()
        err = (got.double() - ref).abs().max().item()
        plain_err = (plain.double() - ref).abs().max().item()
        assert err <= 2.0 * plain_err, (name, err, plain_err)
        assert torch.equal(got.view(torch.int32), again.view(torch.int32))


@pytest.mark.card
def test_the_op_under_autograd_on_the_card(card):
    """On the card ``linear`` under autograd launches one forward, one
    dgrad and one wgrad (and a sum for each split product); its gradients
    are the kernel's dgrad and wgrad and dy's row sum, bit for bit, and a
    call without a gradient gives the same bits as the op."""
    g = torch.Generator(device=card).manual_seed(11)
    x = torch.randn(4, 160, 768, generator=g, device=card,
                    requires_grad=True)
    w = (torch.randn(1024, 768, generator=g, device=card)
         / math.sqrt(768)).requires_grad_()
    b = torch.randn(1024, generator=g, device=card, requires_grad=True)
    dy = torch.randn(4, 160, 1024, generator=g, device=card)
    before = dict(L.LAUNCHES)
    y = L.linear(x, w, b)
    y.backward(dy)
    sums = sum(L.k_splits(*s)[0] > 1 for s in (
        (640, 1024, 768), (640, 768, 1024), (1024, 768, 640)))
    assert {k: L.LAUNCHES[k] - before[k] for k in L.LAUNCHES} == {
        "forward": 1, "dgrad": 1, "wgrad": 1, "splitk_sum": sums}
    dy2 = dy.reshape(-1, 1024)
    with torch.no_grad():
        assert torch.equal(L.linear(x, w, b), y)
        assert torch.equal(x.grad, L.dgrad(dy2, w).view(x.shape))
        assert torch.equal(w.grad, L.wgrad(dy2, x.reshape(-1, 768)))
        assert torch.equal(b.grad, dy2.sum(0))
    # without a bias: the same product bits as with a zero one, no db
    zero = torch.zeros_like(b)
    x.grad = w.grad = None
    y0 = L.linear(x, w, None)
    y0.backward(dy)
    with torch.no_grad():
        assert torch.equal(y0, L.linear(x, w, zero))
        assert torch.equal(x.grad, L.dgrad(dy2, w).view(x.shape))
        assert torch.equal(w.grad, L.wgrad(dy2, x.reshape(-1, 768)))


# the encoder's three product shapes of UNITER-base and UNITER-large, M 2 560
LIST_SHAPES = CARD_SHAPES[:6]
LISTS = ("traffic", "all_valid", "one_row")


def _card_mask(kind, m, device):
    """A ``[m / 160, 160]`` key mask: ``traffic`` as the ``ft_fp32``
    traffic's memes ([60 text | 100 regions], text log-normal with a median
    of 20 over 4-60, regions uniform over 10-100; ≈ 49 % valid), all valid,
    or the first row alone."""
    memes = m // 160
    if kind == "all_valid":
        return torch.ones(memes, 160, dtype=torch.int64, device=device)
    mask = torch.zeros(memes, 160, dtype=torch.int64)
    if kind == "one_row":
        mask[0, 0] = 1
    else:
        g = torch.Generator().manual_seed(m)
        text = torch.empty(memes).log_normal_(math.log(20), 0.5,
                                              generator=g)
        text = text.round().clamp(4, 60).long()
        regions = torch.randint(10, 101, (memes,), generator=g)
        for i in range(memes):
            mask[i, :text[i]] = 1
            mask[i, 60:60 + regions[i]] = 1
    return mask.to(device)


@pytest.mark.card
@pytest.mark.parametrize("kind", LISTS)
@pytest.mark.parametrize("m,n,k", LIST_SHAPES)
def test_listed_products_on_the_card(card, m, n, k, kind):
    """Forward, dgrad and wgrad over a row list: the listed rows within 2×
    the plain fp32 products' error against float64, the forward's and
    dgrad's other rows exactly zero; the forward's listed rows the no-list
    launch's bits wherever the count's plan is the no-list plan, and with
    an all-valid list all three products' bits. A single listed row is too
    few outputs for one maximum to stand against another: there the
    forward's and dgrad's row is held to 2× the no-list launch's error on
    it too, and wgrad, one product an element, to 3×TF32's own bound,
    3·2⁻²¹ of |dy|ᵀ·|x| (each low half read as TF32, and lo·lo dropped)."""
    g = torch.Generator(device=card).manual_seed(m + n + k)
    x = torch.randn(m, k, generator=g, device=card)
    w = torch.randn(n, k, generator=g, device=card) / math.sqrt(k)
    b = torch.randn(n, generator=g, device=card)
    dy = torch.randn(m, n, generator=g, device=card)
    mask = _card_mask(kind, m, card).reshape(-1)
    rows = L.row_list(_key_bias(mask.view(1, -1)))
    on = mask.bool()
    count = int(on.sum())
    assert int(rows[0]) == count
    xs, dys = x[on].double(), dy[on].double()
    cases = {
        "forward": (L._forward_cuda(x, w, b, rows), L._forward_cuda(x, w, b),
                    x[on] @ w.t() + b, xs @ w.double().t() + b.double()),
        "dgrad": (L.dgrad(dy, w, rows), L.dgrad(dy, w), dy[on] @ w,
                  dys @ w.double()),
        "wgrad": (L.wgrad(dy, x, rows), L.wgrad(dy, x), dy[on].t() @ x[on],
                  dys.t() @ xs)}
    torch.cuda.synchronize()
    for name, (got, nolist, plain, ref) in cases.items():
        listed = got if name == "wgrad" else got[on]
        err = (listed.double() - ref).abs().max().item()
        plain_err = (plain.double() - ref).abs().max().item()
        if count == 1 and name == "wgrad":
            plain_err = max(plain_err, 3 * 2.0 ** -21 * float(
                (dys.abs().t() @ xs.abs()).max()))
        elif count == 1:
            plain_err = max(plain_err,
                            (nolist[on].double() - ref).abs().max().item())
        assert err <= 2.0 * max(plain_err, 1e-30), (name, err, plain_err)
        if name != "wgrad":
            assert torch.equal(got[~on], torch.zeros_like(got[~on])), name
        if kind == "all_valid":
            assert torch.equal(got.view(torch.int32),
                               nolist.view(torch.int32)), name
    plan = L.list_plan(m, n, k, True)[0]
    if plan[math.ceil(count / L.BLOCK_M)] == L.k_splits(m, n, k):
        got, nolist = cases["forward"][:2]
        assert torch.equal(got[on].view(torch.int32),
                           nolist[on].view(torch.int32))


@pytest.mark.card
@pytest.mark.parametrize("m,n,k", [(2560, 768, 768), (2560, 1024, 1024)])
def test_a_captured_graph_replays_each_masks_list(card, m, n, k):
    """The list's build and the three listed products captured once in a
    CUDA graph, replayed over two masks (of different counts and plans):
    each replay gives the eager launches' bits for its mask, and the
    counter adds each mask's count."""
    g = torch.Generator(device=card).manual_seed(m + n)
    x = torch.randn(m, k, generator=g, device=card)
    w = torch.randn(n, k, generator=g, device=card) / math.sqrt(k)
    b = torch.randn(n, generator=g, device=card)
    dy = torch.randn(m, n, generator=g, device=card)
    masks = [_card_mask("traffic", m, card).view(1, -1),
             _card_mask("traffic", m, card).view(1, -1)]
    masks[1][:, m // 2:] = 0  # fewer rows: another count, another plan
    bias = _key_bias(masks[0])

    def products():
        rows = L.row_list(bias)
        return (L._forward_cuda(x, w, b, rows), L.dgrad(dy, w, rows),
                L.wgrad(dy, x, rows))

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        products()  # the plan tables and the counter, before the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = products()
    counter = L.listed_rows(card)
    for mask in masks:
        bias.copy_(_key_bias(mask))
        before = counter.clone()
        graph.replay()
        torch.cuda.synchronize()
        assert (counter - before).tolist() == [int(mask.sum()), m]
        for got, want in zip(captured, products()):
            assert torch.equal(got.view(torch.int32), want.view(torch.int32))
