"""The operation and byte counts against hand counts at small shapes."""
import pytest

from portbench import flops

CFG = {"hidden_size": 8, "intermediate_size": 16, "num_hidden_layers": 2,
       "img_dim": 4, "pos_dim": 7, "n_classes": 1}
PEAK = {"flops": {"float32": 100.0, "bfloat16": 400.0}, "bytes_per_s": 10.0}


def test_forward_flops_hand_count():
    # 3 text tokens + 2 regions: L = 5
    embed = 2 * 2 * 8 * (4 + 7)
    layer = 2 * 5 * (4 * 8 * 8 + 2 * 8 * 16) + 4 * 5 * 5 * 8
    head = 2 * 8 * 8 + 2 * 8 * 1
    assert flops.forward_flops(CFG, 3, 2) == embed + 2 * layer + head


def test_train_step_is_three_forwards():
    lengths = [(3, 2), (7, 1)]
    fwd = flops.step_flops(CFG, lengths, train=False)
    assert fwd == flops.forward_flops(CFG, 3, 2) + flops.forward_flops(
        CFG, 7, 1)
    assert flops.step_flops(CFG, lengths, train=True) == 3 * fwd


@pytest.mark.parametrize("backward", [False, True])
def test_attention_counts_valid_lengths(backward):
    heads, d = 2, 4
    ops, nbytes = flops.attention_ops_bytes([3, 5], heads, d, "float32",
                                            backward)
    k = 10 if backward else 4
    tensors = 8 if backward else 4  # q, k, v, out (+ dout, dq, dk, dv)
    assert ops == k * heads * d * (9 + 25)
    assert nbytes == tensors * heads * d * 4 * (3 + 5) + 4 * (3 + 5)
    # a valid length under the padded one counts less than the padding
    pad_ops, pad_bytes = flops.attention_ops_bytes([8, 8], heads, d,
                                                   "float32", backward)
    assert ops < pad_ops and nbytes < pad_bytes


def test_attention_bound_is_the_larger_side():
    ops, nbytes = flops.attention_ops_bytes([6], 2, 4, "bfloat16", False)
    bound = flops.attention_bound_s([6], 2, 4, "bfloat16", False, PEAK)
    assert bound == max(ops / 400.0, nbytes / 10.0)
    assert nbytes == 4 * 2 * 6 * 4 * 2 + 4 * 6


def test_peaks_of_the_card():
    p = flops.peaks("NVIDIA H100 80GB HBM3")
    assert p["flops"]["bfloat16"] == 989e12
    assert p["flops"]["float32"] == pytest.approx(495e12 / 3)
    assert p["bytes_per_s"] == 3.35e12
    with pytest.raises(KeyError):
        flops.peaks("some other card")
