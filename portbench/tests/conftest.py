"""Tests of the port's benchmark. Tests marked ``card`` need an NVIDIA
card and skip without one; whether a card is there is decided in the
``card`` fixture, never while a module is imported."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; run on the chip")
    return torch.device("cuda")


@pytest.fixture
def tiny_cell():
    """A cell of the benchmark shrunk to a size the CPU holds: UNITER at
    hidden 32, 2 layers, 4 heads; 150 memes of up to 14 regions."""
    from portbench import harness

    def make(name="base_ft_fp32", traffic=None):
        cell = harness.resolve(name)
        if traffic is not None:
            cell.mix = harness.mix(traffic)
        cell.cfg.update(hidden_size=32, intermediate_size=64,
                        num_attention_heads=4, num_hidden_layers=2,
                        vocab_size=300, max_position_embeddings=32)
        cell.mix.update(memes=150, regions={"min": 3, "max": 14})
        cell.mix["text_tokens"].update(max=16)
        cell.mix["train"].update(max_bb=14, max_txt_len=16, batch_size=4)
        return cell

    return make
