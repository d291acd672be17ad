"""The control of each cell must come out as not correct: the reference put
in the program's place with TF32 products (the precision below the
configuration's float32 with TF32 off). On the card, at the cells' widths
with fewer layers and memes; the cell's own size is read by
``portbench/calibrate.py``."""
import pytest

from portbench import harness

pytestmark = pytest.mark.card


def _small(name):
    cell = harness.resolve(name)
    cell.cfg["num_hidden_layers"] = 2
    cell.mix["memes"] = 256
    return cell


@pytest.mark.parametrize("name", ["base_ft_fp32", "large_ft_fp32",
                                  "base_infer_fp32"])
def test_tf32_control_is_not_correct(card, name):
    cell = _small(name)
    failed = []
    for seed in (2 ** 31 + 21, 2 ** 31 + 22, 2 ** 31 + 23):
        r = harness.run(cell, seed, 1.0, False, card, 0.0,
                        control=lambda drv: drv.control("tf32"))
        assert r["correct"], r["checks"]
        failed.append(any(v > cell.limits[k]
                          for k, v in r["control"].items()))
    assert all(failed)
