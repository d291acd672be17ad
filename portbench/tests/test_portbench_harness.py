"""The harness: cells found from files, the checks of the command line, and
the reductions of a trace."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench import harness, readers, tracing
from portbench.tracing import Event, Trace

ROOT = harness.ROOT
RUN = os.path.join(ROOT, "portbench", "run.py")


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_every_cell_resolves_with_its_files():
    bench = _bench()
    for w in bench["workloads"]:
        cell = harness.resolve(w["name"])
        assert cell.limits and cell.chips == w["chips"] == 1
        assert cell.mix["driver"] in ("train", "infer")
        for m in cell.per_layer:
            assert callable(harness.reader(m["name"]))
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s", "peak_gib"}
    for m in bench["per_layer"]:
        assert os.path.isfile(os.path.join(ROOT, "portbench", "metrics",
                                           m["name"] + ".py"))


def test_a_new_cell_is_found_as_files(tmp_path):
    """A later change adds a configuration, a mix, a cell's limits, a
    metric's reader and a kernel pattern file, and edits none."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = _bench()
    pb = root / "portbench"
    cfg = json.loads((pb / "configs" / "uniter-base.json").read_text())
    cfg["num_hidden_layers"] = 6
    (pb / "configs" / "uniter-six.json").write_text(json.dumps(cfg))
    mix = json.loads((pb / "traffic" / "ft_fp32.json").read_text())
    mix["train"]["gradient_accumulation"] = 4
    (pb / "traffic" / "ft_fp32_accum4.json").write_text(json.dumps(mix))
    (pb / "limits" / "six_ft.json").write_text(json.dumps(
        {"loss_gap": 1.0, "prob_gap": 1.0, "grad_gap": 1.0,
         "delta_gap": 1.0}))
    (pb / "metrics" / "fetch_ms.train.py").write_text(
        "from portbench.readers import host_ms\n\n\n"
        "def read(trace):\n    return host_ms(trace, ('fetch',))\n")
    (pb / "metrics" / "attn_kernels.d" / "other.txt").write_text(
        "fwd \\bmy_new_attention_kernel\\b\n")
    bench["configs"].append({"name": "uniter-six", "source": "x",
                             "file": "portbench/configs/uniter-six.json",
                             "reduced": ["num_hidden_layers"], "why": "x"})
    bench["workloads"].append({"name": "six_ft", "config": "uniter-six",
                               "traffic": "ft_fp32_accum4", "chips": 1,
                               "why": "x"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_samples_per_s":
            m["workloads"].append("six_ft")
    bench["per_layer"].append({"name": "fetch_ms.train", "unit": "ms",
                               "better": "lower", "source": "host_clock",
                               "layer": "trainer and loader",
                               "moves": "train_samples_per_s",
                               "workloads": ["six_ft"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = harness.resolve("six_ft", root=str(root))
    assert cell.cfg["num_hidden_layers"] == 6
    assert cell.mix["train"]["gradient_accumulation"] == 4
    assert [m["name"] for m in cell.per_layer] == ["fetch_ms.train"]
    assert "train_samples_per_s" in {m["name"] for m in cell.end_to_end}
    read = harness.reader("fetch_ms.train", root=str(root))
    assert read(Trace(spans={"fetch": [0.002, 0.004]}, units=3)) == \
        pytest.approx(2.0)
    assert ("fwd", "\\bmy_new_attention_kernel\\b") in harness.attn_patterns(
        root=str(root))


@pytest.mark.parametrize("modules,bad", [
    (["meme_challenge_tpu_torch", "meme_challenge_tpu_torch.ops"], []),
    (["meme_challenge_tpu.core.config"], ["meme_challenge_tpu"]),
    (["jaxlib.xla_client", "jax_like", "flax.linen"], ["flax", "jaxlib"]),
    (["jax"], ["jax"]),
])
def test_forbidden_modules_by_whole_top_level_name(modules, bad):
    sys.path.insert(0, os.path.dirname(RUN))
    try:
        import run
    finally:
        sys.path.pop(0)
    assert run.forbidden_modules(modules) == bad


def test_no_result_without_a_card():
    """The command fails on a machine without a card and prints nothing
    on its standard output."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, RUN, "--workload", "base_ft_fp32",
                        "--seed", str(2 ** 31 + 9), "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True,
                       env=env, timeout=300)
    assert p.returncode != 0
    assert p.stdout == ""


def _ev(name, kind, a, b):
    return Event(name, kind, float(a), float(b))


def test_trace_reductions():
    events = [
        _ev(tracing.SLICE, "cpu", 0, 1000),
        _ev("portbench.slice", "cpu", 0, 1000),
        _ev("aten::mm", "cpu", 0, 90),
        _ev("aten::copy_", "cpu", 400, 600),
        _ev("gemm", "kernel", 100, 300),
        _ev("void attn_fwd_tf32_kernel<4, true>(float)", "kernel", 250, 350),
        _ev("attn_bwd_tf32_kernel", "kernel", 700, 800),
        _ev("Memcpy HtoD (Pageable -> Device)", "memcpy", 600, 650),
    ]
    span = tracing.slice_span(events)
    assert span == (0.0, 1000.0)
    assert tracing.union_s(events, span) == pytest.approx(350e-6)
    t = Trace(events=events, span=span, slice_units=2,
              attention_launches=[("fwd", 50e-6), ("bwd", 20e-6)],
              attn_patterns=harness.attn_patterns())
    t.units, t.seconds = 4, 4 * 500e-6
    assert readers.idle_percent(t) == pytest.approx(100.0 * (1 - 175.0 / 500.0))
    assert readers.launches_per_unit(t) == pytest.approx(1.5)
    assert readers.attention_roofline_percent(t) == pytest.approx(
        100.0 * 70e-6 / 200e-6)
    # launches the patterns cannot account for: no reading
    t.attention_launches = [("fwd", 50e-6)] * 2
    assert readers.attention_roofline_percent(t) is None
    b = tracing.breakdown(events, span)
    assert b["device_ops"][0] == ["gemm", pytest.approx(200e-6)]
    gaps = dict((k, v) for k, v in b["idle_gaps"])
    assert gaps["aten::copy_"] == pytest.approx(250e-6)
    assert gaps["aten::mm"] == pytest.approx(100e-6)
    assert gaps["no torch op on the host"] == pytest.approx(250e-6)
    assert readers.mfu_percent(Trace(flops=5e12, seconds=2.0,
                                     peak_flops=100e12)) == 2.5
    assert readers.host_ms(Trace(), ("batch",)) is None
