"""The readers of the program's named host ranges (``phases.py`` and the
seven metrics that call it), on hand-built traces: launch calls attributed
to a phase by time, idle time intersected with ranges (not judged at a
gap's midpoint), the idle time no host event names, and no reading where
the slice holds no ``meme.*`` range."""
import pytest

from portbench import harness, phases, tracing
from portbench.tracing import Event, Trace

RANGE_READERS = ("fwd_launches_per_step.train", "bwd_launches_per_step.train",
                 "opt_launches_per_step.train", "loader_idle_ms.train",
                 "loader_idle_ms.infer")
UNNAMED = ("unnamed_idle_ms.train", "unnamed_idle_ms.infer")


def _ev(name, kind, a, b):
    return Event(name, kind, float(a), float(b))


def _trace(events, units=1):
    events = [_ev(tracing.SLICE, "cpu", 0, 1000)] + events
    return Trace(events=events, span=tracing.slice_span(events),
                 slice_units=units)


def _step():
    """One step: forward 0-100 on the caller's thread, backward 100-300
    whose launches come from autograd's thread while the caller waits in
    the range, optimizer 300-400; kernels run late, as the host races
    ahead; the next batch is built 600-700 while the card idles."""
    return [
        _ev("meme.loader.batch", "cpu", 600, 700),
        _ev("meme.step", "cpu", 0, 400),
        _ev("meme.step.forward", "cpu", 0, 100),
        _ev("aten::mm", "cpu", 5, 20),
        _ev("cudaLaunchKernel", "cpu", 10, 12),
        _ev("cuLaunchKernelEx", "cpu", 50, 52),
        _ev("meme.step.backward", "cpu", 100, 300),
        _ev("autograd::engine::evaluate_function: MmBackward0", "cpu",
            140, 260),
        _ev("cudaLaunchKernelExC", "cpu", 150, 151),
        _ev("cudaLaunchKernel", "cpu", 250, 251),
        _ev("cudaMemcpyAsync", "cpu", 255, 256),
        _ev("meme.step.optimizer", "cpu", 300, 400),
        _ev("cudaLaunchKernel", "cpu", 350, 351),
        # after the step: the benchmark's own loop
        _ev("cudaLaunchKernel", "cpu", 450, 451),
        _ev("gemm", "kernel", 20, 600),
    ]


def test_launch_patterns_name_the_launch_calls():
    pats = phases.launch_patterns()
    hit = [n for n in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                       "cuLaunchKernel", "cuLaunchKernelEx",
                       "cudaMemcpyAsync", "cudaStreamSynchronize",
                       "meme.step.forward")
           if any(p.fullmatch(n) for p in pats)]
    assert hit == ["cudaLaunchKernel", "cudaLaunchKernelExC",
                   "cuLaunchKernel", "cuLaunchKernelEx"]


def test_launches_attributed_by_time_across_threads():
    t = _trace(_step(), units=2)
    read = {k: harness.reader(k + "_launches_per_step.train")(t)
            for k in ("fwd", "bwd", "opt")}
    assert read == {"fwd": 1.0, "bwd": 1.0, "opt": 0.5}
    # a launch on the range's edge belongs to it
    t = _trace(_step() + [_ev("cudaLaunchKernel", "cpu", 100, 101)])
    assert phases.launches_in(t, "meme.step.forward") == 3.0


def test_loader_idle_is_the_intersection_not_the_midpoint():
    """One idle gap, 100-300; the loader's range covers 110-160, which
    holds not the gap's midpoint, and the upload 280-320, half over a
    copy."""
    events = [
        _ev("gemm", "kernel", 0, 100),
        _ev("meme.loader.batch", "cpu", 110, 160),
        _ev("meme.upload", "cpu", 280, 320),
        _ev("Memcpy HtoD (Pageable -> Device)", "memcpy", 300, 320),
        _ev("meme.step.forward", "cpu", 320, 400),
        _ev("gemm", "kernel", 330, 400),
    ]
    t = _trace(events, units=2)
    # (50 + 20) us over 2 units, in ms
    assert harness.reader("loader_idle_ms.train")(t) == pytest.approx(0.035)
    assert harness.reader("loader_idle_ms.infer")(t) == pytest.approx(0.035)
    assert phases.idle_in_ms(t, lambda n: n == "meme.step.forward") == \
        pytest.approx(0.005)


def test_unnamed_idle_with_and_without_ranges():
    """Idle 100-300 and 400-1000 (the slice's end); a torch op at
    250-280 and the slice's own label (all of it) aside."""
    base = [
        _ev("gemm", "kernel", 0, 100),
        _ev("gemm", "kernel", 300, 400),
        _ev("aten::copy_", "cpu", 250, 280),
        _ev("portbench.slice", "cpu", 0, 1000),
    ]
    bare = _trace(base)
    assert harness.reader("unnamed_idle_ms.train")(bare) == pytest.approx(
        (200 - 30 + 600) / 1e3)
    named = _trace(base + [_ev("meme.loader.batch", "cpu", 100, 250),
                           _ev("cudaStreamSynchronize", "cpu", 400, 990)])
    assert harness.reader("unnamed_idle_ms.infer")(named) == pytest.approx(
        (20 + 10) / 1e3)
    assert phases.overlap_us([(0, 10), (20, 30)], [(5, 25)]) == 10


@pytest.mark.parametrize("name", RANGE_READERS)
def test_no_reading_without_the_programs_ranges(name):
    """A slice of a program that names no phase (the launches and the idle
    gaps are all there) reads nothing."""
    events = [e for e in _step() if not e.name.startswith("meme.")]
    assert harness.reader(name)(_trace(events)) is None
    assert harness.reader(name)(_trace(_step())) is not None


@pytest.mark.parametrize("name", UNNAMED)
def test_unnamed_idle_reads_without_ranges_but_not_without_kernels(name):
    events = [e for e in _step() if not e.name.startswith("meme.")]
    # idle 0-20 (a torch op from 5) and 600-1000
    assert harness.reader(name)(_trace(events)) == pytest.approx(0.405)
    assert harness.reader(name)(_trace(
        [e for e in events if e.kind == "cpu"])) is None
    assert harness.reader(name)(Trace()) is None
