"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (timed as ``setup_s``), a window of ``--seconds``, then the check
against the plain reference. The last line on standard output is the
result as one JSON object; the last lines on standard error are the numbers
compared, each beside its limit. Without a card, with fewer cards than the
cell asks for, outside a checkout that holds the program, or with JAX
loaded once the window has closed, it exits with another code than 0 and
prints no result.

The run holds one host core and one CPU thread for tensor work: the
program's host loop runs on one thread at a time (the caller, or autograd's
device thread during the backward), and a fixed core keeps the scheduler's
placement of those threads from moving a host-paced cell's pace from run
to run.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the program's build caches stay in the checkout, at fixed paths
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build",
                                                  "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "meme_challenge_tpu")


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose whole top-level name is forbidden (the port's
    name only begins with the JAX package's)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def pin_host() -> None:
    """Bind this process, and the threads it starts later, to the first
    core it may run on, with one thread for the CPU's tensor work."""
    os.environ["OMP_NUM_THREADS"] = "1"
    os.environ["MKL_NUM_THREADS"] = "1"
    if hasattr(os, "sched_setaffinity"):
        os.sched_setaffinity(0, {min(os.sched_getaffinity(0))})


def log(msg: str) -> None:
    print("portbench: " + msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    pin_host()

    import torch

    torch.set_num_threads(1)

    from portbench import harness

    cell = harness.resolve(args.workload)
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell.chips):
        log("needs %d card(s); torch.cuda sees %d" % (
            cell.chips, torch.cuda.device_count()
            if torch.cuda.is_available() else 0))
        return 2
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         "cuda", T_START, log=log)
    bad = forbidden_modules()
    if bad:
        log("forbidden modules loaded: %s" % ", ".join(bad))
        return 3
    for name, c in result["checks"].items():
        print("check %s %.6e limit %.6e" % (name, c["value"], c["limit"]),
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
