"""Readings the limits of ``limits/<cell>.json`` are set from.

    python3 portbench/calibrate.py --workload <cell> --first <seed> --seeds 12 \\
        --seconds 3 --controls tf32,half_batch --control-seeds 3 [--out FILE]

Runs the cell on ``--seeds`` seeds from ``--first`` in one process, each
with a short window, and prints for every number compared the largest
reading of the program (the lower reading). On the first
``--control-seeds`` seeds it also reads each control put in the program's
place (``tf32``: the reference with TF32 products; ``half_batch``: half of
each micro-batch left out of the loss) and prints the smallest (the upper
reading), with the leaves that read worst, and whether the control comes
out as not correct when its numbers are held against the cell's limits of
``limits/<cell>.json``, as a run's are. The benchmark's own runs never run
it.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build",
                                                  "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")


def worst_leaves(got: dict, want: dict, n: int = 3) -> list:
    from portbench.check import counted_leaves

    leaves = counted_leaves(want["grad"])
    out = []
    for key in ("grad", "delta"):
        med = sorted(want[key][x] for x in leaves)[len(leaves) // 2]
        gaps = sorted(((abs(got[key][x] - want[key][x])
                        / max(want[key][x], med), x) for x in leaves),
                      reverse=True)[:n]
        out.append({key: [[x, g, want[key][x]] for g, x in gaps]})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--first", type=int, required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--controls", default="tf32")
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    import torch

    from portbench import harness

    cell = harness.resolve(args.workload)
    controls = [c for c in args.controls.split(",") if c]
    rows = []

    def log(msg):
        print("  " + msg, file=sys.stderr, flush=True)

    for i in range(args.seeds):
        seed = args.first + i

        def control(drv):
            out = {k: drv.control(k) for k in controls}
            if hasattr(drv, "program"):
                out["worst_program"] = worst_leaves(drv.program, drv.ref)
            return out

        r = harness.run(cell, seed, args.seconds, False, args.device,
                        time.perf_counter(), log=log,
                        control=control if i < args.control_seeds else None)
        control_correct = {
            c: all(r["control"][c][k] <= cell.limits[k] for k in cell.limits)
            for c in controls} if r.get("control") else None
        row = {"seed": seed, "correct": r["correct"],
               "checks": {k: v["value"] for k, v in r["checks"].items()},
               "control": r.get("control"),
               "control_correct": control_correct,
               "metrics": {k: v["value"] for k, v in r["metrics"].items()}}
        rows.append(row)
        print(json.dumps(row), flush=True)
        if args.device == "cuda":
            torch.cuda.empty_cache()
    names = list(rows[0]["checks"])
    summary = {"workload": args.workload,
               "lower": {k: max(r["checks"][k] for r in rows) for k in names}}
    for c in controls:
        summary["upper_" + c] = {k: min(r["control"][c][k] for r in rows
                                        if r["control"]) for k in names}
        summary["correct_" + c] = [r["control_correct"][c] for r in rows
                                   if r["control_correct"]]
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"rows": rows, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
