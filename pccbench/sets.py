"""Run a set of runs of one cell, one process after another, and report
each metric's median and spread.

    python3 -m pccbench.sets --workload <name> --seeds 11,12,13
        [--seconds 45] [--trace 0] [--out runs.jsonl]

Each run is ``python3 -m pccbench.run`` in a process of its own, as the
benchmark's check runs it.  Every result line, with the run's seed, exit
code, wall time and the end of its standard error, is appended to
``--out``.  The spread of a metric is the distance between the first
and the third quartile (``statistics.quantiles(values, n=4)``) as a
share of the median; the bound a metric needs is about five times the
widest spread of its two sets.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

from .spec import ROOT


def spread(values):
    """(median, interquartile distance / median) of ``values``."""
    med = statistics.median(values)
    if len(values) < 2 or med == 0:
        return med, 0.0
    q1, _, q3 = statistics.quantiles(values, n=4)
    return med, (q3 - q1) / abs(med)


def card() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi failed: {exc}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated whole numbers, one run each")
    ap.add_argument("--seconds", type=float, default=45)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    print(f"card: {card()}", flush=True)
    rows = []
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "pccbench.run", "--workload",
             args.workload, "--seed", str(seed), "--seconds",
             str(args.seconds), "--trace", str(args.trace)],
            cwd=ROOT, capture_output=True, text=True)
        wall = time.perf_counter() - t0
        lines = proc.stdout.strip().splitlines()
        try:
            result = json.loads(lines[-1]) if lines else None
        except json.JSONDecodeError:
            result = None
        row = {"workload": args.workload, "seed": seed, "rc": proc.returncode,
               "wall_s": wall, "trace": args.trace, "result": result,
               "stderr_tail": proc.stderr[-3000:]}
        rows.append(row)
        if args.out:
            with open(Path(args.out), "a") as f:
                f.write(json.dumps(row) + "\n")
        summary = {k: round(v["value"], 6) for k, v in
                   (result or {}).get("metrics", {}).items()}
        print(f"seed {seed} rc {proc.returncode} wall {wall:.1f}s "
              f"correct {(result or {}).get('correct')} "
              f"attempted {(result or {}).get('attempted')} {summary}",
              flush=True)
        if proc.returncode != 0 or result is None:
            print(proc.stderr[-3000:], flush=True)

    names = sorted({k for r in rows if r["result"]
                    for k in r["result"]["metrics"]})
    for name in names:
        vals = [r["result"]["metrics"][name]["value"] for r in rows
                if r["result"] and name in r["result"]["metrics"]]
        med, sp = spread(vals)
        print(f"{name}: median {med} spread {sp:.4f} n {len(vals)} "
              f"values {vals}", flush=True)
    return 0 if all(r["rc"] == 0 and r["result"] and r["result"]["correct"]
                    for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
