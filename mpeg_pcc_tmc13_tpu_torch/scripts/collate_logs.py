#!/usr/bin/env python3
"""Collate encoder/decoder logs from a CTC cfg-tree run into one CSV.

Counterpart of the reference's log collector (scripts/collect-tmc13.pl
+ Makefile.tmc13-step): walks ``<dir>/<condition>/<sequence>/<rate>/``
for ``encoder.log`` / ``decoder.log`` files (as written by
``tee``-ing the CLI, ``tmc3-cuda``, whose log lines are
reference-shaped) and emits one CSV row per rate point with payload
sizes, bpp, and timings.

Usage:
  python -m mpeg_pcc_tmc13_tpu_torch.scripts.collate_logs <run-dir> \
      [-o results.csv]

The PyTorch + CUDA port's copy of ``scripts/collate_logs.py``.
"""

from __future__ import annotations

import argparse
import csv
import os
import re
import sys

_PATTERNS = {
    "positions_bytes": re.compile(
        r"positions bitstream size (\d+) B \(([\d.]+) bpp\)"),
    "total_bytes": re.compile(r"Total bitstream size (\d+) B"),
    "user_s": re.compile(r"Processing time \(user\): ([\d.]+) s"),
    "wall_s": re.compile(r"Processing time \(wall\): ([\d.]+) s"),
    "points": re.compile(r"frame \d+: (\d+) points"),
}
_ATTR = re.compile(r"(\w+) bitstream size (\d+) B \(([\d.]+) bpp\)")


def parse_log(path):
    out = {}
    attrs = {}
    with open(path, errors="replace") as f:
        for line in f:
            for key, pat in _PATTERNS.items():
                m = pat.search(line)
                if m:
                    out[key] = float(m.group(1))
                    if key == "positions_bytes":
                        out["positions_bpp"] = float(m.group(2))
            m = _ATTR.search(line)
            if m and m.group(1) != "positions":
                attrs[f"{m.group(1)}_bytes"] = int(m.group(2))
                attrs[f"{m.group(1)}_bpp"] = float(m.group(3))
    out.update(attrs)
    return out


def collate(run_dir):
    rows = []
    for root, _dirs, files in sorted(os.walk(run_dir)):
        logs = {k: os.path.join(root, f"{k}.log")
                for k in ("encoder", "decoder")
                if f"{k}.log" in files}
        if not logs:
            continue
        rel = os.path.relpath(root, run_dir).split(os.sep)
        row = {
            "condition": rel[0] if len(rel) > 0 else "",
            "sequence": rel[1] if len(rel) > 1 else "",
            "rate": rel[2] if len(rel) > 2 else "",
        }
        for kind, path in logs.items():
            for k, v in parse_log(path).items():
                row[f"{kind}_{k}"] = v
        rows.append(row)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("run_dir")
    ap.add_argument("-o", "--output", default=None,
                    help="CSV path (default: stdout)")
    args = ap.parse_args(argv)
    rows = collate(args.run_dir)
    if not rows:
        print("no encoder.log/decoder.log files found", file=sys.stderr)
        return 1
    cols = ["condition", "sequence", "rate"]
    for r in rows:
        for k in r:
            if k not in cols:
                cols.append(k)
    out = open(args.output, "w", newline="") if args.output else sys.stdout
    w = csv.DictWriter(out, fieldnames=cols)
    w.writeheader()
    w.writerows(rows)
    if args.output:
        out.close()
        print(f"wrote {len(rows)} rows to {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
