"""The controls of ``correct``: the reference put in the program's place,
with one guarantee of the configuration broken, must come out not
correct.

- attributes (where the mix codes them): the controls of the
  configuration's check (its ``controls``); for ``checks/raht_fp.py``
  the fixed-point closed loop with every floor division of values taken
  through a float32 quotient, the step that would tempt a kernel's
  divisions (the group kernel divides exactly: an FP64 quotient and one
  remainder step);
- geometry (every cell): a decoder that loses the last octree level
  (each position halved and doubled back), lossy where the
  configuration states lossless.

    python3 -m pccbench.control --workload <name> --seeds 1,2,3

prints, for each seed, each control's readings under the run's check
names, as JSON lines (the sound readings are the runs' own).  The
numbers are judged as a run judges them: the geometry of every frame,
the attributes of the frame ``check.sample_frame`` draws from the seed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from . import check, spec
from .frames import make_frames


def lossy_geometry(codes: np.ndarray) -> np.ndarray:
    """The leaf set a decoder that drops the last level gives back."""
    return np.unique((codes >> 3) << 3)


def readings(cell: spec.Cell, seed: int) -> dict:
    cfg = cell.config
    frames = make_frames(cfg, seed, channels=int(cfg["channels"]))
    out = {"seed": seed, "workload": cell.name}
    out["control_geometry"] = {"geom_codes_wrong": sum(
        check.geometry_wrong(lossy_geometry(fr.codes), fr.codes)
        for fr in frames)}
    if cell.mix.attributes:
        chk = cell.check()
        fr = frames[check.sample_frame(seed, len(frames))]
        t0 = time.perf_counter()
        ref = chk.reference(fr, cfg)
        out["reference_s"] = time.perf_counter() - t0
        for name, kept in chk.controls(fr, cfg).items():
            out[name] = chk.numbers([kept], ref)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    for seed in [int(s) for s in args.seeds.split(",")]:
        print(json.dumps(readings(cell, seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
