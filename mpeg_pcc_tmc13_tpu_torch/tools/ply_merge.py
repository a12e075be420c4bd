"""Merge N point-cloud frames into one fused cloud / split back.

Counterpart of the reference `tools/ply-merge.cpp` (README.tools.md):
fused-frame coding experiments tag each point with a `frameindex`
attribute; merge concatenates frames with the tag, split regroups by it.

Usage:
  python -m mpeg_pcc_tmc13_tpu_torch.tools.ply_merge merge out.ply in_%04d.ply first count
  python -m mpeg_pcc_tmc13_tpu_torch.tools.ply_merge split in.ply out_%04d.ply

The PyTorch + CUDA port's copy of
``mpeg_pcc_tmc13_tpu/tools/ply_merge.py``, imports only changed.
"""

from __future__ import annotations

import sys

import numpy as np

from ..utils import ply


def merge(out_path: str, template: str, first: int, count: int):
    parts = []
    for i in range(count):
        c = ply.read(ply.expand_num(template, first + i))
        c.frame_indices = np.full(c.count, i, dtype=np.uint16)
        parts.append(c)
    def cat(get):
        vals = [get(p) for p in parts]
        return None if any(v is None for v in vals) else np.concatenate(vals)
    merged = ply.PlyCloud(
        positions=np.concatenate([p.positions for p in parts]),
        colors=cat(lambda p: p.colors),
        reflectances=cat(lambda p: p.reflectances),
        frame_indices=np.concatenate([p.frame_indices for p in parts]),
    )
    ply.write(merged, out_path, position_is_float=False)
    print(f"merged {count} frames, {merged.count} points -> {out_path}")


def split(in_path: str, template: str, first: int = 0):
    c = ply.read(in_path)
    if c.frame_indices is None:
        raise SystemExit("input has no frameindex attribute")
    for i in np.unique(c.frame_indices):
        sel = c.frame_indices == i
        out = ply.PlyCloud(
            positions=c.positions[sel],
            colors=None if c.colors is None else c.colors[sel],
            reflectances=(None if c.reflectances is None
                          else c.reflectances[sel]),
        )
        path = ply.expand_num(template, first + int(i))
        ply.write(out, path, position_is_float=False)
        print(f"frame {i}: {out.count} points -> {path}")


def main(argv=None):
    a = sys.argv[1:] if argv is None else argv
    if len(a) >= 4 and a[0] == "merge":
        merge(a[1], a[2], int(a[3]), int(a[4]) if len(a) > 4 else 1)
    elif len(a) >= 3 and a[0] == "split":
        split(a[1], a[2], int(a[3]) if len(a) > 3 else 0)
    else:
        print(__doc__)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
