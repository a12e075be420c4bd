"""The frames a cell codes, made from the seed by the generators.

A configuration names its generator, ``pccbench/gen/<generator>.py``,
found by name, and its sizes; this module turns them, with ``--seed``,
into F frames of sorted unique Morton codes and their values in code
order.  The same seed gives the same frames.  The program and the
reference are handed the same arrays.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

SEED_MOD = 1 << 63


@dataclass
class Frame:
    codes: np.ndarray                 # (N,) int64 sorted unique Morton codes
    values: np.ndarray                # (N, C) int64 attributes, code order
    work: dict = field(default_factory=dict)

    @property
    def points(self) -> int:
        return int(self.codes.size)


def step_q16(qp: int) -> int:
    """The attribute quantiser step of ``qp`` in Q16 (6 QPs an octave,
    qp 4 is step 1), the law of the CTC configurations."""
    return max(1, int(round((2.0 ** ((qp - 4) / 6.0)) * 65536)))


def generator(name: str):
    """The ``make(cfg, seed)`` of ``pccbench/gen/<name>.py``: F frames,
    each (sorted unique Morton codes (N,), values (N, C)), in code
    order."""
    return importlib.import_module(f"{__package__}.gen.{name}").make


def tree_work(codes: np.ndarray, depth: int) -> dict:
    """Sizes of the frame's octree, from its codes alone: ``nodes[l]`` is
    the number of occupied nodes ``l`` levels above the leaves (nodes[0]
    the leaves, nodes[depth] the root)."""
    nodes = []
    for level in range(depth + 1):
        c = codes >> (3 * level)
        nodes.append(int(1 + np.count_nonzero(c[1:] != c[:-1]))
                     if c.size else 0)
    return {"depth": depth, "nodes": nodes,
            "occupancy_bytes": int(sum(nodes[1:]))}


def make_frames(cfg: dict, seed: int, channels: Optional[int] = None,
                with_work: bool = False) -> List[Frame]:
    """F frames of the configuration from ``seed`` (any whole number)."""
    frames = []
    for codes, values in generator(cfg["generator"])(cfg, seed % SEED_MOD):
        codes = np.asarray(codes, dtype=np.int64)
        if codes.size > 1 and not np.all(codes[1:] > codes[:-1]):
            raise ValueError("generator gave codes out of order or twice")
        fr = Frame(codes, np.ascontiguousarray(values, dtype=np.int64))
        if channels is not None and fr.values.shape[1] != channels:
            raise ValueError(f"generator gave {fr.values.shape[1]} channels, "
                             f"the configuration states {channels}")
        if with_work:
            fr.work = tree_work(fr.codes, cfg["bits"])
        frames.append(fr)
    return frames
