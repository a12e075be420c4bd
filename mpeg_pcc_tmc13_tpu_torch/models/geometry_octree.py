"""Octree entropy-context state: counterpart of
``mpeg_pcc_tmc13_tpu/models/geometry_octree.py:70-119`` (``OctreeContexts``).

The device pipeline codes occupancy with the bytewise (Fenwick
256-symbol) PARENT-context models only, so only ``occupancy_sym`` is
carried.  The arrays are numpy, owned by the caller, and continue across
slices and frames exactly as in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from mpeg_pcc_tmc13_tpu.bitstream import entropy

from ..ops.octree import NUM_OCC_BASES


@dataclass
class OctreeContexts:
    """Entropy context memories of the device geometry pipeline."""
    occupancy_sym: np.ndarray = field(
        default_factory=lambda: entropy.new_sym_contexts(NUM_OCC_BASES))


def contexts_from_reference(ctx) -> OctreeContexts:
    """Carry a reference ``OctreeContexts`` (or any object with an
    ``occupancy_sym`` array) across, as a numpy copy."""
    return OctreeContexts(np.array(ctx.occupancy_sym, copy=True))
