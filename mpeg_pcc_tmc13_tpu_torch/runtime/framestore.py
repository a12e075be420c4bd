"""Reference-frame store shared by encoder and decoder.

The reference codec keeps decoded frames for inter prediction
(storeCurrentCloudAsRef, tmc3/decoder.cpp:165; encoder
refFrame bookkeeping, encoder.cpp:502-538).  Both sides of this codec
key frames by the *masked* frame counter (frame_ctr_lsb), so eviction
must be by insertion age — sorting the masked keys would, at counter
wraparound, evict the just-stored frame (lsb 0) while old frames with
high lsbs survive, silently desynchronising the two sides.

This class is the single retention policy: insertion-ordered, bounded
capacity, newest frames never evicted.  Encoder and decoder construct
it with the same capacity so any reference the encoder can still see
is guaranteed to exist in the decoder.
"""
from collections import OrderedDict
from typing import Dict, Optional

import numpy as np

# Enough to span the deepest hierarchical-GOF recursion (bi_period is
# bounded by the CLI at 32) plus sequential history.
FRAME_STORE_CAP = 32


class FrameStore:
    """Bounded, insertion-age-evicting map of frame_ctr_lsb -> grid
    positions, with a side map of per-attribute coded-space values that
    is pruned in lockstep."""

    def __init__(self, cap: int = FRAME_STORE_CAP):
        self.cap = cap
        self._grids: "OrderedDict[int, np.ndarray]" = OrderedDict()
        self._attrs: Dict[int, dict] = {}

    def store(self, key: int, grid: np.ndarray,
              attrs: Optional[dict] = None):
        # re-storing a key makes it the newest entry (lsb reuse after
        # counter wraparound replaces the stale frame)
        if key in self._grids:
            del self._grids[key]
            self._attrs.pop(key, None)
        self._grids[key] = grid
        if attrs is not None:
            self._attrs[key] = attrs
        while len(self._grids) > self.cap:
            old, _ = self._grids.popitem(last=False)
            self._attrs.pop(old, None)

    def __contains__(self, key: int) -> bool:
        return key in self._grids

    def __getitem__(self, key: int) -> np.ndarray:
        return self._grids[key]

    def get(self, key: int, default=None):
        return self._grids.get(key, default)

    def attrs(self, key: int) -> dict:
        return self._attrs.get(key, {})

    def set_attrs(self, key: int, attrs: dict):
        if key in self._grids:
            self._attrs[key] = attrs

    def __len__(self) -> int:
        return len(self._grids)
