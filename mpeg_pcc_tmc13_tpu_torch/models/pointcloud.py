"""Struct-of-arrays point cloud (reference PCCPointSet.h:64-600).

The reference's `PCCPointSet3` holds positions (Vec3<int32>), colours
(Vec3<uint16>), reflectances (uint16) plus optional laser angles as
parallel vectors.  This is the same SoA layout as numpy arrays, designed
to move to the device as-is (positions feed Morton encoding; attributes
feed RAHT/LoD passes).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class PointCloud:
    positions: np.ndarray                      # (N,3) int  (coding grid)
    colors: Optional[np.ndarray] = None        # (N,3) uint16
    reflectances: Optional[np.ndarray] = None  # (N,)  uint16
    frame_index: Optional[np.ndarray] = None   # (N,)  (fused-frame coding)

    @property
    def count(self) -> int:
        return int(self.positions.shape[0])

    def __len__(self) -> int:
        return self.count

    @property
    def has_colors(self) -> bool:
        return self.colors is not None

    @property
    def has_reflectances(self) -> bool:
        return self.reflectances is not None

    def bbox(self):
        """(min, max) corners, each (3,)."""
        if self.count == 0:
            z = np.zeros(3, dtype=np.int64)
            return z, z
        return (self.positions.min(axis=0).astype(np.int64),
                self.positions.max(axis=0).astype(np.int64))

    def take(self, idx: np.ndarray) -> "PointCloud":
        """Select / reorder points (keeps attribute alignment)."""
        return PointCloud(
            positions=self.positions[idx],
            colors=None if self.colors is None else self.colors[idx],
            reflectances=(None if self.reflectances is None
                          else self.reflectances[idx]),
            frame_index=(None if self.frame_index is None
                         else self.frame_index[idx]),
        )

    def copy(self) -> "PointCloud":
        return PointCloud(
            positions=self.positions.copy(),
            colors=None if self.colors is None else self.colors.copy(),
            reflectances=(None if self.reflectances is None
                          else self.reflectances.copy()),
            frame_index=(None if self.frame_index is None
                         else self.frame_index.copy()),
        )


def concat(clouds) -> PointCloud:
    """Concatenate clouds (slice reassembly, reference decoder.cpp:744+)."""
    clouds = [c for c in clouds if c.count]
    if not clouds:
        return PointCloud(np.zeros((0, 3), dtype=np.int64))
    def cat(get):
        parts = [get(c) for c in clouds]
        return None if any(p is None for p in parts) else np.concatenate(parts)
    return PointCloud(
        positions=np.concatenate([c.positions for c in clouds]),
        colors=cat(lambda c: c.colors),
        reflectances=cat(lambda c: c.reflectances),
        frame_index=cat(lambda c: c.frame_index),
    )
