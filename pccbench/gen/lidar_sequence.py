"""F consecutive revolutions of ``clouds.make_lidar_frame``, ego motion
on.

Configuration keys: ``lasers``, ``azimuth_steps``, ``ego_speed`` (metres
a frame) and ``frames``.
"""

import numpy as np

from .clouds import make_lidar_frame, morton_encode


def make(cfg: dict, seed: int):
    frames = []
    for f in range(cfg["frames"]):
        pos, refl = make_lidar_frame(f, cfg["lasers"], cfg["azimuth_steps"],
                                     seed=seed, ego_speed=cfg["ego_speed"])
        codes = morton_encode(pos)
        order = np.argsort(codes, kind="stable")
        frames.append((codes[order], refl.reshape(codes.size, -1)[order]))
    return frames
