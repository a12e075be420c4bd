"""A dressed body (``clouds.make_body``) made once, then F seeded
thinnings of it, each a frame: distinct frames, so that no cache keyed
on content helps, for the price of one body.

Configuration keys: ``bits``, ``radius_scale``, ``print_vox``,
``colour_noise``, ``thin`` (the share of points each frame drops) and
``frames``.
"""

import numpy as np

from .clouds import make_body


def make(cfg: dict, seed: int):
    codes, rgb = make_body(cfg["bits"], seed, cfg["radius_scale"],
                           cfg["print_vox"], cfg["colour_noise"])
    frames = []
    for f in range(cfg["frames"]):
        keep = np.random.default_rng([seed, f]).random(codes.size) \
            >= cfg["thin"]
        frames.append((codes[keep], rgb[keep]))
    return frames
