"""The benchmark's synthetic cloud generators.  Plain numpy; imports
nothing of the port.

``make_lidar_frame`` (a spinning HDL-64-like scan on a 1 mm grid, the
shape of the Ford sequences) is copied line for line from
``mpeg_pcc_tmc13_tpu_torch/scripts/gen_clouds.py``, so the benchmark's
frames stay the same whatever later changes make to that script.
``make_body`` is the benchmark's own: a figure in a long dress with the
structure of MPEG's 8i VFB captures (a closed surface one voxel thick,
a printed dress), where the script's ``make_surface`` scatters its
points over a surface twice their number.  ``morton_encode`` is the
port's bit-spreading Morton interleave (x in the highest bit of each
triple), also copied.
"""

from __future__ import annotations

import numpy as np


def _part1by2_64(v):
    """Spread the low 21 bits of v so two zero bits sit between each."""
    x = v & 0x1FFFFF
    x = (x | (x << 32)) & 0x1F00000000FFFF
    x = (x | (x << 16)) & 0x1F0000FF0000FF
    x = (x | (x << 8)) & 0x100F00F00F00F00F
    x = (x | (x << 4)) & 0x10C30C30C30C30C3
    x = (x | (x << 2)) & 0x1249249249249249
    return x


def morton_encode(pos: np.ndarray) -> np.ndarray:
    """positions (N, 3) int -> Morton codes (N,) int64."""
    p = np.asarray(pos, dtype=np.int64)
    return ((_part1by2_64(p[:, 0]) << 2) | (_part1by2_64(p[:, 1]) << 1)
            | _part1by2_64(p[:, 2]))


def _fbm3(p: np.ndarray, octaves: int, seed: int) -> np.ndarray:
    """Cheap fractal value noise on unit-scale 3D points."""
    rng = np.random.default_rng(seed)
    out = np.zeros(p.shape[0])
    amp, freq = 1.0, 1.5
    for o in range(octaves):
        phase = rng.uniform(0, 2 * np.pi, size=(3, 3))
        q = p * freq
        out += amp * (
            np.sin(q @ rng.normal(size=3) + phase[0, 0])
            * np.cos(q @ rng.normal(size=3) + phase[1, 1]))
        amp *= 0.55
        freq *= 2.03
    return out


def _rows(lengths: np.ndarray, spacing: float) -> np.ndarray:
    return np.maximum(1, np.ceil(lengths / spacing)).astype(np.int64)


def _ring_angles(per: np.ndarray, rng) -> np.ndarray:
    """Jittered angles, ``per[i]`` of them evenly round ring ``i``."""
    start = np.repeat(np.cumsum(per) - per, per)
    k = np.arange(int(per.sum())) - start
    return 2 * np.pi * (k + rng.random(k.size)) / np.repeat(per, per)


def _tube(rng, z0, z1, r0, r1, cx, ell, bumps, seed, spacing):
    """The lateral surface of an elliptic truncated cone (x radius ``ell``
    times y's) from height z0 to z1, sampled at ``spacing`` along both
    directions, displaced by fractal noise."""
    slant = np.hypot(z1 - z0, abs(r1 - r0) * (1 + ell) / 2)
    nt = int(np.ceil(slant / spacing))
    t = (np.arange(nt) + rng.random(nt)) / nt
    r = r0 + (r1 - r0) * t
    per = _rows(2 * np.pi * r * (1 + bumps) * max(1.0, ell), spacing)
    ti, ri = np.repeat(t, per), np.repeat(r, per)
    a = _ring_angles(per, rng)
    disp = 1.0 + bumps * _fbm3(
        np.stack([np.cos(a), np.sin(a), ti * slant / 150.0], axis=1), 4, seed)
    return np.stack([cx + ri * disp * np.cos(a) * ell,
                     ri * disp * np.sin(a), z0 + (z1 - z0) * ti], axis=1)


def _ellipsoid(rng, center, radii, bumps, seed, spacing):
    rmax = max(radii) * (1 + bumps)
    nth = int(np.ceil(np.pi * rmax / spacing))
    th = np.pi * (np.arange(nth) + rng.random(nth)) / nth
    per = _rows(2 * np.pi * rmax * np.sin(th), spacing)
    thi = np.repeat(th, per)
    a = _ring_angles(per, rng)
    u = np.stack([np.sin(thi) * np.cos(a), np.sin(thi) * np.sin(a),
                  np.cos(thi)], axis=1)
    disp = 1.0 + bumps * _fbm3(u, 4, seed)
    return np.asarray(center) + u * np.asarray(radii) * disp[:, None]


def make_body(bits: int = 10, seed: int = 0, radius_scale: float = 1.0,
              print_vox: float = 6.0, noise: float = 3.0):
    """A clothed figure in a long dress, voxelised as a capture is: a
    surface one voxel thick, every voxel of it occupied (a few sampling
    holes aside), with RGB.  Returns (sorted unique Morton codes (N,),
    colours (N, 3) int64 in code order).

    Sizes are in voxels of a 10-bit grid, scaled to ``bits``: 955 high,
    head, neck, torso, two arms and the dress; ``radius_scale`` scales
    every horizontal radius, which sets the point count.  The shape's
    noise is fixed; the seed moves the samples' jitter, the colours'
    noise and nothing else, so every seed gives the same amount of work.
    Colours: a two-tone print on the dress (features ``print_vox``
    voxels across), a pale top, skin above the shoulders, one light's
    shading, and Gaussian noise of ``noise`` levels.
    """
    rng = np.random.default_rng(seed)
    g = 2.0 ** (bits - 10)
    s = radius_scale * g
    spacing = 0.5
    pts = np.concatenate([
        _ellipsoid(rng, (0, 0, 905 * g), (44 * s, 50 * s, 62 * g), 0.05,
                   12, spacing),                                   # head
        _tube(rng, 820 * g, 860 * g, 22 * s, 21 * s, 0, 1.0, 0.03, 18,
              spacing),                                            # neck
        _tube(rng, 560 * g, 830 * g, 72 * s, 88 * s, 0, 1.35, 0.05, 11,
              spacing),                                            # torso
        _tube(rng, 545 * g, 815 * g, 21 * s, 27 * s, -120 * s, 1.0, 0.06,
              15, spacing),                                        # arms
        _tube(rng, 545 * g, 815 * g, 21 * s, 27 * s, 120 * s, 1.0, 0.06,
              16, spacing),
        _tube(rng, 12 * g, 570 * g, 185 * s, 75 * s, 0, 1.15, 0.07, 17,
              spacing),                                            # dress
    ])
    span = (1 << bits) - 1
    lo, hi = pts.min(axis=0), pts.max(axis=0)
    v = np.clip(np.round(pts - lo + (span - (hi - lo)) / 2), 0,
                span).astype(np.int64)
    codes, first = np.unique(morton_encode(v), return_index=True)
    p = v[first].astype(np.float64)
    height = (p[:, 2] - p[:, 2].min()) / g
    c = p - p.mean(axis=0)
    shade = 0.72 + 0.28 * np.cos(np.arctan2(c[:, 1], c[:, 0]) - 0.6)
    flower = 1.0 / (1.0 + np.exp(-12.0 * _fbm3(p / (g * print_vox * 8), 5,
                                                21)))[:, None]
    dress = (np.array([28.0, 32.0, 64.0]) * (1 - flower)
             + np.array([205.0, 70.0, 95.0]) * flower)
    top = np.array([225.0, 215.0, 200.0]) \
        - 25 * _fbm3(p / (g * 60), 3, 22)[:, None]
    skin = np.array([215.0, 160.0, 135.0]) \
        + 10 * _fbm3(p / (g * 40), 3, 23)[:, None]
    col = np.where((height < 560)[:, None], dress,
                   np.where((height > 810)[:, None], skin, top))
    col = col * shade[:, None] + rng.normal(0, noise, col.shape)
    return codes, np.clip(np.round(col), 0, 255).astype(np.int64)


# ---------------------------------------------------------------------------
# cat3-like spinning LiDAR
# ---------------------------------------------------------------------------

def _hdl64_elevations(n_lasers: int = 64) -> np.ndarray:
    """HDL-64-like elevation angles: -24.8deg .. +2deg, denser near 0."""
    t = np.linspace(0, 1, n_lasers)
    return np.deg2rad(-24.8 + 26.8 * (t ** 0.85))


def _scene_range(az: np.ndarray, el: np.ndarray, ego: float,
                 rng) -> np.ndarray:
    """Ray-cast a synthetic street scene; returns range in metres
    (0 = no return)."""
    n = az.shape[0]
    rmax = 120.0
    r = np.full(n, rmax)
    # ground plane at z = -1.73m (sensor height)
    down = el < -0.005
    r_ground = np.where(down, -1.73 / np.sin(np.minimum(el, -0.005)),
                        rmax)
    r = np.minimum(r, r_ground)
    # buildings: walls at lateral distance dl/dr (canyon), extent in az
    for side, dist in ((1, 14.0), (-1, 18.0)):
        s = np.sin(az) * side
        vis = s > 0.15
        rw = np.where(vis, dist / np.maximum(s, 0.15), rmax)
        # wall only up to 12m high
        zhit = rw * np.sin(el)
        rw = np.where(zhit < 12.0, rw, rmax)
        r = np.minimum(r, rw)
    # parked vehicles: boxes along the road every ~11m
    xhit = r * np.cos(el) * np.cos(az)
    for k in range(-4, 5):
        cx = k * 11.0 + 4.0 - ego
        cy = -5.5
        dx = np.cos(el) * np.cos(az)
        dy = np.cos(el) * np.sin(az)
        # crude ray-box: param at closest approach to the box centre
        tpar = np.clip(cx * dx + cy * dy, 0.5, rmax)
        px, py = tpar * dx - cx, tpar * dy - cy
        hit = (np.abs(px) < 2.2) & (np.abs(py) < 0.9) \
            & (tpar * np.sin(el) > -1.73) & (tpar * np.sin(el) < 0.1)
        r = np.where(hit & (tpar < r), tpar, r)
    # poles every 30m on the right
    for k in range(-2, 3):
        cx = k * 30.0 + 9.0 - ego
        cy = 7.0
        dx = np.cos(el) * np.cos(az)
        dy = np.cos(el) * np.sin(az)
        tpar = np.clip(cx * dx + cy * dy, 0.5, rmax)
        px, py = tpar * dx - cx, tpar * dy - cy
        hit = (px * px + py * py < 0.05) & (tpar * np.sin(el) < 6.0)
        r = np.where(hit & (tpar < r), tpar, r)
    # range noise (~2cm) + dropouts
    r += rng.normal(0, 0.02, n)
    drop = rng.random(n) < 0.08
    r = np.where((r >= rmax) | drop, 0.0, r)
    return r


def make_lidar_frame(frame: int = 0, n_lasers: int = 64,
                     steps: int = 8000, seed: int = 0,
                     ego_speed: float = 1.0):
    """One spinning-scanner frame on the 1mm grid (18-bit), centred at
    2^17 per axis so coordinates are non-negative ints."""
    rng = np.random.default_rng(seed + frame)
    el = _hdl64_elevations(n_lasers)
    az1 = np.arange(steps) * (2 * np.pi / steps)
    az = np.repeat(az1, n_lasers)
    elv = np.tile(el, steps)
    ego = frame * ego_speed
    r = _scene_range(az, elv, ego, rng)
    keep = r > 0
    r, az, elv = r[keep], az[keep], elv[keep]
    x = r * np.cos(elv) * np.cos(az)
    y = r * np.cos(elv) * np.sin(az)
    z = r * np.sin(elv)
    pos_mm = np.round(np.stack([x, y, z], axis=1) * 1000.0)
    pos = pos_mm.astype(np.int64) + (1 << 17)
    pos = np.clip(pos, 0, (1 << 18) - 1)
    # reflectance: distance-attenuated with per-object variation
    refl = np.clip(255.0 * np.exp(-r / 60.0)
                   * (0.5 + 0.5 * rng.random(r.shape[0])),
                   1, 255).astype(np.int64)
    # dedup on the grid (mm quantisation can collide at long range)
    _, first = np.unique(pos, axis=0, return_index=True)
    first.sort()
    return pos[first], refl[first]
