#!/usr/bin/env python
"""Generate realistic synthetic point clouds for parity/CTC testing.

MPEG CTC content is not redistributable, so the parity harness runs
both codecs (tmc3 and this framework) on clouds with the same
*structure* as the two CTC categories:

  surface  — cat1-style dense voxelised surface scan (longdress-like):
             a human-scale figure built from deformed quadric parts,
             fractal displacement, ~1M occupied 10-bit voxels, smooth
             RGB texture with fine noise.
  lidar    — cat3-style spinning-scanner frame (ford-like): 64 lasers
             with HDL-64-like elevation angles, fixed azimuth rate,
             ground plane + buildings + poles + vehicles, 1mm units in
             an 18-bit grid, 8-bit reflectance. Multiple frames with
             ego-motion for inter/global-motion tests.

Usage:
  python -m mpeg_pcc_tmc13_tpu_torch.scripts.gen_clouds surface out.ply \
      [--points 1000000]
  python -m mpeg_pcc_tmc13_tpu_torch.scripts.gen_clouds lidar \
      out_%04d.ply [--frames 4]

The PyTorch + CUDA port's copy of ``scripts/gen_clouds.py``, imports
only changed: the same arrays and files from the same seed.
"""

from __future__ import annotations

import argparse

import numpy as np

from ..utils import ply


# ---------------------------------------------------------------------------
# cat1-like dense surface
# ---------------------------------------------------------------------------

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


def _sample_ellipsoid(n: int, center, radii, rng, bumps=0.06, seed=1):
    """Points on a displaced ellipsoid surface."""
    u = rng.normal(size=(n, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    disp = 1.0 + bumps * _fbm3(u, 4, seed)
    return np.asarray(center) + u * np.asarray(radii) * disp[:, None]


def _sample_cylinder(n: int, base, axis_len, radius, rng, bumps=0.05,
                     seed=2):
    """Points on a vertical displaced cylinder (limbs, torso)."""
    t = rng.uniform(0, 1, n)
    a = rng.uniform(0, 2 * np.pi, n)
    p = np.stack([np.cos(a), np.sin(a), np.zeros(n)], axis=1)
    disp = 1.0 + bumps * _fbm3(
        np.stack([np.cos(a), np.sin(a), t * 3], axis=1), 4, seed)
    xy = p[:, :2] * (radius * disp)[:, None]
    return np.asarray(base) + np.stack(
        [xy[:, 0], xy[:, 1], t * axis_len], axis=1)


def make_surface(n_target: int = 1_000_000, bits: int = 10,
                 seed: int = 0):
    """Human-figure-like voxelised surface cloud with RGB."""
    rng = np.random.default_rng(seed)
    span = (1 << bits) - 1
    # oversample: voxel dedup keeps roughly half at this density
    n = int(n_target * 2.2)
    parts = []
    # torso / head / limbs in unit space (x,y in [-1,1], z in [0,1])
    parts.append(_sample_cylinder(int(n * 0.34), (0, 0, 0.32), 0.38,
                                  0.17, rng, seed=11))          # torso
    parts.append(_sample_ellipsoid(int(n * 0.10), (0, 0, 0.80),
                                   (0.085, 0.095, 0.11), rng, seed=12))
    parts.append(_sample_cylinder(int(n * 0.13), (-0.09, 0, 0.0),
                                  0.34, 0.062, rng, seed=13))   # legs
    parts.append(_sample_cylinder(int(n * 0.13), (0.09, 0, 0.0),
                                  0.34, 0.062, rng, seed=14))
    parts.append(_sample_cylinder(int(n * 0.10), (-0.23, 0, 0.38),
                                  0.30, 0.046, rng, seed=15))   # arms
    parts.append(_sample_cylinder(int(n * 0.10), (0.23, 0, 0.38),
                                  0.30, 0.046, rng, seed=16))
    # skirt: flaring cone shell (gives large smooth areas like longdress)
    m = n - sum(p.shape[0] for p in parts)
    t = rng.uniform(0, 1, m)
    a = rng.uniform(0, 2 * np.pi, m)
    r = 0.16 + 0.22 * t + 0.02 * _fbm3(
        np.stack([np.cos(a), np.sin(a), t], axis=1), 5, 17)
    parts.append(np.stack([r * np.cos(a), r * np.sin(a),
                           0.30 - 0.28 * t], axis=1))
    pts = np.concatenate(parts)
    # unit space -> voxel grid
    lo = pts.min(axis=0)
    hi = pts.max(axis=0)
    v = np.round((pts - lo) / (hi - lo).max() * span).astype(np.int64)
    v = np.clip(v, 0, span)
    v, first = np.unique(v, axis=0, return_index=True)
    # smooth texture + fine noise, in RGB
    q = v.astype(np.float64) / span
    base_col = np.stack([
        150 + 70 * np.sin(6.0 * q[:, 2] + 2 * q[:, 0]),
        90 + 60 * np.cos(5.0 * q[:, 2]),
        120 + 80 * np.sin(3.0 * q[:, 0] + 4.0 * q[:, 1]),
    ], axis=1)
    noise = rng.normal(0, 6, size=base_col.shape)
    colors = np.clip(base_col + noise, 0, 255).astype(np.int64)
    return v, colors


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


# ---------------------------------------------------------------------------

def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("kind", choices=["surface", "lidar"])
    ap.add_argument("out")
    ap.add_argument("--points", type=int, default=1_000_000)
    ap.add_argument("--bits", type=int, default=10)
    ap.add_argument("--frames", type=int, default=1)
    ap.add_argument("--lasers", type=int, default=64)
    ap.add_argument("--steps", type=int, default=8000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ascii", action="store_true")
    args = ap.parse_args(argv)

    if args.kind == "surface":
        pos, colors = make_surface(args.points, args.bits, args.seed)
        ply.write(ply.PlyCloud(positions=pos.astype(np.float64),
                               colors=colors),
                  args.out, ascii=args.ascii)
        print(f"{args.out}: {pos.shape[0]} points, {args.bits}-bit, RGB")
    else:
        for f in range(args.frames):
            pos, refl = make_lidar_frame(f, args.lasers, args.steps,
                                         args.seed)
            path = ply.expand_num(args.out, f)
            ply.write(ply.PlyCloud(positions=pos.astype(np.float64),
                                   reflectances=refl),
                      path, ascii=args.ascii)
            print(f"{path}: {pos.shape[0]} points, 18-bit mm grid, refl")


if __name__ == "__main__":
    main()
