"""Angular (LiDAR) octree tool set: laser-conditioned planar contexts.

Counterpart of the reference's angular octree machinery
(`determineContextAngleForPlanar`, geometry_octree.cpp:640-756;
`compensateZCoordinate`, :781).  A spinning scanner's points lie on
known elevation cones (lasers) and a regular azimuth grid, so a node's
z-plane side is largely predicted by where the nearest laser crosses
the node, and its x/y plane sides by the azimuth step phase.  This
module derives, per octree level, a laser-aligned context for the
z-plane position bit and azimuth contexts for x/y — vectorised over
all nodes of the level (the reference walks nodes serially with a
per-laser phi buffer; here the predictor is the preceding same-laser
node of the level, a batched argsort instead of a running buffer).

All arithmetic is integer or correctly-rounded IEEE ops (+,-,*,/,
sqrt), so encoder and decoder derive identical contexts on any
platform; atan2 is a fixed-coefficient polynomial (Q20 radians, same
scale as the reference's iatan2, misc.cpp:298).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

Q20_PI = 3294199            # pi in Q20 (reference misc.cpp:304)


def irsqrt_q40(x: np.ndarray) -> np.ndarray:
    """floor(2^40 / sqrt(x)) elementwise; 0 for x == 0.

    np.sqrt and / are correctly-rounded IEEE-754 ops, hence
    deterministic across platforms (reference irsqrt is a LUT+Newton
    integer routine, misc.cpp:190 — same contract, different math)."""
    x = np.asarray(x, dtype=np.float64)
    with np.errstate(divide="ignore"):
        r = np.where(x > 0, (2.0 ** 40) / np.sqrt(x), 0.0)
    return r.astype(np.int64)


def _atan01(t: np.ndarray) -> np.ndarray:
    """atan(t) for t in [0, 1], fixed-coefficient polynomial."""
    c1 = 0.9999999873752535
    c3 = -0.3333316286329367
    c5 = 0.1999354525811384
    c7 = -0.1420037646964435
    c9 = 0.1064678372952751
    c11 = -0.0752186943898794
    c13 = 0.0429096138617126
    c15 = -0.0161657367995554
    c17 = 0.0028498897808425
    t2 = t * t
    return t * (c1 + t2 * (c3 + t2 * (c5 + t2 * (c7 + t2 * (
        c9 + t2 * (c11 + t2 * (c13 + t2 * (c15 + t2 * c17))))))))


def iatan2_q20(y: np.ndarray, x: np.ndarray) -> np.ndarray:
    """atan2(y, x) in Q20 radians (int64), deterministic."""
    xa = np.abs(x).astype(np.float64)
    ya = np.abs(y).astype(np.float64)
    mx = np.maximum(xa, ya)
    mn = np.minimum(xa, ya)
    with np.errstate(invalid="ignore", divide="ignore"):
        t = np.where(mx > 0, mn / mx, 0.0)
    a = _atan01(t)
    a = np.where(ya > xa, np.pi / 2 - a, a)
    q = np.floor(a * (1 << 20)).astype(np.int64)
    q = np.where(np.asarray(x) < 0, Q20_PI - q, q)
    return np.where(np.asarray(y) < 0, -q, q)


@dataclass
class LaserInfo:
    """Precomputed per-laser quantities (reference AzimuthalPhiZi)."""
    theta: np.ndarray        # Q18 tan(elevation), ascending
    z: np.ndarray            # laser z offset (grid units, Q3)
    delta_phi: np.ndarray    # Q20 azimuth step = 2*pi / numPhiPerTurn
    inv_delta: np.ndarray    # floor(2^30 / delta_phi)
    min_delta: int           # min adjacent theta gap (Q18)


def laser_info(theta_q18, z, npt) -> LaserInfo:
    theta = np.asarray(theta_q18, dtype=np.int64)
    zarr = np.asarray(z, dtype=np.int64)
    npt_arr = np.maximum(np.asarray(npt, dtype=np.int64), 1)
    delta = np.maximum((2 * Q20_PI) // npt_arr, 1)
    inv = (1 << 30) // delta
    mind = int(np.min(np.abs(np.diff(theta)))) if theta.size > 1 \
        else 1 << 18
    return LaserInfo(theta=theta, z=zarr, delta_phi=delta,
                     inv_delta=inv, min_delta=max(mind, 1))


def node_angular_ctx(codes: np.ndarray, node_size_log2: int,
                     origin, info: LaserInfo):
    """Angular contexts for one octree level.

    codes: level Morton codes (sorted); node_size_log2 s >= 0.
    origin: angular origin in slice-local grid units.
    Returns (ctx_z (N,) in -1..3, ctx_phi (N,) in -1..7,
    phi_axis (N,) 0=x/1=y; ctx_z == -1 marks angular-ineligible
    nodes (callers fall back to the non-angular contexts)."""
    from ..utils import morton
    n = codes.shape[0]
    out_z = np.full(n, -1, dtype=np.int64)
    out_phi = np.full(n, -1, dtype=np.int64)
    phi_axis = np.zeros(n, dtype=np.int64)
    if n == 0 or info.theta.size == 0:
        return out_z, out_phi, phi_axis

    s = node_size_log2
    pos = morton.decode(codes) << s
    mid = (1 << s) >> 1
    org = np.asarray(origin, dtype=np.int64)
    nl = pos - org[None, :]

    xl = np.abs(((nl[:, 0] + mid) << 8) - 128)
    yl = np.abs(((nl[:, 1] + mid) << 8) - 128)
    rl1 = (xl + yl) >> 1
    num_lasers = info.theta.size
    elig = (info.min_delta * rl1) > (np.int64(mid) << 26)
    if num_lasers == 1:
        elig = np.ones(n, dtype=bool)
    if not elig.any():
        return out_z, out_phi, phi_axis

    r2 = (xl * xl + yl * yl).astype(np.float64)
    rinv = irsqrt_q40(r2)
    zl = ((nl[:, 2] + mid) << 1) - 1
    theta = zl * rinv
    theta32 = np.where(theta >= 0, theta >> np.int64(15),
                       -((-theta) >> np.int64(15)))

    # nearest laser (reference upper_bound + midpoint rule)
    idx = np.searchsorted(info.theta, theta32)
    idx = np.clip(idx, 1, num_lasers - 1)
    lo = info.theta[idx - 1]
    hi = info.theta[idx]
    laser = np.where(theta32 - lo <= hi - theta32, idx - 1, idx)

    # -- THETA context (z plane side) --
    tl_delta = info.theta[laser] - theta32
    hr = info.z[laser] * rinv
    tl_delta += np.where(hr >= 0, -(hr >> np.int64(17)),
                         (-hr) >> np.int64(17))
    z_shift = (rinv * (np.int64(1) << s)) >> np.int64(20)
    top = tl_delta - z_shift
    bot = tl_delta + z_shift
    ctx_z = np.where(tl_delta >= 0, 0, 1)
    ctx_z = ctx_z + np.where((top >= 0) | (bot < 0), 2, 0)
    out_z[elig] = ctx_z[elig]

    # -- PHI context (x/y plane side) --
    px = nl[:, 0]
    py = nl[:, 1]
    phi_node = iatan2_q20(py + mid, px + mid)
    phi_node0 = iatan2_q20(py, px)
    # predictor: preceding node on the same laser, in level order
    # (vectorised stand-in for the reference's running phiBuffer)
    order = np.lexsort((np.arange(n), laser))
    sl = laser[order]
    sp = phi_node[order]
    prev = np.concatenate([[np.int64(-1 << 40)], sp[:-1]])
    same = np.concatenate([[False], sl[1:] == sl[:-1]])
    pred_sorted = np.where(same, prev, np.int64(-1 << 40))
    pred = np.empty(n, dtype=np.int64)
    pred[order] = pred_sorted
    has_pred = pred != np.int64(-1 << 40)
    pred = np.where(has_pred, pred, phi_node)

    # snap the predictor onto the azimuth grid around phi_node
    dphi = info.delta_phi[laser]
    nshift = ((pred - phi_node) * info.inv_delta[laser]
              + (1 << 29)) >> np.int64(30)
    pred = pred - dphi * nshift

    angle_l = phi_node0 - pred
    angle_r = phi_node - pred
    ctx_phi = np.where((angle_l >= 0) == (angle_r >= 0), 2, 0)
    al = np.abs(angle_l)
    ar = np.abs(angle_r)
    ctx_phi = ctx_phi + (al > ar)
    mn = np.minimum(al, ar)
    mx = np.maximum(al, ar)
    ctx_phi = ctx_phi + np.where(mx > (mn << 2), 4, 0)
    # phi eligibility (reference: deltaPhi within one azimuth step)
    dphi_node = np.abs(phi_node - phi_node0) << 1
    phi_ok = elig & (dphi_node <= dphi)
    out_phi[phi_ok] = ctx_phi[phi_ok]
    phi_axis[:] = np.abs(px) <= np.abs(py)   # 1 -> y axis ctx, else x
    return out_z, out_phi, phi_axis


def compensate_z(positions: np.ndarray, info: LaserInfo, origin,
                 tol: int) -> np.ndarray:
    """Decoder-side z snap onto the laser cones (reference
    compensateZCoordinate, geometry_octree.cpp:781): when the decoded
    point lies within `tol` output units of its nearest laser's cone —
    and the cones are separated by more than `tol` at that range, so
    the assignment is unambiguous — replace z by the cone's exact
    prediction.  Recovers the sub-grid z precision lost to geometry
    quantisation on spinning-scanner content.

    positions/origin in output units; tol = output units per coding
    grid cell (ceil(den / 2*num) for an SPS scale num/den)."""
    if info.theta.size < 2 or tol <= 0:
        return positions
    org = np.asarray(origin, dtype=np.int64)
    p = positions.astype(np.int64) - org[None, :]
    r2 = (p[:, 0].astype(np.float64) ** 2
          + p[:, 1].astype(np.float64) ** 2)
    r3 = np.sqrt(r2 + p[:, 2].astype(np.float64) ** 2)
    r = np.floor(np.sqrt(r2)).astype(np.int64)
    rinv = irsqrt_q40(r2)
    theta32 = (p[:, 2] * rinv) >> np.int64(22)   # Q18 tan
    idx = np.clip(np.searchsorted(info.theta, theta32), 1,
                  info.theta.size - 1)
    lo = info.theta[idx - 1]
    hi = info.theta[idx]
    laser = np.where(theta32 - lo <= hi - theta32, idx - 1, idx)
    zc = ((r * info.theta[laser]) >> np.int64(18)) + info.z[laser]
    # cone separation at this range must exceed the snap tolerance
    sep = (np.floor(r3).astype(np.int64) * info.min_delta) \
        >> np.int64(18)
    snap = (sep > 2 * tol) & (np.abs(p[:, 2] - zc) <= tol)
    out = positions.astype(np.int64).copy()
    out[snap, 2] = zc[snap] + org[2]
    return out
