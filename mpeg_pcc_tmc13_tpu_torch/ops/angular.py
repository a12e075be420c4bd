"""Angular (LiDAR) octree tool set: laser-conditioned planar contexts,
for the planar path of ``models.geometry_octree``.

The reference module ``mpeg_pcc_tmc13_tpu/ops/angular.py`` is numpy
code that reaches jax only inside ``node_angular_ctx``, through its
Morton codes.  Its jax-free names (``Q20_PI``, ``irsqrt_q40``,
``iatan2_q20``, ``LaserInfo``, ``laser_info``, ``compensate_z``) are
shared from there; ``node_angular_ctx`` is the reference's, line for
line, with the port's ``utils.morton``.
"""

from __future__ import annotations

import numpy as np

from mpeg_pcc_tmc13_tpu.ops.angular import (  # noqa: F401
    Q20_PI, LaserInfo, compensate_z, iatan2_q20, irsqrt_q40, laser_info)

from ..utils import morton


def node_angular_ctx(codes: np.ndarray, node_size_log2: int,
                     origin, info: LaserInfo):
    """Angular contexts for one octree level.

    codes: level Morton codes (sorted); node_size_log2 s >= 0.
    origin: angular origin in slice-local grid units.
    Returns (ctx_z (N,) in -1..3, ctx_phi (N,) in -1..7,
    phi_axis (N,) 0=x/1=y; ctx_z == -1 marks angular-ineligible
    nodes (callers fall back to the non-angular contexts)."""
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
