"""Pre/post processing: position quantisation, dedup, colourspace.

Counterpart of the reference's `tmc3/pointset_processing.{h,cpp}`
(quantizePositions* `pointset_processing.h:89-147`) and
`tmc3/colourspace.h` (BT.709 + YCgCo-R transforms `colourspace.h:47+`).
All integer math; the YCgCo-R transform is exactly reversible (used for
lossless colour round-trips).
"""

from __future__ import annotations

import numpy as np

from mpeg_pcc_tmc13_tpu.models.pointcloud import PointCloud

from ..utils import morton


def quantize_positions(positions: np.ndarray, scale_num: int,
                       scale_den: int, origin) -> np.ndarray:
    """src -> coding grid: round((pos - origin) * num / den).

    Reference quantizePositions (pointset_processing.cpp): scale then
    clamp to the slice box; we clamp at the caller via the root size.
    """
    p = positions.astype(np.int64) - np.asarray(origin, dtype=np.int64)
    if scale_num == scale_den:
        return p
    # round-half-up in integer arithmetic
    return (p * scale_num + scale_den // 2) // scale_den


def dequantize_positions(positions: np.ndarray, scale_num: int,
                         scale_den: int, origin) -> np.ndarray:
    """coding grid -> output: pos * den / num + origin (inverse scale)."""
    p = positions.astype(np.int64)
    if scale_num != scale_den:
        p = (p * scale_den + scale_num // 2) // scale_num
    return p + np.asarray(origin, dtype=np.int64)


def dedup_with_attributes(cloud: PointCloud) -> PointCloud:
    """Merge duplicate positions, averaging attributes.

    Reference analogue: quantizePositionsUniq + recolouring of merged
    points (pointset_processing.h:108).  Averaging uses round-half-up
    integer division to stay in integer domain.
    """
    codes = morton.encode(cloud.positions.astype(np.int64))
    order = np.argsort(codes, kind="stable")
    cs = codes[order]
    keep = np.empty(cs.shape, dtype=bool)
    if cs.size == 0:
        return cloud.take(order)
    keep[0] = True
    np.not_equal(cs[1:], cs[:-1], out=keep[1:])
    seg = np.cumsum(keep) - 1
    n_uniq = int(seg[-1]) + 1
    counts = np.bincount(seg, minlength=n_uniq).astype(np.int64)

    def avg(a):
        if a is None:
            return None
        a = a[order]
        flat = a.reshape(a.shape[0], -1).astype(np.int64)
        sums = np.zeros((n_uniq, flat.shape[1]), dtype=np.int64)
        np.add.at(sums, seg, flat)
        out = (sums + counts[:, None] // 2) // counts[:, None]
        return out.reshape((n_uniq,) + a.shape[1:]).astype(a.dtype)

    return PointCloud(
        positions=morton.decode(cs[keep]),
        colors=avg(cloud.colors),
        reflectances=avg(cloud.reflectances),
        frame_index=None if cloud.frame_index is None
        else cloud.frame_index[order][keep],
    )


# --- colourspace -----------------------------------------------------
# GBR channel order note: the reference stores colours as G,B,R
# internally when converting (colourspace.h); we keep R,G,B order in
# PointCloud.colors and convert in place.


def rgb_to_ycgcor(rgb: np.ndarray) -> np.ndarray:
    """RGB -> YCgCo-R, exactly reversible (reference colourspace.h
    transformGbrToYCgCoR).  Output int32; Cg/Co are signed, offset by
    caller if unsigned storage is needed."""
    r = rgb[..., 0].astype(np.int32)
    g = rgb[..., 1].astype(np.int32)
    b = rgb[..., 2].astype(np.int32)
    co = r - b
    t = b + (co >> 1)
    cg = g - t
    y = t + (cg >> 1)
    return np.stack([y, cg, co], axis=-1)


def ycgcor_to_rgb(ycc: np.ndarray, bitdepth: int = 8) -> np.ndarray:
    y = ycc[..., 0].astype(np.int32)
    cg = ycc[..., 1].astype(np.int32)
    co = ycc[..., 2].astype(np.int32)
    t = y - (cg >> 1)
    g = cg + t
    b = t - (co >> 1)
    r = b + co
    hi = (1 << bitdepth) - 1
    out = np.stack([r, g, b], axis=-1)
    return np.clip(out, 0, hi)


def rgb_to_ycbcr_bt709(rgb: np.ndarray, bitdepth: int = 8) -> np.ndarray:
    """RGB -> YCbCr BT.709 fixed-point (reference colourspace.h:47,
    transformGbrToYCbCrBt709: 16-bit coefficients, offset + clamp)."""
    r = rgb[..., 0].astype(np.float64)
    g = rgb[..., 1].astype(np.float64)
    b = rgb[..., 2].astype(np.float64)
    off = float(1 << (bitdepth - 1))
    hi = (1 << bitdepth) - 1

    # exact mirror of the reference's double arithmetic: the offset
    # sits INSIDE std::round (half away from zero), which differs
    # from fixed-point offset-after-round on .5 boundary sums
    def c_round(x):
        return np.where(x >= 0, np.floor(x + 0.5), np.ceil(x - 0.5))

    y = c_round(0.212600 * r + 0.715200 * g + 0.072200 * b)
    cb = c_round(-0.114572 * r - 0.385428 * g + 0.5 * b + off)
    cr = c_round(0.5 * r - 0.454153 * g - 0.045847 * b + off)
    out = np.stack([y, cb, cr], axis=-1)
    return np.clip(out, 0, hi).astype(rgb.dtype)


def ycbcr_bt709_to_rgb(ycc: np.ndarray, bitdepth: int = 8) -> np.ndarray:
    """Exact mirror of the reference's double-precision inverse
    (colourspace.h:66-78 transformYCbCrBt709ToGbr): float64 products,
    round-half-away-from-zero, clip."""
    y = ycc[..., 0].astype(np.float64)
    off = float(1 << (bitdepth - 1))
    cb = ycc[..., 1].astype(np.float64) - off
    cr = ycc[..., 2].astype(np.float64) - off
    hi = (1 << bitdepth) - 1

    def c_round(x):
        return np.where(x >= 0, np.floor(x + 0.5), np.ceil(x - 0.5))

    r = c_round(y + 1.57480 * cr)
    g = c_round(y - 0.18733 * cb - 0.46813 * cr)
    b = c_round(y + 1.85563 * cb)
    out = np.stack([r, g, b], axis=-1)
    return np.clip(out, 0, hi).astype(ycc.dtype)
