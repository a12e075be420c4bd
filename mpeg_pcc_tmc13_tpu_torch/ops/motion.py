"""Global motion estimation & compensation.

Counterpart of `tmc3/motionWip.cpp`: LMS-based global motion matrix
estimation (`SearchGlobalMotion`/LMS3D, motionWip.h:72-97) and
`applyGlobalMotion` (motionWip.h:57,101).  The reference also accepts
per-frame matrices from a file (MotionParameters::parseFile,
geometry_params.h:73-112) — mirrored by `MotionParameters` here.

Estimation is encoder-only (non-normative): correspondences from a
Morton-window nearest-neighbour search on subsampled clouds, then a
least-squares affine fit.  The signalled matrix is Q16 fixed point so
compensation is bit-identical on both sides (decoder applies it with
integer arithmetic only).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from . import recolour as recolour_ops

Q = 16
ONE = 1 << Q


def identity_motion():
    mat = np.zeros((3, 3), dtype=np.int64)
    mat[0, 0] = mat[1, 1] = mat[2, 2] = ONE
    return mat, np.zeros(3, dtype=np.int64)


def estimate_global_motion(ref_positions: np.ndarray,
                           cur_positions: np.ndarray,
                           max_samples: int = 2000):
    """Least-squares affine ref->cur fit (encoder heuristic).

    Returns (mat_q16 (3,3) int64, trans (3,) int64).  Mirrors the role
    of the reference's LMS3D (motionWip.h:72); the matrix rides in the
    GBH like the reference's gm_matrix/gm_trans.
    """
    nr, nc = ref_positions.shape[0], cur_positions.shape[0]
    if nr < 16 or nc < 16:
        return identity_motion()
    step_r = max(nr // max_samples, 1)
    sample = ref_positions[::step_r].astype(np.int64)
    nn = recolour_ops.nearest_neighbor(cur_positions, sample)
    target = cur_positions[nn].astype(np.float64)
    src = sample.astype(np.float64)
    # robust trim: drop worst-matching half
    d2 = np.sum((target - src) ** 2, axis=1)
    keep = d2 <= np.median(d2)
    src, target = src[keep], target[keep]
    if src.shape[0] < 8:
        return identity_motion()
    a = np.concatenate([src, np.ones((src.shape[0], 1))], axis=1)
    sol, *_ = np.linalg.lstsq(a, target, rcond=None)   # (4,3)
    mat = np.round(sol[:3].T * ONE).astype(np.int64)   # (3,3) row-major
    trans = np.round(sol[3]).astype(np.int64)
    return mat, trans


def apply_global_motion(positions: np.ndarray, mat_q16: np.ndarray,
                        trans: np.ndarray) -> np.ndarray:
    """Integer-exact compensation (decoder-side normative path):
    out = (mat @ p) >> Q + trans, rounding toward nearest."""
    p = positions.astype(np.int64)
    acc = p @ mat_q16.T.astype(np.int64)
    out = (acc + (1 << (Q - 1))) >> Q
    return out + trans[None, :]


@dataclass
class MotionParameters:
    """Per-frame external motion matrices (reference
    MotionParameters::parseFile, geometry_params.h:73-112: 14 numbers
    per frame — 3x3 matrix, 3 translation, 2 thresholds)."""
    entries: List[Tuple[np.ndarray, np.ndarray, Tuple[int, int]]] = None

    @staticmethod
    def parse_file(path: str) -> "MotionParameters":
        entries = []
        with open(path) as f:
            vals: List[float] = []
            for tok in f.read().split():
                vals.append(float(tok))
        for i in range(0, len(vals) - 13, 14):
            mat = np.round(np.asarray(
                vals[i:i + 9], dtype=np.float64).reshape(3, 3)
                * ONE).astype(np.int64)
            trans = np.round(np.asarray(
                vals[i + 9:i + 12], dtype=np.float64)).astype(np.int64)
            thresh = (int(vals[i + 12]), int(vals[i + 13]))
            entries.append((mat, trans, thresh))
        return MotionParameters(entries)

    def for_frame(self, idx: int):
        if not self.entries:
            return identity_motion()
        mat, trans, _ = self.entries[min(idx, len(self.entries) - 1)]
        return mat, trans


# =====================================================================
# Cuboid LPU local motion (reference lpuType=1 cuboid partition,
# geometry inter: per-LPU motion refinement on top of global motion)
# =====================================================================

# ctx layout: [0..1] per-LPU flag chained on previous LPU's flag,
# [2..] 3 x 26 resbl trees for the MV components.
LPU_FLAG = 0
_LPU_AXIS_CTX = 26
LPU_CTX_SIZE = 2 + 3 * _LPU_AXIS_CTX


def _lpu_cells(points: np.ndarray, lpu_log2: int) -> np.ndarray:
    from ..utils import morton
    return morton.encode(points.astype(np.int64) >> lpu_log2)


def estimate_lpu_motion(ref_points: np.ndarray, cur_points: np.ndarray,
                        lpu_log2: int, depth: int):
    """Encoder-side search: per LPU (2**lpu_log2 cuboid grid over the
    compensated reference), a refinement MV = rounded mean displacement
    of the current points in the cell, kept only when it strictly
    increases exact-voxel hits.  Returns (cells, flags, mvs (L,3))."""
    from ..utils import morton
    rc = _lpu_cells(ref_points, lpu_log2)
    cells, inv = np.unique(rc, return_inverse=True)
    nl = cells.shape[0]
    cur_codes = np.unique(morton.encode(cur_points.astype(np.int64)))
    cc = _lpu_cells(cur_points, lpu_log2)
    # candidate MV per cell = rounded mean NN displacement of the
    # current points (NN in the full reference, so cell-boundary
    # migration doesn't bias the estimate like a cell-mean would)
    from .recolour import nearest_neighbor
    nn = nearest_neighbor(ref_points, cur_points, window=16)
    disp = cur_points.astype(np.int64) - ref_points[nn].astype(np.int64)
    cur_sum = np.zeros((nl, 3), dtype=np.int64)
    cur_cnt = np.zeros(nl, dtype=np.int64)
    pos_in_cells = np.searchsorted(cells, cc)
    ok = (pos_in_cells < nl)
    ok &= cells[np.minimum(pos_in_cells, nl - 1)] == cc
    np.add.at(cur_sum, pos_in_cells[ok], disp[ok])
    np.add.at(cur_cnt, pos_in_cells[ok], 1)
    have = cur_cnt > 0
    mvs = np.zeros((nl, 3), dtype=np.int64)
    cand = np.round(cur_sum[have] / cur_cnt[have, None]).astype(np.int64)
    lim = np.int64(1) << lpu_log2
    mvs[have] = np.clip(cand, -lim, lim)
    # hit counts with and without the refinement
    ref_codes = np.unique(morton.encode(ref_points.astype(np.int64)))
    shifted = np.clip(ref_points.astype(np.int64) + mvs[inv], 0,
                      (np.int64(1) << depth) - 1)
    shift_codes = np.unique(morton.encode(shifted))

    def hits_per_cell(codes):
        m = np.isin(cur_codes, codes, assume_unique=False)
        h = np.zeros(nl, dtype=np.int64)
        hit_cells = _lpu_cells(morton.decode(cur_codes[m]), lpu_log2)
        p = np.searchsorted(cells, hit_cells)
        okh = (p < nl)
        okh &= cells[np.minimum(p, nl - 1)] == hit_cells
        np.add.at(h, p[okh], 1)
        return h

    base_hits = hits_per_cell(ref_codes)
    mv_hits = hits_per_cell(shift_codes)
    flags = (mvs != 0).any(axis=1) & (mv_hits > base_hits)
    mvs[~flags] = 0
    return cells, flags, mvs


def apply_lpu_motion(ref_points: np.ndarray, cells: np.ndarray,
                     flags: np.ndarray, mvs: np.ndarray,
                     lpu_log2: int, depth: int) -> np.ndarray:
    """Shift each reference point by its LPU's MV (identity where the
    flag is off); shared by encoder and decoder."""
    rc = _lpu_cells(ref_points, lpu_log2)
    idx = np.searchsorted(cells, rc)
    out = ref_points.astype(np.int64) + mvs[idx]
    return np.clip(out, 0, (np.int64(1) << depth) - 1)


def encode_lpu_motion(enc, ctx: np.ndarray, ref_points: np.ndarray,
                      cur_points: np.ndarray, lpu_log2: int,
                      depth: int) -> np.ndarray:
    """Search, signal, and apply LPU motion; returns refined reference
    points.  Stream: per-LPU flags (chained contexts) then one resbl
    stream per MV axis over the flagged LPUs."""
    cells, flags, mvs = estimate_lpu_motion(ref_points, cur_points,
                                            lpu_log2, depth)
    f = flags.astype(np.uint8)
    prev = np.concatenate([[0], f[:-1]]).astype(np.int32)
    enc.bits(ctx, LPU_FLAG + prev, f)
    sel = np.nonzero(flags)[0]
    for a in range(3):
        cs = ctx[2 + a * _LPU_AXIS_CTX:2 + (a + 1) * _LPU_AXIS_CTX]
        enc.resbl(cs, mvs[sel, a].astype(np.int32))
    return apply_lpu_motion(ref_points, cells, flags, mvs, lpu_log2,
                            depth)


def decode_lpu_motion(dec, ctx: np.ndarray, ref_points: np.ndarray,
                      lpu_log2: int, depth: int) -> np.ndarray:
    """Mirror of encode_lpu_motion (cells derive from the compensated
    reference, which both sides share)."""
    cells = np.unique(_lpu_cells(ref_points, lpu_log2))
    nl = cells.shape[0]
    flags = dec.bits_chain(ctx[0:2], nl).astype(bool)
    mvs = np.zeros((nl, 3), dtype=np.int64)
    sel = np.nonzero(flags)[0]
    for a in range(3):
        cs = ctx[2 + a * _LPU_AXIS_CTX:2 + (a + 1) * _LPU_AXIS_CTX]
        if sel.size:
            mvs[sel, a] = dec.resbl(cs, sel.size)
    return apply_lpu_motion(ref_points, cells, flags, mvs, lpu_log2,
                            depth)


# ---- road/object split (reference lpuType=0) -------------------------

def estimate_ground(ref_points: np.ndarray):
    """Encoder heuristic: the ground plane height = mode of the z
    histogram (coarse 4-voxel bins), thickness from the spread of the
    dominant bin's neighbourhood.  Returns (z0, thr)."""
    if ref_points.shape[0] == 0:
        return 0, 0
    z = ref_points[:, 2].astype(np.int64)
    hist = np.bincount((z >> 2).clip(0, None).astype(np.int64))
    peak = int(hist.argmax())
    z0 = (peak << 2) + 2
    return int(z0), 6


def split_ground(points: np.ndarray, z0: int, thr: int) -> np.ndarray:
    """Boolean mask of ground points (|z - z0| <= thr); normative —
    both sides classify the shared compensated reference identically."""
    return np.abs(points[:, 2].astype(np.int64) - z0) <= thr


def encode_lpu_motion_split(enc, ctx: np.ndarray,
                            ref_points: np.ndarray,
                            cur_points: np.ndarray, lpu_log2: int,
                            depth: int, z0: int, thr: int) -> np.ndarray:
    """Road-object LPU (reference lpuType=0): ground reference points
    keep global motion; only object points get per-LPU refinement."""
    ground = split_ground(ref_points, z0, thr)
    obj = ref_points[~ground]
    if obj.shape[0] == 0:
        return ref_points
    refined = encode_lpu_motion(enc, ctx, obj, cur_points, lpu_log2,
                                depth)
    out = ref_points.astype(np.int64).copy()
    out[~ground] = refined
    return out


def decode_lpu_motion_split(dec, ctx: np.ndarray,
                            ref_points: np.ndarray, lpu_log2: int,
                            depth: int, z0: int, thr: int) -> np.ndarray:
    ground = split_ground(ref_points, z0, thr)
    obj = ref_points[~ground]
    if obj.shape[0] == 0:
        return ref_points
    refined = decode_lpu_motion(dec, ctx, obj, lpu_log2, depth)
    out = ref_points.astype(np.int64).copy()
    out[~ground] = refined
    return out
