#!/usr/bin/env python3
"""Point-cloud objective quality metric (pc_error equivalent).

Counterpart of the MPEG pc_error tool the reference CTC scripts call
(Makefile.tmc13-step's distortion step): computes the D1
(point-to-point) and D2 (point-to-plane) geometry PSNRs plus per
attribute-channel PSNRs between a source and a reconstruction.

Conventions (matching the de-facto mpeg-pcc-dmetric tool):
  * exact 1-nearest-neighbour matching (scipy cKDTree; falls back to
    the in-repo Morton-window search if scipy is unavailable),
  * symmetric metric: max of the two directional MSEs,
  * geometry PSNR peak energy: 3 * resolution^2 (the MSE sums squared
    error over the three coordinates); resolution from --resolution
    (CTC: 1023 cat1 voxel grids, 30000 cat3 — sequences-cat3.yaml:19),
    else the source bounding-box diagonal,
  * D2 projects the error on the SOURCE cloud's normals in both
    directions (pc_error reads source normals from the file; here they
    are estimated by local PCA when absent),
  * colour PSNR per Y/Cb/Cr (BT.709) channel, peak 255.

Usage:
  python -m mpeg_pcc_tmc13_tpu_torch.tools.pc_error --fileA src.ply \
      --fileB rec.ply [--resolution 1023] [--color 1]
Prints reference-shaped lines: `mseF,PSNR (p2point): <dB>` etc.

The PyTorch + CUDA port's copy of ``tools/pc_error.py``, imports only
changed.  It stays host numpy/scipy, as the reference does.
"""

from __future__ import annotations

import argparse

import numpy as np

from ..utils import ply

try:
    from scipy.spatial import cKDTree
except ImportError:                                  # pragma: no cover
    cKDTree = None


def nn1(query: np.ndarray, pool: np.ndarray):
    """Exact 1-NN: returns (index into pool, squared distance)."""
    if cKDTree is not None:
        d, idx = cKDTree(pool).query(query, k=1, workers=-1)
        return idx, d * d
    from ..ops.recolour import knn
    idx, d2 = knn(pool.astype(np.int64), query.astype(np.int64),
                  k=1, window=64)
    return idx[:, 0], d2[:, 0].astype(np.float64)


def knn_idx(points: np.ndarray, k: int):
    if cKDTree is not None:
        _, idx = cKDTree(points).query(points, k=k, workers=-1)
        return idx
    from ..ops.recolour import knn
    idx, _ = knn(points.astype(np.int64), points.astype(np.int64),
                 k=k, window=64)
    return idx


def estimate_normals(points: np.ndarray, k: int = 9) -> np.ndarray:
    """Unit normals by local PCA (smallest eigenvector of the k-NN
    scatter)."""
    idx = knn_idx(points.astype(np.float64), k)
    nbrs = points[idx].astype(np.float64)          # (N,k,3)
    mean = nbrs.mean(axis=1, keepdims=True)
    d = nbrs - mean
    cov = np.einsum("nki,nkj->nij", d, d) / k
    w, v = np.linalg.eigh(cov)
    n = v[:, :, 0]
    norm = np.linalg.norm(n, axis=1, keepdims=True)
    return n / np.maximum(norm, 1e-12)


_YCBCR709 = np.array([[0.2126, 0.7152, 0.0722],
                      [-0.1146, -0.3854, 0.5000],
                      [0.5000, -0.4542, -0.0458]])


def _rgb_to_ycbcr(rgb: np.ndarray) -> np.ndarray:
    out = rgb.astype(np.float64) @ _YCBCR709.T
    out[:, 1:] += 128.0
    return out


def directional(a: ply.PlyCloud, b: ply.PlyCloud, src_normals=None,
                src_is_a: bool = True):
    """a -> b errors: (d1_mse, d2_mse, per-channel attr mse).

    src_normals are the SOURCE cloud's normals; when the source is b
    (the reverse direction) the projection uses the normal at the
    matched source point, as pc_error does.
    """
    pa = a.positions.astype(np.float64)
    pb = b.positions.astype(np.float64)
    nn, d2pt = nn1(pa, pb)
    diff = pb[nn] - pa
    d1_mse = float(d2pt.mean())
    d2_mse = None
    if src_normals is not None:
        n = src_normals if src_is_a else src_normals[nn]
        proj = (diff * n).sum(axis=1)
        d2_mse = float((proj * proj).mean())
    attr_mse = {}
    if a.colors is not None and b.colors is not None:
        ca = _rgb_to_ycbcr(a.colors)
        cb = _rgb_to_ycbcr(b.colors[nn])
        for ch, name in enumerate(("y", "cb", "cr")):
            e = ca[:, ch] - cb[:, ch]
            attr_mse[name] = float((e * e).mean())
    if a.reflectances is not None and b.reflectances is not None:
        e = (a.reflectances.astype(np.float64)
             - b.reflectances[nn].astype(np.float64))
        attr_mse["reflectance"] = float((e * e).mean())
    return d1_mse, d2_mse, attr_mse


def psnr(mse: float, peak_energy: float) -> float:
    if mse <= 0:
        return float("inf")
    return 10.0 * np.log10(peak_energy / mse)


def compute(a: ply.PlyCloud, b: ply.PlyCloud, resolution: float = None,
            with_d2: bool = True, refl_bits: int = 8):
    if resolution is None:
        ext = a.positions.max(axis=0) - a.positions.min(axis=0)
        resolution = float(np.sqrt((ext * ext).sum()))
    na = estimate_normals(a.positions) if with_d2 else None
    d1_ab, d2_ab, attr_ab = directional(a, b, na, src_is_a=True)
    d1_ba, d2_ba, attr_ba = directional(b, a, na, src_is_a=False)
    geom_peak = 3.0 * resolution * resolution
    out = {
        "d1_mse": max(d1_ab, d1_ba),
        "d1_psnr": psnr(max(d1_ab, d1_ba), geom_peak),
    }
    if with_d2:
        out["d2_mse"] = max(d2_ab, d2_ba)
        out["d2_psnr"] = psnr(max(d2_ab, d2_ba), geom_peak)
    for key in attr_ab:
        m = max(attr_ab[key], attr_ba.get(key, 0.0))
        peak = float((1 << refl_bits) - 1) if key == "reflectance" \
            else 255.0
        out[f"{key}_psnr"] = psnr(m, peak * peak)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fileA", required=True, help="source PLY")
    ap.add_argument("--fileB", required=True, help="reconstruction PLY")
    ap.add_argument("--resolution", type=float, default=None,
                    help="geometry PSNR peak (default: bbox diagonal)")
    ap.add_argument("--color", type=int, default=1)
    ap.add_argument("--noD2", action="store_true")
    args = ap.parse_args(argv)
    a = ply.read(args.fileA)
    b = ply.read(args.fileB)
    r = compute(a, b, args.resolution, with_d2=not args.noD2)
    print(f"mseF      (p2point): {r['d1_mse']:.6f}")
    print(f"mseF,PSNR (p2point): {r['d1_psnr']:.4f}")
    if "d2_psnr" in r:
        print(f"mseF      (p2plane): {r['d2_mse']:.6f}")
        print(f"mseF,PSNR (p2plane): {r['d2_psnr']:.4f}")
    for k, v in r.items():
        if k.endswith("_psnr") and not k.startswith(("d1", "d2")):
            print(f"PSNR {k[:-5]}: {v:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
