#!/usr/bin/env python
"""Cross-config conformance matrix: encode -> md5 -> decode -> verify.

The in-repo analogue of driving the reference's CTC step harness
(scripts/Makefile.tmc13-step) across condition families.  Runs every
codec family through the real CLI on a synthetic cloud (or a PLY you
supply), checks geometry losslessness where applicable, and prints a
JSON summary + md5 digests.

Usage: python -m mpeg_pcc_tmc13_tpu_torch.scripts.ctc_matrix \
           [input.ply] [workdir]

The PyTorch + CUDA port's copy of ``scripts/ctc_matrix.py``: the same
families, cloud and summary, driving the port's CLI (``tmc3-cuda``).
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

from ..utils import morton, ply

CONFIGS = {
    "octree-raht-lossless": dict(
        lossless=True,
        args=["--transformType=0", "--integerHaar=1", "--qp=4",
              "--attribute=color"]),
    "octree-raht-lossy": dict(
        lossless=False,
        args=["--positionQuantizationScale=0.5", "--transformType=0",
              "--qp=22", "--attribute=color"]),
    "octree-predlift": dict(
        lossless=True,
        args=["--transformType=1", "--qp=4", "--attribute=color",
              "--transformType=2", "--qp=4", "--attribute=reflectance"]),
    "trisoup-raht": dict(
        lossless=False,
        args=["--trisoupNodeSizeLog2=2", "--transformType=0", "--qp=16",
              "--attribute=color"]),
    "predgeom-angular": dict(
        lossless=True,
        args=["--geomTreeType=1", "--angularEnabled=1",
              "--mergeDuplicatedPoints=0", "--transformType=1", "--qp=4",
              "--attribute=reflectance"]),
    "octree-inter-gm": dict(
        lossless=True,
        args=["--interPredictionEnabled=1", "--globalMotionEnabled=1",
              "--randomAccessPeriod=8"]),
    "multistream-parent-ctx": dict(
        lossless=True,
        args=["--numOctreeEntropyStreams=4",
              "--neighbourAvailBoundaryLog2=0"]),
    "tiles-slices-qp": dict(
        lossless=False,
        args=["--partitionMethod=4", "--sliceMaxPoints=4000",
              "--tileSize=512", "--positionBaseQp=12"]),
    "bipred-attr-inter": dict(
        lossless=True,
        args=["--interPredictionEnabled=1", "--globalMotionEnabled=1",
              "--biPredictionEnabled=2", "--biPredictionPeriod=4",
              "--randomAccessPeriod=64", "--transformType=0",
              "--integerHaar=1", "--qp=4",
              "--attrInterPredictionEnabled=1", "--attribute=color"]),
    "obuf-planar": dict(
        lossless=True,
        args=["--geomEngine=obuf", "--planarEnabled=1"]),
    "planar-sparse-deep": dict(
        lossless=True,
        args=["--planarEnabled=1", "--inferredDirectCodingMode=0"]),
    "idcm-deep": dict(
        lossless=True,
        args=["--inferredDirectCodingMode=1",
              "--neighbourAvailBoundaryLog2=0"]),
    "multislice-trisoup": dict(
        lossless=False,
        args=["--trisoupNodeSizeLog2=3", "--sliceMaxPoints=6000",
              "--transformType=0", "--qp=22", "--attribute=color"]),
    "pernode-qp": dict(
        lossless=False,
        args=["--positionQuantisationOctreeDepth=3"]),
}


def synth_cloud(path: str, n: int = 20000, depth: int = 10, seed: int = 42):
    rng = np.random.default_rng(seed)
    pos = rng.integers(0, 1 << depth, (n, 3)).astype(np.float64)
    colors = rng.integers(0, 256, (n, 3)).astype(np.uint16)
    refl = rng.integers(0, 256, n).astype(np.uint16)
    ply.write(ply.PlyCloud(positions=pos, colors=colors,
                           reflectances=refl),
              path, position_is_float=False)


def md5(path: str) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    in_ply = argv[0] if len(argv) > 0 else None
    work = argv[1] if len(argv) > 1 else tempfile.mkdtemp(
        prefix="ctc_matrix_")
    os.makedirs(work, exist_ok=True)
    if in_ply is None:
        in_ply = os.path.join(work, "in.ply")
        synth_cloud(in_ply)
    src = ply.read(in_ply)
    src_codes = np.unique(morton.encode(src.positions.astype(np.int64)))

    cli = [sys.executable, "-m", "mpeg_pcc_tmc13_tpu_torch.runtime.cli"]
    results = {}
    ok_all = True
    for name, cfg in CONFIGS.items():
        bin_path = os.path.join(work, f"{name}.bin")
        rec_path = os.path.join(work, f"{name}.ply")
        r = subprocess.run(
            cli + ["--mode=0", f"--uncompressedDataPath={in_ply}",
                   f"--compressedStreamPath={bin_path}"] + cfg["args"],
            capture_output=True, text=True)
        if r.returncode != 0:
            results[name] = {"error": r.stderr[-400:]}
            ok_all = False
            continue
        r2 = subprocess.run(
            cli + ["--mode=1", f"--compressedStreamPath={bin_path}",
                   f"--reconstructedDataPath={rec_path}"],
            capture_output=True, text=True)
        if r2.returncode != 0:
            results[name] = {"error": r2.stderr[-400:]}
            ok_all = False
            continue
        rec = ply.read(rec_path)
        rcodes = np.sort(morton.encode(rec.positions.astype(np.int64)))
        lossless = bool(np.array_equal(rcodes, src_codes))

        def user_time(stdout):
            for line in stdout.splitlines():
                if line.startswith("Processing time (user)"):
                    return float(line.split(":")[1].split()[0])
            return None
        entry = {
            "bytes": os.path.getsize(bin_path),
            "bpp": round(8 * os.path.getsize(bin_path)
                         / max(len(src_codes), 1), 3),
            "points_out": int(rec.count),
            "geom_lossless": lossless,
            "encode_s": user_time(r.stdout),
            "decode_s": user_time(r2.stdout),
            "stream_md5": md5(bin_path),
            "decoded_md5": md5(rec_path),
        }
        if cfg["lossless"] and not lossless:
            entry["FAIL"] = "expected lossless geometry"
            ok_all = False
        results[name] = entry
    print(json.dumps({"input": in_ply, "workdir": work,
                      "ok": ok_all, "configs": results}, indent=2))
    return 0 if ok_all else 1


if __name__ == "__main__":
    sys.exit(main())
