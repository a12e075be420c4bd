#!/usr/bin/env python
"""Head-to-head RD + throughput parity vs the reference tmc3 binary.

Runs the reference encoder/decoder (``build_ref/tmc3/tmc3``, built from
the reference TMC13 sources) and the port's CLI (``tmc3-cuda``) over the
same inputs and operating points, then collates {geom bpp, attr bpp,
D1/D2 PSNR, attr PSNR, enc/dec Mpts/s} into PARITY.csv, PARITY.md and
parity_rows.json under ``--out`` (default ``build/parity_torch/``).
The JAX package's ``docs/PARITY.*`` are never written.

Rate points follow the reference CTC law
(cfg/octree-raht-ctc-lossy-geom-lossy-attrs.yaml:22-34): the
positionQuantizationScale ladder is derived from the source geometry
precision and the attribute QP ladder is {51,46,40,34,28,22}.

Inputs come from ``scripts.gen_clouds`` (``data/surface_1m.ply``,
``data/lidar_%04d.ply``).  Without a binary at ``--tmc3`` every tmc3 row
ends in an error that names the missing path.

Usage:
  python -m mpeg_pcc_tmc13_tpu_torch.scripts.parity [--tmc3 PATH]
      [--cond NAME ...] [--rates r01,r04] [--codecs ours] [--out DIR]

The PyTorch + CUDA port's copy of ``scripts/parity.py``: the same
conditions, rate law, metrics and reports, on the port's CLI and its
``tools.pc_error``.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

from ..tools import pc_error
from ..utils import ply
from .gen_clouds import _hdl64_elevations

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
OUT_DEFAULT = os.path.join(ROOT, "build", "parity_torch")
TMC3_DEFAULT = os.path.join(ROOT, "build_ref", "tmc3", "tmc3")
RATE_QP = {"r01": 51, "r02": 46, "r03": 40, "r04": 34, "r05": 28,
           "r06": 22}


def ctc_pqs(src_geometry_precision: int, rate: str) -> float:
    """The reference CTC geometry rate law (perl $eval from
    cfg/octree-raht-ctc-lossy-geom-lossy-attrs.yaml:22-34)."""
    rp = 6 - int(rate[1:])                 # r01 -> 5 ... r06 -> 0
    gp = src_geometry_precision
    p_min = max(gp - 9, 7)
    start = min(1, gp - (p_min + 6))
    step = max(1.0, (min(gp - 1, p_min + 7) - p_min) / 5.0)
    y = start + round(rp * step)
    div = 1 << (abs(y) + 1)
    # perl: ((1 - 2*signbit(y)) % div) / div  (perl % is floored)
    return ((1 - 2 * (y < 0)) % div) / div


# --------------------------------------------------------------------------
# condition table
# --------------------------------------------------------------------------

SURFACE = os.path.join(ROOT, "data", "surface_1m.ply")
LIDAR0 = os.path.join(ROOT, "data", "lidar_0000.ply")
LIDAR_SEQ = os.path.join(ROOT, "data", "lidar_%04d.ply")


def _color_attr(qp, extra=()):
    return ["--bitdepth=8", f"--qp={qp}", "--qpChromaOffset=-2",
            *extra, "--attribute=color"]


def _refl_attr(qp, transform, extra=()):
    return ["--bitdepth=8", f"--qp={qp}", f"--transformType={transform}",
            *extra, "--attribute=reflectance"]


def conditions():
    """name -> dict(input, frames, gp, resolution, rates, args_fn).

    args_fn(rate) -> (common encoder args for BOTH codecs).  Codec-
    specific extras live in TMC3_EXTRA / OURS_EXTRA.
    """
    c = {}
    c["octree-lossy-geom"] = dict(
        input=LIDAR0, frames=1, gp=18, resolution=30000,
        rates=["r01", "r02", "r03", "r04", "r05", "r06"],
        lossless=False,
        args=lambda r: [
            f"--positionQuantizationScale={ctc_pqs(18, r)}",
            "--mergeDuplicatedPoints=1", "--disableAttributeCoding=1"])
    c["octree-raht-lossless"] = dict(
        input=SURFACE, frames=1, gp=10, resolution=1023,
        rates=["r0X"], lossless=True,
        args=lambda r: [
            "--positionQuantizationScale=1", "--mergeDuplicatedPoints=1",
            "--transformType=0", "--integerHaar=1",
            # the CTC lossless condition codes YCgCo-R (reversible;
            # cfg/octree-raht-ctc-lossless-geom-lossless-attrs.yaml:88)
            *_color_attr(4, ("--colourMatrix=8",))])
    c["octree-raht-lossy"] = dict(
        input=SURFACE, frames=1, gp=10, resolution=1023,
        rates=["r01", "r02", "r03", "r04", "r05", "r06"],
        lossless=False,
        args=lambda r: [
            f"--positionQuantizationScale={ctc_pqs(10, r)}",
            "--mergeDuplicatedPoints=1", "--transformType=0",
            *_color_attr(RATE_QP[r])])
    c["octree-predlift-lossy"] = dict(
        input=SURFACE, frames=1, gp=10, resolution=1023,
        rates=["r02", "r04", "r06"], lossless=False,
        args=lambda r: [
            f"--positionQuantizationScale={ctc_pqs(10, r)}",
            "--mergeDuplicatedPoints=1", "--transformType=2",
            *_color_attr(RATE_QP[r])])
    c["trisoup-raht"] = dict(
        input=SURFACE, frames=1, gp=10, resolution=1023,
        rates=["r02", "r04"], lossless=False,
        args=lambda r: [
            "--positionQuantizationScale=1",
            "--mergeDuplicatedPoints=1",
            f"--trisoupNodeSizeLog2={4 if r == 'r02' else 3}",
            "--transformType=0", *_color_attr(RATE_QP[r])])
    theta = ",".join(f"{t:.6f}" for t in
                     np.tan(_hdl64_elevations(64)))
    npt = ",".join(["8000"] * 64)
    zeros = ",".join(["0"] * 64)
    head = 1 << 17
    c["octree-angular"] = dict(
        input=LIDAR0, frames=1, gp=18, resolution=30000,
        rates=["r02", "r04", "r06"], lossless=False,
        args=lambda r: [
            f"--positionQuantizationScale={ctc_pqs(18, r)}",
            "--mergeDuplicatedPoints=1", "--disableAttributeCoding=1",
            "--angularEnabled=1", "--planarEnabled=1",
            "--numLasers=64",
            f"--lidarHeadPosition={head},{head},{head}",
            f"--lasersTheta={theta}", f"--lasersZ={zeros}",
            f"--lasersNumPhiPerTurn={npt}"])
    c["predgeom-angular"] = dict(
        input=LIDAR0, frames=1, gp=18, resolution=30000,
        rates=["r02", "r04", "r06"], lossless=False,
        args=lambda r: [
            f"--positionQuantizationScale={ctc_pqs(18, r)}",
            "--mergeDuplicatedPoints=1", "--disableAttributeCoding=1",
            "--geomTreeType=1", "--angularEnabled=1",
            "--numLasers=64",
            f"--lidarHeadPosition={head},{head},{head}",
            f"--lasersTheta={theta}", f"--lasersZ={zeros}",
            f"--lasersNumPhiPerTurn={npt}"])
    c["octree-inter-gm"] = dict(
        input=LIDAR_SEQ, frames=4, gp=18, resolution=30000,
        rates=["r04"], lossless=False,
        args=lambda r: [
            f"--positionQuantizationScale={ctc_pqs(18, r)}",
            "--mergeDuplicatedPoints=1", "--disableAttributeCoding=1",
            "--interPredictionEnabled=1", "--globalMotionEnabled=1",
            "--lpuType=1", "--randomAccessPeriod=8"])
    return c


# per-codec extras (options only meaningful to one side)
TMC3_EXTRA = ["--neighbourAvailBoundaryLog2=8", "--planarEnabled=1",
              "--convertPlyColourspace=1"]
OURS_EXTRA = ["--convertPlyColourspace=1"]
# the reference-syntax conformance path: byte-identical streams by
# construction, so it must receive the SAME tool flags as the tmc3
# rows (since round 5 our refSyntax defaults equal tmc3's option-table
# defaults, so any flag given only to tmc3 silently diverges the pair)
OURS_REF_EXTRA = ["--refSyntax=1", "--neighbourAvailBoundaryLog2=8",
                  "--planarEnabled=1", "--convertPlyColourspace=1"]
# native syntax with the OBUF brick engine (reference-class occupancy
# compression inside our own bitstream)
OURS_OBUF_EXTRA = ["--geomEngine=obuf", "--planarEnabled=1",
                   "--convertPlyColourspace=1"]


# --------------------------------------------------------------------------

_TIME_RE = re.compile(r"Processing time \(user\): ([0-9.]+)\s*s")
_WALL_RE = re.compile(r"Processing time \(wall\): ([0-9.]+)\s*s")
_GEOM_RE = re.compile(r"positions bitstream size (\d+) B")
_ATTR_RE = re.compile(r"(colors|reflectances?|color|reflectance)s? "
                      r"bitstream size (\d+) B")


def run(cmd, log_path):
    t0 = time.time()
    p = subprocess.run(cmd, capture_output=True, text=True)
    wall = time.time() - t0
    with open(log_path, "w") as f:
        f.write(" ".join(cmd) + "\n\n" + p.stdout + "\n" + p.stderr)
    if p.returncode != 0:
        raise RuntimeError(
            f"{' '.join(cmd[:2])} rc={p.returncode}; see {log_path}")
    return p.stdout, wall


def parse_log(out: str):
    user = sum(float(m) for m in _TIME_RE.findall(out)) or None
    geom = sum(int(m) for m in _GEOM_RE.findall(out))
    attr = sum(int(m[1]) for m in _ATTR_RE.findall(out))
    return user, geom, attr


def codec_cmd(codec, tmc3_path):
    if codec == "tmc3":
        if not os.path.isfile(tmc3_path):
            raise FileNotFoundError(
                f"no tmc3 binary at {tmc3_path}: build the reference "
                f"TMC13 encoder there or name it with --tmc3")
        return [tmc3_path]
    return [sys.executable, "-m", "mpeg_pcc_tmc13_tpu_torch.runtime.cli"]


def codec_extra(codec):
    if codec == "tmc3":
        return TMC3_EXTRA
    if codec == "ours-ref":
        return OURS_REF_EXTRA
    if codec == "ours-obuf":
        return OURS_OBUF_EXTRA
    return OURS_EXTRA


def eval_condition(name, cond, codec, rate, workdir, tmc3_path):
    os.makedirs(workdir, exist_ok=True)
    tag = f"{name}.{rate}.{codec}"
    bin_path = os.path.join(workdir, tag + ".bin")
    rec_path = os.path.join(workdir, tag + ".dec_%04d.ply")
    frames = cond["frames"]
    enc_cmd = codec_cmd(codec, tmc3_path) + [
        "--mode=0",
        f"--uncompressedDataPath={cond['input']}",
        f"--compressedStreamPath={bin_path}",
        f"--frameCount={frames}",
        *cond["args"](rate),
        *codec_extra(codec),
    ]
    enc_out, enc_wall = run(enc_cmd, os.path.join(
        workdir, tag + ".enc.log"))
    enc_user, geom_b, attr_b = parse_log(enc_out)
    dec_cmd = codec_cmd(codec, tmc3_path) + [
        "--mode=1",
        f"--compressedStreamPath={bin_path}",
        f"--reconstructedDataPath={rec_path}",
        "--outputBinaryPly=1",
        "--convertPlyColourspace=1",
        *(["--refSyntax=1"] if codec == "ours-ref" else []),
    ]
    dec_out, dec_wall = run(dec_cmd, os.path.join(
        workdir, tag + ".dec.log"))
    dec_user, _, _ = parse_log(dec_out)

    # metrics over all frames (exact-NN pc_error equivalent)
    npts = 0
    d1 = []
    d2 = []
    ypsnr = []
    rpsnr = []
    for f in range(frames):
        src = ply.read(ply.expand_num(cond["input"], f))
        rec = ply.read(ply.expand_num(rec_path, f))
        npts += src.positions.shape[0]
        m = pc_error.compute(src, rec, resolution=cond["resolution"])
        d1.append(m["d1_psnr"])
        d2.append(m.get("d2_psnr", float("nan")))
        if "y_psnr" in m:
            ypsnr.append(m["y_psnr"])
        if "reflectance_psnr" in m:
            rpsnr.append(m["reflectance_psnr"])

    total_b = os.path.getsize(bin_path)
    fin = np.mean
    return dict(
        cond=name, rate=rate, codec=codec, points=npts,
        geom_bpp=8.0 * geom_b / npts, attr_bpp=8.0 * attr_b / npts,
        total_bpp=8.0 * total_b / npts,
        d1_psnr=float(fin(d1)), d2_psnr=float(fin(d2)),
        y_psnr=float(fin(ypsnr)) if ypsnr else None,
        refl_psnr=float(fin(rpsnr)) if rpsnr else None,
        enc_user_s=enc_user, dec_user_s=dec_user,
        enc_wall_s=enc_wall, dec_wall_s=dec_wall,
        enc_mpts=npts / enc_user / 1e6 if enc_user else None,
        dec_mpts=npts / dec_user / 1e6 if dec_user else None,
    )


def fmt(v, nd=2):
    if v is None:
        return "-"
    if isinstance(v, float):
        if np.isinf(v):
            return "inf"
        if np.isnan(v):
            return "-"
        return f"{v:.{nd}f}"
    return str(v)


def write_reports(rows, csv_path, md_path):
    cols = ["cond", "rate", "codec", "points", "geom_bpp", "attr_bpp",
            "total_bpp", "d1_psnr", "d2_psnr", "y_psnr", "refl_psnr",
            "enc_user_s", "dec_user_s", "enc_mpts", "dec_mpts"]
    with open(csv_path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=cols, extrasaction="ignore")
        w.writeheader()
        for r in rows:
            w.writerow(r)
    # markdown: per condition, tmc3 and ours side by side per rate
    by_cond = {}
    for r in rows:
        by_cond.setdefault(r["cond"], {}).setdefault(
            r["rate"], {})[r["codec"]] = r
    lines = [
        "# PARITY — head-to-head vs reference tmc3 (the port, tmc3-cuda)",
        "",
        "Reference binary: `build_ref/tmc3/tmc3` (Release), built from "
        "the reference TMC13 sources.  Inputs: synthetic clouds "
        "with CTC-like structure "
        "(`mpeg_pcc_tmc13_tpu_torch.scripts.gen_clouds`): "
        "`surface_1m.ply` (1.22M pts, 10-bit, RGB) and "
        "`lidar_%04d.ply` (468k pts/frame, 18-bit 1mm grid, "
        "reflectance).  Rate points per the reference CTC law "
        "(`cfg/octree-raht-ctc-lossy-geom-lossy-attrs.yaml:22-34`); "
        "metrics from the exact-NN pc_error equivalent "
        "(`mpeg_pcc_tmc13_tpu_torch.tools.pc_error`).  Every row is "
        "from this run.  Δ columns are ours minus tmc3 "
        "(bpp: negative is better; PSNR: positive is better).",
        "",
    ]
    for cond, rates in by_cond.items():
        lines.append(f"## {cond}")
        lines.append("")
        lines.append(
            "| rate | codec | geom bpp | attr bpp | total bpp | D1 dB "
            "| D2 dB | attr dB | enc Mpts/s | dec Mpts/s |")
        lines.append("|---|---|---|---|---|---|---|---|---|---|")
        for rate in sorted(rates):
            pair = rates[rate]
            for codec in ("tmc3", "ours", "ours-obuf", "ours-ref"):
                r = pair.get(codec)
                if not r:
                    continue
                attr_db = r["y_psnr"] if r["y_psnr"] is not None \
                    else r["refl_psnr"]
                lines.append(
                    f"| {rate} | {codec} | {fmt(r['geom_bpp'], 3)} | "
                    f"{fmt(r['attr_bpp'], 3)} | {fmt(r['total_bpp'], 3)}"
                    f" | {fmt(r['d1_psnr'])} | {fmt(r['d2_psnr'])} | "
                    f"{fmt(attr_db)} | {fmt(r['enc_mpts'])} | "
                    f"{fmt(r['dec_mpts'])} |")
            # Δ vs the RD engine (ours-obuf) when present — that's
            # the configuration a user picks for tmc3-class RD; the
            # fast native engine trades bpp for 6-9x encode speed
            best = pair.get("ours-obuf") or pair.get("ours")
            if "tmc3" in pair and best:
                t, o = pair["tmc3"], best
                dg = o["geom_bpp"] - t["geom_bpp"]
                dt = o["total_bpp"] - t["total_bpp"]
                dd = o["d1_psnr"] - t["d1_psnr"]
                sp = (o["enc_mpts"] / t["enc_mpts"]
                      if t["enc_mpts"] and o["enc_mpts"] else None)
                tag = ("**Δ obuf**" if pair.get("ours-obuf")
                       else "**Δ**")
                lines.append(
                    f"| {rate} | {tag} | {dg:+.3f} | | {dt:+.3f} | "
                    f"{dd:+.2f} | | | {fmt(sp)}x | |")
        lines.append("")
    with open(md_path, "w") as f:
        f.write("\n".join(lines) + "\n")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tmc3", default=TMC3_DEFAULT)
    ap.add_argument("--cond", nargs="*", default=None)
    ap.add_argument("--rates", default=None)
    ap.add_argument("--codecs", default="tmc3,ours")
    ap.add_argument("--out", default=OUT_DEFAULT,
                    help="directory of PARITY.csv/.md and parity_rows.json")
    ap.add_argument("--workdir", default=None,
                    help="streams, logs and decodes (default: <out>/runs)")
    ap.add_argument("--json", default=None,
                    help="rows file (default: <out>/parity_rows.json)")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    workdir = args.workdir or os.path.join(args.out, "runs")
    json_path = args.json or os.path.join(args.out, "parity_rows.json")

    conds = conditions()
    names = args.cond or list(conds)
    rows = []
    if os.path.exists(json_path):
        rows = json.load(open(json_path))
    for name in names:
        cond = conds[name]
        rates = (args.rates.split(",") if args.rates else cond["rates"])
        for rate in rates:
            if rate not in cond["rates"]:
                continue
            for codec in args.codecs.split(","):
                # the conformance (refSyntax) engine covers octree,
                # trisoup and predgeom bricks at coding scale 1
                # (tests/test_conformance.py predgeom identity); the
                # parity predgeom rows run at decimated scales, which
                # the refSyntax CLI does not yet plumb
                if codec == "ours-ref" and "predgeom" in name:
                    continue
                if codec == "ours-obuf" and "predgeom" in name:
                    continue
                key = (name, rate, codec)
                rows = [r for r in rows if
                        (r["cond"], r["rate"], r["codec"]) != key]
                print(f"== {name} {rate} {codec}", flush=True)
                try:
                    row = eval_condition(name, cond, codec, rate,
                                         workdir, args.tmc3)
                except Exception as e:
                    print(f"   FAILED: {e}", flush=True)
                    row = dict(cond=name, rate=rate, codec=codec,
                               error=str(e))
                rows.append(row)
                json.dump(rows, open(json_path, "w"), indent=1)
    ok = [r for r in rows if "error" not in r]
    md_path = os.path.join(args.out, "PARITY.md")
    write_reports(ok, os.path.join(args.out, "PARITY.csv"), md_path)
    print(f"wrote {md_path} ({len(ok)} rows)")
    return rows


if __name__ == "__main__":
    main()
