#!/usr/bin/env python3
"""Generate a CTC-style configuration tree for the tmc3-compatible CLI
(``tmc3-cuda``, the port's ``mpeg_pcc_tmc13_tpu_torch.runtime.cli``).

Counterpart of the reference's cfg generator (scripts/gen-cfg.sh +
cfg/*.yaml): produces the same directory shape --
``<out>/<condition>/<sequence>/<rate>/{encoder,decoder}.cfg`` -- for the
common-test-condition matrix, but as plain Python with transparent rate
laws instead of the YAML/perl-eval pipeline (the cfg files drive our
CLI directly; unknown reference options would be ignored anyway).

Conditions follow the reference naming scheme
(``<geom>-<attr>-ctc-<fidelity>``):

  geometry: octree | predgeom | trisoup
  attrs:    raht | predlift
  fidelity: lossy-geom-lossy-attrs        (C1: 6 rate points)
            lossless-geom-lossy-attrs     (C2: 6 attribute rate points)
            lossless-geom-lossless-attrs  (CW: single point)

Sequence metadata comes from a JSON file (``--seq-json``) with entries
{"name", "src", "gp" (geometry precision bits), "attrs": ["color"|
"reflectance"], "frames": N}; without one, two synthetic placeholder
sequences are emitted so the tree shape can be inspected.

Usage:
  python -m mpeg_pcc_tmc13_tpu_torch.scripts.gen_ctc_cfg --out ctc-cfg
      [--seq-json seqs.json] [--geom octree predgeom trisoup]
      [--attr raht predlift] [--inter]
then, per rate point:
  tmc3-cuda -c <out>/<cond>/<seq>/<rate>/encoder.cfg \
      --compressedStreamPath=<bin>

The PyTorch + CUDA port's copy of ``scripts/gen_ctc_cfg.py``.
"""

from __future__ import annotations

import argparse
import json
import os

# CTC attribute QP ladder (reference cfg/*.yaml rate points r01..r06)
ATTR_QP = {1: 51, 2: 46, 3: 40, 4: 34, 5: 28, 6: 22}
LOSSLESS_QP = 4   # step 1 under the 6-QP-per-octave law


def geom_scale(gp: int, r: int) -> float:
    """Geometry scale ladder for lossy-geom rate point r (1..6).

    Spans from roughly (gp-7)-bit precision at r01 up to full precision
    at r06, mirroring the reference ladder's coverage for typical
    10-21 bit sources (the reference's exact perl-eval formula is
    harness-internal; this law is monotone and hits the same endpoints).
    """
    span = max(0, min(gp - 7, 5))
    k = round((6 - r) * span / 5)
    return 1.0 / (1 << k)


def _enc_lines(geom, attr, fidelity, seq, r, inter):
    lossy_geom = fidelity.startswith("lossy-geom")
    lossy_attr = fidelity.endswith("lossy-attrs")
    lines = ["mode: 0"]
    if lossy_geom:
        lines.append(f"positionQuantizationScale: {geom_scale(seq['gp'], r)}")
        lines.append("mergeDuplicatedPoints: 1")
    else:
        lines.append("positionQuantizationScale: 1")
        lines.append("mergeDuplicatedPoints: 1")
    if geom == "trisoup":
        lines.append("trisoupNodeSizeLog2: 3")
    elif geom == "predgeom":
        lines.append("geomTreeType: 1")
    lines.append("neighbourAvailBoundaryLog2: 8")
    if inter:
        lines += ["interPredictionEnabled: 1",
                  "globalMotionEnabled: 1",
                  "randomAccessPeriod: 32"]
    qp = ATTR_QP[r] if lossy_attr else LOSSLESS_QP
    for a in seq.get("attrs", []):
        lines.append(f"bitdepth: {8 if a == 'color' else 16}")
        if attr == "raht":
            lines.append("transformType: 0")
            if a == "color" and lossy_attr:
                lines.append("qpChromaOffset: -2")
        else:
            # predlift: lossless/near-lossless -> predicting transform,
            # lossy -> lifting (reference condition mapping)
            lines.append(f"transformType: {2 if lossy_attr else 1}")
        lines.append(f"qp: {qp}")
        if inter:
            lines.append("attrInterPredictionEnabled: 1")
        lines.append(f"attribute: {a}")
    if not seq.get("attrs"):
        lines.append("disableAttributeCoding: 1")
    lines.append(f"uncompressedDataPath: {seq['src']}")
    if seq.get("frames", 1) > 1:
        lines.append(f"frameCount: {seq['frames']}")
    return lines


def _dec_lines():
    return ["mode: 1"]


def generate(out_dir, seqs, geoms, attrs, fidelities, inter):
    n = 0
    for geom in geoms:
        for attr in attrs:
            for fid in fidelities:
                # trisoup is inherently lossy-geometry; predgeom has no
                # trisoup-style lossy ladder beyond scale (keep both)
                if geom == "trisoup" and fid.startswith("lossless-geom"):
                    continue
                cond = f"{geom}-{attr}-ctc-{fid}"
                if inter:
                    cond = f"{cond}-inter"
                rates = range(1, 7) if "lossy" in fid else (1,)
                for seq in seqs:
                    for r in rates:
                        d = os.path.join(out_dir, cond, seq["name"],
                                         f"r{r:02d}")
                        os.makedirs(d, exist_ok=True)
                        with open(os.path.join(d, "encoder.cfg"), "w") as f:
                            f.write("\n".join(
                                _enc_lines(geom, attr, fid, seq, r,
                                           inter)) + "\n")
                        with open(os.path.join(d, "decoder.cfg"), "w") as f:
                            f.write("\n".join(_dec_lines()) + "\n")
                        n += 1
    return n


_PLACEHOLDER_SEQS = [
    {"name": "synthetic-solid", "src": "synthetic-solid.ply", "gp": 10,
     "attrs": ["color"], "frames": 1},
    {"name": "synthetic-lidar", "src": "synthetic-lidar.ply", "gp": 18,
     "attrs": ["reflectance"], "frames": 1},
]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="ctc-cfg")
    ap.add_argument("--seq-json", default=None,
                    help="JSON list of sequence dicts (name/src/gp/"
                         "attrs/frames)")
    ap.add_argument("--geom", nargs="+", default=["octree"],
                    choices=["octree", "predgeom", "trisoup"])
    ap.add_argument("--attr", nargs="+", default=["raht", "predlift"],
                    choices=["raht", "predlift"])
    ap.add_argument("--fidelity", nargs="+",
                    default=["lossy-geom-lossy-attrs",
                             "lossless-geom-lossy-attrs",
                             "lossless-geom-lossless-attrs"])
    ap.add_argument("--inter", action="store_true",
                    help="generate inter (P-frame + global motion) "
                         "variants")
    args = ap.parse_args(argv)
    if args.seq_json:
        with open(args.seq_json) as f:
            seqs = json.load(f)
    else:
        seqs = _PLACEHOLDER_SEQS
    n = generate(args.out, seqs, args.geom, args.attr, args.fidelity,
                 args.inter)
    print(f"wrote {n} rate-point directories under {args.out}/")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
