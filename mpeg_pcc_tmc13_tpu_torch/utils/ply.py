"""PLY point-cloud reader/writer (drop-in for tmc3's ply.cpp:88,191).

Supports ``ascii`` and ``binary_little_endian`` formats.  Property-name
mapping follows the reference (tmc3/ply.cpp:342-370): positions from the
configured attribute names (default x/y/z), colours from red/green/blue
(uint8), reflectance from ``reflectance``/``refc`` (uint8/uint16),
``frameindex`` (fused-frame experiments), ``laserangle``, and normals
``nx/ny/nz`` are recognised and either captured or skipped.

Everything is numpy-vectorised (np.frombuffer / np.loadtxt-style parsing)
— the reference reads point-by-point through iostreams; a 30M-point LiDAR
frame parses here in a fraction of the time.
"""

from __future__ import annotations

import dataclasses
import io
import os
import re
from typing import Optional

import numpy as np

_PLY_DTYPES = {
    "float64": "<f8", "double": "<f8",
    "float": "<f4", "float32": "<f4",
    "uint64": "<u8", "uint32": "<u4", "uint": "<u4",
    "uint16": "<u2", "ushort": "<u2",
    "uchar": "u1", "uint8": "u1",
    "int64": "<i8", "int32": "<i4", "int": "<i4",
    "int16": "<i2", "short": "<i2",
    "char": "i1", "int8": "i1",
}


@dataclasses.dataclass
class PlyCloud:
    """Struct-of-arrays point cloud at the I/O boundary.

    Mirrors PCCPointSet3 (tmc3/PCCPointSet.h:64): positions + optional
    colours (RGB, stored internally in coding order), reflectances,
    frame indices, laser angles.
    """

    positions: np.ndarray                        # (N,3) float64 or int
    colors: Optional[np.ndarray] = None          # (N,3) uint16 (R,G,B)
    reflectances: Optional[np.ndarray] = None    # (N,) uint16
    frame_indices: Optional[np.ndarray] = None   # (N,) uint16
    laser_angles: Optional[np.ndarray] = None    # (N,) int32

    @property
    def count(self) -> int:
        return len(self.positions)

    def has_colors(self) -> bool:
        return self.colors is not None

    def has_reflectances(self) -> bool:
        return self.reflectances is not None


def _parse_header(f) -> tuple[str, int, list[tuple[str, str]], int]:
    """Returns (format, vertex_count, [(name, dtype_str)], header_len)."""
    magic = f.readline()
    if magic.strip() not in (b"ply",):
        raise ValueError("not a ply file")
    fmt = None
    count = 0
    props: list[tuple[str, str]] = []
    in_vertex = False
    while True:
        line = f.readline()
        if not line:
            raise ValueError("unexpected EOF in ply header")
        tokens = line.decode("ascii", "replace").split()
        if not tokens:
            continue
        if tokens[0] == "format":
            fmt = tokens[1]
        elif tokens[0] == "element":
            in_vertex = tokens[1] == "vertex"
            if in_vertex:
                count = int(tokens[2])
        elif tokens[0] == "property" and in_vertex:
            if tokens[1] == "list":
                raise ValueError("list property on vertex element unsupported")
            props.append((tokens[2], tokens[1]))
        elif tokens[0] == "end_header":
            break
    if fmt not in ("ascii", "binary_little_endian", "binary_big_endian"):
        raise ValueError(f"unsupported ply format {fmt}")
    return fmt, count, props, f.tell()


def read(path, position_names=("x", "y", "z")) -> PlyCloud:
    """Read a PLY file into a PlyCloud (reference ply::read, ply.cpp:191)."""
    with open(path, "rb") as f:
        fmt, count, props, data_off = _parse_header(f)
        names = [p[0] for p in props]
        np_dtype = np.dtype([(n, _PLY_DTYPES[t]) for n, t in props])
        if fmt == "ascii":
            raw = np.loadtxt(
                io.BytesIO(f.read()), dtype=np.float64, ndmin=2, max_rows=count
            )
            rec = {}
            for i, (n, t) in enumerate(props):
                rec[n] = raw[:count, i].astype(np.dtype(_PLY_DTYPES[t]))
        else:
            if fmt == "binary_big_endian":
                np_dtype = np_dtype.newbyteorder(">")
            buf = f.read()
            # tmc3 quirk: frameindex is declared uint8 but written as
            # 2 bytes (reference ply.cpp:133,180-182); detect by size
            if ("frameindex" in names and count
                    and np_dtype["frameindex"].itemsize == 1
                    and len(buf) >= (np_dtype.itemsize + 1) * count):
                props = [(n, "uint16" if n == "frameindex" else t)
                         for n, t in props]
                np_dtype = np.dtype(
                    [(n, _PLY_DTYPES[t]) for n, t in props])
                if fmt == "binary_big_endian":
                    np_dtype = np_dtype.newbyteorder(">")
            arr = np.frombuffer(buf, dtype=np_dtype, count=count)
            rec = {n: arr[n] for n in names}

    def has(*ns):
        return all(n in rec for n in ns)

    if not has(*position_names):
        raise ValueError(f"ply missing position properties {position_names}")
    pos = np.stack([rec[n].astype(np.float64) for n in position_names], axis=1)

    cloud = PlyCloud(positions=pos)
    if has("red", "green", "blue"):
        cloud.colors = np.stack(
            [rec["red"], rec["green"], rec["blue"]], axis=1
        ).astype(np.uint16)
    refl_name = "reflectance" if "reflectance" in rec else (
        "refc" if "refc" in rec else None)
    if refl_name:
        cloud.reflectances = rec[refl_name].astype(np.uint16)
    if "frameindex" in rec:
        cloud.frame_indices = rec["frameindex"].astype(np.uint16)
    if "laserangle" in rec:
        cloud.laser_angles = rec["laserangle"].astype(np.int32)
    return cloud


def write(
    cloud: PlyCloud,
    path,
    ascii: bool = False,
    position_names=("x", "y", "z"),
    position_is_float: bool = True,  # accepted for compat; container
                                     # always matches tmc3 (see below)
):
    """Write a PlyCloud, container byte-identical to tmc3's ply::write
    (reference ply.cpp:88-186):

    * binary positions are always ``float64`` doubles; ascii declares
      ``property float`` and prints fixed 5-decimal values
      (``std::fixed << setprecision(5)``, ply.cpp:141),
    * colours on disk in g,b,r order (ply.cpp:127-129),
    * an empty ``element face 0`` + its list property precede
      ``end_header`` (ply.cpp:136-137),
    * frameindex is declared ``uint8`` but binary-written as 2 bytes —
      a reference quirk we reproduce exactly (ply.cpp:133,180-182).
    """
    n = cloud.count
    # (name, header type, disk dtype, column)
    pt = "float" if ascii else "float64"
    fields: list[tuple[str, str, str, np.ndarray]] = []
    for i, pn in enumerate(position_names):
        fields.append((pn, pt, "<f8", cloud.positions[:, i]))
    if cloud.has_colors():
        # disk order: green, blue, red (ply.cpp:127-129)
        fields.append(("green", "uchar", "u1", cloud.colors[:, 1]))
        fields.append(("blue", "uchar", "u1", cloud.colors[:, 2]))
        fields.append(("red", "uchar", "u1", cloud.colors[:, 0]))
    if cloud.has_reflectances():
        fields.append(("refc", "uint16", "<u2", cloud.reflectances))
    if cloud.frame_indices is not None:
        fields.append(("frameindex", "uint8", "<u2", cloud.frame_indices))

    header = ["ply"]
    header.append(
        "format ascii 1.0" if ascii else "format binary_little_endian 1.0")
    header.append(f"element vertex {n}")
    for name, t, _, _ in fields:
        header.append(f"property {t} {name}")
    header.append("element face 0")
    header.append("property list uint8 int32 vertex_index")
    header.append("end_header")

    rec_dtype = np.dtype([(name, dt) for name, _, dt, _ in fields])
    rec = np.empty(n, dtype=rec_dtype)
    for name, _, dt, col in fields:
        rec[name] = col.astype(np.dtype(dt), copy=False)

    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if ascii:
            cols = []
            for name, t, _, _ in fields:
                c = rec[name]
                if t in ("float", "float64"):
                    cols.append(np.char.mod("%.5f", c))
                else:
                    cols.append(c.astype("U12"))
            lines = cols[0]
            for c in cols[1:]:
                lines = np.char.add(np.char.add(lines, " "), c)
            f.write("\n".join(lines.tolist()).encode("ascii"))
            if n:
                f.write(b"\n")
        else:
            f.write(rec.tobytes())


def expand_num(template: str, number: int) -> str:
    """Expand %d-style frame-number templates (reference misc.cpp:49).

    Supports %d, %0Nd occurrences.
    """
    def repl(m):
        width = m.group(1)
        if width:
            return f"{number:0{int(width)}d}"
        return str(number)

    return re.sub(r"%0?(\d*)d", repl, template)
