"""OBUF octree geometry engine for the native syntax: counterpart of
``mpeg_pcc_tmc13_tpu/models/geometry_obuf.py``.

The engine is the shared native library; ``encode``, ``axes_for`` and
the parameter mapping are the reference's own (re-exported).  Only
``decode`` is copied, because its last step sorts into Morton order with
the port's ``utils.morton``.
"""

from __future__ import annotations

import ctypes

import numpy as np

from mpeg_pcc_tmc13_tpu.conformance.decoder import _load, geom_params_array
from mpeg_pcc_tmc13_tpu.models.geometry_obuf import (  # noqa: F401
    _gps_flags, axes_for, encode)


def decode(data: bytes, num_points: int, depth: int, axis_bits,
           gps, ref_local: np.ndarray = None,
           skip_layers: int = 0, max_points: int = 0) -> np.ndarray:
    """dirac payload -> positions, Morton-sorted.

    skip_layers > 0: scalable truncation — the last layers are not
    decoded and node centres come back at full resolution (reference
    decodeGeometryOctreeScalable)."""
    lib = _load()
    c = ctypes
    if not hasattr(lib.tmc13ref_decode_octree_inter, "_configured"):
        lib.tmc13ref_decode_octree_inter.argtypes = [
            c.POINTER(c.c_uint8), c.c_int,
            c.POINTER(c.c_int32), c.c_int, c.c_int,
            c.POINTER(c.c_int32), c.c_int,
            c.POINTER(c.c_int32),
            c.POINTER(c.c_int32), c.c_int,
        ]
        lib.tmc13ref_decode_octree_inter.restype = c.c_int
        lib.tmc13ref_decode_octree_scalable.argtypes = [
            c.POINTER(c.c_uint8), c.c_int,
            c.POINTER(c.c_int32), c.c_int, c.c_int, c.c_int, c.c_int,
            c.POINTER(c.c_int32), c.c_int,
            c.POINTER(c.c_int32),
            c.POINTER(c.c_int32), c.c_int,
        ]
        lib.tmc13ref_decode_octree_scalable.restype = c.c_int
        lib.tmc13ref_decode_octree_inter._configured = True
    buf = np.frombuffer(data, dtype=np.uint8)
    axes = axes_for(axis_bits, depth, gps.qtbt_max_before_ot,
                    gps.qtbt_min_size_log2)
    gp = geom_params_array(_gps_flags(gps))
    out = np.empty((max(num_points, 1), 3), dtype=np.int32)
    if skip_layers > 0 or max_points > 0:
        ref32 = (np.ascontiguousarray(ref_local, dtype=np.int32)
                 if ref_local is not None and len(ref_local)
                 else np.zeros((0, 3), dtype=np.int32))
        n = lib.tmc13ref_decode_octree_scalable(
            buf.ctypes.data_as(c.POINTER(c.c_uint8)), buf.shape[0],
            axes.ctypes.data_as(c.POINTER(c.c_int32)), len(axes),
            num_points, int(skip_layers), int(max_points),
            ref32.ctypes.data_as(c.POINTER(c.c_int32)),
            ref32.shape[0],
            gp.ctypes.data_as(c.POINTER(c.c_int32)),
            out.ctypes.data_as(c.POINTER(c.c_int32)), num_points)
    elif ref_local is not None and len(ref_local):
        ref32 = np.ascontiguousarray(ref_local, dtype=np.int32)
        if not hasattr(lib.obufls_decode_octree, "_configured"):
            lib.obufls_decode_octree.argtypes = [
                c.POINTER(c.c_uint8), c.c_int,
                c.POINTER(c.c_int32), c.c_int, c.c_int,
                c.POINTER(c.c_int32), c.c_int,
                c.POINTER(c.c_int32),
                c.POINTER(c.c_int32), c.c_int]
            lib.obufls_decode_octree.restype = c.c_int
            lib.obufls_decode_octree._configured = True
        n = lib.obufls_decode_octree(
            buf.ctypes.data_as(c.POINTER(c.c_uint8)), buf.shape[0],
            axes.ctypes.data_as(c.POINTER(c.c_int32)), len(axes),
            num_points,
            ref32.ctypes.data_as(c.POINTER(c.c_int32)),
            ref32.shape[0],
            gp.ctypes.data_as(c.POINTER(c.c_int32)),
            out.ctypes.data_as(c.POINTER(c.c_int32)), num_points)
        if n == -3:
            n = lib.tmc13ref_decode_octree_inter(
                buf.ctypes.data_as(c.POINTER(c.c_uint8)), buf.shape[0],
                axes.ctypes.data_as(c.POINTER(c.c_int32)), len(axes),
                num_points,
                ref32.ctypes.data_as(c.POINTER(c.c_int32)),
                ref32.shape[0],
                gp.ctypes.data_as(c.POINTER(c.c_int32)),
                out.ctypes.data_as(c.POINTER(c.c_int32)), num_points)
    else:
        # production path: the level-sweep decoder (native/obuf_ls.cc)
        # — batched parent-level analysis + thin serial loop, output-
        # identical to the BFS oracle; falls back on unsupported tools
        # (IDCM, >21 levels) with rc=-3
        if not hasattr(lib.obufls_decode_octree, "_configured"):
            lib.obufls_decode_octree.argtypes = [
                c.POINTER(c.c_uint8), c.c_int,
                c.POINTER(c.c_int32), c.c_int, c.c_int,
                c.POINTER(c.c_int32), c.c_int,
                c.POINTER(c.c_int32),
                c.POINTER(c.c_int32), c.c_int]
            lib.obufls_decode_octree.restype = c.c_int
            lib.obufls_decode_octree._configured = True
        n = lib.obufls_decode_octree(
            buf.ctypes.data_as(c.POINTER(c.c_uint8)), buf.shape[0],
            axes.ctypes.data_as(c.POINTER(c.c_int32)), len(axes),
            num_points, None, 0,
            gp.ctypes.data_as(c.POINTER(c.c_int32)),
            out.ctypes.data_as(c.POINTER(c.c_int32)), num_points)
        if n == -3:
            n = lib.tmc13ref_decode_octree_intra(
                buf.ctypes.data_as(c.POINTER(c.c_uint8)), buf.shape[0],
                axes.ctypes.data_as(c.POINTER(c.c_int32)), len(axes),
                num_points,
                gp.ctypes.data_as(c.POINTER(c.c_int32)),
                out.ctypes.data_as(c.POINTER(c.c_int32)), num_points)
    if n < 0:
        raise RuntimeError(f"obuf decode failed rc={n}")
    pos = out[:n].astype(np.int64)
    from ..utils import morton
    return pos[np.argsort(morton.encode(pos), kind="stable")]
