"""OBUF octree geometry engine for the native syntax.

Wraps the dynamic-OBUF context machinery (native/refcodec.cc — our
own re-implementation of the reference's strongest occupancy engine,
geometry_octree.h:328-613 + geometry_octree_encoder.cpp) as a brick
payload engine for THIS framework's bitstream: the geometry stream of
a brick is a dirac-coded octree payload instead of a range-coded one.
The QTBT schedule is derived implicitly from the brick's per-axis root
sizes on both sides (reference mkQtBtNodeSizeList rule), so only the
payload bytes travel.

Scope: intra slices, unique points, single entropy stream.  RD on
these bricks matches the reference encoder by construction.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..conformance import ref_hls
from ..conformance.decoder import _load, geom_params_array
from ..conformance.encoder import qtbt_axis_list


def _gps_flags(gps) -> ref_hls.RefGps:
    """Map this framework's GPS planar/QTBT knobs onto the OBUF
    engine's parameter block."""
    planar = bool(gps.planar_mode_enabled)
    th = gps.planar_thresholds
    return ref_hls.RefGps(
        gps_id=0, sps_id=0, geom_box_log2_scale_present=True,
        qtbt_enabled=True, unique_points=True,
        inferred_direct_coding_mode=gps.inferred_direct_coding_mode,
        joint_2pt_idcm=bool(gps.inferred_direct_coding_mode),
        idcm_rate_minus1=31,
        neighbour_avail_boundary_log2_minus1=7,
        adjacent_child_contextualization=True,
        bitwise_occupancy=True,
        planar_enabled=planar,
        planar_threshold0=int(th[0]), planar_threshold1=int(th[1]),
        planar_threshold2=int(th[2]),
        depth_planar_eligibility=(planar
                                  and gps.depth_planar_eligibility),
        planar_dynamic_obuf_eligibility=(planar
                                         and gps.planar_dynamic_obuf),
        multiple_planar=planar and gps.multiple_planar)


def axes_for(axis_bits, depth: int, max_before_ot: int = 4,
             min_size_log2: int = 0) -> np.ndarray:
    root = [int(v) if v else depth for v in
            (axis_bits or (depth, depth, depth))]
    return np.asarray(
        qtbt_axis_list(root, True, max_num_qtbt_before_ot=max_before_ot,
                       min_qtbt_size_log2=min_size_log2),
        dtype=np.int32)


def encode(local: np.ndarray, depth: int, axis_bits, gps,
           ref_local: np.ndarray = None) -> bytes:
    """local: unique non-negative int positions -> dirac payload.

    ref_local: motion-compensated reference positions (same grid);
    per-node child occupancy of the reference selects the OBUF map
    bank per bit (reference inter octree, interCtx = bitPred)."""
    lib = _load()
    c = ctypes
    if not hasattr(lib.tmc13ref_encode_octree_intra, "_configured"):
        lib.tmc13ref_encode_octree_intra.argtypes = [
            c.POINTER(c.c_int32), c.c_int,
            c.POINTER(c.c_int32), c.c_int,
            c.POINTER(c.c_int32),
            c.POINTER(c.c_uint8), c.c_int,
        ]
        lib.tmc13ref_encode_octree_intra.restype = c.c_int
        lib.tmc13ref_encode_octree_inter.argtypes = [
            c.POINTER(c.c_int32), c.c_int,
            c.POINTER(c.c_int32), c.c_int,
            c.POINTER(c.c_int32), c.c_int,
            c.POINTER(c.c_int32),
            c.POINTER(c.c_uint8), c.c_int,
        ]
        lib.tmc13ref_encode_octree_inter.restype = c.c_int
        lib.tmc13ref_encode_octree_intra._configured = True
    pos32 = np.ascontiguousarray(local, dtype=np.int32)
    axes = axes_for(axis_bits, depth, gps.qtbt_max_before_ot,
                    gps.qtbt_min_size_log2)
    gp = geom_params_array(_gps_flags(gps))
    cap = max(int(pos32.shape[0] * 16 + (1 << 16)), 1 << 16)
    out = np.empty(cap, dtype=np.uint8)
    has_ref = ref_local is not None and len(ref_local)
    ref32 = (np.ascontiguousarray(ref_local, dtype=np.int32)
             if has_ref else np.zeros(3, dtype=np.int32))

    # production path: the level-sweep engine (native/obuf_ls.cc) --
    # batched per-level analysis + thin token loop, byte-identical to
    # the BFS oracle and ~3x the reference encoder's speed
    if not hasattr(lib.obufls_encode_octree, "_configured"):
        lib.obufls_encode_octree.argtypes = [
            c.POINTER(c.c_int32), c.c_int,
            c.POINTER(c.c_int32), c.c_int,
            c.POINTER(c.c_int32), c.c_int,
            c.POINTER(c.c_int32), c.POINTER(c.c_uint8), c.c_int]
        lib.obufls_encode_octree.restype = c.c_int
        lib.obufls_encode_octree._configured = True
    n = lib.obufls_encode_octree(
        pos32.ctypes.data_as(c.POINTER(c.c_int32)), pos32.shape[0],
        ref32.ctypes.data_as(c.POINTER(c.c_int32)),
        ref32.shape[0] if has_ref else 0,
        axes.ctypes.data_as(c.POINTER(c.c_int32)), len(axes),
        gp.ctypes.data_as(c.POINTER(c.c_int32)),
        out.ctypes.data_as(c.POINTER(c.c_uint8)), cap)
    if n > 0:
        return out[:n].tobytes()
    if n != -3:
        raise RuntimeError(f"obuf level-sweep encode failed rc={n}")

    # >21 levels: the 64-bit level key does not fit; fall back to the
    # BFS oracle
    if has_ref:
        n = lib.tmc13ref_encode_octree_inter(
            pos32.ctypes.data_as(c.POINTER(c.c_int32)),
            pos32.shape[0],
            ref32.ctypes.data_as(c.POINTER(c.c_int32)),
            ref32.shape[0],
            axes.ctypes.data_as(c.POINTER(c.c_int32)), len(axes),
            gp.ctypes.data_as(c.POINTER(c.c_int32)),
            out.ctypes.data_as(c.POINTER(c.c_uint8)), cap)
    else:
        n = lib.tmc13ref_encode_octree_intra(
            pos32.ctypes.data_as(c.POINTER(c.c_int32)),
            pos32.shape[0],
            axes.ctypes.data_as(c.POINTER(c.c_int32)), len(axes),
            gp.ctypes.data_as(c.POINTER(c.c_int32)),
            out.ctypes.data_as(c.POINTER(c.c_uint8)), cap)
    if n < 0:
        raise RuntimeError(f"obuf encode failed rc={n}")
    return out[:n].tobytes()


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
