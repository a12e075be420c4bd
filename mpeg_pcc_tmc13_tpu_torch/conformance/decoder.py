"""Decode reference (tmc3) bitstreams to point clouds.

Glue around the native bit-exact engine (native/refcodec.cc): parses
the reference TLV/HLS syntax (ref_hls.py) and drives the octree brick
decoder, reproducing the reference decoder's output cloud
(PCCTMC3Decoder3::decodeGeometryBrick + outputCurrentCloud,
tmc3/decoder.cpp:573,?).

Supported: octree geometry, intra, planar/IDCM (non-angular)/
angular off, single entropy stream, bitwise occupancy, no in-tree
scaling; unique or duplicate points; any QTBT coded-axis schedule.

The PyTorch + CUDA port's copy of
``mpeg_pcc_tmc13_tpu/conformance/decoder.py``, imports only changed.
``_load`` hands out the package's own native library
(``bitstream.entropy``) and builds nothing itself.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional

import numpy as np

from . import ref_hls
from ..bitstream import entropy

_lib: Optional[ctypes.CDLL] = None


def _load() -> ctypes.CDLL:
    """The package's own native library (built by ``bitstream.entropy``
    from ``native/``) with this module's entry points bound.  Raises when
    the library did not build: nothing here has a fallback."""
    global _lib
    if _lib is not None:
        return _lib
    lib = entropy._LIB
    if lib is None:
        raise RuntimeError("the native library of mpeg_pcc_tmc13_tpu_torch "
                           "did not build (see bitstream/entropy.py)")
    c = ctypes
    lib.tmc13ref_decode_octree_intra.argtypes = [
        c.POINTER(c.c_uint8), c.c_int,
        c.POINTER(c.c_int32), c.c_int,
        c.c_int,
        c.POINTER(c.c_int32),
        c.POINTER(c.c_int32), c.c_int,
    ]
    lib.tmc13ref_decode_octree_intra.restype = c.c_int
    lib.tmc13ref_decode_raht_attr.argtypes = [
        c.POINTER(c.c_uint8), c.c_int,
        c.POINTER(c.c_int64), c.c_int, c.c_int,
        c.POINTER(c.c_int32), c.c_int,
        c.c_int,
        c.POINTER(c.c_int32),
        c.POINTER(c.c_int32),
        c.POINTER(c.c_int32),    # pointQp region offsets, nullable
    ]
    lib.tmc13ref_decode_raht_attr.restype = c.c_int
    lib.tmc13ref_decode_octree_trisoup.argtypes = [
        c.POINTER(c.c_uint8), c.c_int, c.POINTER(c.c_int32), c.c_int,
        c.c_int, c.c_int, c.POINTER(c.c_int32), c.POINTER(c.c_int32),
        c.c_int, c.POINTER(c.c_void_p)]
    lib.tmc13ref_decode_octree_trisoup.restype = c.c_int
    lib.tsref_open.argtypes = [c.c_void_p]
    lib.tsref_open.restype = c.c_void_p
    lib.tsref_close.argtypes = [c.c_void_p]
    lib.tsref_dec_verts.argtypes = [
        c.c_void_p, c.POINTER(c.c_uint16), c.POINTER(c.c_int32), c.c_int,
        c.c_int, c.POINTER(c.c_uint8), c.POINTER(c.c_uint8),
        c.POINTER(c.c_int32)]
    lib.tsref_dec_verts.restype = c.c_int
    lib.tsref_dec_centroids.argtypes = [
        c.c_void_p, c.POINTER(c.c_int32), c.c_int, c.POINTER(c.c_int32)]
    lib.tsref_dec_faces.argtypes = [
        c.c_void_p, c.c_int, c.POINTER(c.c_uint8)]
    lib.tsgeom_open.argtypes = [
        c.POINTER(c.c_int32), c.c_int, c.c_int, c.c_int, c.c_int, c.c_int,
        c.POINTER(c.c_int32), c.POINTER(c.c_int32), c.c_int, c.c_int,
        c.c_int, c.c_int, c.c_int, c.c_int]
    lib.tsgeom_open.restype = c.c_void_p
    lib.tsgeom_close.argtypes = [c.c_void_p]
    lib.tsgeom_nseg.argtypes = [c.c_void_p]
    lib.tsgeom_nseg.restype = c.c_int
    lib.tsgeom_set_verts.argtypes = [c.c_void_p, c.POINTER(c.c_int32)]
    lib.tsgeom_set_verts.restype = c.c_int
    lib.tsgeom_get_cctx.argtypes = [c.c_void_p, c.POINTER(c.c_int32)]
    lib.tsgeom_apply_drifts.argtypes = [c.c_void_p, c.POINTER(c.c_int32)]
    lib.tsgeom_apply_drifts.restype = c.c_int
    lib.tsgeom_apply_faces.argtypes = [c.c_void_p, c.POINTER(c.c_uint8)]
    lib.tsgeom_reconstruct.argtypes = [c.c_void_p]
    lib.tsgeom_reconstruct.restype = c.c_int
    lib.tsgeom_get_points.argtypes = [c.c_void_p, c.POINTER(c.c_int32)]
    _lib = lib
    return lib


def geom_params_array(gps, bypass_no_update=False,
                      cabac_bypass=False) -> "np.ndarray":
    """Pack the RefGps tool flags into the native GeomParams layout
    (native/obuf_core.h GeomParams)."""
    return np.array([
        gps.neighbour_avail_boundary_log2_minus1 + 1,
        1 if gps.adjacent_child_contextualization else 0,
        1 if gps.unique_points else 0,
        1 if gps.planar_enabled else 0,
        0 if gps.planar_buffer_disabled else 1,
        1 if gps.multiple_planar else 0,
        1 if gps.depth_planar_eligibility else 0,
        1 if gps.planar_dynamic_obuf_eligibility else 0,
        gps.planar_threshold0, gps.planar_threshold1,
        gps.planar_threshold2,
        1 if bypass_no_update else 0,
        gps.inferred_direct_coding_mode,
        1 if gps.joint_2pt_idcm else 0,
        gps.idcm_rate_minus1,
        1 if cabac_bypass else 0,
    ], dtype=np.int32)


class UnsupportedTool(NotImplementedError):
    pass


def _check_supported(sps: ref_hls.RefSps, gps: ref_hls.RefGps,
                     gbh: ref_hls.RefGbh):
    unsupported = []
    if sps.cabac_bypass_stream_enabled and gbh.geom_stream_cnt_minus1:
        unsupported.append("cabac bypass stream with multiple streams")
    if gps.angular_enabled and gps.trisoup_enabled:
        unsupported.append("angular trisoup")
    if gps.scaling_enabled:
        unsupported.append("in-tree scaling")
    # gps.bitwise_occupancy == 0: accepted.  The DualLut bytewise
    # occupancy coder is vestigial in this reference version — the
    # array is initialised (geometry_octree_decoder.cpp:282) but no
    # occupancy call site dispatches on _useBitwiseOccupancyCoder, so
    # the stream's occupancy coding is the normal bitwise path (with
    # planar disabled by the option sanitizer, TMC3.cpp:1727-1731).
    if gbh.inter_prediction:
        # octree inter with road/object GM is supported; the cuboid
        # LPU partition codes motion flags in the arithmetic stream
        # (decodeCuboidGlobalMotion) and stays out of scope, as do
        # bi-prediction, angular inter and non-octree inter bricks
        if gps.trisoup_enabled:
            unsupported.append("trisoup inter brick")
        if gbh.bi_prediction and (gps.global_motion
                                  or gps.angular_enabled):
            # B-frame bricks are supported for the plain octree tool
            # set; GM per reference (gm_matrix2/gm_thresh2) and the
            # angular bi-pred paths remain out of scope
            unsupported.append("bi-prediction with GM/angular")
        if gbh.geom_stream_cnt_minus1:
            unsupported.append("inter with multiple entropy streams")
    if gbh.entropy_continuation:
        unsupported.append("entropy continuation")
    if unsupported:
        raise UnsupportedTool(", ".join(unsupported))


def compensate_z(sps: ref_hls.RefSps, gps: ref_hls.RefGps,
                 positions_stv: np.ndarray, num: int,
                 den: int) -> np.ndarray:
    """Lidar ground-height z revision applied at output when
    geom_z_compensation_enabled_flag is set (compensateZCoordinate,
    geometry_octree.cpp:781-850) via the native port.  Returns the
    scaled (x num/den) compensated STV cloud."""
    lib = _load()
    c = ctypes
    if not hasattr(lib.tmc13ref_compensate_z, "_configured"):
        lib.tmc13ref_compensate_z.argtypes = [
            c.POINTER(c.c_int32), c.c_int, c.c_int, c.c_int,
            c.POINTER(c.c_int32),
            c.POINTER(c.c_int32), c.POINTER(c.c_int32), c.c_int]
        lib.tmc13ref_compensate_z.restype = None
        lib.tmc13ref_compensate_z._configured = True
    pos = np.ascontiguousarray(positions_stv, dtype=np.int32).copy()
    org = np.asarray(ref_hls.from_xyz(
        sps.geometry_axis_order, list(gps.angular_origin)),
        dtype=np.int32)
    th = np.ascontiguousarray(gps.angular_theta, dtype=np.int32)
    zl = np.ascontiguousarray(gps.angular_z, dtype=np.int32)
    lib.tmc13ref_compensate_z(
        pos.ctypes.data_as(c.POINTER(c.c_int32)), int(pos.shape[0]),
        num, den,
        org.ctypes.data_as(c.POINTER(c.c_int32)),
        th.ctypes.data_as(c.POINTER(c.c_int32)),
        zl.ctypes.data_as(c.POINTER(c.c_int32)), int(th.shape[0]))
    return pos


def _gm_min_pos(sps: ref_hls.RefSps,
                gbh: ref_hls.RefGbh) -> np.ndarray:
    if gbh.min_zero_origin:
        return np.zeros(3, dtype=np.int64)
    return np.asarray(ref_hls.from_xyz(
        sps.geometry_axis_order, list(sps.bbox_origin)),
        dtype=np.int64)


def apply_global_motion_q16(points: np.ndarray, gm_matrix, gm_trans,
                            min_pos: np.ndarray,
                            sel=None) -> np.ndarray:
    """Q16 affine with the reference's exact rounding
    (applyGlobalMotion_with_shift, motionWip.cpp:867-895:
    divExp2RoundHalfInfPositiveShift at prec 16)."""
    pts = points.astype(np.int64, copy=True)
    b = pts + min_pos[None, :]
    if sel is None:
        sel = np.ones(len(pts), dtype=bool)
    mat = np.asarray(gm_matrix, dtype=np.int64).reshape(3, 3)
    acc = b[sel] @ mat.T
    pts[sel] = ((acc + (1 << 15)) >> 16) \
        + np.asarray(gm_trans, dtype=np.int64)[None, :] \
        - min_pos[None, :]
    return pts


def compensate_predictor(sps: ref_hls.RefSps, gps: ref_hls.RefGps,
                         gbh: ref_hls.RefGbh,
                         ref_cloud: np.ndarray) -> np.ndarray:
    """Build the slice-local motion-compensated predictor cloud from
    the previous frame's reconstruction (slice-global STV, decode
    order), mirroring updatePredictorWorld + compensateGlobalMotion
    with the road/object classification
    (geometry_octree_decoder.cpp:1673-1691, motionWip.cpp:899-929).
    Cuboid-partition GM (lpu_type 1) is handled natively because its
    selection flags ride the arithmetic stream."""
    pred = ref_cloud.astype(np.int64, copy=True)
    if gps.global_motion:
        min_pos = _gm_min_pos(sps, gbh)
        b = pred + min_pos[None, :]
        thresh_hi, thresh_lo = gbh.gm_thresh
        sel = (b[:, 2] < thresh_lo) | (b[:, 2] > thresh_hi)
        if np.any(sel):
            pred = apply_global_motion_q16(
                pred, gbh.gm_matrix, gbh.gm_trans, min_pos, sel)
    pred -= np.asarray(gbh.box_origin_stv, dtype=np.int64)[None, :]
    return pred


def decode_trisoup_payload(aec: bytes, axes: np.ndarray,
                           gp: np.ndarray, ts_log2: int, *,
                           cap: int, sampling: int,
                           halo: bool, adaptive_halo: bool,
                           fine_ray: bool, face_vertex: bool,
                           centroid_residual: bool,
                           vertex_quant_bits: int,
                           flag_n: int, flag_f: int,
                           bb_min: np.ndarray, bb_max: np.ndarray,
                           expected_nseg: int = -1,
                           expected_points: int = -1) -> np.ndarray:
    """Decode one reference-syntax trisoup AEC payload: octree phase
    down to the trisoup node size, vertex/centroid/face entropy
    stages, then the normative ray-traced surface voxelisation
    (decodeGeometryTrisoup, tmc3/
    geometry_trisoup_decoder.cpp:125-203).  Returns slice-local STV
    positions in the reference's reconstruction order.  Shared by the
    tmc3-interop brick decoder and the native-syntax obuf-engine
    trisoup bricks (which embed the same payload)."""
    lib = _load()
    c = ctypes

    def p32(a):
        return a.ctypes.data_as(c.POINTER(c.c_int32))

    def pu8(a):
        return a.ctypes.data_as(c.POINTER(c.c_uint8))

    aec_arr = np.frombuffer(aec, dtype=np.uint8)
    axes = np.ascontiguousarray(axes, dtype=np.int32)
    leaves = np.empty((cap, 3), dtype=np.int32)
    hnd = c.c_void_p()
    n = lib.tmc13ref_decode_octree_trisoup(
        pu8(aec_arr), len(aec), p32(axes), len(axes), cap,
        ts_log2, p32(gp), p32(leaves), cap, c.byref(hnd))
    if n < 0:
        raise RuntimeError(f"trisoup octree phase failed rc={n}")
    leaves = np.ascontiguousarray(leaves[:n])

    from ..ops.trisoup_ref import trisoup_neighbours
    w = 1 << ts_log2
    feats = trisoup_neighbours(leaves, w)
    neighb = np.ascontiguousarray(feats["neighb"])
    pattern = np.ascontiguousarray(feats["pattern"])
    nseg = int(neighb.shape[0])
    if expected_nseg >= 0 and nseg != expected_nseg:
        raise RuntimeError(
            f"segment count {nseg} != header {expected_nseg}")

    maxvq = vertex_quant_bits or ts_log2
    bit_dropped = max(0, ts_log2 - maxvq)
    nbits = ts_log2 - bit_dropped
    segind = np.zeros(nseg, dtype=np.uint8)
    vert = np.zeros(nseg, dtype=np.uint8)
    seg2v = np.zeros(nseg, dtype=np.int32)
    bb_min = np.ascontiguousarray(bb_min, dtype=np.int32)
    bb_max = np.ascontiguousarray(bb_max, dtype=np.int32)
    ts = lib.tsref_open(hnd)
    try:
        lib.tsref_dec_verts(
            ts, neighb.ctypes.data_as(c.POINTER(c.c_uint16)), p32(pattern),
            nseg, nbits, pu8(segind), pu8(vert), p32(seg2v))

        gh = lib.tsgeom_open(
            p32(leaves), n, w, bit_dropped, flag_n, flag_f, p32(bb_min),
            p32(bb_max), sampling, int(halo),
            int(adaptive_halo), int(fine_ray),
            int(face_vertex), int(centroid_residual))
        try:
            uniq_vert = np.full(nseg, -1, dtype=np.int32)
            uniq_vert[segind > 0] = vert[segind > 0]
            nelig = lib.tsgeom_set_verts(gh, p32(uniq_vert))
            cctx = np.zeros((max(nelig, 1), 5), dtype=np.int32)
            lib.tsgeom_get_cctx(gh, p32(cctx))
            driftq = np.zeros(max(nelig, 1), dtype=np.int32)
            if nelig:
                lib.tsref_dec_centroids(ts, p32(cctx), nelig, p32(driftq))
            ncand = lib.tsgeom_apply_drifts(gh, p32(driftq))
            conn = np.zeros(max(ncand, 1), dtype=np.uint8)
            if ncand:
                lib.tsref_dec_faces(ts, ncand, pu8(conn))
            lib.tsgeom_apply_faces(gh, pu8(conn))
            npts = lib.tsgeom_reconstruct(gh)
            out = np.empty((npts, 3), dtype=np.int32)
            lib.tsgeom_get_points(gh, p32(out))
        finally:
            lib.tsgeom_close(gh)
    finally:
        lib.tsref_close(ts)
    if expected_points >= 0 and npts != expected_points:
        raise RuntimeError(
            f"reconstructed {npts} points, footer says {expected_points}")
    return out.astype(np.int64)


def decode_trisoup_brick(sps: ref_hls.RefSps, gps: ref_hls.RefGps,
                         gbh: ref_hls.RefGbh,
                         payload: bytes) -> np.ndarray:
    """Decode one tmc3 trisoup geometry brick (HLS fields unpacked
    from the GBH, payload decoded by decode_trisoup_payload)."""
    aec = payload[gbh.header_bytes:len(payload) - gbh.footer_bytes]
    axes = np.asarray(gbh.tree_lvl_coded_axis_list, dtype=np.int32)
    gp = geom_params_array(gps, sps.bypass_bin_coding_without_prob_update,
                           cabac_bypass=sps.cabac_bypass_stream_enabled)
    flag_n = int(gps.non_cubic_node_start_edge
                 and gbh.slice_bb_pos_bits > 0)
    flag_f = int(gps.non_cubic_node_end_edge
                 and gbh.slice_bb_width_bits > 0)
    bb_min = np.asarray(
        [p << gbh.slice_bb_pos_log2_scale for p in gbh.slice_bb_pos],
        dtype=np.int32)
    bb_max = bb_min + np.asarray(
        [p << gbh.slice_bb_width_log2_scale for p in gbh.slice_bb_width],
        dtype=np.int32)
    # the reference sizes the node fifo at a fixed 1.1M for trisoup
    # (geometry_octree_decoder.cpp:1587-1588)
    return decode_trisoup_payload(
        aec, axes, gp, gbh.trisoup_node_size_log2,
        cap=max(gbh.num_points, 1100000),
        sampling=gbh.trisoup_sampling,
        halo=gbh.trisoup_halo,
        adaptive_halo=gbh.trisoup_adaptive_halo,
        fine_ray=gbh.trisoup_fine_ray,
        face_vertex=gbh.trisoup_face_vertex,
        centroid_residual=gbh.trisoup_centroid_residual,
        vertex_quant_bits=gbh.trisoup_vertex_quant_bits,
        flag_n=flag_n, flag_f=flag_f, bb_min=bb_min, bb_max=bb_max,
        expected_nseg=gbh.num_unique_segments,
        expected_points=gbh.num_points)


def predgeom_params_array(sps: ref_hls.RefSps, gps: ref_hls.RefGps,
                          gbh: ref_hls.RefGbh,
                          origin_stv) -> np.ndarray:
    """Pack the predictive-geometry GPS/GBH fields into the native
    PGParams layout (native/refpredgeom.cc PGParams::from)."""
    return np.array([
        1 if gps.unique_points else 0,
        1 if gps.angular_enabled else 0,
        1 if gps.azimuth_scaling_enabled else 0,
        1 if gps.residual2_disabled else 0,
        max(len(gps.angular_theta), 1),
        int(origin_stv[0]), int(origin_stv[1]), int(origin_stv[2]),
        gps.azimuth_scale_log2_minus11 + 12,
        gps.azimuth_speed_minus1 + 1,
        gps.radius_inv_scale_log2,
        gps.predgeom_max_pred_index,
        gps.predgeom_radius_threshold,
        # tmc3 zeroes the threshold when the present flag is off
        # (geometry_predictive_encoder.cpp:257-259)
        gps.resr_qphi_threshold if gps.resr_qphi_threshold_present else 0,
        gbh.pgeom_resid_abs_log2_bits[0],
        gbh.pgeom_resid_abs_log2_bits[1],
        gbh.pgeom_resid_abs_log2_bits[2],
        gbh.pgeom_min_radius,
        1 if sps.bypass_bin_coding_without_prob_update else 0,
        0, 0, 0, 0, 0,                 # encode-only fields
        1 if sps.cabac_bypass_stream_enabled else 0,
    ], dtype=np.int32)


def decode_predgeom_brick(sps: ref_hls.RefSps, gps: ref_hls.RefGps,
                          gbh: ref_hls.RefGbh,
                          payload: bytes,
                          pg_ref=None,
                          sph_out: Optional[list] = None) -> np.ndarray:
    """Decode one tmc3 predictive-geometry brick
    (decodePredictiveGeometry, tmc3/
    geometry_predictive_decoder.cpp:735-756) via the native
    conformance port (native/refpredgeom.cc).  ``pg_ref`` is the
    native RefSph handle for inter prediction (refFrameSph); the
    reconstructed spherical positions are appended to ``sph_out`` and
    inserted into the reference chain (decoder.cpp:750-752)."""
    lib = _load()
    c = ctypes
    if not hasattr(lib.tmc13ref_decode_predgeom, "_configured"):
        lib.tmc13ref_decode_predgeom.argtypes = [
            c.POINTER(c.c_uint8), c.c_int, c.POINTER(c.c_int32),
            c.POINTER(c.c_int32), c.POINTER(c.c_int32), c.c_int,
            c.POINTER(c.c_int32)]
        lib.tmc13ref_decode_predgeom.restype = c.c_int
        lib.tmc13ref_decode_predgeom._configured = True
        lib.tmc13ref_decode_predgeom_inter.argtypes = [
            c.POINTER(c.c_uint8), c.c_int, c.POINTER(c.c_int32),
            c.POINTER(c.c_int32), c.POINTER(c.c_int32), c.c_int,
            c.POINTER(c.c_int32), c.POINTER(c.c_int32), c.c_void_p]
        lib.tmc13ref_decode_predgeom_inter.restype = c.c_int
        lib.tmc13ref_pgref_set_inter.argtypes = [c.c_void_p, c.c_int]
        lib.tmc13ref_pgref_set_inter.restype = None
        lib.tmc13ref_pgref_insert.argtypes = [
            c.c_void_p, c.POINTER(c.c_int32), c.c_int]
        lib.tmc13ref_pgref_insert.restype = None
    # slice-local lidar head (gbh.geomAngularOrigin, hls.h:658)
    if gps.slice_angular_origin_present:
        origin = np.asarray(gbh.angular_origin_stv, dtype=np.int64)
    else:
        origin = (np.asarray(ref_hls.from_xyz(
            sps.geometry_axis_order, list(gps.angular_origin)),
            dtype=np.int64)
            - np.asarray(gbh.box_origin_stv, dtype=np.int64))
    params = predgeom_params_array(sps, gps, gbh, origin)
    th = np.ascontiguousarray(gps.angular_theta or [0], dtype=np.int32)
    zl = np.ascontiguousarray(gps.angular_z or [0], dtype=np.int32)
    aec = payload[gbh.header_bytes:len(payload) - gbh.footer_bytes]
    aec_arr = np.frombuffer(aec, dtype=np.uint8)
    out = np.empty((gbh.num_points, 3), dtype=np.int32)

    def p32(a):
        return a.ctypes.data_as(c.POINTER(c.c_int32))

    if pg_ref is not None:
        # gbh.interPredictionEnabledFlag gates the brick; an intra
        # brick also clears the previous-frame maps (decoder.cpp:722)
        lib.tmc13ref_pgref_set_inter(
            pg_ref, 1 if gbh.inter_prediction else 0)
        out_sph = np.empty((gbh.num_points, 3), dtype=np.int32)
        n = lib.tmc13ref_decode_predgeom_inter(
            aec_arr.ctypes.data_as(c.POINTER(c.c_uint8)), len(aec),
            p32(params), p32(th), p32(zl), gbh.num_points, p32(out),
            p32(out_sph), pg_ref)
        if n >= 0:
            lib.tmc13ref_pgref_insert(pg_ref, p32(out_sph), n)
            if sph_out is not None:
                sph_out.append(out_sph[:max(n, 0)].astype(np.int64))
    else:
        n = lib.tmc13ref_decode_predgeom(
            aec_arr.ctypes.data_as(c.POINTER(c.c_uint8)), len(aec),
            p32(params), p32(th), p32(zl), gbh.num_points, p32(out))
    if n < 0:
        raise RuntimeError(f"refpredgeom decode failed rc={n}")
    if n != gbh.num_points:
        raise RuntimeError(
            f"decoded {n} points, footer says {gbh.num_points}")
    return out.astype(np.int64)


def _slice_angular_origin(sps: ref_hls.RefSps, gps: ref_hls.RefGps,
                          gbh: ref_hls.RefGbh) -> np.ndarray:
    """gbh.geomAngularOrigin (hls.h:658): slice-local lidar head."""
    if gps.slice_angular_origin_present:
        return np.asarray(gbh.angular_origin_stv, dtype=np.int64)
    return (np.asarray(ref_hls.from_xyz(
        sps.geometry_axis_order, list(gps.angular_origin)),
        dtype=np.int64)
        - np.asarray(gbh.box_origin_stv, dtype=np.int64))


def _ang_flags(gps: ref_hls.RefGps) -> int:
    return (int(gps.octree_angular_extension)
            | (int(gps.planar_disabled_idcm_angular) << 1)
            | (int(gps.inter_idcm) << 2)
            | (int(gps.one_point_alone_laser_beam) << 3))


def _decode_brick_inter_ang(sps, gps, gbh, aec_arr, aec, axes, gp,
                            out, ref_cloud) -> np.ndarray:
    """Angular octree inter brick: compensated predictor + laser
    tables through the native combined entry."""
    lib = _load()
    c = ctypes

    def p32(a):
        return a.ctypes.data_as(c.POINTER(c.c_int32))

    org = np.ascontiguousarray(
        _slice_angular_origin(sps, gps, gbh), dtype=np.int32)
    th = np.ascontiguousarray(gps.angular_theta, dtype=np.int32)
    zl = np.ascontiguousarray(gps.angular_z, dtype=np.int32)
    np_ = np.ascontiguousarray(gps.angular_num_phi, dtype=np.int32)
    if not hasattr(lib.tmc13ref_decode_octree_inter_ang,
                   "_configured"):
        lib.tmc13ref_decode_octree_inter_ang.argtypes = [
            c.POINTER(c.c_uint8), c.c_int,
            c.POINTER(c.c_int32), c.c_int, c.c_int,
            c.POINTER(c.c_int32), c.POINTER(c.c_int32), c.c_int,
            c.POINTER(c.c_int32), c.POINTER(c.c_int32),
            c.POINTER(c.c_int32),
            c.POINTER(c.c_int32), c.c_int,
            c.POINTER(c.c_int32), c.POINTER(c.c_int32),
            c.POINTER(c.c_int32), c.c_int,
            c.POINTER(c.c_int32), c.c_int]
        lib.tmc13ref_decode_octree_inter_ang.restype = c.c_int
        lib.tmc13ref_decode_octree_inter_ang._configured = True
    if gps.global_motion and gbh.lpu_type == 1:
        vehicle = np.ascontiguousarray(ref_cloud, dtype=np.int32)
        world = np.ascontiguousarray(
            apply_global_motion_q16(
                ref_cloud, gbh.gm_matrix, gbh.gm_trans,
                _gm_min_pos(sps, gbh)), dtype=np.int32)
        mbs = np.asarray(gbh.motion_block_size, dtype=np.int32)
        borg = np.asarray(gbh.box_origin_stv, dtype=np.int32)
        n = lib.tmc13ref_decode_octree_inter_ang(
            aec_arr.ctypes.data_as(c.POINTER(c.c_uint8)), len(aec),
            p32(axes), len(axes), gbh.num_points,
            p32(vehicle), p32(world), int(vehicle.shape[0]),
            p32(mbs), p32(borg), p32(gp),
            p32(org), th.shape[0], p32(th), p32(zl), p32(np_),
            _ang_flags(gps),
            out.ctypes.data_as(c.POINTER(c.c_int32)), gbh.num_points)
    else:
        pred = np.ascontiguousarray(
            compensate_predictor(sps, gps, gbh, ref_cloud),
            dtype=np.int32)
        n = lib.tmc13ref_decode_octree_inter_ang(
            aec_arr.ctypes.data_as(c.POINTER(c.c_uint8)), len(aec),
            p32(axes), len(axes), gbh.num_points,
            p32(pred), None, int(pred.shape[0]),
            None, None, p32(gp),
            p32(org), th.shape[0], p32(th), p32(zl), p32(np_),
            _ang_flags(gps),
            out.ctypes.data_as(c.POINTER(c.c_int32)), gbh.num_points)
    if n < 0:
        raise RuntimeError(f"refcodec inter-ang decode failed rc={n}")
    if n != gbh.num_points:
        raise RuntimeError(
            f"decoded {n} points, footer says {gbh.num_points}")
    return out.astype(np.int64)


def decode_geometry_brick(sps: ref_hls.RefSps, gps: ref_hls.RefGps,
                          gbh: ref_hls.RefGbh,
                          payload: bytes,
                          ref_cloud: Optional[np.ndarray] = None,
                          pg_ref=None,
                          sph_out: Optional[list] = None,
                          ref2_cloud: Optional[np.ndarray] = None
                          ) -> np.ndarray:
    """Decode one octree geometry brick to slice-local STV grid
    positions in the reference's decode order.  ``ref_cloud`` is the
    previous frame's reconstruction (slice-global STV, decode order)
    for inter bricks; ``pg_ref`` the predgeom refFrameSph handle;
    ``ref2_cloud`` the second reference for B-frame bricks
    (gbh.biPredictionEnabledFlag, decoder.cpp:730-733)."""
    _check_supported(sps, gps, gbh)
    if gps.predgeom_enabled:
        return decode_predgeom_brick(sps, gps, gbh, payload, pg_ref,
                                     sph_out)
    if gps.trisoup_enabled:
        return decode_trisoup_brick(sps, gps, gbh, payload)
    lib = _load()
    aec = payload[gbh.header_bytes:len(payload) - gbh.footer_bytes]
    aec_arr = np.frombuffer(aec, dtype=np.uint8)
    axes = np.asarray(gbh.tree_lvl_coded_axis_list, dtype=np.int32)
    gp = geom_params_array(
        gps, sps.bypass_bin_coding_without_prob_update,
        cabac_bypass=sps.cabac_bypass_stream_enabled)
    out = np.empty((gbh.num_points, 3), dtype=np.int32)
    c = ctypes
    if gbh.inter_prediction:
        if ref_cloud is None:
            raise RuntimeError(
                "inter brick without a reference frame")
        if gps.angular_enabled:
            return _decode_brick_inter_ang(sps, gps, gbh, aec_arr,
                                           aec, axes, gp, out,
                                           ref_cloud)
        if gbh.bi_prediction:
            if ref2_cloud is None:
                raise RuntimeError(
                    "B-frame brick without a second reference")
            org = np.asarray(gbh.box_origin_stv, dtype=np.int64)
            pred = np.ascontiguousarray(
                ref_cloud.astype(np.int64) - org[None, :],
                dtype=np.int32)
            pred2 = np.ascontiguousarray(
                ref2_cloud.astype(np.int64) - org[None, :],
                dtype=np.int32)
            if not hasattr(lib.tmc13ref_decode_octree_bipred,
                           "_configured"):
                lib.tmc13ref_decode_octree_bipred.argtypes = [
                    c.POINTER(c.c_uint8), c.c_int,
                    c.POINTER(c.c_int32), c.c_int, c.c_int,
                    c.POINTER(c.c_int32), c.c_int,
                    c.POINTER(c.c_int32), c.c_int,
                    c.POINTER(c.c_int32),
                    c.POINTER(c.c_int32), c.c_int]
                lib.tmc13ref_decode_octree_bipred.restype = c.c_int
                lib.tmc13ref_decode_octree_bipred._configured = True
            n = lib.tmc13ref_decode_octree_bipred(
                aec_arr.ctypes.data_as(c.POINTER(c.c_uint8)),
                len(aec),
                axes.ctypes.data_as(c.POINTER(c.c_int32)), len(axes),
                gbh.num_points,
                pred.ctypes.data_as(c.POINTER(c.c_int32)),
                int(pred.shape[0]),
                pred2.ctypes.data_as(c.POINTER(c.c_int32)),
                int(pred2.shape[0]),
                gp.ctypes.data_as(c.POINTER(c.c_int32)),
                out.ctypes.data_as(c.POINTER(c.c_int32)),
                gbh.num_points)
            if n < 0:
                raise RuntimeError(
                    f"refcodec bipred decode failed rc={n}")
            if n != gbh.num_points:
                raise RuntimeError(
                    f"decoded {n} points, footer says {gbh.num_points}")
            return out.astype(np.int64)
        if gps.global_motion and gbh.lpu_type == 1:
            # cuboid partition: flags ride the AEC, decoded natively
            vehicle = np.ascontiguousarray(ref_cloud, dtype=np.int32)
            world = np.ascontiguousarray(
                apply_global_motion_q16(
                    ref_cloud, gbh.gm_matrix, gbh.gm_trans,
                    _gm_min_pos(sps, gbh)), dtype=np.int32)
            mbs = np.asarray(gbh.motion_block_size, dtype=np.int32)
            org = np.asarray(gbh.box_origin_stv, dtype=np.int32)
            if not hasattr(lib.tmc13ref_decode_octree_inter_gm,
                           "_configured"):
                lib.tmc13ref_decode_octree_inter_gm.argtypes = [
                    c.POINTER(c.c_uint8), c.c_int,
                    c.POINTER(c.c_int32), c.c_int, c.c_int,
                    c.POINTER(c.c_int32), c.POINTER(c.c_int32),
                    c.c_int,
                    c.POINTER(c.c_int32), c.POINTER(c.c_int32),
                    c.POINTER(c.c_int32),
                    c.POINTER(c.c_int32), c.c_int]
                lib.tmc13ref_decode_octree_inter_gm.restype = c.c_int
                lib.tmc13ref_decode_octree_inter_gm._configured = True
            n = lib.tmc13ref_decode_octree_inter_gm(
                aec_arr.ctypes.data_as(c.POINTER(c.c_uint8)),
                len(aec),
                axes.ctypes.data_as(c.POINTER(c.c_int32)), len(axes),
                gbh.num_points,
                vehicle.ctypes.data_as(c.POINTER(c.c_int32)),
                world.ctypes.data_as(c.POINTER(c.c_int32)),
                int(vehicle.shape[0]),
                mbs.ctypes.data_as(c.POINTER(c.c_int32)),
                org.ctypes.data_as(c.POINTER(c.c_int32)),
                gp.ctypes.data_as(c.POINTER(c.c_int32)),
                out.ctypes.data_as(c.POINTER(c.c_int32)),
                gbh.num_points)
            if n < 0:
                raise RuntimeError(
                    f"refcodec inter-gm decode failed rc={n}")
            if n != gbh.num_points:
                raise RuntimeError(
                    f"decoded {n} points, footer says {gbh.num_points}")
            return out.astype(np.int64)
        pred = np.ascontiguousarray(
            compensate_predictor(sps, gps, gbh, ref_cloud),
            dtype=np.int32)
        if not hasattr(lib.tmc13ref_decode_octree_inter,
                       "_configured"):
            lib.tmc13ref_decode_octree_inter.argtypes = [
                c.POINTER(c.c_uint8), c.c_int,
                c.POINTER(c.c_int32), c.c_int, c.c_int,
                c.POINTER(c.c_int32), c.c_int,
                c.POINTER(c.c_int32),
                c.POINTER(c.c_int32), c.c_int]
            lib.tmc13ref_decode_octree_inter.restype = c.c_int
            lib.tmc13ref_decode_octree_inter._configured = True
        n = lib.tmc13ref_decode_octree_inter(
            aec_arr.ctypes.data_as(c.POINTER(c.c_uint8)), len(aec),
            axes.ctypes.data_as(c.POINTER(c.c_int32)), len(axes),
            gbh.num_points,
            pred.ctypes.data_as(c.POINTER(c.c_int32)),
            int(pred.shape[0]),
            gp.ctypes.data_as(c.POINTER(c.c_int32)),
            out.ctypes.data_as(c.POINTER(c.c_int32)), gbh.num_points)
        if n < 0:
            raise RuntimeError(f"refcodec inter decode failed rc={n}")
        if n != gbh.num_points:
            raise RuntimeError(
                f"decoded {n} points, footer says {gbh.num_points}")
        return out.astype(np.int64)
    if gps.angular_enabled:
        # slice-local lidar head (gbh.geomAngularOrigin, hls.h:658)
        if gps.slice_angular_origin_present:
            origin = np.asarray(gbh.angular_origin_stv, dtype=np.int64)
        else:
            origin = (np.asarray(ref_hls.from_xyz(
                sps.geometry_axis_order, list(gps.angular_origin)),
                dtype=np.int64)
                - np.asarray(gbh.box_origin_stv, dtype=np.int64))
        if not hasattr(lib.tmc13ref_decode_octree_intra_ang,
                       "_configured"):
            lib.tmc13ref_decode_octree_intra_ang.argtypes = [
                c.POINTER(c.c_uint8), c.c_int,
                c.POINTER(c.c_int32), c.c_int, c.c_int,
                c.POINTER(c.c_int32),
                c.POINTER(c.c_int32), c.c_int,
                c.POINTER(c.c_int32), c.POINTER(c.c_int32),
                c.POINTER(c.c_int32), c.c_int,
                c.POINTER(c.c_int32), c.c_int]
            lib.tmc13ref_decode_octree_intra_ang.restype = c.c_int
            lib.tmc13ref_decode_octree_intra_ang._configured = True
        org = np.ascontiguousarray(origin, dtype=np.int32)
        th = np.ascontiguousarray(gps.angular_theta, dtype=np.int32)
        zl = np.ascontiguousarray(gps.angular_z, dtype=np.int32)
        np_ = np.ascontiguousarray(gps.angular_num_phi, dtype=np.int32)
        ang_flags = _ang_flags(gps)
        n = lib.tmc13ref_decode_octree_intra_ang(
            aec_arr.ctypes.data_as(c.POINTER(c.c_uint8)), len(aec),
            axes.ctypes.data_as(c.POINTER(c.c_int32)), len(axes),
            gbh.num_points,
            gp.ctypes.data_as(c.POINTER(c.c_int32)),
            org.ctypes.data_as(c.POINTER(c.c_int32)), th.shape[0],
            th.ctypes.data_as(c.POINTER(c.c_int32)),
            zl.ctypes.data_as(c.POINTER(c.c_int32)),
            np_.ctypes.data_as(c.POINTER(c.c_int32)), ang_flags,
            out.ctypes.data_as(c.POINTER(c.c_int32)), gbh.num_points)
    elif gbh.geom_stream_cnt_minus1:
        if not hasattr(lib.tmc13ref_decode_octree_intra_ms,
                       "_configured"):
            lib.tmc13ref_decode_octree_intra_ms.argtypes = [
                c.POINTER(c.c_uint8), c.c_int,
                c.POINTER(c.c_int32), c.c_int, c.c_int,
                c.POINTER(c.c_int32),
                c.POINTER(c.c_int32), c.c_int, c.c_int]
            lib.tmc13ref_decode_octree_intra_ms.restype = c.c_int
            lib.tmc13ref_decode_octree_intra_ms._configured = True
        n = lib.tmc13ref_decode_octree_intra_ms(
            aec_arr.ctypes.data_as(c.POINTER(c.c_uint8)), len(aec),
            axes.ctypes.data_as(c.POINTER(c.c_int32)), len(axes),
            gbh.num_points,
            gp.ctypes.data_as(c.POINTER(c.c_int32)),
            out.ctypes.data_as(c.POINTER(c.c_int32)), gbh.num_points,
            gbh.geom_stream_cnt_minus1)
    else:
        n = lib.tmc13ref_decode_octree_intra(
            aec_arr.ctypes.data_as(c.POINTER(c.c_uint8)), len(aec),
            axes.ctypes.data_as(c.POINTER(c.c_int32)), len(axes),
            gbh.num_points,
            gp.ctypes.data_as(c.POINTER(c.c_int32)),
            out.ctypes.data_as(c.POINTER(c.c_int32)), gbh.num_points)
    if n < 0:
        raise RuntimeError(f"refcodec decode failed rc={n}")
    if n != gbh.num_points:
        raise RuntimeError(
            f"decoded {n} points, footer says {gbh.num_points}")
    return out.astype(np.int64)


def _predlift_params(sps: ref_hls.RefSps, aps: ref_hls.RefAps,
                     abh: ref_hls.RefAbh, n_layers: int) -> np.ndarray:
    """Pack the RefAps/RefAbh predlift fields into the native PlParams
    layout (refpredlift.cc plparams_from)."""
    dims = sps.attr_dims[abh.sps_attr_idx]
    bitdepth = sps.attr_bitdepths[abh.sps_attr_idx]
    qnw = aps.quant_neigh_weight or [0, 0, 0]
    qnw = (list(qnw) + [0, 0, 0])[:3]
    p = np.zeros(31, dtype=np.int32)
    p[0] = dims
    p[1] = bitdepth
    p[2] = 1 if aps.attr_encoding == ref_hls.ATTR_PRED else 2
    p[3] = aps.init_qp_minus4 + 4
    p[4] = aps.chroma_qp_offset
    p[5] = aps.num_pred_nearest_neighbours_minus1
    p[6] = aps.inter_lod_search_range
    p[7:10] = aps.lod_neigh_bias
    p[10] = 1 if aps.last_component_prediction else 0
    p[11] = aps.num_detail_levels_minus1
    p[12] = 1 if aps.canonical_point_order else 0
    p[13] = aps.lod_decimation_type
    p[14] = aps.dist2
    p[15] = abh.attr_dist2_delta
    p[16] = aps.max_num_direct_predictors
    p[17] = aps.adaptive_prediction_threshold
    p[18] = 1 if aps.direct_avg_predictor_disabled else 0
    p[19] = min(aps.intra_lod_prediction_skip_layers, 0x7fffffff)
    p[20] = aps.intra_lod_search_range
    p[21] = 1 if aps.inter_component_prediction else 0
    p[22] = 1 if aps.pred_weight_blending else 0
    p[23:26] = qnw
    p[26] = aps.max_points_per_sort_log2_plus1
    p[27] = 1 if aps.prediction_with_distribution else 0
    p[28] = 1 if sps.bypass_bin_coding_without_prob_update else 0
    p[29] = n_layers
    p[30] = 1 if sps.cabac_bypass_stream_enabled else 0
    return p


def _decode_predlift_brick(sps: ref_hls.RefSps, aps: ref_hls.RefAps,
                           abh: ref_hls.RefAbh, payload: bytes,
                           positions_stv: np.ndarray,
                           attr_ref=None) -> np.ndarray:
    """Decode one predicting/lifting attribute brick, mirroring
    AttributeDecoder::decode{Reflectances,Colors}{Pred,Lift}
    (tmc3/AttributeDecoder.cpp:328-861) through the
    native normative port (native/refpredlift.cc).  With attribute
    inter prediction active (abh.enableAttrInterPred), the previous
    frame's attribute-coordinate cloud joins the LoD candidate pool
    after bbox filtering (decoder.cpp:926-947)."""
    lib = _load()
    c = ctypes
    if not hasattr(lib.tmc13ref_decode_predlift, "_configured"):
        lib.tmc13ref_decode_predlift.argtypes = [
            c.POINTER(c.c_int32), c.c_int, c.POINTER(c.c_int32),
            c.POINTER(c.c_int32), c.POINTER(c.c_int32),
            c.POINTER(c.c_int32), c.POINTER(c.c_int32),
            c.POINTER(c.c_uint8), c.c_int, c.POINTER(c.c_int32)]
        lib.tmc13ref_decode_predlift.restype = c.c_int
        lib.tmc13ref_decode_predlift._configured = True
        lib.tmc13ref_decode_predlift_inter.argtypes = (
            lib.tmc13ref_decode_predlift.argtypes
            + [c.POINTER(c.c_int32), c.POINTER(c.c_int32), c.c_int,
               c.c_int])
        lib.tmc13ref_decode_predlift_inter.restype = c.c_int

    if getattr(abh, "qp_regions", None):
        raise UnsupportedTool(
            "region QP boxes with pred/lift bricks (RAHT only)")
    dims = sps.attr_dims[abh.sps_attr_idx]
    layers = ref_hls.derive_layer_qps(aps, abh)
    qp_arr = np.asarray(layers, dtype=np.int32).reshape(-1)
    params = _predlift_params(sps, aps, abh, len(layers))

    nper = max(aps.num_detail_levels_minus1, 1)
    periods = np.zeros(nper, dtype=np.int32)
    if aps.lod_sampling_periods:
        periods[:len(aps.lod_sampling_periods)] = aps.lod_sampling_periods

    lcp = np.zeros(aps.num_detail_levels_minus1 + 2, dtype=np.int32)
    if abh.lcp_coeffs:
        lcp[:len(abh.lcp_coeffs)] = abh.lcp_coeffs
    icp = np.zeros(3 * (aps.num_detail_levels_minus1 + 2), dtype=np.int32)
    if abh.icp_coeffs:
        flat = [v for t in abh.icp_coeffs for v in t]
        icp[:len(flat)] = flat

    pos32 = np.ascontiguousarray(positions_stv, dtype=np.int32)
    n = int(pos32.shape[0])
    aec = payload[abh.header_bytes:]
    aec_arr = np.frombuffer(aec, dtype=np.uint8)
    out = np.empty((n, dims), dtype=np.int32)

    def p32(a):
        return a.ctypes.data_as(c.POINTER(c.c_int32))

    inter_on = (aps.attr_inter_prediction and abh.enable_attr_inter_pred
                and attr_ref is not None)
    if inter_on:
        # referencePointCloud = previous frame's attribute-coordinate
        # cloud filtered to the current frame's bounding box,
        # order-preserving (decoder.cpp:928-947)
        ref_pos, ref_attr = attr_ref
        ref_pos = np.asarray(ref_pos, dtype=np.int64)
        ref_attr = np.asarray(ref_attr, dtype=np.int32).reshape(
            ref_pos.shape[0], -1)
        lo = pos32.min(axis=0).astype(np.int64)
        hi = pos32.max(axis=0).astype(np.int64)
        keep = np.all((ref_pos >= lo[None, :]) & (ref_pos <= hi[None, :]),
                      axis=1)
        rpos = np.ascontiguousarray(ref_pos[keep], dtype=np.int32)
        rattr = np.ascontiguousarray(ref_attr[keep].reshape(-1),
                                     dtype=np.int32)
        nref = int(rpos.shape[0])
        if nref:
            rc = lib.tmc13ref_decode_predlift_inter(
                p32(pos32), n, p32(params), p32(periods), p32(qp_arr),
                p32(lcp), p32(icp),
                aec_arr.ctypes.data_as(c.POINTER(c.c_uint8)), len(aec),
                p32(out), p32(rpos), p32(rattr), nref,
                int(aps.attr_inter_pred_search_range))
        else:
            rc = lib.tmc13ref_decode_predlift(
                p32(pos32), n, p32(params), p32(periods), p32(qp_arr),
                p32(lcp), p32(icp),
                aec_arr.ctypes.data_as(c.POINTER(c.c_uint8)), len(aec),
                p32(out))
    else:
        rc = lib.tmc13ref_decode_predlift(
            p32(pos32), n, p32(params), p32(periods), p32(qp_arr),
            p32(lcp), p32(icp),
            aec_arr.ctypes.data_as(c.POINTER(c.c_uint8)), len(aec),
            p32(out))
    if rc < 0:
        raise RuntimeError(f"refpredlift decode failed rc={rc}")
    return out


def attr_coding_positions(sps: ref_hls.RefSps, gps: ref_hls.RefGps,
                          gbh: ref_hls.RefGbh, aps: ref_hls.RefAps,
                          slice_local: np.ndarray) -> np.ndarray:
    """Positions the attribute coder operates on when
    aps.spherical_coord_flag is set: the slice-local decoded cloud
    converted to (radius, azimuth, laser), offset to the bbox minimum
    and scaled by the per-axis APS weights (decoder.cpp:900-918,
    coordinate_conversion.cpp convertXyzToRpl + offsetAndScale)."""
    lib = _load()
    c = ctypes
    if not hasattr(lib.tmc13ref_xyz_to_rpl, "_configured"):
        lib.tmc13ref_xyz_to_rpl.argtypes = [
            c.POINTER(c.c_int32), c.c_int,
            c.POINTER(c.c_int32),
            c.POINTER(c.c_int32), c.c_int,
            c.POINTER(c.c_int32), c.POINTER(c.c_int32)]
        lib.tmc13ref_xyz_to_rpl.restype = None
        lib.tmc13ref_xyz_to_rpl._configured = True
    pos32 = np.ascontiguousarray(slice_local, dtype=np.int32)
    org = np.ascontiguousarray(
        _slice_angular_origin(sps, gps, gbh), dtype=np.int32)
    th = np.ascontiguousarray(gps.angular_theta, dtype=np.int32)
    rpl = np.empty_like(pos32)
    mn = np.empty(3, dtype=np.int32)
    lib.tmc13ref_xyz_to_rpl(
        pos32.ctypes.data_as(c.POINTER(c.c_int32)),
        int(pos32.shape[0]),
        org.ctypes.data_as(c.POINTER(c.c_int32)),
        th.ctypes.data_as(c.POINTER(c.c_int32)), int(th.shape[0]),
        rpl.ctypes.data_as(c.POINTER(c.c_int32)),
        mn.ctypes.data_as(c.POINTER(c.c_int32)))
    if aps.attr_inter_prediction:
        # inter keeps a frame-stable origin (minPos = 0 unless the
        # reference frame shifted); intra-only scope here
        mn = np.zeros(3, dtype=np.int32)
    w = np.asarray(aps.attr_coord_scale, dtype=np.int64)
    scaled = ((rpl.astype(np.int64) - mn[None, :].astype(np.int64))
              * w[None, :] + (1 << 7)) >> 8
    return scaled


def _point_region_qps(abh, positions_stv: np.ndarray,
                      order: np.ndarray) -> Optional[np.ndarray]:
    """Per-sorted-point (luma, chroma) region QP offsets, or None.

    Mirrors QpSet::regionQpOffset (quantization.cpp:194-203) applied
    per packed voxel (AttributeDecoder.cpp:562-565): a point inside
    [origin, origin+size] (Box3::contains is max-INclusive,
    PCCMath.h:469-474) of the single permitted region gets the
    region's offset pair."""
    if not getattr(abh, "qp_regions", None):
        return None
    pos = np.asarray(positions_stv, dtype=np.int64)[order]
    out = np.zeros((pos.shape[0], 2), dtype=np.int32)
    for origin, size, offs in reversed(abh.qp_regions):
        o = np.asarray(origin, dtype=np.int64)
        s = np.asarray(size, dtype=np.int64)
        inside = np.all((pos >= o) & (pos <= o + s), axis=1)
        out[inside] = np.asarray(offs, dtype=np.int32)
    return np.ascontiguousarray(out.reshape(-1))


def decode_attr_brick(sps: ref_hls.RefSps, aps: ref_hls.RefAps,
                      abh: ref_hls.RefAbh, payload: bytes,
                      positions_stv: np.ndarray,
                      gps: Optional[ref_hls.RefGps] = None,
                      gbh: Optional[ref_hls.RefGbh] = None,
                      slice_local: Optional[np.ndarray] = None,
                      attr_ref=None,
                      positions_override: Optional[np.ndarray]
                      = None) -> np.ndarray:
    """Decode one intra RAHT attribute brick against the slice's
    decoded positions (slice-local STV + slice origin, decode order).
    Returns attributes aligned with `positions_stv` rows, mirroring
    AttributeDecoder::decodeColorsRaht / decodeReflectancesRaht
    (tmc3/AttributeDecoder.cpp:528-674: morton sort,
    entropy decode, uraht inverse, clip, scatter by packed index)."""
    if positions_override is not None:
        # predgeom reuses its reconstructed spherical positions
        # (decoder.cpp:881-899) — already offset and scaled
        positions_stv = positions_override
    elif aps.spherical_coord:
        if gps is None or gbh is None or slice_local is None:
            raise UnsupportedTool(
                "spherical attribute coords need the geometry slice")
        positions_stv = attr_coding_positions(sps, gps, gbh, aps,
                                              slice_local)
    if aps.attr_encoding in (ref_hls.ATTR_PRED, ref_hls.ATTR_LIFT):
        return _decode_predlift_brick(sps, aps, abh, payload,
                                      positions_stv, attr_ref)
    if aps.attr_encoding != ref_hls.ATTR_RAHT:
        raise UnsupportedTool("non-RAHT attribute brick")
    lib = _load()
    from ..utils import morton

    dims = sps.attr_dims[abh.sps_attr_idx]
    bitdepth = sps.attr_bitdepths[abh.sps_attr_idx]

    codes = morton.encode(np.ascontiguousarray(positions_stv,
                                               dtype=np.int64))
    order = np.argsort(codes, kind="stable")
    codes_sorted = np.ascontiguousarray(codes[order])

    layers = ref_hls.derive_layer_qps(aps, abh)
    qp_arr = np.asarray(layers, dtype=np.int32).reshape(-1)

    params = np.zeros(40, dtype=np.int32)
    params[0] = 1 if aps.raht_prediction_enabled else 0
    params[1] = 1 if aps.integer_haar else 0
    params[2] = aps.raht_prediction_threshold0
    params[3] = aps.raht_prediction_threshold1
    params[4] = 1 if aps.raht_subnode_prediction else 0
    params[5] = aps.raht_prediction_search_range
    params[6] = 1 if aps.raht_extension else 0
    params[7] = 1 if sps.bypass_bin_coding_without_prob_update else 0
    params[8:27] = aps.pred_weight_parent()
    params[27:39] = aps.pred_weight_child()
    params[39] = 1 if sps.cabac_bypass_stream_enabled else 0

    aec = payload[abh.header_bytes:]
    aec_arr = np.frombuffer(aec, dtype=np.uint8)
    n = len(codes_sorted)
    out = np.empty((n, dims), dtype=np.int32)
    c = ctypes
    if (aps.attr_inter_prediction and abh.enable_attr_inter_pred
            and attr_ref is not None):
        if getattr(abh, "qp_regions", None):
            raise UnsupportedTool(
                "region QP boxes with inter RAHT bricks")
        # inter-RAHT: previous frame's attribute cloud at coding
        # positions, morton-sorted (AttributeDecoder.cpp:570-593)
        ref_pos, ref_attr = attr_ref
        from ..utils import morton as _morton
        ref_codes = _morton.encode(
            np.ascontiguousarray(ref_pos, dtype=np.int64))
        rorder = np.argsort(ref_codes, kind="stable")
        ref_codes = np.ascontiguousarray(ref_codes[rorder])
        ref_vals = np.ascontiguousarray(
            np.asarray(ref_attr, dtype=np.int32)[rorder].reshape(-1))
        iparams = np.asarray(
            [aps.raht_inter_depth_minus1 + 1,
             1 if aps.raht_send_inter_filters else 0,
             aps.raht_inter_skip_layers,
             1 if aps.raht_enable_code_layer else 0,
             len(abh.raht_filter_taps),
             len(abh.raht_attr_layer_code_mode)], dtype=np.int32)
        taps = np.asarray(abh.raht_filter_taps or [0], dtype=np.int32)
        modes = np.asarray(abh.raht_attr_layer_code_mode or [0],
                           dtype=np.int32)
        if not hasattr(lib.tmc13ref_decode_raht_attr_inter,
                       "_configured"):
            lib.tmc13ref_decode_raht_attr_inter.argtypes = [
                c.POINTER(c.c_uint8), c.c_int,
                c.POINTER(c.c_int64), c.c_int, c.c_int,
                c.POINTER(c.c_int32), c.c_int, c.c_int,
                c.POINTER(c.c_int32),
                c.POINTER(c.c_int64), c.POINTER(c.c_int32), c.c_int,
                c.POINTER(c.c_int32), c.POINTER(c.c_int32),
                c.POINTER(c.c_int32), c.POINTER(c.c_int32)]
            lib.tmc13ref_decode_raht_attr_inter.restype = c.c_int
            lib.tmc13ref_decode_raht_attr_inter._configured = True
        rc = lib.tmc13ref_decode_raht_attr_inter(
            aec_arr.ctypes.data_as(c.POINTER(c.c_uint8)), len(aec),
            codes_sorted.ctypes.data_as(c.POINTER(c.c_int64)), n, dims,
            qp_arr.ctypes.data_as(c.POINTER(c.c_int32)), len(layers),
            bitdepth,
            params.ctypes.data_as(c.POINTER(c.c_int32)),
            ref_codes.ctypes.data_as(c.POINTER(c.c_int64)),
            ref_vals.ctypes.data_as(c.POINTER(c.c_int32)),
            int(ref_codes.shape[0]),
            iparams.ctypes.data_as(c.POINTER(c.c_int32)),
            taps.ctypes.data_as(c.POINTER(c.c_int32)),
            modes.ctypes.data_as(c.POINTER(c.c_int32)),
            out.ctypes.data_as(c.POINTER(c.c_int32)))
    else:
        pqp = _point_region_qps(abh, positions_stv, order)
        pqp_ptr = (pqp.ctypes.data_as(c.POINTER(c.c_int32))
                   if pqp is not None else None)
        rc = lib.tmc13ref_decode_raht_attr(
            aec_arr.ctypes.data_as(c.POINTER(c.c_uint8)), len(aec),
            codes_sorted.ctypes.data_as(c.POINTER(c.c_int64)), n, dims,
            qp_arr.ctypes.data_as(c.POINTER(c.c_int32)), len(layers),
            bitdepth,
            params.ctypes.data_as(c.POINTER(c.c_int32)),
            out.ctypes.data_as(c.POINTER(c.c_int32)), pqp_ptr)
    if rc != 0:
        raise RuntimeError(f"refattr decode failed rc={rc}")

    # scatter back to decode order (packedVoxel[n].index)
    result = np.empty_like(out)
    result[order] = out
    return result


def decode_stream(data: bytes, want_attrs: bool = False):
    """Decode a full tmc3 TLV stream to per-frame XYZ integer
    positions at the sequence scale, mirroring the reference's output
    conversion for seq scale 1 (decoder.cpp outputCurrentCloud: slice
    origin add + toXyz).  With ``want_attrs`` also decodes intra RAHT
    attribute bricks and returns (frames, attr_frames) where
    attr_frames[i] is the per-point attribute array (coded colour
    space) or None."""
    sps: Optional[ref_hls.RefSps] = None
    gps_map = {}
    aps_map = {}
    frames: List[np.ndarray] = []
    attr_frames: List[Optional[np.ndarray]] = []
    cur_slices: List[np.ndarray] = []
    cur_slices_stv: List[np.ndarray] = []
    cur_attrs: List[np.ndarray] = []
    cur_ctr: Optional[int] = None
    # slice-global STV positions of the last geometry brick, for
    # attribute decode (decoder.cpp:921-922 adds _sliceOrigin)
    last_slice_pos: Optional[np.ndarray] = None
    last_slice_local: Optional[np.ndarray] = None
    last_gbh = None
    last_gps = None
    # attribute inter prediction reference (previous frame's coding
    # positions + decoded attributes)
    attr_ref = None
    next_attr_ref = None
    # previous frame's reconstruction for inter prediction
    # (storeCurrentCloudAsRef, decoder.cpp:165-172: the accumulated
    # slice-global STV cloud)
    ref_cloud: Optional[np.ndarray] = None
    # bi-prediction (gps.biPredictionEnabledFlag == 1, IBBB GOF):
    # refPointCloud2 = the last non-B frame's reconstruction
    # (storeCurrentCloudAsBRef, decoder.cpp:176-192); frames are
    # coded out of display order, so each finished frame is tagged
    # with its reconstructed FrameCtr (framectr.h:61-75) and the
    # output list is reordered at the end — the positions content is
    # identical to outputGOFCurrentCloud's deferred-P-frame flow
    # (decoder.cpp:210-224) because the deferred output IS
    # refPointCloud2
    ref2_stv: Optional[np.ndarray] = None
    cur_is_b = False
    frame_ctr_rec = 0
    frame_nums: List[int] = []
    # predictive-geometry inter reference (refFrameSph handle,
    # decoder.cpp:603-645) + per-slice spherical reconstructions
    pg_ref = None
    last_slice_sph: Optional[np.ndarray] = None
    # predgeom spherical attribute minPos chain (decoder.cpp:885-899)
    pg_attr_min_ref: Optional[np.ndarray] = None

    def flush():
        nonlocal ref_cloud, attr_ref, next_attr_ref, ref2_stv
        if cur_slices:
            if next_attr_ref is not None:
                attr_ref = next_attr_ref
                next_attr_ref = None
            gps0 = next(iter(gps_map.values())) if gps_map else None
            if (gps0 is not None and gps0.z_compensation
                    and gps0.angular_enabled):
                # z compensation runs on the accumulated STV cloud at
                # output (decoder.cpp compensateZ; scale-1 scope:
                # num/den = 1000/1, output unit reverts the 1000)
                acc = np.ascontiguousarray(
                    np.concatenate(cur_slices_stv, axis=0),
                    dtype=np.int32)
                comp = compensate_z(sps, gps0, acc, num=1000, den=1)
                xyz = np.stack(
                    ref_hls.to_xyz(sps.geometry_axis_order,
                                   [comp[:, 0], comp[:, 1],
                                    comp[:, 2]]),
                    axis=1).astype(np.float64) / 1000.0
                xyz += np.asarray(sps.bbox_origin, dtype=np.float64)
                frames.append(xyz)
            else:
                frames.append(np.concatenate(cur_slices, axis=0))
            if cur_attrs and len(cur_attrs) == len(cur_slices):
                attr_frames.append(np.concatenate(cur_attrs, axis=0))
            else:
                attr_frames.append(None)
            if sps is not None and sps.inter_frame_prediction_enabled:
                gps0 = (next(iter(gps_map.values()))
                        if gps_map else None)
                if gps0 is not None and gps0.bi_prediction:
                    # storeCurrentCloudAsBRef (decoder.cpp:176-192):
                    # a non-B frame's reconstruction becomes the
                    # second reference; a B frame's becomes the first
                    acc = np.concatenate(cur_slices_stv, axis=0)
                    if cur_is_b:
                        ref_cloud = acc
                    else:
                        ref2_stv = acc
                else:
                    ref_cloud = np.concatenate(cur_slices_stv, axis=0)
            frame_nums.append(frame_ctr_rec)
            cur_slices.clear()
            cur_slices_stv.clear()
            cur_attrs.clear()

    for t, payload in ref_hls.iter_ref_tlv(data):
        if t == ref_hls.T_SPS:
            sps = ref_hls.parse_sps(payload)
        elif t == ref_hls.T_GPS:
            g = ref_hls.parse_gps(payload)
            gps_map[g.gps_id] = g
        elif t == ref_hls.T_APS and want_attrs:
            a = ref_hls.parse_aps(payload)
            aps_map[a.aps_id] = a
        elif t == ref_hls.T_GEOM_BRICK:
            gbh_ids = ref_hls.parse_gbh(
                sps, gps_map[payload[0] >> 4], payload)
            gps = gps_map[gbh_ids.gps_id]
            first_slice_in_frame = (
                cur_ctr is None or gbh_ids.frame_ctr_lsb != cur_ctr)
            if cur_ctr is not None and gbh_ids.frame_ctr_lsb != cur_ctr:
                flush()
            if gps.predgeom_enabled and gps.inter_prediction:
                lib = _load()
                c = ctypes
                if pg_ref is None:
                    if not hasattr(lib.tmc13ref_pgref_create,
                                   "_configured"):
                        lib.tmc13ref_pgref_create.argtypes = [
                            c.c_int, c.c_int, c.c_int, c.c_int]
                        lib.tmc13ref_pgref_create.restype = c.c_void_p
                        lib.tmc13ref_pgref_set_motion.argtypes = [
                            c.c_void_p, c.c_int, c.c_int, c.c_int,
                            c.POINTER(c.c_int32), c.POINTER(c.c_int32)]
                        lib.tmc13ref_pgref_set_motion.restype = None
                        lib.tmc13ref_pgref_update_frame.argtypes = [
                            c.c_void_p, c.c_int, c.c_int, c.c_int,
                            c.POINTER(c.c_int32), c.POINTER(c.c_int32)]
                        lib.tmc13ref_pgref_update_frame.restype = None
                        lib.tmc13ref_pgref_create._configured = True
                    pg_ref = lib.tmc13ref_pgref_create(
                        gps.inter_azim_scale_log2,
                        max(len(gps.angular_theta), 1),
                        1 if gps.global_motion else 0,
                        1 if gps.resampling_enabled else 0)
                    pg_first_frame = True
                else:
                    pg_first_frame = False
                if first_slice_in_frame and not pg_first_frame:
                    # decoder.cpp:640-645: refresh the motion params
                    # from the new frame's GBH, then rotate the
                    # reference maps
                    if gps.global_motion:
                        mat = np.asarray(gbh_ids.gm_matrix,
                                         dtype=np.int32)
                        trn = np.asarray(gbh_ids.gm_trans,
                                         dtype=np.int32)
                        lib.tmc13ref_pgref_set_motion(
                            pg_ref,
                            1 if gbh_ids.inter_frame_ref_gmc else 0,
                            int(gbh_ids.gm_thresh[0]),
                            int(gbh_ids.gm_thresh[1]),
                            mat.ctypes.data_as(c.POINTER(c.c_int32)),
                            trn.ctypes.data_as(c.POINTER(c.c_int32)))
                    th = np.ascontiguousarray(
                        gps.angular_theta or [0], dtype=np.int32)
                    zl = np.ascontiguousarray(
                        gps.angular_z or [0], dtype=np.int32)
                    lib.tmc13ref_pgref_update_frame(
                        pg_ref, gps.radius_inv_scale_log2,
                        gps.azimuth_scale_log2_minus11 + 12,
                        max(len(gps.angular_theta), 1),
                        th.ctypes.data_as(c.POINTER(c.c_int32)),
                        zl.ctypes.data_as(c.POINTER(c.c_int32)))
            cur_ctr = gbh_ids.frame_ctr_lsb
            if first_slice_in_frame:
                # FrameCtr reconstruction (framectr.h:61-75): the lsb
                # window disambiguates the out-of-order GOF coding
                bits = sps.frame_ctr_bits
                window = (1 << bits) >> 1
                cl = frame_ctr_rec & ((1 << bits) - 1)
                cm = frame_ctr_rec >> bits
                lsb = gbh_ids.frame_ctr_lsb
                if lsb < cl and cl - lsb >= window:
                    cm += 1
                elif lsb > cl and lsb - cl > window:
                    cm -= 1
                frame_ctr_rec = (cm << bits) | lsb
                if (gps.bi_prediction and not gbh_ids.bi_prediction
                        and ref2_stv is not None):
                    # a non-B frame predicts from the stored
                    # refPointCloud2 (decoder.cpp:611-616)
                    ref_cloud = ref2_stv
            cur_is_b = bool(gbh_ids.bi_prediction)
            sph_box: list = []
            local = decode_geometry_brick(
                sps, gps, gbh_ids, payload, ref_cloud=ref_cloud,
                pg_ref=pg_ref, sph_out=sph_box,
                ref2_cloud=(ref2_stv if gbh_ids.bi_prediction
                            else None))
            last_slice_sph = sph_box[0] if sph_box else None
            pos = local + np.asarray(gbh_ids.box_origin_stv,
                                     dtype=np.int64)
            cur_slices_stv.append(pos)
            last_slice_pos = pos
            last_slice_local = local
            last_gbh, last_gps = gbh_ids, gps
            xyz = np.stack(
                ref_hls.to_xyz(sps.geometry_axis_order,
                               [pos[:, 0], pos[:, 1], pos[:, 2]]),
                axis=1)
            # sequence bounding box origin offset (output conversion)
            xyz += np.asarray(sps.bbox_origin, dtype=np.int64)
            cur_slices.append(xyz)
        elif t == ref_hls.T_ATTR_BRICK and want_attrs:
            abh_ids = ref_hls.parse_abh(
                sps, aps_map[payload[0] >> 4], payload)
            aps = aps_map[abh_ids.aps_id]
            attr_pos = None
            if (aps.spherical_coord and last_gps is not None
                    and last_gps.predgeom_enabled):
                # predgeom reuses _posSph; the offset minimum chains
                # across frames under attribute inter prediction and
                # the stored reference shifts with it
                # (decoder.cpp:881-899)
                if last_slice_sph is None:
                    raise UnsupportedTool(
                        "predgeom spherical attrs need the "
                        "spherical reconstruction")
                sph = last_slice_sph.astype(np.int64)
                min_pos = sph.min(axis=0)
                w = np.asarray(aps.attr_coord_scale, dtype=np.int64)
                if (aps.attr_inter_prediction
                        and abh_ids.enable_attr_inter_pred
                        and pg_attr_min_ref is not None):
                    min_pos = np.minimum(min_pos, pg_attr_min_ref)
                    shift = pg_attr_min_ref - min_pos
                    if np.any(shift != 0) and attr_ref is not None:
                        sgn = np.sign(shift)
                        scal = ((np.abs(shift) * w) >> 8) * sgn
                        attr_ref = (
                            np.asarray(attr_ref[0], dtype=np.int64)
                            + scal[None, :], attr_ref[1])
                pg_attr_min_ref = min_pos
                attr_pos = ((sph - min_pos[None, :]) * w[None, :]
                            + (1 << 7)) >> 8
            attrs = decode_attr_brick(sps, aps, abh_ids, payload,
                                      last_slice_pos,
                                      gps=last_gps, gbh=last_gbh,
                                      slice_local=last_slice_local,
                                      attr_ref=attr_ref,
                                      positions_override=attr_pos)
            cur_attrs.append(attrs)
            if aps.attr_inter_prediction:
                # this brick's attribute cloud becomes the next
                # frame's reference (decoder.cpp:956-968: positions
                # in the attribute coding domain + decoded values)
                if attr_pos is not None:
                    ref_pos_attr = attr_pos
                elif aps.spherical_coord:
                    ref_pos_attr = attr_coding_positions(
                        sps, last_gps, last_gbh, aps,
                        last_slice_local)
                else:
                    ref_pos_attr = last_slice_pos
                next_attr_ref = (ref_pos_attr, attrs)
        elif t == ref_hls.T_FRAME_BOUNDARY:
            flush()
            cur_ctr = None
    flush()
    if any(g.bi_prediction for g in gps_map.values()):
        # display-order output (outputGOFCurrentCloud,
        # decoder.cpp:210-224): reorder by the reconstructed FrameCtr
        order = sorted(range(len(frames)), key=lambda i: frame_nums[i])
        frames = [frames[i] for i in order]
        attr_frames = [attr_frames[i] for i in order] \
            if attr_frames else attr_frames
    if want_attrs:
        return frames, attr_frames
    return frames


def write_tmc3_ply(path: str, positions_xyz: np.ndarray,
                   colors_gbr: Optional[np.ndarray] = None,
                   reflectances: Optional[np.ndarray] = None) -> None:
    """Write a PLY byte-identical to the reference decoder's ascii
    output (ply.cpp:103-159: header layout, green/blue/red property
    order, std::fixed 5-decimal positions)."""
    n = len(positions_xyz)
    lines = ["ply", "format ascii 1.0", f"element vertex {n}",
             "property float x", "property float y", "property float z"]
    if colors_gbr is not None:
        lines += ["property uchar green", "property uchar blue",
                  "property uchar red"]
    if reflectances is not None:
        lines += ["property uint16 refc"]
    lines += ["element face 0",
              "property list uint8 int32 vertex_index", "end_header"]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
        for i in range(n):
            p = positions_xyz[i]
            row = f"{p[0]:.5f} {p[1]:.5f} {p[2]:.5f}"
            if colors_gbr is not None:
                c = colors_gbr[i]
                row += f" {int(c[0])} {int(c[1])} {int(c[2])}"
            if reflectances is not None:
                row += f" {int(reflectances[i])}"
            f.write(row + "\n")
