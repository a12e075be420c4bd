"""Reference-syntax high-level-syntax parsing (tmc3 interop).

Bit-exact readers for the reference codec's TLV framing and parameter
sets, matching tmc3/io_tlv.cpp and io_hls.cpp
(parseSps io_hls.cpp:476, parseGps :769, parseGbh :1482, parseGbf).
Only the fields needed to drive geometry decoding are retained; every
field is still consumed so the bit positions stay exact.

Axis-order note: the reference stores positions internally in STV
order (hls.h:151); origins parsed here are converted from XYZ with
`from_xyz` exactly as the reference does on parse.

The PyTorch + CUDA port's copy of
``mpeg_pcc_tmc13_tpu/conformance/ref_hls.py``, imports only changed.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

# ---------------------------------------------------------------------------
# bit reader with the reference's exact conventions (BitReader.h):
# MSB-first bits, ue = leading-zeros exp-golomb, se sign bit 1 => +,
# sn = magnitude then sign (1 => negative)
# ---------------------------------------------------------------------------


class RefBitReader:
    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.byte = pos
        self.mask = 0
        self.buf = 0

    def u1(self) -> int:
        if self.mask == 0:
            if self.byte >= len(self.data):
                return 0
            self.buf = self.data[self.byte]
            self.byte += 1
            self.mask = 0x80
        v = 1 if (self.buf & self.mask) else 0
        self.mask >>= 1
        return v

    def un(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.u1()
        return v

    def sn(self, n: int) -> int:
        v = self.un(n)
        return -v if self.u1() else v

    def ue(self) -> int:
        length = 0
        while not self.u1():
            length += 1
            if length > 64:   # corrupt/foreign payload: all-zero tail
                raise ValueError("corrupt ue(v)")
        return ((1 << length) | self.un(length)) - 1

    def se(self) -> int:
        v = self.ue()
        sign = v & 1
        v = (v + sign) >> 1
        return v if sign else -v

    def byte_align(self):
        self.mask = 0

    def tell_bytes(self) -> int:
        return self.byte


# TLV payload types (reference hls.h:49-61)
T_SPS = 0
T_GPS = 1
T_GEOM_BRICK = 2
T_APS = 3
T_ATTR_BRICK = 4
T_TILE_INV = 5
T_FRAME_BOUNDARY = 6


def iter_ref_tlv(data: bytes):
    """Reference TLV: 1-byte type, 4-byte big-endian length, payload
    (io_tlv.cpp:45-58)."""
    pos = 0
    while pos + 5 <= len(data):
        t = data[pos]
        ln = int.from_bytes(data[pos + 1:pos + 5], "big")
        yield t, data[pos + 5:pos + 5 + ln]
        pos += 5 + ln


def axis_perm(axis_order: int) -> Tuple[int, int, int]:
    """XYZ -> STV permutation per AxisOrder (reference hls.h:164-195
    fromXyz): returns indices p with stv[k] = xyz[p[k]]."""
    return {
        0: (2, 1, 0),   # kZYX
        1: (0, 1, 2),   # kXYZ
        2: (0, 2, 1),   # kXZY
        3: (1, 2, 0),   # kYZX
        4: (2, 1, 0),   # kZYX_4
        5: (2, 0, 1),   # kZXY
        6: (1, 0, 2),   # kYXZ
        7: (0, 1, 2),   # kXYZ_7
    }[axis_order]


def from_xyz(axis_order: int, v):
    p = axis_perm(axis_order)
    return [v[p[0]], v[p[1]], v[p[2]]]


def to_xyz(axis_order: int, v):
    p = axis_perm(axis_order)
    out = [0, 0, 0]
    for k in range(3):
        out[p[k]] = v[k]
    return out


# ---------------------------------------------------------------------------


@dataclass
class RefSps:
    main_profile_compat: int = 1
    slice_reordering_constraint: int = 0
    unique_point_positions_constraint: int = 0
    level: int = 0
    sps_id: int = 0
    frame_ctr_bits: int = 0
    slice_tag_bits: int = 0
    bbox_origin: Tuple[int, int, int] = (0, 0, 0)
    bbox_size: Tuple[int, int, int] = (0, 0, 0)
    seq_scale_num: int = 1
    seq_scale_den: int = 1
    seq_geom_scale_unit: int = 0
    global_scale_mul_log2: int = 0
    global_scale_fp_bits: int = 0
    global_scale_rem: int = 0
    num_attrs: int = 0
    attr_bitdepths: List[int] = field(default_factory=list)
    attr_labels: List[int] = field(default_factory=list)
    attr_dims: List[int] = field(default_factory=list)
    # cicp_matrix_coefficients_idx per attribute, or None
    # (ColourMatrix, hls.h; 0=identity, 1=Bt709, 8=YCgCo)
    attr_cicp_matrix: List[Optional[int]] = field(default_factory=list)
    geometry_axis_order: int = 1
    cabac_bypass_stream_enabled: bool = False
    entropy_continuation_enabled: bool = False
    inter_frame_prediction_enabled: bool = False
    inter_entropy_continuation_enabled: bool = False
    bypass_bin_coding_without_prob_update: bool = False


def parse_sps(data: bytes) -> RefSps:
    """parseSps, io_hls.cpp:476."""
    bs = RefBitReader(data)
    s = RefSps()
    s.main_profile_compat = bs.un(1)
    bs.un(21)                       # reserved
    s.slice_reordering_constraint = bs.un(1)
    s.unique_point_positions_constraint = bs.un(1)
    s.level = bs.un(8)
    s.sps_id = bs.un(4)
    s.frame_ctr_bits = bs.un(5)
    s.slice_tag_bits = bs.un(5)
    origin = [0, 0, 0]
    origin_bits = bs.ue()
    if origin_bits:
        origin = [bs.sn(origin_bits) for _ in range(3)]
        scale = bs.ue()
        origin = [o << scale for o in origin]
    s.bbox_origin = tuple(origin)
    size = [0, 0, 0]
    size_bits = bs.ue()
    if size_bits:
        size = [bs.un(size_bits) + 1 for _ in range(3)]
    s.bbox_size = tuple(size)
    s.seq_scale_num = bs.ue() + 1
    s.seq_scale_den = bs.ue() + 1
    s.seq_geom_scale_unit = bs.un(1)
    s.global_scale_mul_log2 = bs.ue()
    s.global_scale_fp_bits = bs.ue()
    s.global_scale_rem = bs.un(s.global_scale_fp_bits)
    s.num_attrs = bs.ue()
    if s.num_attrs > 255:    # foreign/corrupt payload guard
        raise ValueError("implausible attribute count")
    for _ in range(s.num_attrs):
        s.attr_dims.append(bs.ue() + 1)   # attr_num_dimensions_minus1
        bs.ue()                           # attr_instance_id
        s.attr_bitdepths.append(bs.ue() + 1)
        known = bs.u1()
        if known:
            s.attr_labels.append(bs.ue())
        else:
            # oid label: X.690 subidentifier bytes behind a 1+7 bit
            # length header (hls.h:81-95, io_hls.cpp:98-131 writeOid/
            # readOid); stored as bytes to round-trip exactly
            bs.un(1)                      # oid_reserved_zero_bit
            oid_len = bs.un(7)
            s.attr_labels.append(
                bytes(bs.un(8) for _ in range(oid_len)))
        n_params = bs.ue()
        bs.byte_align()
        cicp_matrix = None
        for _ in range(n_params):
            # parseAttributeParameter (io_hls.cpp:357-381)
            ptype = bs.un(8)
            plen = bs.un(8)
            if ptype == 2:              # kCicp
                bs.ue()                 # colour primaries
                bs.ue()                 # transfer characteristics
                cicp_matrix = bs.ue()
                bs.u1()                 # full range flag
                bs.byte_align()
            elif ptype == 3:            # kScaling
                ob = bs.ue()
                bs.sn(ob)
                sb = bs.ue()
                bs.un(sb)
                bs.ue()
                bs.byte_align()
            elif ptype == 4:            # kDefaultValue
                dims = s.attr_dims[-1]
                for _k in range(dims):
                    bs.un(s.attr_bitdepths[-1])
                bs.byte_align()
            else:                       # opaque: skip plen bytes
                bs.byte_align()
                for _b in range(plen):
                    bs.un(8)
        s.attr_cicp_matrix.append(cicp_matrix)
    s.geometry_axis_order = bs.un(3)
    s.cabac_bypass_stream_enabled = bool(bs.u1())
    s.entropy_continuation_enabled = bool(bs.u1())
    if bs.u1():                           # sps_extension_flag
        s.inter_frame_prediction_enabled = bool(bs.u1())
        if s.inter_frame_prediction_enabled:
            s.inter_entropy_continuation_enabled = bool(bs.u1())
        s.bypass_bin_coding_without_prob_update = bool(bs.u1())
    return s


@dataclass
class RefGps:
    gps_id: int = 0
    sps_id: int = 0
    geom_box_log2_scale_present: bool = False
    gps_geom_box_log2_scale: int = 0
    unique_points: bool = True
    predgeom_enabled: bool = False
    point_count_list_present: bool = False
    inferred_direct_coding_mode: int = 0
    joint_2pt_idcm: bool = False
    qtbt_enabled: bool = False
    neighbour_avail_boundary_log2_minus1: int = 0
    adjacent_child_contextualization: bool = False
    intra_pred_max_node_size_log2: int = 0
    bitwise_occupancy: bool = True
    planar_enabled: bool = False
    planar_threshold0: int = 0
    planar_threshold1: int = 0
    planar_threshold2: int = 0
    idcm_rate_minus1: int = 0
    planar_buffer_disabled: bool = False
    angular_enabled: bool = False
    slice_angular_origin_present: bool = False
    angular_origin: Tuple[int, int, int] = (0, 0, 0)
    angular_theta: List[int] = field(default_factory=list)
    angular_z: List[int] = field(default_factory=list)
    angular_num_phi: List[int] = field(default_factory=list)
    z_compensation: bool = False
    inter_idcm: bool = False
    one_point_alone_laser_beam: bool = False
    scaling_enabled: bool = False
    base_qp: int = 0
    qp_multiplier_log2: int = 0
    idcm_qp_offset: int = 0
    trisoup_enabled: bool = False
    non_cubic_node_start_edge: bool = False
    non_cubic_node_end_edge: bool = False
    inter_prediction: bool = False
    global_motion: bool = False
    bi_prediction: bool = False
    frame_merge: bool = False
    planar_disabled_idcm_angular: bool = False
    octree_angular_extension: bool = False
    depth_planar_eligibility: bool = False
    planar_dynamic_obuf_eligibility: bool = False
    multiple_planar: bool = False
    # predictive-geometry fields (io_hls.cpp:658-661,739-748)
    azimuth_scale_log2_minus11: int = 5
    azimuth_speed_minus1: int = 362
    radius_inv_scale_log2: int = 0
    residual2_disabled: bool = False
    azimuth_scaling_enabled: bool = False
    predgeom_max_pred_index: int = 0
    predgeom_radius_threshold: int = 0
    resr_qphi_threshold_present: bool = False
    resr_qphi_threshold: int = 0
    inter_azim_scale_log2: int = 0
    resampling_enabled: bool = False


def parse_gps(data: bytes) -> RefGps:
    """parseGps, io_hls.cpp:769 (octree fields; angular predgeom
    extras consumed for bit-exact positions)."""
    bs = RefBitReader(data)
    g = RefGps()
    g.gps_id = bs.un(4)
    g.sps_id = bs.un(4)
    g.geom_box_log2_scale_present = bool(bs.u1())
    if not g.geom_box_log2_scale_present:
        g.gps_geom_box_log2_scale = bs.ue()
    g.unique_points = bool(bs.u1())
    g.predgeom_enabled = bool(bs.u1())
    if not g.predgeom_enabled:
        g.point_count_list_present = bool(bs.u1())
        g.inferred_direct_coding_mode = bs.un(2)
        if g.inferred_direct_coding_mode:
            g.joint_2pt_idcm = bool(bs.u1())
        g.qtbt_enabled = bool(bs.u1())
        g.neighbour_avail_boundary_log2_minus1 = bs.un(3)
        if g.neighbour_avail_boundary_log2_minus1 > 0:
            g.adjacent_child_contextualization = bool(bs.u1())
            g.intra_pred_max_node_size_log2 = bs.ue()
        g.bitwise_occupancy = bool(bs.u1())
        g.planar_enabled = bool(bs.u1())
        if g.planar_enabled:
            g.planar_threshold0 = bs.ue()
            g.planar_threshold1 = bs.ue()
            g.planar_threshold2 = bs.ue()
            if g.inferred_direct_coding_mode == 1:
                g.idcm_rate_minus1 = bs.un(5)
    g.angular_enabled = bool(bs.u1())
    if g.angular_enabled:
        g.slice_angular_origin_present = bool(bs.u1())
        if not g.slice_angular_origin_present:
            nb = bs.ue() + 1
            g.angular_origin = tuple(bs.sn(nb) for _ in range(3))
        if g.predgeom_enabled:
            g.azimuth_scale_log2_minus11 = bs.ue()
            g.azimuth_speed_minus1 = bs.ue()
            g.radius_inv_scale_log2 = bs.ue()
        n_lasers = bs.ue() + 1
        theta = [bs.se()]
        z = [bs.se()]
        nphi = []
        if not g.predgeom_enabled:
            nphi.append(bs.ue() + 1)
            g.z_compensation = bool(bs.u1())
        for i in range(1, n_lasers):
            dt = bs.se()
            dz = bs.se()
            # theta prediction: theta[i-1] + (theta[i-1]-theta[i-2])
            pred = theta[i - 1] if i == 1 else \
                theta[i - 1] * 2 - theta[i - 2]
            theta.append(pred + dt)
            z.append(z[i - 1] + dz)
            if not g.predgeom_enabled:
                nphi.append(nphi[i - 1] + bs.se())
        g.angular_theta, g.angular_z, g.angular_num_phi = theta, z, nphi
        if g.planar_enabled:
            g.planar_buffer_disabled = bool(bs.u1())
        g.inter_idcm = bool(bs.u1())
        if g.inter_idcm:
            g.one_point_alone_laser_beam = bool(bs.u1())
    g.scaling_enabled = bool(bs.u1())
    if g.scaling_enabled:
        g.base_qp = bs.ue()
        g.qp_multiplier_log2 = bs.un(2)
        if g.predgeom_enabled:
            bs.ue()     # qp offset interval log2
        elif g.inferred_direct_coding_mode:
            g.idcm_qp_offset = bs.se()
    if bs.u1():                           # gps_extension_flag
        if not g.predgeom_enabled:
            g.trisoup_enabled = bool(bs.u1())
        if g.trisoup_enabled:
            g.non_cubic_node_start_edge = bool(bs.u1())
            g.non_cubic_node_end_edge = bool(bs.u1())
        if (g.planar_enabled and g.angular_enabled
                and g.inferred_direct_coding_mode):
            g.planar_disabled_idcm_angular = bool(bs.u1())
        if not g.predgeom_enabled or g.angular_enabled:
            g.inter_prediction = bool(bs.u1())
        if g.inter_prediction:
            g.global_motion = bool(bs.u1())
            if g.predgeom_enabled:
                g.inter_azim_scale_log2 = bs.ue()
                g.resampling_enabled = bool(bs.u1())
            # biPredictionEnabledFlag: 0/1 (IBBB) or 2
            # (hierarchical GOF) — keep the integer value
            g.bi_prediction = bs.ue()
            if g.bi_prediction:
                g.frame_merge = bool(bs.u1())
        if g.predgeom_enabled and g.angular_enabled:
            # NB: the reference's azimuth-scaling block is missing
            # braces (io_hls.cpp:937-949): only max_pred_index is
            # conditional; the threshold and qphi fields always follow
            g.residual2_disabled = bool(bs.u1())
            g.azimuth_scaling_enabled = bool(bs.u1())
            if g.azimuth_scaling_enabled:
                g.predgeom_max_pred_index = bs.ue()
            g.predgeom_radius_threshold = bs.ue()
            g.resr_qphi_threshold_present = bool(bs.u1())
            if g.resr_qphi_threshold_present:
                g.resr_qphi_threshold = bs.ue()
            else:
                g.resr_qphi_threshold = 0
        if not g.predgeom_enabled and g.angular_enabled:
            g.octree_angular_extension = bool(bs.u1())
        if g.planar_enabled:
            g.depth_planar_eligibility = bool(bs.u1())
        if g.planar_enabled and not g.angular_enabled:
            g.planar_dynamic_obuf_eligibility = bool(bs.u1())
        if not g.predgeom_enabled and g.planar_enabled:
            g.multiple_planar = bool(bs.u1())
    return g


@dataclass
class RefGbh:
    gps_id: int = 0
    slice_id: int = 0
    slice_tag: int = 0
    frame_ctr_lsb: int = 0
    entropy_continuation: bool = False
    prev_slice_id: int = 0
    geom_box_log2_scale: int = 0
    box_origin_stv: Tuple[int, int, int] = (0, 0, 0)
    angular_origin_stv: Tuple[int, int, int] = (0, 0, 0)
    tree_lvl_coded_axis_list: List[int] = field(default_factory=list)
    geom_stream_cnt_minus1: int = 0
    slice_qp_offset: int = 0
    inter_prediction: bool = False
    bi_prediction: bool = False
    # global-motion fields (io_hls.cpp:1430-1476 / 1623-1686)
    inter_frame_ref_gmc: bool = False
    gm_matrix: Tuple[int, ...] = (65536, 0, 0, 0, 65536, 0, 0, 0, 65536)
    gm_trans: Tuple[int, int, int] = (0, 0, 0)
    gm_thresh: Tuple[int, int] = (0, 0)
    # second reference's global motion under bi-prediction
    # (hls.h gm_matrix2/gm_trans2/gm_thresh2, io_hls.cpp:1649-1680)
    inter_frame_ref_gmc2: bool = False
    gm_matrix2: Tuple[int, ...] = (65536, 0, 0, 0, 65536, 0, 0, 0, 65536)
    gm_trans2: Tuple[int, int, int] = (0, 0, 0)
    gm_thresh2: Tuple[int, int] = (0, 0)
    lpu_type: int = 0
    min_zero_origin: bool = False
    motion_block_size: Tuple[int, int, int] = (0, 0, 0)
    num_points: int = 0
    lvl_num_points: List[int] = field(default_factory=list)
    header_bytes: int = 0
    footer_bytes: int = 0
    # entropy stream lengths when geom_stream_cnt_minus1 > 0
    stream_lens: List[int] = field(default_factory=list)
    # trisoup fields (io_hls.cpp:1560-1580)
    trisoup_node_size_log2: int = 0
    trisoup_sampling: int = 1
    num_unique_segments: int = 0
    trisoup_vertex_quant_bits: int = 0
    trisoup_centroid_residual: bool = False
    trisoup_face_vertex: bool = False
    trisoup_halo: bool = False
    trisoup_adaptive_halo: bool = False
    trisoup_fine_ray: bool = False
    slice_bb_pos_bits: int = 0
    slice_bb_pos_log2_scale: int = 0
    slice_bb_pos: Tuple[int, int, int] = (0, 0, 0)
    slice_bb_width_bits: int = 0
    slice_bb_width_log2_scale: int = 0
    slice_bb_width: Tuple[int, int, int] = (0, 0, 0)
    # predictive-geometry fields (io_hls.cpp:1413-1419)
    pgeom_resid_abs_log2_bits: Tuple[int, int, int] = (0, 0, 0)
    pgeom_min_radius: int = 0


def parse_gbh(sps: RefSps, gps: RefGps, data: bytes) -> RefGbh:
    """parseGbh + parseGbf, io_hls.cpp:1482 (octree intra subset;
    raises on tools outside the conformance beachhead)."""
    bs = RefBitReader(data)
    h = RefGbh()
    h.gps_id = bs.un(4)
    bs.un(3)                              # reserved
    h.slice_id = bs.ue()
    h.slice_tag = bs.un(sps.slice_tag_bits)
    h.frame_ctr_lsb = bs.un(sps.frame_ctr_bits)
    if sps.entropy_continuation_enabled:
        h.entropy_continuation = bool(bs.u1())
        if h.entropy_continuation:
            h.prev_slice_id = bs.ue()
    if gps.geom_box_log2_scale_present:
        h.geom_box_log2_scale = bs.ue()
    else:
        h.geom_box_log2_scale = gps.gps_geom_box_log2_scale
    origin_bits = bs.ue() + 1
    origin_xyz = [bs.un(origin_bits) for _ in range(3)]
    h.box_origin_stv = tuple(
        v << h.geom_box_log2_scale
        for v in from_xyz(sps.geometry_axis_order, origin_xyz))
    if gps.slice_angular_origin_present:
        nb = bs.ue() + 1
        ang = [bs.sn(nb) for _ in range(3)]
        h.angular_origin_stv = tuple(
            from_xyz(sps.geometry_axis_order, ang))
    tree_depth_minus1 = 0
    if not gps.predgeom_enabled:
        if not gps.trisoup_enabled:
            tree_depth_minus1 = bs.ue()
        else:
            tree_depth_minus1 = bs.ue() - 1
        h.tree_lvl_coded_axis_list = [7] * (tree_depth_minus1 + 1)
        if gps.qtbt_enabled:
            for i in range(tree_depth_minus1 + 1):
                h.tree_lvl_coded_axis_list[i] = bs.un(3)
        h.geom_stream_cnt_minus1 = bs.ue()
    if gps.scaling_enabled:
        h.slice_qp_offset = bs.se()
        if gps.predgeom_enabled:
            bs.ue()              # geom_qp_offset_intvl_log2_delta
    if gps.trisoup_enabled:
        h.trisoup_node_size_log2 = bs.ue() + 2
        h.trisoup_sampling = bs.ue() + 1
        seg_bits = bs.ue() + 1
        h.num_unique_segments = bs.un(seg_bits) + 1
        h.trisoup_vertex_quant_bits = bs.ue()
        h.trisoup_centroid_residual = bool(bs.u1())
        if h.trisoup_centroid_residual:
            h.trisoup_face_vertex = bool(bs.u1())
        h.trisoup_halo = bool(bs.u1())
        if h.trisoup_halo:
            h.trisoup_adaptive_halo = bool(bs.u1())
        h.trisoup_fine_ray = bool(bs.u1())
        if gps.non_cubic_node_start_edge:
            h.slice_bb_pos_bits = bs.ue()
            if h.slice_bb_pos_bits > 0:
                h.slice_bb_pos_log2_scale = bs.ue()
                h.slice_bb_pos = tuple(
                    bs.un(h.slice_bb_pos_bits) for _ in range(3))
        if gps.non_cubic_node_end_edge:
            h.slice_bb_width_bits = bs.ue()
            if h.slice_bb_width_bits > 0:
                h.slice_bb_width_log2_scale = bs.ue()
                h.slice_bb_width = tuple(
                    bs.un(h.slice_bb_width_bits) for _ in range(3))
    if gps.predgeom_enabled:
        h.pgeom_resid_abs_log2_bits = tuple(bs.un(3) for _ in range(3))
        if gps.angular_enabled:
            h.pgeom_min_radius = bs.ue()
    if gps.inter_prediction:
        h.inter_prediction = bool(bs.u1())
    if gps.bi_prediction:
        h.bi_prediction = bool(bs.u1())
    if h.inter_prediction and gps.global_motion:
        # global-motion fields (io_hls.cpp:1632-1686); Q16 matrix with
        # the diagonal coded as a delta from 65536
        if gps.predgeom_enabled:
            h.inter_frame_ref_gmc = bool(bs.u1())
        if not gps.predgeom_enabled or h.inter_frame_ref_gmc:
            mat = [65536, 0, 0, 0, 65536, 0, 0, 0, 65536]
            trans = [0, 0, 0]
            for i in range(4):
                for j in range(3):
                    v = bs.se()
                    if i == 3:
                        trans[j] = v
                    elif i == j:
                        mat[3 * i + j] = 65536 + v
                    else:
                        mat[3 * i + j] = v
            h.gm_matrix = tuple(mat)
            h.gm_trans = tuple(trans)
        if h.bi_prediction:
            # second-reference GM (io_hls.cpp:1649-1662): the gmc2
            # flag is unconditional and the matrix follows regardless
            h.inter_frame_ref_gmc2 = bool(bs.u1())
            mat2 = [65536, 0, 0, 0, 65536, 0, 0, 0, 65536]
            trans2 = [0, 0, 0]
            for i in range(4):
                for j in range(3):
                    v = bs.se()
                    if i == 3:
                        trans2[j] = v
                    elif i == j:
                        mat2[3 * i + j] = 65536 + v
                    else:
                        mat2[3 * i + j] = v
            h.gm_matrix2 = tuple(mat2)
            h.gm_trans2 = tuple(trans2)
        if not gps.predgeom_enabled:
            h.lpu_type = bs.ue()
            h.min_zero_origin = bool(bs.u1())
            if h.lpu_type != 0:
                h.motion_block_size = tuple(bs.ue() for _ in range(3))
        if gps.predgeom_enabled or not h.lpu_type:
            if not gps.predgeom_enabled or h.inter_frame_ref_gmc:
                h.gm_thresh = (bs.se(), bs.se())
            if h.bi_prediction:
                h.gm_thresh2 = (bs.se(), bs.se())
    bs.byte_align()
    h.header_bytes = bs.tell_bytes()

    # footer (parseGbf): fixed 24-bit fields at the end of the payload
    foot = 3
    if gps.point_count_list_present:
        foot += 3 * tree_depth_minus1
    h.footer_bytes = foot
    fr = RefBitReader(data, len(data) - foot)
    if gps.point_count_list_present:
        h.lvl_num_points = [fr.un(24) + 1
                            for _ in range(tree_depth_minus1)]
    h.num_points = fr.un(24) + 1

    # multi-stream payloads carry the sub-streams back-to-back with NO
    # explicit lengths (encoder.cpp:1503-1511 concatenates the flushed
    # coder buffers directly); the decoder recovers each boundary via
    # the flush-and-restart renormalisation (entropydirac.h:335)
    h.stream_lens = [len(data) - h.header_bytes - foot]
    return h


# ---------------------------------------------------------------------------
# bit writer with the reference's exact conventions (BitWriter.h):
# MSB-first, ue = leading zeros + value+1, byteAlign pads zeros
# ---------------------------------------------------------------------------


class RefBitWriter:
    def __init__(self):
        self.out = bytearray()
        self.buf = 0
        self.nbits = 0

    def u1(self, bit: int):
        self.buf = (self.buf << 1) | (1 if bit else 0)
        self.nbits += 1
        if self.nbits == 8:
            self.out.append(self.buf)
            self.buf = 0
            self.nbits = 0

    def un(self, n: int, v: int):
        for i in range(n - 1, -1, -1):
            self.u1((v >> i) & 1)

    def sn(self, n: int, v: int):
        self.un(n, abs(v))
        self.u1(1 if v < 0 else 0)

    def ue(self, v: int):
        v += 1
        length = v.bit_length() - 1
        self.un(length, 0)
        self.un(length + 1, v)

    def se(self, v: int):
        # mirror of readSe: sign bit 1 => positive
        self.ue(2 * v - 1 if v > 0 else -2 * v)

    def byte_align(self):
        if self.nbits:
            self.out.append(self.buf << (8 - self.nbits))
            self.buf = 0
            self.nbits = 0

    def get_bytes(self) -> bytes:
        self.byte_align()
        return bytes(self.out)


def write_ref_tlv(t: int, payload: bytes) -> bytes:
    return bytes([t]) + len(payload).to_bytes(4, "big") + payload


def write_sps(s: RefSps) -> bytes:
    """Mirror of parse_sps (reference write(sps), io_hls.cpp:386);
    geometry-only subset (no attribute sets)."""
    w = RefBitWriter()
    w.un(1, s.main_profile_compat)
    w.un(21, 0)
    w.un(1, s.slice_reordering_constraint)
    w.un(1, s.unique_point_positions_constraint)
    w.un(8, s.level)
    w.un(4, s.sps_id)
    w.un(5, s.frame_ctr_bits)
    w.un(5, s.slice_tag_bits)
    # sps_bounding_box_offset_bits = numBits(origin.abs().max())
    # (encoder.cpp:161; numBits(0)=1 so the field is always present);
    # bbox_origin is kept in xyz, as parsed
    origin_xyz = list(s.bbox_origin)
    origin_bits = max(max(abs(v) for v in origin_xyz).bit_length(), 1)
    w.ue(origin_bits)
    for v in origin_xyz:
        w.sn(origin_bits, v)
    w.ue(0)                      # seq_bounding_box_offset_log2_scale
    w.ue(0)                      # bounding box size bits (none)
    w.ue(s.seq_scale_num - 1)
    w.ue(s.seq_scale_den - 1)
    w.un(1, s.seq_geom_scale_unit)
    w.ue(s.global_scale_mul_log2)
    w.ue(s.global_scale_fp_bits)
    w.un(s.global_scale_fp_bits, s.global_scale_rem)
    w.ue(s.num_attrs)            # num_attribute_sets
    for i in range(s.num_attrs):
        w.ue(s.attr_dims[i] - 1)
        w.ue(0)                  # attr_instance_id
        w.ue(s.attr_bitdepths[i] - 1)
        label = s.attr_labels[i]
        if isinstance(label, (bytes, bytearray)):
            w.u1(0)              # known_attribute_label_flag = 0: oid
            w.un(1, 0)           # oid_reserved_zero_bit
            w.un(7, len(label))
            for b in label:
                w.un(8, b)
        else:
            w.u1(1)              # known attribute label
            w.ue(label)
        cicp = (s.attr_cicp_matrix[i]
                if i < len(s.attr_cicp_matrix) else None)
        if cicp is not None:
            # one kCicp parameter block (writeAttributeParameters +
            # writeAttrParamCicp, io_hls.cpp:304-331,160-170):
            # primaries=2, transfer=2, matrix, full_range=1
            w.ue(1)              # num_attribute_parameters
            w.byte_align()
            pw = RefBitWriter()
            pw.ue(2)
            pw.ue(2)
            pw.ue(cicp)
            pw.u1(1)
            pw.byte_align()
            body = pw.get_bytes()
            w.un(8, 2)           # AttributeParameterType::kCicp
            w.un(8, len(body))
            for bb in body:
                w.un(8, bb)
        else:
            w.ue(0)              # num_attribute_parameters
            w.byte_align()
    w.un(3, s.geometry_axis_order)
    w.u1(s.cabac_bypass_stream_enabled)
    w.u1(s.entropy_continuation_enabled)
    # tmc3 always writes the extension block (io_hls.cpp:461-468)
    w.u1(1)                      # sps_extension_flag
    w.u1(s.inter_frame_prediction_enabled)
    if s.inter_frame_prediction_enabled:
        w.u1(s.inter_entropy_continuation_enabled)
    w.u1(s.bypass_bin_coding_without_prob_update)
    return w.get_bytes()


def write_gps(g: RefGps) -> bytes:
    """Mirror of parse_gps; octree + predictive-geometry intra."""
    w = RefBitWriter()
    w.un(4, g.gps_id)
    w.un(4, g.sps_id)
    w.u1(g.geom_box_log2_scale_present)
    if not g.geom_box_log2_scale_present:
        w.ue(g.gps_geom_box_log2_scale)
    w.u1(g.unique_points)
    w.u1(g.predgeom_enabled)
    if not g.predgeom_enabled:
        w.u1(g.point_count_list_present)
        w.un(2, g.inferred_direct_coding_mode)
        if g.inferred_direct_coding_mode:
            w.u1(g.joint_2pt_idcm)
        w.u1(g.qtbt_enabled)
        w.un(3, g.neighbour_avail_boundary_log2_minus1)
        if g.neighbour_avail_boundary_log2_minus1 > 0:
            w.u1(g.adjacent_child_contextualization)
            w.ue(g.intra_pred_max_node_size_log2)
        w.u1(g.bitwise_occupancy)
        w.u1(g.planar_enabled)
        if g.planar_enabled:
            w.ue(g.planar_threshold0)
            w.ue(g.planar_threshold1)
            w.ue(g.planar_threshold2)
            if g.inferred_direct_coding_mode == 1:
                w.un(5, g.idcm_rate_minus1)
    w.u1(g.angular_enabled)
    if g.angular_enabled:
        # io_hls.cpp angular block (origin in coded xyz order)
        w.u1(g.slice_angular_origin_present)
        if not g.slice_angular_origin_present:
            nb = max(max(abs(int(v)) for v in g.angular_origin)
                     .bit_length(), 1)
            w.ue(nb - 1)
            for v in g.angular_origin:
                w.sn(nb, int(v))
        if g.predgeom_enabled:
            w.ue(g.azimuth_scale_log2_minus11)
            w.ue(g.azimuth_speed_minus1)
            w.ue(g.radius_inv_scale_log2)
        n_lasers = len(g.angular_theta)
        w.ue(n_lasers - 1)
        w.se(g.angular_theta[0])
        w.se(g.angular_z[0])
        if not g.predgeom_enabled:
            w.ue(g.angular_num_phi[0] - 1)
            w.u1(g.z_compensation)
        for i in range(1, n_lasers):
            pred = (g.angular_theta[i - 1] if i == 1 else
                    g.angular_theta[i - 1] * 2 - g.angular_theta[i - 2])
            w.se(g.angular_theta[i] - pred)
            w.se(g.angular_z[i] - g.angular_z[i - 1])
            if not g.predgeom_enabled:
                w.se(g.angular_num_phi[i] - g.angular_num_phi[i - 1])
        if g.planar_enabled:
            w.u1(g.planar_buffer_disabled)
        w.u1(g.inter_idcm)
        if g.inter_idcm:
            w.u1(g.one_point_alone_laser_beam)
    w.u1(g.scaling_enabled)
    if g.scaling_enabled:
        raise NotImplementedError("scaling")
    # tmc3 always writes the extension block for the draft profile
    # (io_hls.cpp:712: gps_extension_flag = isDraftProfile())
    w.u1(1)                      # gps_extension_flag
    if not g.predgeom_enabled:
        w.u1(g.trisoup_enabled)
    if g.trisoup_enabled:
        w.u1(g.non_cubic_node_start_edge)
        w.u1(g.non_cubic_node_end_edge)
    if (g.planar_enabled and g.angular_enabled
            and g.inferred_direct_coding_mode):
        w.u1(g.planar_disabled_idcm_angular)
    if not g.predgeom_enabled or g.angular_enabled:
        w.u1(g.inter_prediction)
    if g.inter_prediction:
        w.u1(g.global_motion)
        if g.predgeom_enabled:
            w.ue(g.inter_azim_scale_log2)
            w.u1(g.resampling_enabled)
        w.ue(int(g.bi_prediction))
        if g.bi_prediction:
            w.u1(g.frame_merge)
    if g.predgeom_enabled and g.angular_enabled:
        # NB: the reference's missing-brace layout (io_hls.cpp:739-748)
        w.u1(g.residual2_disabled)
        w.u1(g.azimuth_scaling_enabled)
        if g.azimuth_scaling_enabled:
            w.ue(g.predgeom_max_pred_index)
        w.ue(g.predgeom_radius_threshold)
        w.u1(g.resr_qphi_threshold_present)
        if g.resr_qphi_threshold_present:
            w.ue(g.resr_qphi_threshold)
    if not g.predgeom_enabled and g.angular_enabled:
        w.u1(g.octree_angular_extension)
    if g.planar_enabled:
        w.u1(g.depth_planar_eligibility)
        if not g.angular_enabled:
            w.u1(g.planar_dynamic_obuf_eligibility)
        w.u1(g.multiple_planar)
    return w.get_bytes()


def write_gbh(sps: RefSps, gps: RefGps, h: RefGbh,
              aec_payload: bytes) -> bytes:
    """Mirror of parse_gbh + footer for the octree intra subset;
    returns the complete geometry brick payload."""
    w = RefBitWriter()
    w.un(4, h.gps_id)
    w.un(3, 0)
    w.ue(h.slice_id)
    w.un(sps.slice_tag_bits, h.slice_tag)
    w.un(sps.frame_ctr_bits, h.frame_ctr_lsb)
    if sps.entropy_continuation_enabled:
        w.u1(h.entropy_continuation)
        if h.entropy_continuation:
            w.ue(h.prev_slice_id)
    if gps.geom_box_log2_scale_present:
        w.ue(h.geom_box_log2_scale)
    origin_xyz = to_xyz(sps.geometry_axis_order,
                        [v >> h.geom_box_log2_scale
                         for v in h.box_origin_stv])
    origin_bits = max(max(v.bit_length() for v in origin_xyz), 1)
    w.ue(origin_bits - 1)
    for v in origin_xyz:
        w.un(origin_bits, v)
    if not gps.predgeom_enabled:
        tree_depth_minus1 = len(h.tree_lvl_coded_axis_list) - 1
        # for trisoup the coded value is the depth itself (parse:
        # ue()-1)
        w.ue(tree_depth_minus1 + (1 if gps.trisoup_enabled else 0))
        if gps.qtbt_enabled:
            for a in h.tree_lvl_coded_axis_list:
                w.un(3, a)
        w.ue(h.geom_stream_cnt_minus1)
    if gps.trisoup_enabled:
        # io_hls.cpp trisoup header fields (mirror of parse_gbh)
        w.ue(h.trisoup_node_size_log2 - 2)
        w.ue(h.trisoup_sampling - 1)
        # numBits(num_unique_segments_minus1), PCCMisc.h numBits(0)=1
        seg_bits = max(int(h.num_unique_segments - 1).bit_length(), 1)
        w.ue(seg_bits - 1)
        w.un(seg_bits, h.num_unique_segments - 1)
        w.ue(h.trisoup_vertex_quant_bits)
        w.u1(h.trisoup_centroid_residual)
        if h.trisoup_centroid_residual:
            w.u1(h.trisoup_face_vertex)
        w.u1(h.trisoup_halo)
        if h.trisoup_halo:
            w.u1(h.trisoup_adaptive_halo)
        w.u1(h.trisoup_fine_ray)
        if gps.non_cubic_node_start_edge:
            w.ue(h.slice_bb_pos_bits)
            if h.slice_bb_pos_bits > 0:
                w.ue(h.slice_bb_pos_log2_scale)
                for v in h.slice_bb_pos:
                    w.un(h.slice_bb_pos_bits, v)
        if gps.non_cubic_node_end_edge:
            w.ue(h.slice_bb_width_bits)
            if h.slice_bb_width_bits > 0:
                w.ue(h.slice_bb_width_log2_scale)
                for v in h.slice_bb_width:
                    w.un(h.slice_bb_width_bits, v)
    if gps.predgeom_enabled:
        for k in range(3):
            w.un(3, h.pgeom_resid_abs_log2_bits[k])
        if gps.angular_enabled:
            w.ue(h.pgeom_min_radius)
    if gps.inter_prediction:
        w.u1(h.inter_prediction)
    if gps.bi_prediction:
        w.u1(h.bi_prediction)
    if h.inter_prediction and gps.global_motion:
        # global-motion fields (io_hls.cpp:1430-1476)
        if gps.predgeom_enabled:
            w.u1(h.inter_frame_ref_gmc)
        if not gps.predgeom_enabled or h.inter_frame_ref_gmc:
            for i in range(4):
                for j in range(3):
                    if i == 3:
                        w.se(h.gm_trans[j])
                    elif i == j:
                        w.se(h.gm_matrix[3 * i + j] - 65536)
                    else:
                        w.se(h.gm_matrix[3 * i + j])
        if h.bi_prediction:
            # second-reference GM (io_hls.cpp:1445-1457)
            w.u1(h.inter_frame_ref_gmc2)
            for i in range(4):
                for j in range(3):
                    if i == 3:
                        w.se(h.gm_trans2[j])
                    elif i == j:
                        w.se(h.gm_matrix2[3 * i + j] - 65536)
                    else:
                        w.se(h.gm_matrix2[3 * i + j])
        if not gps.predgeom_enabled:
            w.ue(h.lpu_type)
            w.u1(h.min_zero_origin)
            if h.lpu_type != 0:
                for v in h.motion_block_size:
                    w.ue(v)
        if gps.predgeom_enabled or not h.lpu_type:
            if not gps.predgeom_enabled or h.inter_frame_ref_gmc:
                w.se(h.gm_thresh[0])
                w.se(h.gm_thresh[1])
            if h.bi_prediction:
                w.se(h.gm_thresh2[0])
                w.se(h.gm_thresh2[1])
    head = w.get_bytes()

    foot = RefBitWriter()
    if gps.point_count_list_present:
        for n in h.lvl_num_points:
            foot.un(24, n - 1)
    foot.un(24, h.num_points - 1)
    return head + aec_payload + foot.get_bytes()


# ---------------------------------------------------------------------------
# attribute parameter set + brick header (RAHT interop scope)
# ---------------------------------------------------------------------------

# AttributeEncoding (reference hls.h:132-138)
ATTR_RAHT = 0
ATTR_PRED = 1
ATTR_LIFT = 2
ATTR_RAW = 3


@dataclass
class RefAps:
    """AttributeParameterSet fields needed to drive RAHT decode
    (parseAps, io_hls.cpp:1126-1290).  Non-RAHT codings are parsed far
    enough to know they are out of scope and raise."""
    aps_id: int = 0
    sps_id: int = 0
    attr_encoding: int = 0
    init_qp_minus4: int = 0
    chroma_qp_offset: int = 0
    slice_qp_deltas_present: bool = False
    raht_prediction_enabled: bool = False
    raht_prediction_threshold0: int = 0
    raht_prediction_threshold1: int = 0
    raw_attr_variable_len: bool = False
    spherical_coord: bool = False
    attr_coord_scale: Tuple[int, int, int] = (0, 0, 0)
    integer_haar: bool = False
    attr_inter_prediction: bool = False
    raht_inter_depth_minus1: int = 0
    raht_send_inter_filters: bool = False
    raht_inter_skip_layers: int = 0
    raht_enable_code_layer: bool = False
    attr_inter_pred_search_range: int = 0
    raht_extension: bool = False
    raht_subnode_prediction: bool = False
    raht_prediction_weights: Optional[List[int]] = None
    raht_prediction_search_range: int = 0
    # predicting / lifting transform fields (io_hls.cpp:1143-1203)
    num_pred_nearest_neighbours_minus1: int = 2
    inter_lod_search_range: int = 0
    lod_neigh_bias: Tuple[int, int, int] = (1, 1, 1)
    last_component_prediction: bool = False
    scalable_lifting: bool = False
    canonical_point_order: bool = False
    num_detail_levels_minus1: int = 0
    lod_decimation_type: int = 0
    lod_sampling_periods: Optional[List[int]] = None
    dist2: int = 0
    slice_dist2_deltas_present: bool = False
    max_num_direct_predictors: int = 0
    adaptive_prediction_threshold: int = 0
    direct_avg_predictor_disabled: bool = False
    intra_lod_prediction_skip_layers: int = 0
    intra_lod_search_range: int = 0
    inter_component_prediction: bool = False
    pred_weight_blending: bool = False
    quant_neigh_weight: Optional[List[int]] = None
    max_points_per_sort_log2_plus1: int = 0
    prediction_with_distribution: bool = False

    def pred_weight_parent(self) -> List[int]:
        """predWeightParent (hls.h:448-466)."""
        if self.raht_prediction_weights is None:
            return [4, 2, 2, 2, 1, 1, 1, 1, 1, 2,
                    1, 2, 2, 1, 1, 1, 1, 1, 1]
        w = self.raht_prediction_weights
        return [w[0], w[1], w[1], w[1], w[2], w[2], w[2],
                w[2], w[2], w[1], w[2], w[1], w[1], w[2],
                w[2], w[2], w[2], w[2], w[2]]

    def pred_weight_child(self) -> List[int]:
        if self.raht_prediction_weights is None:
            return [0] * 12
        w = self.raht_prediction_weights
        return [w[4], w[4], w[3], w[4], w[3], w[3],
                w[4], w[4], w[4], w[4], w[4], w[4]]


def parse_aps(data: bytes) -> RefAps:
    """parseAps, io_hls.cpp:1126 (RAHT branch complete; LoD branches
    parsed for bit-position fidelity, then rejected downstream)."""
    bs = RefBitReader(data)
    a = RefAps()
    a.aps_id = bs.un(4)
    a.sps_id = bs.un(4)
    a.attr_encoding = bs.ue()
    a.init_qp_minus4 = bs.ue()
    a.chroma_qp_offset = bs.se()
    a.slice_qp_deltas_present = bool(bs.u1())

    scalable_lifting = False
    num_detail_levels_minus1 = 0
    # parse-time presets (parseAps io_hls.cpp:1188-1190): lifting
    # never uses intra-LoD prediction (kSkipAllLayers)
    a.intra_lod_prediction_skip_layers = 0x7fffffff
    if a.attr_encoding in (ATTR_PRED, ATTR_LIFT):
        # lodParametersPresent branch (io_hls.cpp:1143-1186)
        a.num_pred_nearest_neighbours_minus1 = bs.ue()
        a.inter_lod_search_range = bs.ue()
        a.lod_neigh_bias = tuple(bs.ue() + 1 for _ in range(3))
        if a.attr_encoding == ATTR_LIFT:
            a.last_component_prediction = bool(bs.u1())
        scalable_lifting = bool(bs.u1())
        a.scalable_lifting = scalable_lifting
        if scalable_lifting:
            raise NotImplementedError(
                "attribute interop: scalable lifting")
        a.canonical_point_order = False
        a.num_detail_levels_minus1 = bs.ue()
        num_detail_levels_minus1 = a.num_detail_levels_minus1
        if not a.num_detail_levels_minus1:
            a.canonical_point_order = bool(bs.u1())
        else:
            a.lod_decimation_type = bs.ue()
            if a.lod_decimation_type != 0:
                a.lod_sampling_periods = [
                    bs.ue() + 2
                    for _ in range(a.num_detail_levels_minus1)]
            if a.lod_decimation_type != 1:
                a.dist2 = bs.ue()
                a.slice_dist2_deltas_present = bool(bs.u1())

    if a.attr_encoding == ATTR_PRED:
        # predicting-transform fields (io_hls.cpp:1191-1203)
        a.max_num_direct_predictors = bs.ue()
        a.adaptive_prediction_threshold = 0
        a.direct_avg_predictor_disabled = False
        if a.max_num_direct_predictors:
            a.adaptive_prediction_threshold = bs.un(8)
            a.direct_avg_predictor_disabled = bool(bs.u1())
        a.intra_lod_prediction_skip_layers = bs.ue()
        a.intra_lod_search_range = bs.ue()
        a.inter_component_prediction = bool(bs.u1())
        a.pred_weight_blending = bool(bs.u1())

    if a.attr_encoding == ATTR_RAHT:
        a.raht_prediction_enabled = bool(bs.u1())
        if a.raht_prediction_enabled:
            a.raht_prediction_threshold0 = bs.ue()
            a.raht_prediction_threshold1 = bs.ue()

    if a.attr_encoding == ATTR_RAW:
        a.raw_attr_variable_len = bool(bs.u1())

    if not scalable_lifting:
        a.spherical_coord = bool(bs.u1())
    if a.spherical_coord:
        # per-axis scale weights, 5-bit length prefix
        # (io_hls.cpp:1219-1224)
        a.attr_coord_scale = tuple(
            bs.un(bs.un(5) + 1) for _ in range(3))

    aps_extension = bool(bs.u1())
    if aps_extension:
        if a.attr_encoding == ATTR_RAHT:
            a.integer_haar = bool(bs.u1())
        if a.attr_encoding == ATTR_PRED:
            # per-rank quant neighbour weights (io_hls.cpp:1240-1243)
            a.quant_neigh_weight = [
                bs.ue()
                for _ in range(a.num_pred_nearest_neighbours_minus1 + 1)]
        a.attr_inter_prediction = bool(bs.u1())
        if a.attr_inter_prediction:
            # inter-RAHT controls (io_hls.cpp:1246-1255)
            if a.attr_encoding == ATTR_RAHT:
                a.raht_inter_depth_minus1 = bs.ue()
                a.raht_send_inter_filters = bool(bs.u1())
                a.raht_inter_skip_layers = bs.ue()
                a.raht_enable_code_layer = bool(bs.u1())
            else:
                a.attr_inter_pred_search_range = bs.ue()
        if (a.attr_encoding in (ATTR_PRED, ATTR_LIFT)
                and not scalable_lifting
                and not num_detail_levels_minus1):
            a.max_points_per_sort_log2_plus1 = bs.ue()
        if (a.attr_encoding in (ATTR_PRED, ATTR_LIFT)
                and a.num_pred_nearest_neighbours_minus1 >= 2):
            a.prediction_with_distribution = bool(bs.u1())
        if a.attr_encoding == ATTR_RAHT:
            a.raht_extension = bool(bs.u1())
        if a.attr_encoding == ATTR_RAHT and a.raht_prediction_enabled:
            a.raht_subnode_prediction = bool(bs.u1())
            if a.raht_subnode_prediction:
                a.raht_prediction_weights = [bs.ue() for _ in range(5)]
                a.raht_prediction_search_range = bs.ue()
    bs.byte_align()
    return a


@dataclass
class RefAbh:
    """AttributeBrickHeader (parseAbh, io_hls.cpp:1922-2050), RAHT
    intra scope: qp deltas, layer QPs; regions and AC-coefficient QP
    offsets rejected."""
    aps_id: int = 0
    sps_attr_idx: int = 0
    geom_slice_id: int = 0
    qp_delta_luma: int = 0
    qp_delta_chroma: int = 0
    layer_qp_delta_luma: Optional[List[int]] = None
    layer_qp_delta_chroma: Optional[List[int]] = None
    attr_dist2_delta: int = 0
    enable_attr_inter_pred: bool = False
    disable_attr_inter_pred_ref2: bool = False
    raht_filter_taps: List[int] = field(default_factory=list)
    raht_attr_layer_code_mode: List[int] = field(default_factory=list)
    lcp_coeffs: Optional[List[int]] = None
    icp_coeffs: Optional[List[Tuple[int, int, int]]] = None
    # region QP boxes (hls.h:954-966 QpRegion; <=1 region): each entry
    # (origin_stv (3,), size_stv (3,), (qp_off_luma, qp_off_chroma))
    qp_regions: List[Tuple[Tuple[int, int, int], Tuple[int, int, int],
                           Tuple[int, int]]] = field(default_factory=list)
    region_bits_minus1: int = -1
    header_bytes: int = 0


def parse_abh(sps: RefSps, aps: RefAps, data: bytes) -> RefAbh:
    bs = RefBitReader(data)
    h = RefAbh()
    h.aps_id = bs.un(4)
    bs.un(3)                         # abh_reserved_zero_3bits
    h.sps_attr_idx = bs.ue()
    h.geom_slice_id = bs.ue()

    h.attr_dist2_delta = 0
    if aps.slice_dist2_deltas_present or aps.attr_inter_prediction:
        h.attr_dist2_delta = bs.se()

    # lifting last-component-prediction coefficients, delta-coded from
    # pred=4 (parseAbh io_hls.cpp:1944-1955; presence hls.h:890-900)
    dims = (sps.attr_dims[h.sps_attr_idx]
            if h.sps_attr_idx < len(sps.attr_dims) else 1)
    if (aps.attr_encoding == ATTR_LIFT
            and aps.last_component_prediction and dims == 3):
        h.lcp_coeffs = []
        pred = 4
        for _ in range(aps.num_detail_levels_minus1 + 1):
            pred += bs.se()
            h.lcp_coeffs.append(pred)

    # predicting inter-component-prediction coefficients
    # (io_hls.cpp:1957-1970; presence hls.h:906-916)
    if (aps.attr_encoding == ATTR_PRED
            and aps.inter_component_prediction and dims != 1):
        h.icp_coeffs = []
        pred = [0, 4, 4]
        for _ in range(aps.num_detail_levels_minus1 + 1):
            d1 = bs.se()
            d2 = bs.se()
            pred = [0, pred[1] + d1, pred[2] + d2]
            h.icp_coeffs.append(tuple(pred))

    if aps.slice_qp_deltas_present:
        h.qp_delta_luma = bs.se()
        h.qp_delta_chroma = bs.se()

    if bs.u1():                      # attr_layer_qp_present_flag
        n = bs.ue() + 1
        h.layer_qp_delta_luma = []
        h.layer_qp_delta_chroma = []
        for _ in range(n):
            h.layer_qp_delta_luma.append(bs.se())
            h.layer_qp_delta_chroma.append(bs.se())

    num_regions = bs.ue()
    if num_regions > 1:
        raise ValueError("at most one QP region permitted "
                         "(io_hls.cpp:1992 assert)")
    if num_regions:
        h.region_bits_minus1 = bs.ue()
        rb = h.region_bits_minus1 + 1
        for _ in range(num_regions):
            origin_xyz = tuple(bs.un(rb) for _ in range(3))
            whd_xyz = tuple(bs.un(rb) for _ in range(3))
            off0 = bs.se()
            off1 = bs.se() if dims > 1 else 0
            h.qp_regions.append((
                tuple(from_xyz(sps.geometry_axis_order,
                               list(origin_xyz))),
                tuple(v + 1 for v in from_xyz(sps.geometry_axis_order,
                                              list(whd_xyz))),
                (off0, off1)))

    if bs.u1():                      # raht_ac_coeff_qp_offset_present
        raise NotImplementedError(
            "attribute interop: RAHT AC coefficient QP offsets")

    if aps.attr_inter_prediction:
        # per-slice inter enable + RAHT filter taps / layer modes
        # (parseAbh, io_hls.cpp:1994-2022)
        h.enable_attr_inter_pred = bool(bs.u1())
        h.disable_attr_inter_pred_ref2 = bool(bs.u1())
        if h.enable_attr_inter_pred and aps.raht_send_inter_filters:
            n_filters = bs.ue()
            h.raht_filter_taps = [bs.se() for _ in range(n_filters)]
        if (aps.raht_enable_code_layer and h.enable_attr_inter_pred
                and aps.attr_encoding == ATTR_RAHT):
            n_depth = bs.ue()
            h.raht_attr_layer_code_mode = [bs.u1()
                                           for _ in range(n_depth)]

    bs.byte_align()
    h.header_bytes = bs.tell_bytes()
    return h


def derive_layer_qps(aps: RefAps, abh: RefAbh) -> List[Tuple[int, int]]:
    """deriveLayerQps (quantization.cpp:80-97): per-layer
    (lumaQp, chromaOffset) before the +qp0 chroma chaining."""
    def layer(l: int) -> Tuple[int, int]:
        luma = aps.init_qp_minus4 + 4
        chroma = aps.chroma_qp_offset
        if aps.slice_qp_deltas_present:
            luma += abh.qp_delta_luma
            chroma += abh.qp_delta_chroma
        if abh.layer_qp_delta_luma is not None:
            luma += abh.layer_qp_delta_luma[l]
            chroma += abh.layer_qp_delta_chroma[l]
        return luma, chroma

    layers = [layer(0)]
    if abh.layer_qp_delta_luma is not None:
        for l in range(1, len(abh.layer_qp_delta_luma)):
            layers.append(layer(l))
    return layers


def write_aps(a: RefAps) -> bytes:
    """Mirror of parse_aps (write(aps), io_hls.cpp:979-1122): RAHT,
    predicting and lifting intra scopes."""
    if a.attr_encoding not in (ATTR_RAHT, ATTR_PRED, ATTR_LIFT):
        raise NotImplementedError("write_aps: RAHT/PRED/LIFT only")
    w = RefBitWriter()
    w.un(4, a.aps_id)
    w.un(4, a.sps_id)
    w.ue(a.attr_encoding)
    w.ue(a.init_qp_minus4)
    se_w(w, a.chroma_qp_offset)
    w.u1(a.slice_qp_deltas_present)
    if a.attr_encoding in (ATTR_PRED, ATTR_LIFT):
        # lodParametersPresent branch (io_hls.cpp:993-1036)
        w.ue(a.num_pred_nearest_neighbours_minus1)
        w.ue(a.inter_lod_search_range)
        for v in a.lod_neigh_bias:
            w.ue(v - 1)
        if a.attr_encoding == ATTR_LIFT:
            w.u1(a.last_component_prediction)
        w.u1(0)                      # scalable_lifting_enabled_flag
        w.ue(a.num_detail_levels_minus1)
        if not a.num_detail_levels_minus1:
            w.u1(a.canonical_point_order)
        else:
            w.ue(a.lod_decimation_type)
            if a.lod_decimation_type != 0:
                for p in (a.lod_sampling_periods or []):
                    w.ue(p - 2)
            if a.lod_decimation_type != 1:
                w.ue(a.dist2)
                w.u1(a.slice_dist2_deltas_present)
    if a.attr_encoding == ATTR_PRED:
        w.ue(a.max_num_direct_predictors)
        if a.max_num_direct_predictors:
            w.un(8, a.adaptive_prediction_threshold)
            w.u1(a.direct_avg_predictor_disabled)
        w.ue(a.intra_lod_prediction_skip_layers)
        w.ue(a.intra_lod_search_range)
        w.u1(a.inter_component_prediction)
        w.u1(a.pred_weight_blending)
    if a.attr_encoding == ATTR_RAHT:
        w.u1(a.raht_prediction_enabled)
        if a.raht_prediction_enabled:
            w.ue(a.raht_prediction_threshold0)
            w.ue(a.raht_prediction_threshold1)
    w.u1(a.spherical_coord)
    if a.spherical_coord:
        for v in a.attr_coord_scale:
            nb = max(int(v).bit_length(), 1)
            w.un(5, nb - 1)
            w.un(nb, int(v))
    w.u1(1)                          # aps_extension_flag
    if a.attr_encoding == ATTR_RAHT:
        w.u1(a.integer_haar)
    if a.attr_encoding == ATTR_PRED:
        for v in (a.quant_neigh_weight
                  or [0] * (a.num_pred_nearest_neighbours_minus1 + 1)):
            w.ue(v)
    w.u1(a.attr_inter_prediction)
    if a.attr_inter_prediction:
        # inter-RAHT controls (io_hls.cpp:1246-1255)
        if a.attr_encoding == ATTR_RAHT:
            w.ue(a.raht_inter_depth_minus1)
            w.u1(a.raht_send_inter_filters)
            w.ue(a.raht_inter_skip_layers)
            w.u1(a.raht_enable_code_layer)
        else:
            w.ue(a.attr_inter_pred_search_range)
    if (a.attr_encoding in (ATTR_PRED, ATTR_LIFT)
            and not a.num_detail_levels_minus1):
        w.ue(a.max_points_per_sort_log2_plus1)
    if (a.attr_encoding in (ATTR_PRED, ATTR_LIFT)
            and a.num_pred_nearest_neighbours_minus1 >= 2):
        w.u1(a.prediction_with_distribution)
    if a.attr_encoding == ATTR_RAHT:
        w.u1(a.raht_extension)
        if a.raht_prediction_enabled:
            w.u1(a.raht_subnode_prediction)
            if a.raht_subnode_prediction:
                for v in a.raht_prediction_weights:
                    w.ue(v)
                w.ue(a.raht_prediction_search_range)
    return w.get_bytes()


def se_w(w: RefBitWriter, v: int):
    """Signed exp-golomb, mirror of BitReader se(): magnitude-first
    mapping (positive -> odd codes)."""
    w.ue(2 * v - 1 if v > 0 else -2 * v)


def write_abh(aps: RefAps, sps_attr_idx: int, geom_slice_id: int,
              aec_payload: bytes, dims: int = 3,
              lcp_coeffs=None, icp_coeffs=None,
              dist2_delta: int = 0,
              enable_inter: bool = False,
              raht_filter_taps=None,
              raht_layer_modes=None,
              qp_regions=None, axis_order: int = 1) -> bytes:
    """Attribute brick = ABH (parseAbh mirror, intra scope) + AEC
    payload.  ``lcp_coeffs``/``icp_coeffs`` are the encoder-derived
    per-LoD coefficient lists (delta-coded, io_hls.cpp:1780-1810)."""
    w = RefBitWriter()
    w.un(4, aps.aps_id)
    w.un(3, 0)                       # abh_reserved_zero_3bits
    w.ue(sps_attr_idx)
    w.ue(geom_slice_id)
    if aps.slice_dist2_deltas_present or aps.attr_inter_prediction:
        se_w(w, dist2_delta)         # attr_dist2_delta
    if (aps.attr_encoding == ATTR_LIFT
            and aps.last_component_prediction and dims == 3):
        pred = 4
        for v in (lcp_coeffs or []):
            se_w(w, v - pred)
            pred = v
    if (aps.attr_encoding == ATTR_PRED
            and aps.inter_component_prediction and dims != 1):
        pred = [0, 4, 4]
        for t in (icp_coeffs or []):
            se_w(w, t[1] - pred[1])
            se_w(w, t[2] - pred[2])
            pred = [0, t[1], t[2]]
    if aps.slice_qp_deltas_present:
        se_w(w, 0)
        se_w(w, 0)
    w.u1(0)                          # attr_layer_qp_present_flag
    regions = list(qp_regions or [])
    w.ue(len(regions))               # attr_num_regions
    if regions:
        # writeAbh region block (io_hls.cpp:1834-1861); entries are
        # (origin_stv, size_stv, (off_luma, off_chroma))
        mx = max(max(o) for o, s, _ in regions)
        mx = max(mx, max(max(s) for o, s, _ in regions))
        rb = max(1, mx.bit_length())
        w.ue(rb - 1)                 # attr_region_bits_minus1
        for origin, size, offs in regions:
            for v in to_xyz(axis_order, list(origin)):
                w.un(rb, v)
            for v in to_xyz(axis_order, [s - 1 for s in size]):
                w.un(rb, v)
            se_w(w, offs[0])
            if dims > 1:
                se_w(w, offs[1])
    w.u1(0)                          # raht_ac_coeff_qp_offset_present
    if aps.attr_inter_prediction:
        # per-slice inter enable + RAHT filter taps / layer modes
        # (writeAbh, io_hls.cpp:1994-2022)
        w.u1(1 if enable_inter else 0)
        # !biPredEncodeParams.movingState2 — always 1 without
        # bi-prediction (encoder.cpp:1105)
        w.u1(1)
        if enable_inter and aps.raht_send_inter_filters:
            taps = list(raht_filter_taps or [])
            w.ue(len(taps))
            for v in taps:
                se_w(w, v)
        if (aps.raht_enable_code_layer and enable_inter
                and aps.attr_encoding == ATTR_RAHT):
            modes = list(raht_layer_modes or [])
            w.ue(len(modes))
            for v in modes:
                w.u1(1 if v else 0)
    return w.get_bytes() + aec_payload
