"""Reference-syntax high-level-syntax parsing (tmc3 interop): the part
of ``mpeg_pcc_tmc13_tpu/conformance/ref_hls.py`` this package uses.

The reference's TLV framing, its SPS parser (which the CLI uses to tell
the tmc3 syntax family from its own) and the GPS record the OBUF
geometry engine fills in (``models.geometry_obuf``), copied line for
line.  Decoding and encoding tmc3-syntax streams are not ported yet.
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


def iter_ref_tlv(data: bytes):
    """Reference TLV: 1-byte type, 4-byte big-endian length, payload
    (io_tlv.cpp:45-58)."""
    pos = 0
    while pos + 5 <= len(data):
        t = data[pos]
        ln = int.from_bytes(data[pos + 1:pos + 5], "big")
        yield t, data[pos + 5:pos + 5 + ln]
        pos += 5 + ln


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
