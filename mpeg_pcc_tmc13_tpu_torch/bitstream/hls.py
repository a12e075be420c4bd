"""High-level syntax: parameter sets and brick headers.

Counterpart of the reference's `tmc3/hls.h` (SPS `hls.h:352`, GPS
`hls.h:470`, APS `hls.h:782`, GBH `hls.h:627`, ABH `hls.h:880`) and its
serialisers `tmc3/io_hls.cpp`.  The field inventory mirrors the
reference; the bit layout is this framework's own (we are a new codec,
not a bit-exact remux of the reference's syntax — see SURVEY.md §7).

Every payload is byte-aligned and framed by TLV (bitstream/tlv.py).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from .bitio import BitReader, BitWriter


class GeometryCodecType(enum.IntEnum):
    OCTREE = 0          # reference: default octree path
    PREDICTIVE = 1      # reference: gps.predgeom_enabled_flag
    TRISOUP = 2         # reference: gps.trisoup_enabled_flag


class AttributeEncoding(enum.IntEnum):
    """reference hls.h:132-138 (AttributeEncoding)."""
    RAHT = 0
    PRED = 1
    LIFT = 2
    RAW = 3


class AxisOrder(enum.IntEnum):
    """Internal/output axis permutation (reference hls.h:151-161,
    toXyz/fromXyz hls.h:164-195)."""
    XYZ = 0
    XZY = 1
    YXZ = 2
    YZX = 3
    ZXY = 4
    ZYX = 5

    @property
    def perm(self):
        """xyz -> internal (stv) column permutation."""
        return {0: (0, 1, 2), 1: (0, 2, 1), 2: (1, 0, 2),
                3: (1, 2, 0), 4: (2, 0, 1), 5: (2, 1, 0)}[int(self)]

    @property
    def inv_perm(self):
        p = self.perm
        inv = [0, 0, 0]
        for i, a in enumerate(p):
            inv[a] = i
        return tuple(inv)


@dataclass
class AttributeDescription:
    """One attribute in the SPS (reference hls.h:206-246).

    cicp_matrix follows the reference's colourMatrix coding
    (TMC3.cpp:1270-1275): 0 = identity, 1 = BT.709, 8 = YCgCo(-R).
    """
    label: str = "color"        # 'color' | 'reflectance' | other oid
    num_components: int = 3
    bitdepth: int = 8
    cicp_matrix: int = 0
    # coded-value interpretation (reference attr_scale_minus1 /
    # attr_offset, TMC3.cpp:1253-1259): output = coded*scale + offset
    attr_scale: int = 1
    attr_offset: int = 0

    def write(self, w: BitWriter):
        known = {"color": 0, "reflectance": 1}
        code = known.get(self.label, 2)
        w.write_ue(code)
        if code == 2:
            raw = self.label.encode()
            w.write_ue(len(raw))
            for b in raw:
                w.write(b, 8)
        w.write_ue(self.num_components - 1)
        w.write_ue(self.bitdepth - 1)
        w.write_ue(self.cicp_matrix)
        w.write_ue(self.attr_scale - 1)
        w.write_se(self.attr_offset)

    @staticmethod
    def parse(r: BitReader) -> "AttributeDescription":
        code = r.read_ue()
        if code == 0:
            label = "color"
        elif code == 1:
            label = "reflectance"
        else:
            n = r.read_ue()
            label = bytes(r.read(8) for _ in range(n)).decode()
        ncomp = r.read_ue() + 1
        bd = r.read_ue() + 1
        cicp = r.read_ue()
        scale = r.read_ue() + 1
        off = r.read_se()
        return AttributeDescription(label, ncomp, bd, cicp, scale, off)


@dataclass
class SequenceParameterSet:
    """reference hls.h:352-435."""
    sps_id: int = 0
    frame_ctr_bits: int = 8
    # sequence bounding box + global scale (reference seq_geom_scale,
    # a Rational — kept as num/den pair)
    seq_origin: Tuple[int, int, int] = (0, 0, 0)
    seq_bbox_whd: Tuple[int, int, int] = (0, 0, 0)
    geom_scale_num: int = 1
    geom_scale_den: int = 1
    geom_axis_order: AxisOrder = AxisOrder.XYZ
    attributes: List[AttributeDescription] = field(default_factory=list)
    entropy_continuation_enabled: bool = False
    inter_entropy_continuation_enabled: bool = False

    def write(self) -> bytes:
        w = BitWriter()
        w.write_ue(self.sps_id)
        w.write_ue(self.frame_ctr_bits)
        for v in self.seq_origin:
            w.write_se(int(v))
        for v in self.seq_bbox_whd:
            w.write_ue(int(v))
        w.write_ue(self.geom_scale_num)
        w.write_ue(self.geom_scale_den)
        w.write(int(self.geom_axis_order), 3)
        w.write_ue(len(self.attributes))
        for a in self.attributes:
            a.write(w)
        w.write_bit(self.entropy_continuation_enabled)
        w.write_bit(self.inter_entropy_continuation_enabled)
        w.byte_align()
        return w.get_bytes()

    @staticmethod
    def parse(data: bytes) -> "SequenceParameterSet":
        r = BitReader(data)
        s = SequenceParameterSet()
        s.sps_id = r.read_ue()
        s.frame_ctr_bits = r.read_ue()
        s.seq_origin = tuple(r.read_se() for _ in range(3))
        s.seq_bbox_whd = tuple(r.read_ue() for _ in range(3))
        s.geom_scale_num = r.read_ue()
        s.geom_scale_den = r.read_ue()
        s.geom_axis_order = AxisOrder(r.read(3))
        s.attributes = [AttributeDescription.parse(r)
                        for _ in range(r.read_ue())]
        s.entropy_continuation_enabled = bool(r.read_bit())
        s.inter_entropy_continuation_enabled = bool(r.read_bit())
        return s


@dataclass
class GeometryParameterSet:
    """reference hls.h:470-623."""
    gps_id: int = 0
    sps_id: int = 0
    codec_type: GeometryCodecType = GeometryCodecType.OCTREE
    unique_points: bool = True
    neighbour_context_enabled: bool = True
    # occupancy symbol coder: bytewise Fenwick model (default; one
    # multisymbol range op per node) vs binary context tree
    bytewise_occupancy: bool = True
    # OBUF engine: the brick's octree payload is a dirac-coded stream
    # from the dynamic-OBUF context machinery (native/refcodec.cc) —
    # reference-class occupancy compression (geometry_octree.h:328-613
    # redesign).  Intra, single-stream, unique-point slices only.
    obuf_engine: bool = False
    # rANS engine: the brick's octree payload is a fully on-device
    # K-lane interleaved rANS stream (ops/octree_rans.py) — analysis,
    # context modelling AND entropy coding run on the accelerator; the
    # host only moves the compressed bytes.  Intra, single-stream,
    # unique-point slices only.
    rans_engine: bool = False
    inferred_direct_coding_mode: int = 0   # 0=off (IDCM, later rounds)
    planar_mode_enabled: bool = False
    # OBUF-engine planar configuration (reference planarModeThreshold*,
    # multiplePlanarEnabled, octreeDepthPlanarEligibilityEnabled,
    # octreePlanarDynamicOBUFEligibilityEnabled) — normative for
    # obuf-engine bricks (models/geometry_obuf.py)
    planar_thresholds: Tuple[int, int, int] = (77, 99, 113)
    multiple_planar: bool = True
    depth_planar_eligibility: bool = True
    planar_dynamic_obuf: bool = True
    qtbt_enabled: bool = False
    # implicit QTBT schedule knobs (reference maxNumQtBtBeforeOt,
    # minQtbtSizeLog2; geometry_octree.cpp:51-160) — drive the
    # obuf-engine coded-axis derivation
    qtbt_max_before_ot: int = 4
    qtbt_min_size_log2: int = 0
    trisoup_node_size_log2: int = 0        # >0 when codec_type==TRISOUP
    trisoup_face_vertex_enabled: bool = False
    trisoup_halo_enabled: bool = False
    # centroid drift residual per >=3-vertex node (reference
    # trisoupCentroidResidualEnabled)
    trisoup_centroid_enabled: bool = True
    geom_scaling_enabled: bool = False
    interPredictionEnabled: bool = False
    globalMotionEnabled: bool = False
    # cuboid LPU local motion refinement (reference lpuType=1)
    lpu_motion_enabled: bool = False
    lpu_size_log2: int = 6
    # angular (LiDAR) tool set; calibrated laser tables (reference
    # numLasers/lasersTheta/lasersZ/lasersNumPhiPerTurn): tan(theta)
    # in Q18, z offset, azimuth steps per turn, one entry per laser
    angular_enabled: bool = False
    # decoder-side z snap onto the laser cones (reference
    # zCompensationEnabled)
    z_compensation_enabled: bool = True
    # scanner head position in sequence grid coords (reference
    # lidarHeadPosition / gpsAngularOrigin, TMC3.cpp:1052)
    angular_origin: tuple = (0, 0, 0)
    laser_theta_q: List[int] = field(default_factory=list)
    laser_z: List[int] = field(default_factory=list)
    laser_npt: List[int] = field(default_factory=list)

    def write(self) -> bytes:
        w = BitWriter()
        w.write_ue(self.gps_id)
        w.write_ue(self.sps_id)
        w.write(int(self.codec_type), 2)
        w.write_bit(self.unique_points)
        w.write_bit(self.neighbour_context_enabled)
        w.write_bit(self.bytewise_occupancy)
        w.write_bit(self.obuf_engine)
        if self.obuf_engine:
            for v in self.planar_thresholds:
                w.write_ue(int(v))
            w.write_bit(self.multiple_planar)
            w.write_bit(self.depth_planar_eligibility)
            w.write_bit(self.planar_dynamic_obuf)
            w.write_ue(self.qtbt_max_before_ot)
            w.write_ue(self.qtbt_min_size_log2)
        w.write_bit(self.rans_engine)
        w.write_ue(self.inferred_direct_coding_mode)
        w.write_bit(self.planar_mode_enabled)
        w.write_bit(self.qtbt_enabled)
        w.write_ue(self.trisoup_node_size_log2)
        w.write_bit(self.trisoup_face_vertex_enabled)
        w.write_bit(self.trisoup_halo_enabled)
        w.write_bit(self.trisoup_centroid_enabled)
        w.write_bit(self.geom_scaling_enabled)
        w.write_bit(self.interPredictionEnabled)
        w.write_bit(self.globalMotionEnabled)
        w.write_bit(self.lpu_motion_enabled)
        w.write_ue(self.lpu_size_log2)
        w.write_bit(self.angular_enabled)
        if self.angular_enabled:
            w.write_bit(self.z_compensation_enabled)
            for v in self.angular_origin:
                w.write_ue(int(v))
        w.write_ue(len(self.laser_theta_q))
        pt = pz = 0
        for i in range(len(self.laser_theta_q)):
            w.write_se(self.laser_theta_q[i] - pt)
            pt = self.laser_theta_q[i]
            w.write_se(self.laser_z[i] - pz)
            pz = self.laser_z[i]
            w.write_ue(self.laser_npt[i])
        w.byte_align()
        return w.get_bytes()

    @staticmethod
    def parse(data: bytes) -> "GeometryParameterSet":
        r = BitReader(data)
        g = GeometryParameterSet()
        g.gps_id = r.read_ue()
        g.sps_id = r.read_ue()
        g.codec_type = GeometryCodecType(r.read(2))
        g.unique_points = bool(r.read_bit())
        g.neighbour_context_enabled = bool(r.read_bit())
        g.bytewise_occupancy = bool(r.read_bit())
        g.obuf_engine = bool(r.read_bit())
        if g.obuf_engine:
            g.planar_thresholds = tuple(r.read_ue() for _ in range(3))
            g.multiple_planar = bool(r.read_bit())
            g.depth_planar_eligibility = bool(r.read_bit())
            g.planar_dynamic_obuf = bool(r.read_bit())
            g.qtbt_max_before_ot = r.read_ue()
            g.qtbt_min_size_log2 = r.read_ue()
        g.rans_engine = bool(r.read_bit())
        g.inferred_direct_coding_mode = r.read_ue()
        g.planar_mode_enabled = bool(r.read_bit())
        g.qtbt_enabled = bool(r.read_bit())
        g.trisoup_node_size_log2 = r.read_ue()
        g.trisoup_face_vertex_enabled = bool(r.read_bit())
        g.trisoup_halo_enabled = bool(r.read_bit())
        g.trisoup_centroid_enabled = bool(r.read_bit())
        g.geom_scaling_enabled = bool(r.read_bit())
        g.interPredictionEnabled = bool(r.read_bit())
        g.globalMotionEnabled = bool(r.read_bit())
        g.lpu_motion_enabled = bool(r.read_bit())
        g.lpu_size_log2 = r.read_ue()
        g.angular_enabled = bool(r.read_bit())
        if g.angular_enabled:
            g.z_compensation_enabled = bool(r.read_bit())
            g.angular_origin = tuple(r.read_ue() for _ in range(3))
        nlas = r.read_ue()
        pt = pz = 0
        for _ in range(nlas):
            pt += r.read_se()
            g.laser_theta_q.append(pt)
            pz += r.read_se()
            g.laser_z.append(pz)
            g.laser_npt.append(r.read_ue())
        return g


@dataclass
class AttributeParameterSet:
    """reference hls.h:782-876."""
    aps_id: int = 0
    sps_id: int = 0
    attr_encoding: AttributeEncoding = AttributeEncoding.RAHT
    init_qp: int = 4
    chroma_qp_offset: int = 0
    # LoD machinery (Pred/Lift)
    num_pred_nearest_neighbours: int = 3
    lod_levels: int = 12
    lod_decimation: int = 0        # 0=dist2 subsampling
    dist2: int = 0
    # Pred-specific
    max_direct_predictors: int = 3
    adaptive_prediction_threshold: int = 64
    # RAHT-specific
    raht_prediction_enabled: bool = True
    raht_integer_haar: bool = False
    # fixed-point RAHT (ops/raht_fp.py): integer transform executable
    # bit-identically on host and device
    raht_fixed_point: bool = False
    # transform-domain prediction sparsity thresholds + neighbourhood
    # weights (reference rahtPredictionThreshold0/1,
    # rahtPredictionWeights w0..w2 = self/face/edge; TMC3.cpp:1299)
    raht_pred_threshold0: int = 2
    raht_pred_threshold1: int = 6
    raht_pred_weights: Tuple[int, int, int] = (9, 3, 1)
    # LoD decimation period (reference lodSamplingPeriod)
    lod_sampling_period: int = 4
    # Lift
    scalable_lifting_enabled: bool = False
    # coordinate conversion (spherical attrs, LiDAR)
    spherical_coord_enabled: bool = False
    # inter attribute prediction (reference AttributeInterPredParams,
    # PCCTMC3Common.h:276-302): reference-frame points join the LoD
    # predictor pool on inter slices
    inter_prediction_enabled: bool = False
    # last-component prediction (reference hls.h
    # last_component_prediction_enabled_flag): the third component's
    # residual is predicted from the second's reconstruction with a
    # per-layer Q2 coefficient carried in the ABH
    last_component_prediction_enabled: bool = False
    # inter-component prediction (reference
    # inter_component_prediction_enabled_flag): chroma residuals
    # predicted from the luma residual, per-LoD-level Q2 coeffs in
    # the ABH (PRED transform)
    inter_component_prediction_enabled: bool = False

    def write(self) -> bytes:
        w = BitWriter()
        w.write_ue(self.aps_id)
        w.write_ue(self.sps_id)
        w.write(int(self.attr_encoding), 2)
        w.write_ue(self.init_qp)
        w.write_se(self.chroma_qp_offset)
        w.write_ue(self.num_pred_nearest_neighbours - 1)
        w.write_ue(self.lod_levels)
        w.write_ue(self.lod_decimation)
        w.write_ue(self.dist2)
        w.write_ue(self.max_direct_predictors)
        w.write_ue(self.adaptive_prediction_threshold)
        w.write_bit(self.raht_prediction_enabled)
        if self.raht_prediction_enabled:
            w.write_ue(self.raht_pred_threshold0)
            w.write_ue(self.raht_pred_threshold1)
            for v in self.raht_pred_weights:
                w.write_ue(int(v))
        w.write_ue(self.lod_sampling_period - 2)
        w.write_bit(self.raht_integer_haar)
        w.write_bit(self.raht_fixed_point)
        w.write_bit(self.scalable_lifting_enabled)
        w.write_bit(self.spherical_coord_enabled)
        w.write_bit(self.inter_prediction_enabled)
        w.write_bit(self.last_component_prediction_enabled)
        w.write_bit(self.inter_component_prediction_enabled)
        w.byte_align()
        return w.get_bytes()

    @staticmethod
    def parse(data: bytes) -> "AttributeParameterSet":
        r = BitReader(data)
        a = AttributeParameterSet()
        a.aps_id = r.read_ue()
        a.sps_id = r.read_ue()
        a.attr_encoding = AttributeEncoding(r.read(2))
        a.init_qp = r.read_ue()
        a.chroma_qp_offset = r.read_se()
        a.num_pred_nearest_neighbours = r.read_ue() + 1
        a.lod_levels = r.read_ue()
        a.lod_decimation = r.read_ue()
        a.dist2 = r.read_ue()
        a.max_direct_predictors = r.read_ue()
        a.adaptive_prediction_threshold = r.read_ue()
        a.raht_prediction_enabled = bool(r.read_bit())
        if a.raht_prediction_enabled:
            a.raht_pred_threshold0 = r.read_ue()
            a.raht_pred_threshold1 = r.read_ue()
            a.raht_pred_weights = tuple(r.read_ue() for _ in range(3))
        a.lod_sampling_period = r.read_ue() + 2
        a.raht_integer_haar = bool(r.read_bit())
        a.raht_fixed_point = bool(r.read_bit())
        a.scalable_lifting_enabled = bool(r.read_bit())
        a.spherical_coord_enabled = bool(r.read_bit())
        a.inter_prediction_enabled = bool(r.read_bit())
        a.last_component_prediction_enabled = bool(r.read_bit())
        a.inter_component_prediction_enabled = bool(r.read_bit())
        return a


@dataclass
class GeometryBrickHeader:
    """reference hls.h:627-780 (GBH): per-slice geometry header."""
    gps_id: int = 0
    slice_id: int = 0
    slice_tag: int = 0            # tile id association
    frame_ctr_lsb: int = 0
    slice_origin: Tuple[int, int, int] = (0, 0, 0)
    # exact slice extent (whd) for boundary-node clipping (reference
    # non-cubic nodes, slice_bb_width; 0,0,0 = cubic root box)
    slice_whd: Tuple[int, int, int] = (0, 0, 0)
    root_node_size_log2: int = 0  # cubic (max-axis) root size
    # per-axis root sizes (reference implicit QT/BT partitions,
    # hls.h gbh qtbt fields): axes whose size is below the cubic
    # depth are 'exhausted' at the top levels and their child slots
    # are skipped by the coder with no signalling
    axis_bits: Tuple[int, int, int] = (0, 0, 0)
    num_points: int = 0           # total points incl. duplicates
    entropy_continuation: bool = False
    prev_slice_id: int = 0
    # in-tree geometry quantisation (reference positionBaseQp /
    # positionSliceQpOffset, geometry_params.h:347): slice positions
    # are coded at a 2**geom_qp_shift coarser grid
    geom_qp_shift: int = 0
    # per-region geometry quantisation (per-node QP, region
    # granularity): slice-local boxes coded at a 2**shift coarser
    # grid; the decoder re-centres box points by half a cell
    geom_qp_boxes: List[Tuple[Tuple[int, int, int],
                              Tuple[int, int, int], int]] = field(
        default_factory=list)
    # per-NODE geometry QP (reference positionQuantisationOctreeDepth,
    # calculateNodeQps geometry_octree_encoder.cpp:2128): every
    # occupied node at this octree depth carries its own shift,
    # entropy-coded after the tree in Morton node order; 0 = off
    geom_qp_node_depth: int = 0
    # inter prediction (reference GBH gm_matrix/gm_trans, hls.h:627-780;
    # bi-prediction ref management PCCTMC3Common.h:304-399)
    is_inter: bool = False
    ref0_delta: int = 1           # frame_ctr distance to reference 0
    gm_matrix: Tuple[int, ...] = (65536, 0, 0, 0, 65536, 0, 0, 0, 65536)
    gm_trans: Tuple[int, int, int] = (0, 0, 0)
    # road-object LPU split (lpuType=0): ground plane height and
    # half-thickness; 0 thr = cuboid mode (no split)
    lpu_ground_z0: int = 0
    lpu_ground_thr: int = 0
    is_bi: bool = False
    ref1_delta: int = 1           # distance to reference 1 (future)
    gm_matrix1: Tuple[int, ...] = (65536, 0, 0, 0, 65536, 0, 0, 0, 65536)
    gm_trans1: Tuple[int, int, int] = (0, 0, 0)
    # entropy substream byte lengths (reference geom_stream_cnt_minus1 +
    # per-stream lengths, §2.9.3): stream 0 carries the shared-context
    # coarse levels; streams 1..N-1 carry one deep level each and are
    # independently decodable from the stream-0 context snapshot.
    stream_lens: List[int] = field(default_factory=lambda: [0])

    def write(self) -> bytes:
        w = BitWriter()
        w.write_ue(self.gps_id)
        w.write_ue(self.slice_id)
        w.write_ue(self.slice_tag)
        w.write_ue(self.frame_ctr_lsb)
        for v in self.slice_origin:
            w.write_se(int(v))
        for v in self.slice_whd:
            w.write_ue(int(v))
        w.write_ue(self.root_node_size_log2)
        for i in range(3):
            ab = self.axis_bits[i] or self.root_node_size_log2
            w.write_ue(self.root_node_size_log2 - ab)
        w.write_ue(self.num_points)
        w.write_bit(self.entropy_continuation)
        if self.entropy_continuation:
            w.write_ue(self.prev_slice_id)
        w.write_ue(self.geom_qp_shift)
        w.write_ue(self.geom_qp_node_depth)
        w.write_ue(len(self.geom_qp_boxes))
        for origin, size, shift in self.geom_qp_boxes:
            for v in origin:
                w.write_se(int(v))
            for v in size:
                w.write_ue(int(v))
            w.write_ue(int(shift))
        w.write_bit(self.is_inter)
        if self.is_inter:
            w.write_ue(self.ref0_delta - 1)
            for v in self.gm_matrix:
                w.write_se(int(v))
            for v in self.gm_trans:
                w.write_se(int(v))
            w.write_se(self.lpu_ground_z0)
            w.write_ue(self.lpu_ground_thr)
            w.write_bit(self.is_bi)
            if self.is_bi:
                w.write_ue(self.ref1_delta - 1)
                for v in self.gm_matrix1:
                    w.write_se(int(v))
                for v in self.gm_trans1:
                    w.write_se(int(v))
        w.write_ue(len(self.stream_lens) - 1)
        for v in self.stream_lens:
            w.write_ue(int(v))
        w.byte_align()
        return w.get_bytes()

    @staticmethod
    def parse(data: bytes):
        r = BitReader(data)
        h = GeometryBrickHeader()
        h.gps_id = r.read_ue()
        h.slice_id = r.read_ue()
        h.slice_tag = r.read_ue()
        h.frame_ctr_lsb = r.read_ue()
        h.slice_origin = tuple(r.read_se() for _ in range(3))
        h.slice_whd = tuple(r.read_ue() for _ in range(3))
        h.root_node_size_log2 = r.read_ue()
        h.axis_bits = tuple(h.root_node_size_log2 - r.read_ue()
                            for _ in range(3))
        h.num_points = r.read_ue()
        h.entropy_continuation = bool(r.read_bit())
        if h.entropy_continuation:
            h.prev_slice_id = r.read_ue()
        h.geom_qp_shift = r.read_ue()
        h.geom_qp_node_depth = r.read_ue()
        for _ in range(r.read_ue()):
            origin = tuple(r.read_se() for _ in range(3))
            size = tuple(r.read_ue() for _ in range(3))
            h.geom_qp_boxes.append((origin, size, r.read_ue()))
        h.is_inter = bool(r.read_bit())
        if h.is_inter:
            h.ref0_delta = r.read_ue() + 1
            h.gm_matrix = tuple(r.read_se() for _ in range(9))
            h.gm_trans = tuple(r.read_se() for _ in range(3))
            h.lpu_ground_z0 = r.read_se()
            h.lpu_ground_thr = r.read_ue()
            h.is_bi = bool(r.read_bit())
            if h.is_bi:
                h.ref1_delta = r.read_ue() + 1
                h.gm_matrix1 = tuple(r.read_se() for _ in range(9))
                h.gm_trans1 = tuple(r.read_se() for _ in range(3))
        nstreams = r.read_ue() + 1
        h.stream_lens = [r.read_ue() for _ in range(nstreams)]
        r.byte_align()
        return h, r.byte_pos


@dataclass
class AttributeBrickHeader:
    """reference hls.h:880-979 (ABH): slice QP deltas plus optional
    per-layer QP offsets (abh_attr_layer_qp_delta_luma/chroma,
    hls.h:921-933).  A "layer" is a RAHT sweep group or an LoD level;
    offsets beyond the signalled list repeat the last entry."""
    aps_id: int = 0
    sps_attr_idx: int = 0         # which SPS attribute this brick codes
    slice_id: int = 0
    qp_delta: int = 0             # luma slice delta
    qp_delta_chroma: int = 0
    layer_qp_deltas_luma: List[int] = field(default_factory=list)
    layer_qp_deltas_chroma: List[int] = field(default_factory=list)
    # last-component prediction coefficients, one per layer in the
    # codec's chunk order (reference attrLcpCoeffs, hls.h:887;
    # se-diff coded, range [-8, 8], Q2 fixed point)
    lcp_coeffs: List[int] = field(default_factory=list)
    # inter-component prediction coefficients: (chroma1, chroma2)
    # pairs per LoD level (reference icpCoeffs, hls.h:903)
    icp_coeffs: List[int] = field(default_factory=list)
    # region QPs (reference QpRegion, hls.h:953-963): slice-local
    # boxes with (luma, chroma) QP offsets; first matching box wins.
    # Applied per point in the PRED/LIFT transforms.
    qp_regions: List[Tuple[Tuple[int, int, int],
                           Tuple[int, int, int],
                           Tuple[int, int]]] = field(
        default_factory=list)

    def write(self) -> bytes:
        w = BitWriter()
        w.write_ue(self.aps_id)
        w.write_ue(self.sps_attr_idx)
        w.write_ue(self.slice_id)
        w.write_se(self.qp_delta)
        w.write_se(self.qp_delta_chroma)
        w.write_ue(len(self.layer_qp_deltas_luma))
        for i, d in enumerate(self.layer_qp_deltas_luma):
            w.write_se(d)
            cd = (self.layer_qp_deltas_chroma[i]
                  if i < len(self.layer_qp_deltas_chroma) else 0)
            w.write_se(cd)
        w.write_ue(len(self.lcp_coeffs))
        pred = 0
        for c in self.lcp_coeffs:
            w.write_se(int(c) - pred)
            pred = int(c)
        w.write_ue(len(self.icp_coeffs))
        pred = 0
        for c in self.icp_coeffs:
            w.write_se(int(c) - pred)
            pred = int(c)
        w.write_ue(len(self.qp_regions))
        for origin, size, offs in self.qp_regions:
            for v in origin:
                w.write_se(int(v))
            for v in size:
                w.write_ue(int(v))
            w.write_se(int(offs[0]))
            w.write_se(int(offs[1]))
        w.byte_align()
        return w.get_bytes()

    @staticmethod
    def parse(data: bytes):
        r = BitReader(data)
        h = AttributeBrickHeader()
        h.aps_id = r.read_ue()
        h.sps_attr_idx = r.read_ue()
        h.slice_id = r.read_ue()
        h.qp_delta = r.read_se()
        h.qp_delta_chroma = r.read_se()
        nl = r.read_ue()
        for _ in range(nl):
            h.layer_qp_deltas_luma.append(r.read_se())
            h.layer_qp_deltas_chroma.append(r.read_se())
        nc = r.read_ue()
        pred = 0
        for _ in range(nc):
            pred += r.read_se()
            h.lcp_coeffs.append(pred)
        ni = r.read_ue()
        pred = 0
        for _ in range(ni):
            pred += r.read_se()
            h.icp_coeffs.append(pred)
        nr = r.read_ue()
        for _ in range(nr):
            origin = tuple(r.read_se() for _ in range(3))
            size = tuple(r.read_ue() for _ in range(3))
            offs = (r.read_se(), r.read_se())
            h.qp_regions.append((origin, size, offs))
        r.byte_align()
        return h, r.byte_pos

    def layer_qp_offset(self, comp: int, layer: int) -> int:
        """Total ABH QP offset for component `comp` at `layer`
        (layer < 0 = the DC/root coefficient -> layer 0)."""
        off = self.qp_delta if comp == 0 else self.qp_delta_chroma
        lst = (self.layer_qp_deltas_luma if comp == 0
               else self.layer_qp_deltas_chroma)
        if lst:
            off += lst[min(max(layer, 0), len(lst) - 1)]
        return off


@dataclass
class TileInventory:
    """reference hls.h:1000-1053: spatial tile boxes for a frame."""
    tiles: List[Tuple[Tuple[int, int, int], Tuple[int, int, int]]] = \
        field(default_factory=list)  # (origin, size) per tile

    def write(self) -> bytes:
        w = BitWriter()
        w.write_ue(len(self.tiles))
        for origin, size in self.tiles:
            for v in origin:
                w.write_se(int(v))
            for v in size:
                w.write_ue(int(v))
        w.byte_align()
        return w.get_bytes()

    @staticmethod
    def parse(data: bytes) -> "TileInventory":
        r = BitReader(data)
        t = TileInventory()
        for _ in range(r.read_ue()):
            origin = tuple(r.read_se() for _ in range(3))
            size = tuple(r.read_ue() for _ in range(3))
            t.tiles.append((origin, size))
        return t


@dataclass
class AttributeParamInventory:
    """Per-frame attribute parameter updates (reference
    AttributeParamInventory, hls.h:303-318): overrides the SPS
    attribute's cicp matrix, scale/offset interpretation, and/or the
    soft default values from the signalled frame onward."""
    sps_attr_idx: int = 0
    frame_ctr_lsb: int = 0
    cicp_matrix: Optional[int] = None
    attr_scale: Optional[int] = None
    attr_offset: int = 0
    default_value: Optional[Tuple[int, ...]] = None

    def write(self) -> bytes:
        w = BitWriter()
        w.write_ue(self.sps_attr_idx)
        # ue(v): width-independent of sps.frame_ctr_bits, so the
        # inventory lsb always matches the GBH lsb it gates on
        w.write_ue(self.frame_ctr_lsb)
        w.write_bit(self.cicp_matrix is not None)
        if self.cicp_matrix is not None:
            w.write_ue(self.cicp_matrix)
        w.write_bit(self.attr_scale is not None)
        if self.attr_scale is not None:
            w.write_ue(self.attr_scale - 1)
            w.write_se(self.attr_offset)
        w.write_bit(self.default_value is not None)
        if self.default_value is not None:
            w.write_ue(len(self.default_value))
            for v in self.default_value:
                w.write_se(int(v))
        w.byte_align()
        return w.get_bytes()

    @staticmethod
    def parse(data: bytes) -> "AttributeParamInventory":
        r = BitReader(data)
        inv = AttributeParamInventory()
        inv.sps_attr_idx = r.read_ue()
        inv.frame_ctr_lsb = r.read_ue()
        if r.read_bit():
            inv.cicp_matrix = r.read_ue()
        if r.read_bit():
            inv.attr_scale = r.read_ue() + 1
            inv.attr_offset = r.read_se()
        if r.read_bit():
            inv.default_value = tuple(
                r.read_se() for _ in range(r.read_ue()))
        return inv


@dataclass
class UserData:
    """User-data unit (reference hls.h:1041-1044): an OID naming the
    data type followed by opaque payload bytes.  Decoders that don't
    recognise the OID skip the unit."""
    oid: Tuple[int, ...] = (1, 2)
    payload: bytes = b""

    def write(self) -> bytes:
        w = BitWriter()
        w.write_ue(len(self.oid))
        for arc in self.oid:
            w.write_ue(int(arc))
        w.byte_align()
        return w.get_bytes() + self.payload

    @staticmethod
    def parse(data: bytes):
        r = BitReader(data)
        n = r.read_ue()
        oid = tuple(r.read_ue() for _ in range(n))
        r.byte_align()
        return UserData(oid=oid, payload=data[r.byte_pos:])


@dataclass
class ConstantAttribute:
    """Constant-attribute data unit (reference decodeConstantAttribute,
    decoder.cpp:994): one value for the whole slice instead of a brick."""
    aps_id: int = 0
    sps_attr_idx: int = 0
    slice_id: int = 0
    values: Tuple[int, ...] = (0,)

    def write(self) -> bytes:
        w = BitWriter()
        w.write_ue(self.aps_id)
        w.write_ue(self.sps_attr_idx)
        w.write_ue(self.slice_id)
        w.write_ue(len(self.values))
        for v in self.values:
            w.write_ue(int(v))
        w.byte_align()
        return w.get_bytes()

    @staticmethod
    def parse(data: bytes) -> "ConstantAttribute":
        r = BitReader(data)
        c = ConstantAttribute()
        c.aps_id = r.read_ue()
        c.sps_attr_idx = r.read_ue()
        c.slice_id = r.read_ue()
        c.values = tuple(r.read_ue() for _ in range(r.read_ue()))
        return c


@dataclass
class FrameBoundaryMarker:
    """reference hls.h / io_hls.cpp frame boundary data unit."""
    frame_ctr_lsb: int = 0

    def write(self) -> bytes:
        w = BitWriter()
        w.write_ue(self.frame_ctr_lsb)
        w.byte_align()
        return w.get_bytes()

    @staticmethod
    def parse(data: bytes) -> "FrameBoundaryMarker":
        r = BitReader(data)
        return FrameBoundaryMarker(r.read_ue())
