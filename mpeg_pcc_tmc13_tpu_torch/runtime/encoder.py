"""Per-frame encoder orchestration.

Counterpart of `PCCTMC3Encoder3::compress` (reference encoder.cpp:86-610):
derive parameter sets on frame 0, quantise+dedup input, partition into
slices, per-slice geometry + attribute bricks, emit TLV payloads through
a callback.  Slices are the multi-chip parallelism unit (SURVEY.md §2.9);
the slice loop here is embarrassingly parallel and is what
`parallel/` shards over a device mesh.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np

from ..bitstream import entropy, hls
from ..bitstream.tlv import PayloadBuffer, PayloadType
from ..models.pointcloud import PointCloud
from .framestore import FrameStore

from ..models import attributes as attr_model
from ..models import geometry_octree, geometry_predictive, geometry_trisoup
from ..ops import motion as motion_ops
from ..ops import partition as partition_ops
from ..ops import processing
from ..ops import recolour as recolour_ops
from ..utils import morton as morton_ops
from ..utils import timing
from ..utils.device import NoDeviceError, cuda_or_none


@dataclass
class AttributeConfig:
    """Per-attribute encoder options (reference per-attribute APS
    derivation, encoder.cpp:677-708)."""
    label: str = "color"
    bitdepth: int = 8
    encoding: hls.AttributeEncoding = hls.AttributeEncoding.RAHT
    qp: int = 4
    qp_chroma_offset: int = 0
    raht_integer_haar: bool = False
    # fixed-point RAHT (ops/raht_fp.py): deterministic integer
    # transform, identical streams from host and device backends.
    # Default ON for the native syntax (RD equals the float mode)
    raht_fixed_point: bool = True
    # colourMatrix (reference TMC3.cpp:1270): 0 identity, 8 YCgCo-R.
    # YCgCo-R is exactly reversible => default for transform coding.
    cicp_matrix: int = 8
    # coded-value interpretation (reference attrScale/attrOffset)
    attr_scale: int = 1
    attr_offset: int = 0
    # reference-syntax LoD count (raw tmc3 option semantics,
    # num_detail_levels_minus1; TMC3.cpp:1374 default 1)
    ref_num_detail_levels_minus1: int = 1
    # LoD construction (reference dist2 / lodDecimator): dist2 > 0
    # selects distance subsampling, else Morton-periodic decimation
    dist2: int = 0
    # inter attribute prediction (reference AttributeInterPredParams)
    inter_pred: bool = False
    # further APS knobs (reference per-attribute options)
    raht_prediction: bool = True
    lod_levels: int = 12
    num_pred_nearest_neighbours: int = 3
    max_direct_predictors: int = 3
    adaptive_prediction_threshold: int = 64
    # per-layer QP offsets (reference qpLayerOffsetsLuma/Chroma,
    # TMC3.cpp:1447-1453): layer = RAHT sweep group or LoD level;
    # entries past the end repeat the last value
    layer_qp_offsets_luma: List[int] = field(default_factory=list)
    layer_qp_offsets_chroma: List[int] = field(default_factory=list)
    # last-component (chroma-from-chroma) prediction (reference
    # lastComponentPredictionEnabled, TMC3.cpp:1404)
    last_component_prediction: bool = False
    inter_component_prediction: bool = False
    # scalable lifting (reference aps_scalable_enable_flag):
    # per-LoD-level chunks, truncatable at decode
    scalable_lifting: bool = False
    # RAHT transform-domain prediction knobs (reference
    # rahtPredictionThreshold0/1, rahtPredictionWeights)
    raht_pred_threshold0: int = 2
    raht_pred_threshold1: int = 6
    raht_pred_weights: tuple = (9, 3, 1)
    # LoD decimation period (reference lodSamplingPeriod)
    lod_sampling_period: int = 4
    # region QPs (reference QpRegion): [(origin, size, (dL, dC))]
    # in GLOBAL grid coords; rebased per slice into the ABH.
    # Applied per point by the PRED/LIFT transforms.
    qp_regions: List[tuple] = field(default_factory=list)


@dataclass
class EncoderParams:
    """Encoder options (subset of the reference's ~190, TMC3.cpp:632)."""
    # positionQuantizationScale as a rational (reference seq scale)
    geom_scale_num: int = 1
    geom_scale_den: int = 1
    merge_duplicated_points: bool = True
    # the 13 recolour* options (reference TMC3.cpp:1501-1549)
    recolour_params: "recolour_ops.RecolourParams" = None
    recolour_window: int = 8
    # sequence bounding box (reference seqOrigin/seqSizeWhd; None =
    # derived from content, reference autoSeqBbox)
    seq_origin: tuple = None
    seq_bbox_whd: tuple = None
    geometry_codec: hls.GeometryCodecType = hls.GeometryCodecType.OCTREE
    # encode slices on a host thread pool (framework extension; the
    # heavy per-slice work is native code that releases the GIL).  The
    # emitted stream is byte-identical to the sequential encode; only
    # valid without entropy continuation (slices share no context).
    parallel_slices: int = 0
    trisoup_node_size_log2: int = 0
    # reference defaults: halo + face vertices ON (TMC3.cpp:954,984)
    trisoup_face_vertex_enabled: bool = True
    trisoup_halo_enabled: bool = True
    trisoup_centroid_enabled: bool = True
    # OBUF-engine planar/QTBT knobs (reference planarModeThreshold*,
    # multiplePlanarEnabled, octree*PlanarEligibility*,
    # maxNumQtBtBeforeOt, minQtbtSizeLog2)
    planar_thresholds: tuple = (77, 99, 113)
    multiple_planar: bool = True
    depth_planar_eligibility: bool = True
    planar_dynamic_obuf: bool = True
    qtbt_max_before_ot: int = 4
    qtbt_min_size_log2: int = 0
    # decoder-side laser-cone z snap (reference zCompensationEnabled)
    z_compensation: bool = True
    # opaque user data emitted once with the parameter sets
    # (reference UserData, hls.h:1041)
    user_data: Optional["hls.UserData"] = None
    attributes: List[AttributeConfig] = field(default_factory=list)
    # slice/tile partitioning (reference partitioning.cpp; CLI
    # partitionMethod TMC3.cpp:781)
    partition_method: "partition_ops.PartitionMethod" = None
    max_points_per_slice: int = 1_100_000
    min_points_per_slice: int = 0
    partition_octree_depth: int = 1
    tile_size: int = 0
    # reference numOctreeEntropyStreams (TMC3.cpp:861): last N-1 octree
    # levels in separate, independently-decodable entropy streams
    num_entropy_streams: int = 1
    entropy_continuation: bool = False
    # device-sharded slice encode: round-robin each slice worker's
    # device placement over the first N CUDA devices (multi-chip form
    # of parallel_slices; SURVEY.md §2.9 TPU-equivalents)
    shard_devices: int = 0
    # torch device of the on-device geometry engines ("device", "rans");
    # None = the current CUDA device, raising when there is none
    # (utils/device.resolve).  Resolved only when such an engine runs.
    device: Optional[str] = None
    # carry adapted contexts into inter frames (reference
    # InterEntropyContinuationEnabled, TMC3.cpp)
    inter_entropy_continuation: bool = False
    frame_ctr_bits: int = 8
    # in-tree geometry quantisation: slice positions coded on a
    # 2**geom_qp_shift coarser grid (reference positionBaseQp; our
    # shift = qp // 6, one octave per 6 QP)
    geom_qp_shift: int = 0
    # per-node geometry QP at an octree depth (reference
    # positionQuantisationOctreeDepth / ...OctreeSizeLog2,
    # calculateNodeQps geometry_octree_encoder.cpp:2128): every
    # occupied node at that depth gets a density-derived shift
    geom_qp_octree_depth: int = 0
    geom_qp_octree_size_log2: int = 0
    # IDCM (reference inferredDirectCodingMode, TMC3.cpp).  Off by
    # default: with this framework's adaptive chain contexts, isolated
    # branches already cost ~1-2 bits/level, so direct coding only
    # saves ~3% on very sparse content while forcing the numpy engine.
    idcm: bool = False
    idcm_mode: int = 0          # reference mode 0-3 (refSyntax path)
    planar_enabled: bool = False
    bytewise_occupancy: bool = True
    # cuboid LPU local motion (reference lpuType=1): per-2^m-cell
    # refinement MV on top of global motion
    lpu_motion: bool = False
    lpu_size_log2: int = 6
    # 0 = road-object split (ground keeps GM), 1 = cuboid only
    lpu_type: int = 1
    # per-region geometry quantisation: [(origin, size, shift)] in
    # GLOBAL grid coords; box points code on a 2**shift coarser grid
    geom_qp_regions: List[tuple] = field(default_factory=list)
    # calibrated laser tables (angular predictive geometry)
    laser_theta: List[float] = field(default_factory=list)
    laser_z: List[int] = field(default_factory=list)
    laser_npt: List[int] = field(default_factory=list)
    # inter prediction (reference TMC3.cpp:1113-1151)
    inter_prediction: bool = False
    random_access_period: int = 1     # 1 = all-intra
    global_motion: bool = False
    motion_file: Optional[str] = None
    # cuboid-LPU geometry (reference globalMotionBlockSize /
    # globalMotionWindowSize, TMC3.cpp:1167-1174, scaled per
    # deriveMotionParams at encode time)
    motion_block_size: tuple = (0, 0, 4096)
    motion_window_size: int = 512
    # bi-directional prediction (reference biPredictionEnabled /
    # biPredictionPeriod, TMC3.cpp:1126-1139): hierarchical GOF of
    # bi_period frames, B frames referencing both coded neighbours
    bi_prediction: bool = False
    bi_period: int = 8
    # occupancy context mode (reference neighbourAvailBoundaryLog2>0):
    # True = 6-neighbour contexts, False = parent-occupancy (fast)
    neighbour_context: bool = True
    # geometry engine: auto | numpy | native | device
    engine: str = "auto"
    # predictive-geometry input ordering (reference predGeomSort)
    predgeom_sort_mode: "geometry_predictive.SortMode" = None
    # angular (spherical-domain) coding for LiDAR (reference
    # angularEnabled, TMC3.cpp cfg: angular tool set)
    angular_enabled: bool = False
    # scanner head position (reference lidarHeadPosition)
    angular_origin: tuple = (0, 0, 0)
    # internal axis permutation (reference geometry_axis_order,
    # TMC3.cpp:750)
    axis_order: hls.AxisOrder = hls.AxisOrder.XYZ

    def __post_init__(self):
        if self.predgeom_sort_mode is None:
            self.predgeom_sort_mode = geometry_predictive.SortMode.MORTON
        if self.partition_method is None:
            self.partition_method = partition_ops.PartitionMethod.NPTS


def _angular_for(gps, slice_origin):
    """(LaserInfo, slice-local origin) for angular planar contexts,
    or None when the angular octree tool set is off."""
    if not (gps.angular_enabled and gps.laser_theta_q
            and gps.planar_mode_enabled
            and gps.codec_type == hls.GeometryCodecType.OCTREE):
        return None
    from ..ops import angular as angular_ops
    info = angular_ops.laser_info(gps.laser_theta_q, gps.laser_z,
                                  gps.laser_npt)
    org = (np.asarray(gps.angular_origin, dtype=np.int64)
           - np.asarray(slice_origin, dtype=np.int64))
    return (info, org)


class FrameEncoder:
    """Sequence-scoped encoder state + per-frame compress()."""

    def __init__(self, params: EncoderParams):
        self.params = params
        # Angular predictive geometry determines spherical positions
        # from the input; quantising the input would disturb them.
        # Like the reference (encoder.cpp:98-110), replace sequence
        # scaling by input decimation: keep one point per coarse cell,
        # code at full precision, signal scale 1.
        self._decimation_scale: Optional[float] = None
        if (params.geometry_codec == hls.GeometryCodecType.PREDICTIVE
                and params.angular_enabled
                and params.geom_scale_num != params.geom_scale_den):
            self._decimation_scale = (params.geom_scale_num
                                      / params.geom_scale_den)
            params.geom_scale_num = 1
            params.geom_scale_den = 1
        self.sps: Optional[hls.SequenceParameterSet] = None
        self.gps: Optional[hls.GeometryParameterSet] = None
        self.aps: List[hls.AttributeParameterSet] = []
        self.frame_ctr = 0
        self._slice_id = 0
        self._geom_ctx: Optional[geometry_octree.OctreeContexts] = None
        self._trisoup_ctx: Optional[geometry_trisoup.TrisoupContexts] = None
        self._pending_param_updates: List[
            hls.AttributeParamInventory] = []
        self._attr_ctx: Dict[int, attr_model.AttributeContexts] = {}
        # inter state (reference refFrame bookkeeping, encoder.cpp:502;
        # bi-pred frame store + GOF buffer, PCCTMC3Common.h:304-399);
        # retention policy shared with the decoder (framestore.py)
        self._frames = FrameStore()                # ctr_lsb -> grid
        # frame_ctr mask applied to every store key, ref delta and
        # inventory lsb (one source of truth: sps.frame_ctr_bits)
        self._ctr_mask = (1 << params.frame_ctr_bits) - 1
        self._attr_acc: List = []
        self._geom_acc: List = []
        self._gof: List = []                       # buffered (ctr, cloud)
        self._anchor_ctr: Optional[int] = None
        self._motion_params = (motion_ops.MotionParameters.parse_file(
            params.motion_file) if params.motion_file else None)

    # -- parameter-set derivation (reference deriveParameterSets,
    #    encoder.cpp:677) ---------------------------------------------
    def _derive_parameter_sets(self, cloud: PointCloud):
        p = self.params
        sps = hls.SequenceParameterSet(
            frame_ctr_bits=p.frame_ctr_bits,
            seq_origin=tuple(p.seq_origin) if p.seq_origin else (0, 0, 0),
            seq_bbox_whd=tuple(p.seq_bbox_whd) if p.seq_bbox_whd
            else (0, 0, 0),
            geom_scale_num=p.geom_scale_num,
            geom_scale_den=p.geom_scale_den,
            geom_axis_order=p.axis_order,
            entropy_continuation_enabled=p.entropy_continuation,
            inter_entropy_continuation_enabled=p.inter_entropy_continuation,
        )
        for ac in p.attributes:
            ncomp = 3 if ac.label == "color" else 1
            cicp = ac.cicp_matrix if (
                ac.label == "color"
                and ac.encoding != hls.AttributeEncoding.RAW) else 0
            sps.attributes.append(hls.AttributeDescription(
                label=ac.label, num_components=ncomp,
                bitdepth=ac.bitdepth, cicp_matrix=cicp,
                attr_scale=ac.attr_scale, attr_offset=ac.attr_offset))
        gps = hls.GeometryParameterSet(
            codec_type=p.geometry_codec,
            unique_points=p.merge_duplicated_points,
            neighbour_context_enabled=p.neighbour_context,
            bytewise_occupancy=p.bytewise_occupancy,
            obuf_engine=(
                p.engine == "obuf"
                and p.geometry_codec in (
                    hls.GeometryCodecType.OCTREE,
                    hls.GeometryCodecType.TRISOUP)
                and p.merge_duplicated_points
                and not p.idcm
                and p.geom_qp_shift == 0
                and not p.geom_qp_regions
                and p.num_entropy_streams <= 1),
            rans_engine=(
                p.engine == "rans"
                and p.geometry_codec == hls.GeometryCodecType.OCTREE
                and p.merge_duplicated_points
                and not p.idcm and not p.planar_enabled
                and p.geom_qp_shift == 0
                and not p.geom_qp_regions
                and p.geom_qp_octree_depth == 0
                and p.geom_qp_octree_size_log2 == 0
                and not p.inter_prediction
                and p.num_entropy_streams <= 1),
            inferred_direct_coding_mode=1 if (
                p.idcm and p.merge_duplicated_points) else 0,
            planar_mode_enabled=(
                p.planar_enabled
                and p.geometry_codec == hls.GeometryCodecType.OCTREE),
            trisoup_node_size_log2=p.trisoup_node_size_log2,
            trisoup_face_vertex_enabled=p.trisoup_face_vertex_enabled,
            trisoup_halo_enabled=p.trisoup_halo_enabled,
            trisoup_centroid_enabled=p.trisoup_centroid_enabled,
            planar_thresholds=p.planar_thresholds,
            multiple_planar=p.multiple_planar,
            depth_planar_eligibility=p.depth_planar_eligibility,
            planar_dynamic_obuf=p.planar_dynamic_obuf,
            qtbt_max_before_ot=p.qtbt_max_before_ot,
            qtbt_min_size_log2=p.qtbt_min_size_log2,
            z_compensation_enabled=p.z_compensation,
            interPredictionEnabled=p.inter_prediction,
            globalMotionEnabled=p.global_motion,
            lpu_motion_enabled=p.lpu_motion and p.inter_prediction,
            lpu_size_log2=p.lpu_size_log2,
            angular_enabled=p.angular_enabled,
            # lidarHeadPosition is given in input units (reference
            # TMC3.cpp sanitization); store in coding grid units
            angular_origin=tuple(
                int(round(v * p.geom_scale_num / p.geom_scale_den))
                for v in p.angular_origin),
            laser_theta_q=[int(round(t * (1 << 18)))
                           for t in p.laser_theta],
            laser_z=[int(p.laser_z[i]) if i < len(p.laser_z) else 0
                     for i in range(len(p.laser_theta))],
            laser_npt=[int(p.laser_npt[i]) if i < len(p.laser_npt)
                       else 1024
                       for i in range(len(p.laser_theta))],
        )
        aps_list = []
        for i, ac in enumerate(p.attributes):
            aps_list.append(hls.AttributeParameterSet(
                aps_id=i, attr_encoding=ac.encoding, init_qp=ac.qp,
                chroma_qp_offset=ac.qp_chroma_offset,
                raht_integer_haar=ac.raht_integer_haar,
                raht_fixed_point=(ac.raht_fixed_point
                                  and not ac.raht_integer_haar),
                raht_prediction_enabled=ac.raht_prediction,
                dist2=ac.dist2,
                lod_levels=ac.lod_levels,
                num_pred_nearest_neighbours=(
                    ac.num_pred_nearest_neighbours),
                max_direct_predictors=ac.max_direct_predictors,
                adaptive_prediction_threshold=(
                    ac.adaptive_prediction_threshold),
                inter_prediction_enabled=(
                    ac.inter_pred and p.inter_prediction),
                last_component_prediction_enabled=(
                    ac.last_component_prediction),
                inter_component_prediction_enabled=(
                    ac.inter_component_prediction),
                scalable_lifting_enabled=ac.scalable_lifting,
                raht_pred_threshold0=ac.raht_pred_threshold0,
                raht_pred_threshold1=ac.raht_pred_threshold1,
                raht_pred_weights=tuple(ac.raht_pred_weights),
                lod_sampling_period=ac.lod_sampling_period))
        self.sps, self.gps, self.aps = sps, gps, aps_list

    # -- tile + slice partitioning (reference encoder.cpp:340-473) ----
    def _partition(self, cloud: PointCloud,
                   out: Callable[[PayloadBuffer], None]
                   ) -> List[PointCloud]:
        p = self.params
        if p.tile_size > 0:
            tiles, inventory = partition_ops.tile_partition(
                cloud.positions, p.tile_size)
            out(PayloadBuffer(
                PayloadType.TILE_INVENTORY,
                hls.TileInventory(tiles=inventory).write()))
        else:
            tiles = [np.arange(cloud.count)]
        result = []
        for tidx in tiles:
            tcloud = cloud.take(tidx)
            for sidx in partition_ops.partition_slices(
                    tcloud.positions, p.partition_method,
                    max_points=p.max_points_per_slice,
                    min_points=p.min_points_per_slice,
                    octree_depth=p.partition_octree_depth):
                result.append(tcloud.take(sidx))
        return result

    def compress(self, cloud: PointCloud,
                 out: Callable[[PayloadBuffer], None]):
        """Compress one display-order frame; emits payloads via `out`.

        With bi_prediction, frames buffer until a GOF completes
        (reference compressOneGOF, TMC3.cpp:2267); call flush() after
        the last frame.
        """
        p = self.params
        qcloud = None
        if self.sps is None:
            self._derive_parameter_sets(cloud)
            with timing.span("frame.prepare"):
                qcloud = self._prepare_frame(cloud)
            self._auto_dist2(qcloud)
            out(PayloadBuffer(PayloadType.SEQUENCE_PARAMETER_SET,
                              self.sps.write()))
            out(PayloadBuffer(PayloadType.GEOMETRY_PARAMETER_SET,
                              self.gps.write()))
            for a in self.aps:
                out(PayloadBuffer(PayloadType.ATTRIBUTE_PARAMETER_SET,
                                  a.write()))
            if p.user_data is not None:
                out(PayloadBuffer(PayloadType.USER_DATA,
                                  p.user_data.write()))
        for inv in self._pending_param_updates:
            inv.frame_ctr_lsb = self.frame_ctr & self._ctr_mask
            out(PayloadBuffer(PayloadType.ATTR_PARAM_INVENTORY,
                              inv.write()))
        self._pending_param_updates = []
        if qcloud is None:
            with timing.span("frame.prepare"):
                qcloud = self._prepare_frame(cloud)
        ctr = self.frame_ctr
        self.frame_ctr += 1
        bi = (p.bi_prediction and p.inter_prediction
              and p.geometry_codec == hls.GeometryCodecType.OCTREE)
        if not bi:
            refs = self._choose_refs(ctr, qcloud)
            self._code_frame(qcloud, ctr, out, refs)
            return
        # hierarchical GOF buffering
        if self._anchor_ctr is None:
            self._code_frame(qcloud, ctr, out, [])     # first anchor: I
            self._anchor_ctr = ctr
            return
        self._gof.append((ctr, qcloud))
        if len(self._gof) >= max(p.bi_period, 1):
            self._code_gof(out)

    def update_attribute_params(self, sps_attr_idx: int,
                                cicp_matrix: int = None,
                                attr_scale: int = None,
                                attr_offset: int = 0,
                                default_value=None):
        """Queue an attribute parameter inventory (reference
        AttributeParamInventory): emitted with the next frame and
        applied to this encoder's SPS copy so coded-space
        conversions stay consistent."""
        desc = self.sps.attributes[sps_attr_idx]
        if cicp_matrix is not None:
            desc.cicp_matrix = cicp_matrix
        if attr_scale is not None:
            desc.attr_scale = attr_scale
            desc.attr_offset = attr_offset
        self._pending_param_updates.append(
            hls.AttributeParamInventory(
                sps_attr_idx=sps_attr_idx, cicp_matrix=cicp_matrix,
                attr_scale=attr_scale, attr_offset=attr_offset,
                default_value=tuple(default_value)
                if default_value is not None else None))

    def flush(self, out: Callable[[PayloadBuffer], None]):
        """Code any buffered GOF tail (P-chain)."""
        for ctr, qcloud in self._gof:
            refs = self._choose_refs(ctr, qcloud, forced_ref=True)
            self._code_frame(qcloud, ctr, out, refs)
        self._gof = []

    def _auto_dist2(self, qcloud: PointCloud) -> None:
        """Estimate the LoD base distance for distance-subsampled
        PRED/LIFT attributes when the config leaves dist2 unset
        (reference encoder.cpp:1199-1205 slice dist2 refinement with
        estimateDist2).  Runs on the first frame's coding-grid cloud,
        before the APS is written, so both sides build the same LoD."""
        from ..ops import lod as lod_ops
        est = None
        for a in self.aps:
            if (a.attr_encoding in (hls.AttributeEncoding.PRED,
                                    hls.AttributeEncoding.LIFT)
                    and a.dist2 == 0 and a.lod_decimation == 0):
                if est is None:
                    est = lod_ops.estimate_dist2(qcloud.positions)
                a.dist2 = est

    def _prepare_frame(self, cloud: PointCloud) -> PointCloud:
        p = self.params
        # axis permutation into internal stv order (reference
        # convertXyzToStv, decoder.cpp:347-369)
        positions = cloud.positions[:, self.sps.geom_axis_order.perm]
        if self._decimation_scale is not None:
            # angular predgeom: decimate instead of scaling
            # (samplePositionsUniq, pointset_processing.cpp:114-134 —
            # keep the first source point per coarse cell, positions
            # stay at full precision)
            pos_i = np.round(positions).astype(np.int64)
            # std::round = half away from zero (the reference's key
            # law); np.round's half-even would merge boundary cells
            # differently and keep a different point set
            kf = pos_i * self._decimation_scale
            key = np.where(kf >= 0, np.floor(kf + 0.5),
                           np.ceil(kf - 0.5)).astype(np.int64)
            key -= key.min(axis=0)         # morton needs non-negative
            kcodes = morton_ops.encode(key)
            _, first = np.unique(kcodes, return_index=True)
            first.sort()
            positions = positions[first]
            cloud = PointCloud(
                cloud.positions[first],
                None if cloud.colors is None else cloud.colors[first],
                None if cloud.reflectances is None
                else cloud.reflectances[first],
                cloud.frame_index)
        # input quantisation (reference encoder.cpp:1554-1577).  Scale
        # only; per-slice origins are signalled absolute in grid units,
        # so no sequence origin enters the reconstruction path.
        grid = processing.quantize_positions(
            positions, p.geom_scale_num, p.geom_scale_den, (0, 0, 0))
        if not self.aps:
            # geometry-only coding: drop attributes up front
            cloud = PointCloud(cloud.positions, None, None,
                               cloud.frame_index)
        qcloud = PointCloud(grid, cloud.colors, cloud.reflectances,
                            cloud.frame_index)
        # only transfer attributes that will actually be coded: with
        # attribute coding disabled the (expensive) recolouring is
        # pure waste (reference gates on the attribute set too)
        has_attrs = bool(self.aps) and (cloud.colors is not None
                                        or cloud.reflectances is not None)
        if (p.geom_scale_num != p.geom_scale_den and has_attrs
                and p.merge_duplicated_points):
            # geometry changed: reference recolours the original
            # attributes onto the quantised positions instead of
            # averaging merged duplicates (encoder.cpp:1031-1037,
            # pointset_processing.cpp:230+)
            uniq = morton_ops.decode(
                np.unique(morton_ops.encode(grid)))
            src = PointCloud(positions.astype(np.int64),
                             cloud.colors, cloud.reflectances)
            rc = recolour_ops.recolour(
                src, uniq, source_scale_num=p.geom_scale_num,
                source_scale_den=p.geom_scale_den,
                window=p.recolour_window,
                params=p.recolour_params)
            qcloud = PointCloud(uniq, rc.colors, rc.reflectances,
                                cloud.frame_index)
        elif p.merge_duplicated_points:
            qcloud = processing.dedup_with_attributes(qcloud)
        return qcloud

    def _gm_for(self, ref_grid, qcloud, ctr):
        p = self.params
        if self._motion_params is not None:
            return self._motion_params.for_frame(ctr)
        if p.global_motion:
            return motion_ops.estimate_global_motion(
                ref_grid, qcloud.positions)
        return motion_ops.identity_motion()

    def _choose_refs(self, ctr, qcloud, forced_ref=False):
        """Sequential (non-GOF) reference selection: previous frame."""
        p = self.params
        rap = max(p.random_access_period, 1)
        prev = (ctr - 1) & self._ctr_mask
        is_inter = (p.inter_prediction and prev in self._frames
                    and (forced_ref or ctr % rap != 0)
                    and p.geometry_codec in (
                        hls.GeometryCodecType.OCTREE,
                        hls.GeometryCodecType.PREDICTIVE))
        if not is_inter:
            return []
        gm = self._gm_for(self._frames[prev], qcloud, ctr)
        return [(prev, gm)]

    def _code_gof(self, out):
        """Code the buffered GOF hierarchically: P anchor first, then
        midpoint B frames (reference processHierarchicalGOF order)."""
        gof = {ctr: c for ctr, c in self._gof}
        self._gof = []
        lo = self._anchor_ctr
        hi = max(gof)
        # trailing anchor as P(lo)
        qhi = gof.pop(hi)
        mask = self._ctr_mask
        self._code_frame(qhi, hi, out,
                         [(lo, self._gm_for(self._frames[lo & mask],
                                            qhi, hi))])

        def recurse(a, b):
            mids = [c for c in sorted(gof) if a < c < b]
            if not mids:
                return
            mid = mids[len(mids) // 2]
            qc = gof.pop(mid)
            refs = [(a, self._gm_for(self._frames[a & mask], qc, mid)),
                    (b, self._gm_for(self._frames[b & mask], qc, mid))]
            self._code_frame(qc, mid, out, refs)
            recurse(a, mid)
            recurse(mid, b)

        recurse(lo, hi)
        self._anchor_ctr = hi

    def _code_frame(self, qcloud: PointCloud, ctr: int, out, refs):
        """Code one frame with 0 (intra), 1 (P) or 2 (B) references."""
        p = self.params
        frame_ctr_lsb = ctr & ((1 << self.sps.frame_ctr_bits) - 1)
        if ctr != 0:
            out(PayloadBuffer(
                PayloadType.FRAME_BOUNDARY_MARKER,
                hls.FrameBoundaryMarker(frame_ctr_lsb).write()))
        keep_ctx = bool(refs) and p.inter_entropy_continuation
        self._attr_acc = []
        self._geom_acc = []
        slices = self._partition(qcloud, out)
        # trisoup slice padding: neighbouring slices' points near each
        # slice's boundary join its vertex estimation (reference
        # pointIndexesPadding, encoder.cpp:480-494)
        pads = [None] * len(slices)
        if (self.gps.codec_type == hls.GeometryCodecType.TRISOUP
                and len(slices) > 1):
            allp = qcloud.positions.astype(np.int64)
            all_codes = morton_ops.encode(allp)
            margin = 1 << self.gps.trisoup_node_size_log2
            for i, sc in enumerate(slices):
                lo, hi = sc.bbox()
                lo = np.asarray(lo, dtype=np.int64) - margin
                hi = np.asarray(hi, dtype=np.int64) + margin
                inb = np.all((allp >= lo) & (allp <= hi), axis=1)
                # exclude the slice's own points (true membership,
                # not bbox: Morton spans interleave spatially)
                sown = np.sort(morton_ops.encode(
                    sc.positions.astype(np.int64)))
                ins = np.searchsorted(sown, all_codes)
                ins = np.minimum(ins, sown.size - 1)
                own = sown[ins] == all_codes
                sel = inb & ~own
                if sel.any():
                    pads[i] = allp[sel]
        use_par = ((p.parallel_slices > 1 or p.shard_devices > 1)
                   and len(slices) > 1
                   and not p.entropy_continuation and not keep_ctx)
        if use_par:
            # slice-parallel encode: with fresh contexts per slice the
            # bricks are independent (the reference's own parallelism
            # surface, partitioning.cpp:120-497), so each worker codes
            # one slice on a clone of this encoder (shared read-only
            # config, private context/accumulator state) and the
            # buffered payloads are emitted in slice order — the
            # stream is byte-identical to the sequential encode.  The
            # hot per-slice work is native code that releases the GIL.
            import concurrent.futures as cf
            import copy as _copy
            base_id = self._slice_id

            shard_devs = None
            if p.shard_devices > 1:
                import torch
                if torch.cuda.is_available():
                    shard_devs = list(range(min(p.shard_devices,
                                                torch.cuda.device_count())))
                elif p.engine in ("device", "rans"):
                    raise NoDeviceError(
                        "shardDevices > 1 needs CUDA devices; none found")
                # else: host engines only, so the workers run unplaced
                # (the reference's jax.devices() are then CPU devices;
                # the bytes are the same)

            def work(i):
                w = _copy.copy(self)
                w._geom_ctx = None       # forces fresh contexts
                w._attr_acc = []
                w._geom_acc = []
                w._slice_id = base_id + i
                bufs = []

                def run():
                    w._compress_slice(slices[i], frame_ctr_lsb,
                                      bufs.append, ctr=ctr, refs=refs,
                                      keep_ctx=False,
                                      pad_positions=pads[i])
                if shard_devs is not None:
                    # the current CUDA device is per thread: the device
                    # engines' default (utils/device.resolve) follows it
                    import torch
                    with torch.cuda.device(
                            shard_devs[i % len(shard_devs)]):
                        run()
                else:
                    run()
                return bufs, w._attr_acc, w._geom_acc

            with cf.ThreadPoolExecutor(
                    max_workers=max(p.parallel_slices,
                                    p.shard_devices, 2)) as ex:
                results = list(ex.map(work, range(len(slices))))
            for bufs, aacc, gacc in results:
                for b in bufs:
                    out(b)
                self._attr_acc.extend(aacc)
                self._geom_acc.extend(gacc)
            self._slice_id = base_id + len(slices)
        else:
            for i, scloud in enumerate(slices):
                self._compress_slice(scloud, frame_ctr_lsb, out,
                                     ctr=ctr, refs=refs,
                                     keep_ctx=keep_ctx,
                                     pad_positions=pads[i])
                keep_ctx = p.entropy_continuation
        # reference store = what the DECODER reconstructs (matters for
        # in-tree quantisation / trisoup where they differ from input);
        # insertion-age eviction shared with the decoder (framestore.py)
        attrs = None
        if self._attr_acc:
            # kept per attribute as (positions, values) pairs so an
            # attribute skipped in some slice (e.g. constant-coded)
            # stays aligned with its own positions
            per_idx: Dict[int, list] = {}
            for pos, vals_map in self._attr_acc:
                for i, v in vals_map.items():
                    per_idx.setdefault(i, []).append((pos, v))
            attrs = {
                i: (np.concatenate([p for p, _ in pairs]),
                    np.concatenate([v for _, v in pairs]))
                for i, pairs in per_idx.items()}
        self._frames.store(
            frame_ctr_lsb,
            np.concatenate(self._geom_acc) if self._geom_acc
            else qcloud.positions.astype(np.int64),
            attrs)

    def _ref_points_for_slice(self, refs, slice_origin, depth):
        """Compensated in-bounds reference points, slice-local
        (None when intra)."""
        if not refs:
            return None
        parts = []
        for ref_ctr, ref_gm in refs:
            ref_grid = self._frames[ref_ctr & self._ctr_mask]
            comp = motion_ops.apply_global_motion(
                ref_grid, ref_gm[0], ref_gm[1]) - slice_origin
            inb = np.all((comp >= 0) & (comp < (1 << depth)), axis=1)
            parts.append(comp[inb])
        return np.concatenate(parts)

    def _ref_codes_for_slice(self, refs, slice_origin, depth):
        """Union of the compensated reference frames' slice-local
        Morton codes (None when intra)."""
        pts = self._ref_points_for_slice(refs, slice_origin, depth)
        if pts is None:
            return None
        from ..utils import morton as morton_mod
        return np.unique(morton_mod.encode(pts))

    # -- per-slice coding (reference compressPartition,
    #    encoder.cpp:924) --------------------------------------------
    def _compress_slice(self, cloud: PointCloud, frame_ctr_lsb: int,
                        out: Callable[[PayloadBuffer], None], ctr: int = 0,
                        refs=(), keep_ctx: Optional[bool] = None,
                        pad_positions: np.ndarray = None):
        p = self.params
        refs = list(refs)
        gm = refs[0][1] if refs else None   # primary-ref motion
        slice_origin = cloud.bbox()[0]
        local = cloud.positions.astype(np.int64) - slice_origin
        qshift = max(p.geom_qp_shift, 0)
        if qshift:
            # in-tree quantisation: floor to the coarse cell (the
            # decoder reconstructs at cell centres, so |err| <= half)
            local = local >> qshift
        geom_boxes = []
        for origin, size, shift in p.geom_qp_regions:
            sh = int(shift)
            if sh <= 0:
                continue
            o = ((np.asarray(origin, dtype=np.int64) - slice_origin)
                 >> qshift)
            sz = np.asarray(size, dtype=np.int64) >> qshift
            o = (o >> sh) << sh            # align to the box grid
            sz = ((sz + (1 << sh) - 1) >> sh) << sh
            inb = np.all((local >= o) & (local < o + sz), axis=1)
            if inb.any():
                local[inb] = (local[inb] >> sh) << sh
            geom_boxes.append((tuple(int(v) for v in o),
                               tuple(int(v) for v in sz), sh))
        maxv = int(local.max()) if cloud.count else 0
        depth = max(int(maxv).bit_length(), 1) if cloud.count else 1
        # per-axis root sizes: exhausted axes drive implicit QT/BT
        axis_bits = (tuple(
            max(int(local[:, a].max()).bit_length(), 1)
            for a in range(3)) if cloud.count else (1, 1, 1))

        if keep_ctx is None:
            keep_ctx = p.entropy_continuation
        continuing = keep_ctx and self._geom_ctx is not None
        if not continuing:
            self._geom_ctx = geometry_octree.OctreeContexts()
            self._trisoup_ctx = geometry_trisoup.TrisoupContexts()
            self._predgeom_ctx = geometry_predictive.PredGeomContexts()
            self._attr_ctx = {
                i: attr_model.AttributeContexts()
                for i in range(len(self.aps))}

        with timing.span("geom.brick"):
            from ..ops import octree as octree_ops
            ctx_mode = (octree_ops.CTX_MODE_NEIGH
                        if self.gps.neighbour_context_enabled
                        else octree_ops.CTX_MODE_PARENT)
            enc = entropy.RangeEncoder()
            # 'obuf' is a brick-payload engine; the fallback paths (inter,
            # trisoup, multistream) use the auto-selected native engine
            eng = "auto" if p.engine in ("obuf", "rans") else p.engine
            trisoup = (self.gps.codec_type == hls.GeometryCodecType.TRISOUP
                       and self.gps.trisoup_node_size_log2 > 0)
            multistream = (p.num_entropy_streams > 1 and gm is None
                           and self.gps.unique_points and not trisoup
                           and self.gps.codec_type
                           == hls.GeometryCodecType.OCTREE)
            # per-node geometry QP (reference calculateNodeQps): derive a
            # shift per occupied node at the signalled depth from local
            # density; quantise the node's points, signal the shifts after
            # the tree (Morton node order)
            node_qp_depth = 0
            node_shifts = None
            if ((p.geom_qp_octree_depth > 0
                 or p.geom_qp_octree_size_log2 > 0)
                    and self.gps.codec_type == hls.GeometryCodecType.OCTREE
                    and not trisoup and not multistream and not refs
                    and not self.gps.obuf_engine and local.size):
                d = (p.geom_qp_octree_depth if p.geom_qp_octree_depth > 0
                     else max(depth - p.geom_qp_octree_size_log2, 1))
                node_qp_depth = min(d, depth - 1)
                if node_qp_depth > 0:
                    codes = morton_ops.encode(local)
                    nid = codes >> np.int64(3 * (depth - node_qp_depth))
                    uniq_n, inv, counts = np.unique(
                        nid, return_inverse=True, return_counts=True)
                    med = max(float(np.median(counts)), 1.0)
                    sh = np.zeros(uniq_n.size, dtype=np.int64)
                    sh[counts > 4 * med] = 1
                    sh[counts > 16 * med] = 2
                    sh = np.minimum(sh, max(depth - node_qp_depth - 1, 0))
                    if sh.any():
                        sp = sh[inv]
                        local = (local >> sp[:, None]) << sp[:, None]
                    node_shifts = sh
            recon_local = None
            order = None
            lpu_z0 = lpu_thr = 0
            slice_whd = (local.max(axis=0) + 1 if local.size
                         else np.ones(3, dtype=np.int64))
            if trisoup:
                pad_local = (np.asarray(pad_positions, dtype=np.int64)
                             - slice_origin
                             if pad_positions is not None else None)
                recon_local = geometry_trisoup.encode(
                    local, depth, self.gps.trisoup_node_size_log2, enc,
                    self._geom_ctx, self._trisoup_ctx,
                    engine=eng, ctx_mode=ctx_mode,
                    face_vertices=self.gps.trisoup_face_vertex_enabled,
                    halo=self.gps.trisoup_halo_enabled,
                    centroid=self.gps.trisoup_centroid_enabled,
                    pad_points=pad_local,
                    bbox_max=np.asarray(slice_whd) - 1,
                    obuf_gps=(self.gps if self.gps.obuf_engine else None),
                    device=p.device)
            elif self.gps.codec_type == hls.GeometryCodecType.PREDICTIVE:
                ref_pos = self._ref_points_for_slice(refs, slice_origin,
                                                     depth)
                lasers = None
                if self.gps.angular_enabled and self.gps.laser_theta_q:
                    lasers = (np.asarray(self.gps.laser_theta_q,
                                         dtype=np.int64),
                              np.asarray(self.gps.laser_z,
                                         dtype=np.int64),
                              np.asarray(self.gps.laser_npt,
                                         dtype=np.int64))
                pg_origin = None
                if self.gps.angular_enabled:
                    # slice-local lidar head (gbh.geomAngularOrigin)
                    pg_origin = (np.asarray(self.gps.angular_origin,
                                            dtype=np.int64)
                                 - np.asarray(slice_origin,
                                              dtype=np.int64))
                order = geometry_predictive.encode(
                    local, enc, self._predgeom_ctx,
                    sort_mode=p.predgeom_sort_mode,
                    angular=self.gps.angular_enabled,
                    ref_positions=ref_pos, lasers=lasers,
                    origin=pg_origin)
            elif self.gps.rans_engine:
                # fully on-device brick: analysis + contexts + rANS
                # entropy all run on the accelerator (models/geometry_rans)
                from ..models import geometry_rans
                payload = geometry_rans.encode(local, depth, device=p.device)
                streams = [payload]
                multistream = True   # stream is final; skip enc flush
                order = np.argsort(morton_ops.encode(local), kind="stable")
            elif self.gps.obuf_engine:
                # inter bricks run through the OBUF engine with the
                # (GM + optional LPU)-compensated reference selecting the
                # map bank per occupancy bit; an LPU refinement table is
                # carried as a leading range-coded stream of the brick
                from ..models import geometry_obuf
                ref_u = None
                lpu_stream = None
                if refs:
                    ref_pts = self._ref_points_for_slice(
                        refs, slice_origin, depth)
                    if (ref_pts is not None and len(ref_pts)
                            and self.gps.lpu_motion_enabled):
                        if p.lpu_type == 0:
                            lpu_z0, lpu_thr = motion_ops.estimate_ground(
                                ref_pts)
                            ref_pts = motion_ops.encode_lpu_motion_split(
                                enc, self._geom_ctx.lpu, ref_pts, local,
                                self.gps.lpu_size_log2, depth, lpu_z0,
                                lpu_thr)
                        else:
                            ref_pts = motion_ops.encode_lpu_motion(
                                enc, self._geom_ctx.lpu, ref_pts, local,
                                self.gps.lpu_size_log2, depth)
                        lpu_stream = enc.get_bytes()
                    if ref_pts is not None and len(ref_pts):
                        from ..utils import morton as morton_mod
                        ref_u = morton_mod.decode(
                            np.unique(morton_mod.encode(ref_pts)))
                payload = geometry_obuf.encode(
                    local, depth, axis_bits, self.gps, ref_local=ref_u)
                streams = ([lpu_stream, payload] if lpu_stream is not None
                           else [payload])
                multistream = True   # streams are final; skip enc flush
                # obuf decode emits Morton-sorted positions
                order = np.argsort(morton_ops.encode(local), kind="stable")
            elif multistream:
                streams, order = geometry_octree.encode_multistream(
                    local, depth, self._geom_ctx, p.num_entropy_streams,
                    ctx_mode=ctx_mode,
                    bytewise=self.gps.bytewise_occupancy)
            else:
                ref_pts = self._ref_points_for_slice(refs, slice_origin,
                                                     depth)
                if (ref_pts is not None and len(ref_pts)
                        and self.gps.lpu_motion_enabled):
                    # LPU refinement table heads the geometry stream
                    if p.lpu_type == 0:
                        lpu_z0, lpu_thr = motion_ops.estimate_ground(
                            ref_pts)
                        ref_pts = motion_ops.encode_lpu_motion_split(
                            enc, self._geom_ctx.lpu, ref_pts, local,
                            self.gps.lpu_size_log2, depth, lpu_z0,
                            lpu_thr)
                    else:
                        ref_pts = motion_ops.encode_lpu_motion(
                            enc, self._geom_ctx.lpu, ref_pts, local,
                            self.gps.lpu_size_log2, depth)
                ref_codes = None
                if ref_pts is not None and len(ref_pts):
                    from ..utils import morton as morton_mod
                    ref_codes = np.unique(morton_mod.encode(ref_pts))
                order = geometry_octree.encode(
                    local, depth, enc, self._geom_ctx,
                    unique_points=self.gps.unique_points,
                    engine=eng, ctx_mode=ctx_mode, ref_codes=ref_codes,
                    idcm=self.gps.inferred_direct_coding_mode > 0,
                    need_order=bool(self.aps),
                    planar=self.gps.planar_mode_enabled,
                    bytewise=self.gps.bytewise_occupancy,
                    axis_bits=axis_bits,
                    angular=_angular_for(self.gps, slice_origin),
                    device=p.device)
                if node_shifts is not None:
                    enc.ueg(self._geom_ctx.node_qp,
                            np.zeros(node_shifts.size, dtype=np.int32),
                            node_shifts.astype(np.uint32), 4, 1)
            if not multistream:
                streams = [enc.get_bytes()]

            if trisoup:
                # num_points doubles as the decoder's octree-node capacity
                # AND the sampling-loop point budget of the v2 surface
                # model (reference geom_num_points, used by the automatic
                # sub-sampling loop, geometry_trisoup_encoder.cpp:210-237)
                s = min(self.gps.trisoup_node_size_log2, depth)
                codes_u = np.unique(morton_ops.encode(local))
                n_nodes = int(np.unique(codes_u >> (3 * s)).size)
                num_points = max(int(codes_u.size), n_nodes)
            else:
                num_points = cloud.count
            ident = ((65536, 0, 0, 0, 65536, 0, 0, 0, 65536), (0, 0, 0))

            def gm_tuple(g):
                return (tuple(int(v) for v in g[0].reshape(-1)),
                        tuple(int(v) for v in g[1]))
            gm_mat, gm_trans = gm_tuple(refs[0][1]) if refs else ident
            gm_mat1, gm_trans1 = gm_tuple(refs[1][1]) if len(refs) > 1 \
                else ident
            gbh = hls.GeometryBrickHeader(
                geom_qp_shift=qshift,
                geom_qp_node_depth=node_qp_depth if node_shifts is not None
                else 0,
                geom_qp_boxes=geom_boxes,
                lpu_ground_z0=lpu_z0,
                lpu_ground_thr=lpu_thr,
                is_inter=bool(refs),
                ref0_delta=max((ctr - refs[0][0]) & self._ctr_mask, 1)
                if refs else 1,
                gm_matrix=gm_mat,
                gm_trans=gm_trans,
                is_bi=len(refs) > 1,
                ref1_delta=max((refs[1][0] - ctr) & self._ctr_mask, 1)
                if len(refs) > 1 else 1,
                gm_matrix1=gm_mat1,
                gm_trans1=gm_trans1,
                gps_id=self.gps.gps_id,
                slice_id=self._slice_id,
                frame_ctr_lsb=frame_ctr_lsb,
                slice_origin=tuple(int(v) for v in np.asarray(slice_origin)),
                slice_whd=(tuple(int(v) for v in np.asarray(slice_whd))
                           if trisoup else (0, 0, 0)),
                root_node_size_log2=depth,
                axis_bits=axis_bits,
                num_points=num_points,
                entropy_continuation=continuing,
                prev_slice_id=self._slice_id - 1,
                stream_lens=[len(s) for s in streams],
            )
            out(PayloadBuffer(PayloadType.GEOMETRY_BRICK,
                              gbh.write() + b"".join(streams)))

        # decoder-equivalent reconstructed grid positions of this slice
        from ..utils import morton as morton_mod
        if trisoup:
            rec = recon_local
        elif self.gps.codec_type == hls.GeometryCodecType.PREDICTIVE:
            rec = local
        elif self.gps.unique_points:
            rec = morton_mod.decode(np.unique(morton_mod.encode(local)))
        else:
            rec = morton_mod.decode(
                np.sort(morton_mod.encode(local)))
        if node_shifts is not None:
            nid = (morton_mod.encode(rec)
                   >> np.int64(3 * (depth - node_qp_depth)))
            uq = np.unique(nid)
            idx = np.searchsorted(uq, nid)
            sp = node_shifts[idx]
            rec = rec + ((np.int64(1) << sp) >> 1)[:, None] \
                * (sp > 0)[:, None]
        for origin, size, shift in geom_boxes:
            o = np.asarray(origin, dtype=np.int64)
            inb = np.all((rec >= o)
                         & (rec < o + np.asarray(size,
                                                 dtype=np.int64)),
                         axis=1)
            if inb.any():
                rec = rec.copy()
                rec[inb] += (1 << shift) >> 1
        if qshift:
            rec = (rec << qshift) + (1 << (qshift - 1))
        self._geom_acc.append(rec + np.asarray(slice_origin,
                                               dtype=np.int64))

        with timing.span("attr.brick"):
            if not self.aps:
                coded = None
                dec_positions = None
            elif trisoup or qshift or geom_boxes \
                    or node_shifts is not None:
                # geometry changed: transfer attributes onto the decoded
                # positions (reference recolour, encoder.cpp:1031-1037)
                from ..ops import recolour as recolour_ops
                from ..utils import morton as morton_mod
                if trisoup:
                    src = PointCloud(local, cloud.colors, cloud.reflectances)
                    coded = recolour_ops.recolour(src, recon_local)
                    dec_positions = recon_local
                else:
                    dec_positions = morton_mod.decode(
                        np.unique(morton_mod.encode(local)))
                    src = PointCloud(
                        cloud.positions.astype(np.int64) - slice_origin,
                        cloud.colors, cloud.reflectances)
                    coded = recolour_ops.recolour(
                        src, dec_positions, source_scale_num=1,
                        source_scale_den=1 << qshift)
            else:
                # decoded-order positions for the attribute transforms
                coded = cloud.take(order)
                dec_positions = coded.positions.astype(np.int64) - slice_origin

            # a float predicted RAHT colour brick runs its transform on
            # the card where there is one, as the decoder does
            # (models/attr_raht.py); the same bytes either way
            card = cuda_or_none(p.device)
            for i, (aps, desc) in enumerate(zip(self.aps,
                                                self.sps.attributes)):
                values = (coded.colors if desc.label == "color"
                          else coded.reflectances)
                if values is None:
                    continue
                values = np.asarray(values)
                if desc.attr_scale != 1 or desc.attr_offset != 0:
                    # scaleAttributesForInput (reference TMC3.cpp:2233-2236)
                    values = (values.astype(np.int64) - desc.attr_offset
                              + desc.attr_scale // 2) // desc.attr_scale
                if desc.cicp_matrix == 8:
                    values = processing.rgb_to_ycgcor(values)
                elif desc.cicp_matrix == 1:
                    values = processing.rgb_to_ycbcr_bt709(
                        values, desc.bitdepth)
                # constant attribute shortcut (reference constant-attribute
                # data unit, decoder.cpp:994); values are in the coded
                # colourspace so the decoder's inverse applies uniformly.
                # ue(v) coding needs non-negative: bias by bitdepth+1 range.
                flat = values.reshape(values.shape[0], -1)
                if flat.size and np.all(flat == flat[0]):
                    bias = 1 << (desc.bitdepth + 1)
                    out(PayloadBuffer(
                        PayloadType.CONSTANT_ATTRIBUTE,
                        hls.ConstantAttribute(
                            aps_id=aps.aps_id, sps_attr_idx=i,
                            slice_id=self._slice_id,
                            values=tuple(int(v) + bias
                                         for v in flat[0])).write()))
                    if aps.inter_prediction_enabled:
                        # keep the reference pool identical to the decoder's
                        self._attr_acc.append(
                            (dec_positions + slice_origin,
                             {i: values.astype(np.int64)}))
                    continue
                # inter attribute prediction: compensated reference points
                # + their decoded values join the predictor pool
                ref = None
                if aps.inter_prediction_enabled and refs:
                    stored = self._frames.attrs(refs[0][0] & self._ctr_mask)
                    if i in stored:
                        rp, rv = stored[i]
                        g = refs[0][1]
                        comp = motion_ops.apply_global_motion(
                            rp, g[0], g[1]) - slice_origin
                        inb = np.all((comp >= 0) & (comp < (1 << depth)),
                                     axis=1)
                        if inb.any():
                            ref = (comp[inb], np.asarray(rv)[inb])
                acfg = p.attributes[i]
                regions = []
                for origin, size, offs in acfg.qp_regions:
                    o = ((np.asarray(origin, dtype=np.int64)
                          - slice_origin) >> qshift)
                    sz = np.asarray(size, dtype=np.int64) >> qshift
                    regions.append((tuple(int(v) for v in o),
                                    tuple(int(v) for v in sz),
                                    (int(offs[0]), int(offs[1]))))
                abh = hls.AttributeBrickHeader(
                    aps_id=aps.aps_id, sps_attr_idx=i,
                    slice_id=self._slice_id,
                    layer_qp_deltas_luma=list(acfg.layer_qp_offsets_luma),
                    layer_qp_deltas_chroma=list(
                        acfg.layer_qp_offsets_chroma),
                    qp_regions=regions)
                need_recon = aps.inter_prediction_enabled
                ctx_copy = self._attr_ctx[i].copy() if need_recon else None
                body = attr_model.encode(
                    values, dec_positions, aps, desc, self._attr_ctx[i],
                    ref=ref, abh=abh, device=card)
                if need_recon:
                    recon = attr_model.decode(
                        body, dec_positions, aps, desc, ctx_copy, ref=ref,
                        abh=abh, device=card)
                    self._attr_acc.append(
                        (dec_positions + slice_origin,
                         {i: np.asarray(recon)}))
                out(PayloadBuffer(PayloadType.ATTRIBUTE_BRICK,
                                  abh.write() + body))
        self._slice_id += 1
