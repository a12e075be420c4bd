"""tmc3-compatible CLI and sequence encoder/decoder.

Counterpart of the reference `main`/`SequenceEncoder`/`SequenceDecoder`
(TMC3.cpp:220-259, 2153-2440): `--mode=0` encodes a PLY (sequence) to a
TLV stream, `--mode=1` decodes it back.  Accepts the same core option
names and `name: value` config files as the reference so the CTC harness
scripts drive it unchanged.  Options not yet meaningful to this
framework are accepted and ignored with a notice (printed once), so
reference-generated cfg trees run as-is.

Run: python -m mpeg_pcc_tmc13_tpu_torch.runtime.cli --mode=0 \
       --uncompressedDataPath=in.ply --compressedStreamPath=out.bin

This is the PyTorch + CUDA port's copy of
``mpeg_pcc_tmc13_tpu/runtime/cli.py``: the same options and the same
bytes.  ``--device=<torch device>`` places the on-device geometry
engines (``--geomEngine=device|rans``, and the decode of rANS bricks);
unset, they take the current CUDA device and refuse to run without one.
``--shardDevices=N`` (N > 1) places the slice workers on the first N
CUDA devices instead, so it is refused together with ``--device``.
The host-only paths (``--refSyntax=1``, the host geometry engines, every
attribute codec) need no device and ask for none.  A float predicted
RAHT colour brick (last-component prediction on, the CLI's default) runs
its transform on the CUDA device that ``--device`` names, or unset on the
current one, on encode and on decode alike, and on the host where there
is none: the same bytes and values either way.
"""

from __future__ import annotations

import sys
import time
from typing import Dict, List, Optional

import numpy as np

from ..bitstream import hls
from ..bitstream.tlv import iter_tlv, write_tlv
from ..models.pointcloud import PointCloud
from ..utils import options as opt
from ..utils import ply

from .. import __version__
from ..utils.device import NoDeviceError
from .decoder import FrameDecoder
from .encoder import AttributeConfig, EncoderParams, FrameEncoder

# Reference option names accepted without behavioural change.  Three
# groups: (a) the framework's default behaviour already matches the
# reference semantics for CTC values, (b) encoder-internal tuning with
# no normative effect on this framework's design, (c) harness/metric
# options that belong to the experiment scripts.  Each name's
# disposition is documented in docs/OPTIONS.md.
# reference options that map 1:1 onto RefAps/RefGps syntax fields the
# conformance engines honor (packed into the native params arrays:
# decoder.py _predlift_params / RAHT params / predgeom_params_array).
_REF_APS_OPTIONS = {
    "rahtPredictionSearchRange": ("raht_prediction_search_range", int),
    "rahtSubnodePredictionEnabled": ("raht_subnode_prediction",
                                     lambda v: bool(int(v))),
    "rahtExtension": ("raht_extension", lambda v: bool(int(v))),
    "rahtEnableCodeLayer": ("raht_enable_code_layer",
                            lambda v: bool(int(v))),
    "rahtInterPredictionDepthMinus1": ("raht_inter_depth_minus1", int),
    "rahtInterSendFilters": ("raht_send_inter_filters",
                             lambda v: bool(int(v))),
    "rahtInterSkipFilteringLayers": ("raht_inter_skip_layers", int),
    "attrInterPredSearchRange": ("attr_inter_pred_search_range", int),
    "interLodSearchRange": ("inter_lod_search_range", int),
    "intraLodSearchRange": ("intra_lod_search_range", int),
    "canonical_point_order_flag": ("canonical_point_order",
                                   lambda v: bool(int(v))),
    "predWeightBlending": ("pred_weight_blending",
                           lambda v: bool(int(v))),
    "predictionWithDistributionEnabled": (
        "prediction_with_distribution", lambda v: bool(int(v))),
    "max_points_per_sort_log2_plus1": (
        "max_points_per_sort_log2_plus1", int),
    "lod_neigh_bias": ("lod_neigh_bias", lambda v: tuple(
        int(x) for x in v.replace(",", " ").split())),
    "quantNeighWeight": ("quant_neigh_weight", lambda v: [
        int(x) for x in v.replace(",", " ").split()]),
}
_REF_GPS_OPTIONS = {
    "positionAzimuthScaleLog2": ("azimuth_scale_log2_minus11",
                                 lambda v: int(v) - 11),
    "positionAzimuthSpeed": ("azimuth_speed_minus1",
                             lambda v: int(v) - 1),
    "positionRadiusInvScaleLog2": ("radius_inv_scale_log2", int),
    "predGeomMaxPredIdx": ("predgeom_max_pred_index", int),
    "predGeomRadiusPredThreshold": ("predgeom_radius_threshold", int),
    "jointTwoPointIdcm": ("joint_2pt_idcm", lambda v: bool(int(v))),
    "planarBufferDisabled": ("planar_buffer_disabled",
                             lambda v: bool(int(v))),
    "interIDCMPredEnabled": ("inter_idcm", lambda v: bool(int(v))),
    "octreeAngularExtension": ("octree_angular_extension",
                               lambda v: bool(int(v))),
    "disable_planar_IDCM_angluar": ("planar_disabled_idcm_angular",
                                    lambda v: bool(int(v))),
}

_ACCEPTED_REFERENCE_OPTIONS = {
    # (a) defaults already provided
    "neighborsProc", "enforceLevelLimits", "intra_pred_max_node_size_log2",
    "positionQuantisationMethod", "deriveGMThreshold",
    "trisoup_sampling_value", "safeTrisoupPartionning",
    "autoSeqBbox",
    # (b) encoder-internal / tuning knobs without a counterpart in
    # this framework's redesign
    "QPShiftStep", "aps_slice_qp_deltas_present_flag",
    "attrSphericalMaxLog2",
    "dist2PercentileEstimate",
    "enableGroundPartition", "externalScale", "frameMergeEnabled",
    "globalMotionSrcType", "gmThresholdHistScale",
    "gmThresholdLeftScale", "gmThresholdMaxZ", "gmThresholdMinZ",
    "gmThresholdRightScale", "interAzimScaleLog2",
    "intraLodPredictionSkipLayers", "lodDecimator", "max_neigh_range", "nodeUniqueDSE", "pointCountMetadata", "positionBaseQpFreqLog2",
    "positionIdcmQp", "positionQpMultiplierLog2",
    "positionQuantizationScaleAdjustsDist2",
    "positionSliceQpFreqLog2",
    "positionSliceQpOffset", "predGeomAzimuthSortPrecision", "predGeomMaxPredIdxTested", "predGeomTreePtsMax",
    "resRContextQphiThreshold",
    "resRContextQphiThresholdPresentFlag", "resamplingEnabled",
    "sortInputByAzimuth",
    "spherical_coord_flag", "trisoupAdaptiveHaloEnabled",
    "trisoupFineRayTracingEnabled", "trisoupImprovedEncoderEnabled",
    "trisoupNonCubicNodeFarFromOriginSideEnabled",
    "trisoupNonCubicNodeNearOriginSideEnabled",
    "trisoupQuantizationBits", "use_cuboidal_regions_in_GM_estimation",
    "lodSamplingPeriod0",
    # (c) harness / metric / io options
    "hausdorff", "resolution", "norm", "outputPrecisionBits",
    "outputScaling", "outputUnitLength", "srcUnit", "srcUnitLength",
    "preInvScalePath", "postRecolorPath", "outputSystem",
    "reflectance8b16b_scale_factor",
}


def usage() -> str:
    return (
        "tmc3-compatible CLI: --mode=0 encode / --mode=1 decode; "
        "accepts the reference option names (name=value or cfg "
        "files).  See docs/OPTIONS.md for the full option table.")


_TRANSFORM_TYPES = {
    0: hls.AttributeEncoding.RAHT,
    1: hls.AttributeEncoding.PRED,
    2: hls.AttributeEncoding.LIFT,
    3: hls.AttributeEncoding.RAW,
}


class Config:
    """Effective configuration after option processing."""

    def __init__(self):
        self.mode = 0
        self.skip_octree_layers = 0
        self.decode_max_points = 0
        self.max_lod_levels = 0
        self.uncompressed_path: Optional[str] = None
        self.compressed_path: Optional[str] = None
        self.reconstructed_path: Optional[str] = None
        self.first_frame = 0
        self.frame_count = 1
        self.output_binary_ply = True
        self.convert_colourspace = True
        # tmc3 default: bypass bins coded without probability update
        # (TMC3.cpp:824-827); honoured by the refSyntax engine
        self.bypass_no_update = True
        self.cabac_bypass = False
        self.params = EncoderParams()
        self.disable_attributes = False
        # reference-syntax (tmc3-interoperable) codec path.
        # None = unset: encode defaults to the native syntax; decode
        # auto-detects the family from the stream's SPS payload.
        self.ref_syntax = None
        self.attr_slice_rdo = False
        self.adjacent_child = True
        self.bitwise_occ = True
        self.secondary_residual_disabled = False
        self.azimuth_quantization = True
        self.neighbour_avail_log2 = 8
        self.ref_aps_overrides: Dict[str, object] = {}
        self.ref_gps_overrides: Dict[str, object] = {}
        self.attr_inter_translation_threshold = 1000.0
        self.qtbt_enabled = True
        self.ignored: List[str] = []
        # recognised reference options recorded without behavioural
        # change (see _ACCEPTED_REFERENCE_OPTIONS)
        self.accepted: Dict[str, str] = {}
        self.slice_max_trisoup = 0
        self.seq_origin = None
        self.seq_bbox_whd = None
        self.recolour_window = 8
        # options the user actually supplied (CLI or cfg file); any
        # other option keeps a default, which under --refSyntax=1 is
        # pinned to tmc3's option-table default (TMC3.cpp:632-1553)
        # by _apply_ref_syntax_defaults so a zero-flag encode matches
        # tmc3 byte for byte
        self.explicit: set = set()
        # per --attribute snapshot of which sticky attribute options
        # the user set (parallel to params.attributes)
        self.attr_explicit: List[set] = []
        # reference planarModeIdcmUse (geom_idcm_rate = value,
        # signalled minus 1); -1 = unset, which disables IDCM mode 1
        # (sanitizeEncoderOpts, TMC3.cpp:1666-1669)
        self.planar_idcm_use = -1
        # sticky per-attribute pending state (reference TMC3.cpp:1247)
        self._pending_attr: Dict[str, str] = {}

    def apply(self, name: str, value: str):
        p = self.params
        self.explicit.add(name)
        try:
            if name == "mode":
                self.mode = opt.to_int(value)
            elif name == "uncompressedDataPath":
                self.uncompressed_path = value
            elif name == "compressedStreamPath":
                self.compressed_path = value
            elif name == "reconstructedDataPath":
                self.reconstructed_path = value
            elif name == "firstFrameNum":
                self.first_frame = opt.to_int(value)
            elif name == "frameCount":
                self.frame_count = opt.to_int(value)
            elif name == "outputBinaryPly":
                self.output_binary_ply = opt.to_bool(value)
            elif name == "convertPlyColourspace":
                self.convert_colourspace = opt.to_bool(value)
            elif name in ("positionQuantizationScale", "codingScale",
                          "sequenceScale", "inputScale"):
                num, den = opt.float_to_rational(opt.to_float(value))
                p.geom_scale_num, p.geom_scale_den = num, den
            elif name == "mergeDuplicatedPoints":
                p.merge_duplicated_points = opt.to_bool(value)
            elif name == "sliceMaxPoints":
                p.max_points_per_slice = opt.to_int(value)
            elif name == "sliceMinPoints":
                p.min_points_per_slice = opt.to_int(value)
            elif name == "partitionMethod":
                from ..ops.partition import PartitionMethod
                v = opt.to_int(value)
                # reference value 1 (deprecated) maps to NPTS
                p.partition_method = (PartitionMethod(v)
                                      if v in PartitionMethod._value2member_map_
                                      else PartitionMethod.NPTS)
            elif name == "partitionOctreeDepth":
                p.partition_octree_depth = opt.to_int(value)
            elif name == "tileSize":
                p.tile_size = opt.to_int(value)
            elif name == "entropyContinuationEnabled":
                p.entropy_continuation = opt.to_bool(value)
            elif name == "numOctreeEntropyStreams":
                p.num_entropy_streams = max(opt.to_int(value), 1)
            elif name == "parallelSlices":
                # framework extension: host thread-pool over slices
                # (byte-identical stream; needs continuation off)
                p.parallel_slices = max(opt.to_int(value), 0)
            elif name == "InterEntropyContinuationEnabled":
                p.inter_entropy_continuation = opt.to_bool(value)
            elif name == "trisoupNodeSizeLog2":
                v = opt.to_int(value.split()[0]) if value else 0
                p.trisoup_node_size_log2 = v
                if v > 0:
                    p.geometry_codec = hls.GeometryCodecType.TRISOUP
            elif name == "trisoupFaceVertexEnabled":
                p.trisoup_face_vertex_enabled = opt.to_bool(value)
            elif name == "trisoupHaloEnabled":
                p.trisoup_halo_enabled = opt.to_bool(value)
            elif name == "geomTreeType":
                p.geometry_codec = (hls.GeometryCodecType.PREDICTIVE
                                    if opt.to_int(value)
                                    else hls.GeometryCodecType.OCTREE)
            elif name == "angularEnabled":
                p.angular_enabled = opt.to_bool(value)
            elif name == "lidarHeadPosition":
                p.angular_origin = tuple(
                    int(float(t)) for t in
                    value.replace(",", " ").split())
            elif name == "numLasers":
                pass   # implied by the table lengths
            elif name == "lasersTheta":
                p.laser_theta = [float(t) for t in
                                 value.replace(",", " ").split()]
            elif name == "lasersZ":
                p.laser_z = [int(float(t)) for t in
                             value.replace(",", " ").split()]
            elif name == "lasersNumPhiPerTurn":
                p.laser_npt = [int(t) for t in
                               value.replace(",", " ").split()]
            elif name == "planarEnabled":
                p.planar_enabled = opt.to_bool(value)
            elif name in ("planarModeThreshold0", "planarModeThreshold1",
                          "planarModeThreshold2"):
                i = int(name[-1])
                th = list(p.planar_thresholds)
                th[i] = opt.to_int(value)
                p.planar_thresholds = tuple(th)
            elif name == "multiplePlanarEnabled":
                p.multiple_planar = opt.to_bool(value)
            elif name == "octreeDepthPlanarEligibilityEnabled":
                p.depth_planar_eligibility = opt.to_bool(value)
            elif name == "octreePlanarDynamicOBUFEligibilityEnabled":
                p.planar_dynamic_obuf = opt.to_bool(value)
            elif name == "maxNumQtBtBeforeOt":
                p.qtbt_max_before_ot = opt.to_int(value)
            elif name == "minQtbtSizeLog2":
                p.qtbt_min_size_log2 = opt.to_int(value)
            elif name == "zCompensationEnabled":
                p.z_compensation = opt.to_bool(value)
            elif name == "trisoupCentroidResidualEnabled":
                p.trisoup_centroid_enabled = opt.to_bool(value)
            elif name == "sliceMaxPointsTrisoup":
                self.slice_max_trisoup = opt.to_int(value)
            elif name == "positionQuantisationEnabled":
                if not opt.to_bool(value):
                    p.geom_qp_shift = 0
                    p.geom_qp_octree_depth = 0
                    p.geom_qp_octree_size_log2 = 0
            elif name == "positionQuantisationOctreeDepth":
                p.geom_qp_octree_depth = max(opt.to_int(value), 0)
            elif name == "positionQuantisationOctreeSizeLog2":
                p.geom_qp_octree_size_log2 = max(opt.to_int(value), 0)
            elif name == "seqOrigin":
                self.seq_origin = tuple(
                    int(float(t)) for t in
                    value.replace(",", " ").split())
            elif name == "seqSizeWhd":
                self.seq_bbox_whd = tuple(
                    int(float(t)) for t in
                    value.replace(",", " ").split())
            elif name == "autoSeqBbox":
                if opt.to_bool(value):
                    self.seq_origin = None
                    self.seq_bbox_whd = None
            elif name == "recolourSearchRange":
                from ..ops import recolour as recolour_ops
                if p.recolour_params is None:
                    p.recolour_params = recolour_ops.RecolourParams()
                # reference searchRange scales the candidate window
                self.recolour_window = 8 * max(opt.to_int(value), 1)
            elif name == "dropdups":
                p.merge_duplicated_points = opt.to_bool(value)
            elif name == "help":
                print(usage())
                raise SystemExit(0)
            elif name == "refSyntax":   # framework-specific
                self.ref_syntax = opt.to_bool(value)
            elif name == "bypassBinCodingWithoutProbUpdate":
                self.bypass_no_update = opt.to_bool(value)
            elif name == "cabac_bypass_stream_enabled_flag":
                self.cabac_bypass = opt.to_bool(value)
            elif name == "qtbtEnabled":
                self.qtbt_enabled = opt.to_bool(value)
            elif name == "inferredDirectCodingMode":
                p.idcm = opt.to_int(value) > 0
                p.idcm_mode = opt.to_int(value)
            elif name == "planarModeIdcmUse":
                # reference geom_idcm_rate (signalled minus 1);
                # <1 disables IDCM mode 1 (TMC3.cpp:1666-1669)
                self.planar_idcm_use = opt.to_int(value)
            elif name == "geometry_axis_order":
                p.axis_order = hls.AxisOrder(opt.to_int(value))
            elif name == "positionBaseQp":
                # one octave per 6 QP (reference QP->stepsize law)
                p.geom_qp_shift = max(opt.to_int(value), 0) // 6
            elif name == "disableAttributeCoding":
                self.disable_attributes = opt.to_bool(value)
            elif name.startswith("recolour") or name.startswith("recolor"):
                # the 13 recolour* options (reference TMC3.cpp:1501-1549)
                key = {
                    "NumNeighboursFwd": "num_neighbours_fwd",
                    "NumNeighboursBwd": "num_neighbours_bwd",
                    "UseDistWeightedAvgFwd": "use_dist_weighted_avg_fwd",
                    "UseDistWeightedAvgBwd": "use_dist_weighted_avg_bwd",
                    "SkipAvgIfIdenticalSourcePointPresentFwd":
                        "skip_avg_if_identical_fwd",
                    "SkipAvgIfIdenticalSourcePointPresentBwd":
                        "skip_avg_if_identical_bwd",
                    "DistOffsetFwd": "dist_offset_fwd",
                    "DistOffsetBwd": "dist_offset_bwd",
                    "MaxGeometryDist2Fwd": "max_geometry_dist2_fwd",
                    "MaxGeometryDist2Bwd": "max_geometry_dist2_bwd",
                    "MaxAttributeDist2Fwd": "max_attribute_dist2_fwd",
                    "MaxAttributeDist2Bwd": "max_attribute_dist2_bwd",
                }.get(name.replace("recolour", "").replace("recolor", ""))
                if key is None:
                    self.ignored.append(name)
                else:
                    from ..ops import recolour as recolour_ops
                    if p.recolour_params is None:
                        p.recolour_params = recolour_ops.RecolourParams()
                    cur = getattr(p.recolour_params, key)
                    setattr(p.recolour_params, key,
                            opt.to_bool(value) if isinstance(cur, bool)
                            else type(cur)(float(value)))
            elif name == "neighbourAvailBoundaryLog2":
                # reference semantics: 0 disables the neighbour atlas
                p.neighbour_context = opt.to_int(value) > 0
                # refSyntax GPS: tmc3 stores minus1=0 when disabled
                self.neighbour_avail_log2 = max(opt.to_int(value), 1)
            elif name == "bytewiseOccupancyCoder":  # framework-specific
                p.bytewise_occupancy = opt.to_bool(value)
            elif name == "geomEngine":   # framework-specific
                p.engine = value.strip()
            elif name == "device":   # port-specific: a torch device
                p.device = value.strip() or None
            elif name == "shardDevices":  # framework-specific
                p.shard_devices = opt.to_int(value)
            elif name == "interPredictionEnabled":
                p.inter_prediction = opt.to_bool(value)
            elif name == "randomAccessPeriod":
                p.random_access_period = opt.to_int(value)
            elif name == "globalMotionEnabled":
                p.global_motion = opt.to_bool(value)
            elif name == "biPredictionEnabled":
                p.bi_prediction = opt.to_int(value) > 0
            elif name in ("biPredictionPeriod", "predictionPeriod"):
                # tmc3 names this option predictionPeriod
                # (TMC3.cpp:1137-1140)
                p.bi_period = opt.to_int(value)
            elif name == "lpuType":
                p.lpu_motion = True
                p.lpu_type = opt.to_int(value) if value else 1
            elif name == "lpuSizeLog2":   # framework-specific
                p.lpu_size_log2 = max(opt.to_int(value), 2)
            elif name == "motionVectorPath":
                p.motion_file = value.strip()
            elif name == "globalMotionBlockSize":
                # reference: comma list per axis (TMC3.cpp:1167-1171)
                vals = [int(v) for v in value.split(",")]
                vals = (vals + [0, 0, 0])[:3]
                p.motion_block_size = tuple(vals)
            elif name == "globalMotionWindowSize":
                p.motion_window_size = opt.to_int(value)
            elif name == "skipOctreeLayers":
                self.skip_octree_layers = opt.to_int(value)
            elif name == "decodeMaxPoints":
                self.decode_max_points = opt.to_int(value)
            elif name == "maxLodLevels":   # framework-specific
                self.max_lod_levels = opt.to_int(value)
            # ---- sticky attribute params ----
            elif name in ("qp", "bitdepth", "transformType", "integerHaar",
                          "rahtFixedPoint",
                          "qpChromaOffset", "attrScale", "attrOffset",
                          "defaultValue", "colourMatrix", "dist2",
                          "attrInterPredictionEnabled",
                          "rahtPredictionEnabled", "levelOfDetailCount",
                          "numberOfNearestNeighborsInPrediction",
                          "maxNumDirectPredictors",
                          "adaptivePredictionThreshold",
                          "qpLayerOffsetsLuma",
                          "qpLayerOffsetsChroma",
                          "lastComponentPredictionEnabled",
                          "interComponentPredictionEnabled",
                          "aps_scalable_enable_flag",
                          "rahtPredictionThreshold0",
                          "rahtPredictionThreshold1",
                          "rahtPredictionWeights",
                          "lodSamplingPeriod"):
                self._pending_attr[name] = value
            elif name == "predGeomSort":
                from ..models.geometry_predictive import SortMode
                p.predgeom_sort_mode = SortMode(opt.to_int(value))
            elif name == "direct_avg_predictor_disabled_flag":
                self._pending_attr[name] = value
            elif name == "attributeInterPredictionEnabled":
                self._pending_attr["attrInterPredictionEnabled"] = value
            elif name == "adjacentChildContextualization":
                self.adjacent_child = opt.to_bool(value)
            elif name == "bitwiseOccupancyCoding":
                self.bitwise_occ = opt.to_bool(value)
            elif name == "secondaryResidualDisabled":
                self.secondary_residual_disabled = opt.to_bool(value)
            elif name == "predGeomAzimuthQuantization":
                self.azimuth_quantization = opt.to_bool(value)
            elif name in _REF_APS_OPTIONS:
                f, conv = _REF_APS_OPTIONS[name]
                self.ref_aps_overrides[f] = conv(value)
            elif name in _REF_GPS_OPTIONS:
                f, conv = _REF_GPS_OPTIONS[name]
                self.ref_gps_overrides[f] = conv(value)
            elif name == "attrInterIntraSliceRDO":
                # two-pass inter/intra slice decision for pred/lift
                # (AttributeEncoder.cpp:498-580)
                self.attr_slice_rdo = opt.to_bool(value)
            elif name == "attrInterPredTranslationThresh":
                self.attr_inter_translation_threshold = \
                    float(value)
            elif name == "max_num_direct_predictors":
                self._pending_attr["maxNumDirectPredictors"] = value
            elif name in _ACCEPTED_REFERENCE_OPTIONS:
                # recognised reference option whose reference-default
                # behaviour this framework already provides (or whose
                # effect is non-normative / encoder-internal); recorded
                # but does not change behaviour.  docs/OPTIONS.md lists
                # every accepted name and its disposition.
                self.accepted[name] = value
            elif name == "attribute":
                a = self._pending_attr
                # remember which per-attribute options were explicit so
                # --refSyntax=1 can pin the rest to tmc3's defaults
                self.attr_explicit.append(set(a.keys()))
                enc_t = _TRANSFORM_TYPES[int(a.get("transformType", "0"))]
                # reference default is BT.709 (TMC3.cpp:1270
                # ColourMatrix::kBt709); the lossless CTC cfgs override
                # to 8 (YCgCo-R) for reversibility.  Matching the
                # default matters for RD: YCgCo-R chroma has twice the
                # amplitude of Cb/Cr, which shifts the lossy-attr
                # deadzone cliff ~6 QP finer.
                cicp = int(a.get("colourMatrix", "1"))
                if not self.convert_colourspace:
                    cicp = 0
                self.params.attributes.append(AttributeConfig(
                    label=value.strip(),
                    bitdepth=int(a.get("bitdepth", "8")),
                    encoding=enc_t,
                    qp=int(a.get("qp", "4")),
                    qp_chroma_offset=int(a.get("qpChromaOffset", "0")),
                    raht_integer_haar=opt.to_bool(a.get("integerHaar", "0")),
                    raht_fixed_point=opt.to_bool(
                        a.get("rahtFixedPoint", "1")),
                    cicp_matrix=cicp,
                    attr_scale=int(a.get("attrScale", "1")),
                    attr_offset=int(a.get("attrOffset", "0")),
                    dist2=int(float(a.get("dist2", "0").split()[0]))
                    if a.get("dist2") else 0,
                    inter_pred=opt.to_bool(
                        a.get("attrInterPredictionEnabled", "0")),
                    raht_prediction=opt.to_bool(
                        a.get("rahtPredictionEnabled", "1")),
                    # reference semantics: the option counts REFINEMENT
                    # layers (TMC3.cpp:1374 note), default 1 -> two
                    # total levels with an auto-estimated dist2 base
                    # levelOfDetailCount maps to the reference's
                    # minus1 semantics when given; unset, this encoder
                    # defaults to a deep LoD pyramid (capped by the
                    # point count) — the reference's 2-level default
                    # is strictly RD-dominated on dense content
                    lod_levels=(int(a["levelOfDetailCount"]) + 1
                                if "levelOfDetailCount" in a else 12),
                    ref_num_detail_levels_minus1=(
                        int(a["levelOfDetailCount"])
                        if "levelOfDetailCount" in a else 1),
                    num_pred_nearest_neighbours=min(int(
                        a.get("numberOfNearestNeighborsInPrediction",
                              "3")), 3),
                    max_direct_predictors=min(int(
                        a.get("maxNumDirectPredictors", "3")), 3),
                    adaptive_prediction_threshold=int(
                        a.get("adaptivePredictionThreshold", "64")),
                    layer_qp_offsets_luma=_int_list(
                        a.get("qpLayerOffsetsLuma", "")),
                    layer_qp_offsets_chroma=_int_list(
                        a.get("qpLayerOffsetsChroma", "")),
                    # tmc3 default TRUE (TMC3.cpp:1404-1406)
                    last_component_prediction=opt.to_bool(
                        a.get("lastComponentPredictionEnabled", "1")),
                    inter_component_prediction=opt.to_bool(
                        a.get("interComponentPredictionEnabled",
                              "0")),
                    scalable_lifting=opt.to_bool(
                        a.get("aps_scalable_enable_flag", "0")),
                    raht_pred_threshold0=int(
                        a.get("rahtPredictionThreshold0", "2")),
                    raht_pred_threshold1=int(
                        a.get("rahtPredictionThreshold1", "6")),
                    raht_pred_weights=tuple(
                        (_int_list(a["rahtPredictionWeights"]) + [1, 1])[:3]
                        if a.get("rahtPredictionWeights") else (9, 3, 1)),
                    lod_sampling_period=max(int(
                        a.get("lodSamplingPeriod", "4")), 2),
                ))
            else:
                self.ignored.append(name)
        except (ValueError, KeyError) as e:
            raise opt.OptionError(f"option {name}={value!r}: {e}") from e


def _int_list(v: str) -> List[int]:
    """Reference list syntax: comma- or space-separated ints."""
    return [int(t) for t in v.replace(',', ' ').split()]


def parse_command_line(argv: List[str]) -> Config:
    cfg = Config()
    for name, value in opt.parse_argv(argv):
        cfg.apply(name, value)
    if cfg.disable_attributes:
        cfg.params.attributes = []
    return cfg


def _ply_to_cloud(pcloud: ply.PlyCloud) -> PointCloud:
    return PointCloud(
        positions=np.round(pcloud.positions).astype(np.int64),
        colors=pcloud.colors,
        reflectances=pcloud.reflectances,
        frame_index=pcloud.frame_indices,
    )


def _cloud_to_ply(cloud: PointCloud) -> ply.PlyCloud:
    return ply.PlyCloud(
        positions=cloud.positions.astype(np.float64),
        colors=cloud.colors,
        reflectances=cloud.reflectances,
    )


def _notice_accepted(cfg: Config) -> None:
    """Reference options recorded without behavioural change get one
    visible notice per run (silent acceptance would hide non-default
    CTC variants behaving differently from tmc3)."""
    if cfg.accepted:
        names = ", ".join(sorted(cfg.accepted))
        print(f"NOTE: options recorded without effect: {names}")


# tmc3 encoder option-table defaults (TMC3.cpp:632-1553) that differ
# from this framework's native-syntax defaults.  Under --refSyntax=1
# any option the user did not set is pinned to the tmc3 default so a
# zero-flag encode is byte-identical to a zero-flag tmc3 encode.
_TMC3_ENCODE_DEFAULTS = (
    ("planarEnabled", "1"),                    # TMC3.cpp:898
    ("neighbourAvailBoundaryLog2", "0"),       # TMC3.cpp:872
    ("adjacentChildContextualization", "1"),   # TMC3.cpp:890
    ("inferredDirectCodingMode", "1"),         # TMC3.cpp:878
    ("partitionMethod", "4"),                  # TMC3.cpp:781
    ("sliceMinPoints", "550000"),              # TMC3.cpp:808
    ("qtbtEnabled", "1"),                      # TMC3.cpp:849
    ("maxNumQtBtBeforeOt", "4"),               # TMC3.cpp:853
    ("predictionPeriod", "1"),                 # TMC3.cpp:1137
)


def _apply_ref_syntax_defaults(cfg: Config) -> None:
    """Pin unset options to tmc3's defaults and replay the relevant
    sanitizeEncoderOpts rules (TMC3.cpp:1624-2060) so --refSyntax=1
    with no extra flags emits tmc3's zero-flag stream."""
    for name, value in _TMC3_ENCODE_DEFAULTS:
        if name not in cfg.explicit:
            cfg.apply(name, value)
    p = cfg.params
    # planarModeIdcmUse defaults to -1: IDCM mode 1 is disabled
    # (TMC3.cpp:1666-1669); modes >1 force the rate to full
    if cfg.planar_idcm_use < 1 and p.idcm_mode == 1:
        p.idcm_mode = 0
        p.idcm = False
    # the occupancy atlas gates adjacent-child contextualization
    # (TMC3.cpp:2013-2023); neighbour_avail_log2 is clamped to 1
    # (minus1=0) when the atlas is disabled
    if cfg.neighbour_avail_log2 <= 1:
        cfg.adjacent_child = False
    # tmc3's per-attribute transformType default is Pred
    # (TMC3.cpp:1290 AttributeEncoding::kPredictingTransform)
    for i, a in enumerate(p.attributes):
        if (i < len(cfg.attr_explicit)
                and "transformType" not in cfg.attr_explicit[i]):
            a.encoding = hls.AttributeEncoding.PRED


def encode_sequence_ref_syntax(cfg: Config) -> int:
    """Encode to the reference (tmc3-decodable) syntax via the
    bit-exact conformance engine (geometry, and the first colour or
    reflectance attribute)."""
    _notice_accepted(cfg)
    from ..conformance import encoder as refenc
    from ..conformance import ref_hls
    from ..utils.timing import Stopwatch
    from ..ops import processing
    p = cfg.params
    # attribute coding: first configured color/reflectance attribute
    # rides the conformance RAHT engine (native/refattr.cc)
    attr_cfg = next(
        (a for a in p.attributes
         if a.encoding in (hls.AttributeEncoding.RAHT,
                           hls.AttributeEncoding.PRED,
                           hls.AttributeEncoding.LIFT)), None)
    sw = Stopwatch().start()
    frames = []
    colors = [] if (attr_cfg and attr_cfg.label == "color") else None
    refls = ([] if (attr_cfg and attr_cfg.label != "color"
                    and colors is None) else None)
    npts = 0
    for i in range(cfg.frame_count):
        sw.stop()   # ply read outside the clock (TMC3.cpp:2231)
        path = ply.expand_num(cfg.uncompressed_path, cfg.first_frame + i)
        cloud = ply.read(path)
        pos = np.round(cloud.positions).astype(np.int64)
        sw.start()
        npts += pos.shape[0]
        if p.geom_scale_num != 1 or p.geom_scale_den != 1:
            pos = np.floor(pos * p.geom_scale_num / p.geom_scale_den
                           + 0.5).astype(np.int64)
        pos -= pos.min(axis=0).clip(max=0)     # keep non-negative
        frames.append(pos)
        if colors is not None:
            rgb = np.asarray(cloud.colors, dtype=np.int64)
            if cfg.convert_colourspace and attr_cfg.cicp_matrix == 8:
                # YCgCo-R chroma is offset by 1<<bitdepth and coded
                # one bit wider (colourspace.h:84-99, TMC3.cpp:1846)
                ycc = processing.rgb_to_ycgcor(rgb)
                off = 1 << attr_cfg.bitdepth
                ycc[..., 1] += off
                ycc[..., 2] += off
                colors.append(ycc)
            elif cfg.convert_colourspace and attr_cfg.cicp_matrix:
                # BT.709 is the tmc3 default matrix (TMC3.cpp:1270)
                colors.append(processing.rgb_to_ycbcr_bt709(rgb))
            else:
                # internal coding order is GBR (PCCPointSet3)
                colors.append(rgb[:, [1, 2, 0]])
        elif refls is not None:
            refls.append(np.asarray(cloud.reflectances,
                                    dtype=np.int64))
        print(f"frame {cfg.first_frame + i}: {pos.shape[0]} points")
    stream = refenc.encode_frames(
        frames, unique_points=p.merge_duplicated_points,
        planar=p.planar_enabled, qtbt=cfg.qtbt_enabled,
        idcm=p.idcm_mode,
        inter=p.inter_prediction,
        global_motion=p.global_motion,
        bi_prediction=bool(p.bi_prediction),
        bi_prediction_period=max(p.bi_period, 1),
        random_access_period=max(p.random_access_period, 1),
        motion_block_size=tuple(
            max(64, int(round(v * p.geom_scale_num / p.geom_scale_den)))
            if v > 0 else 0 for v in p.motion_block_size),
        motion_window_size=max(2, int(round(
            p.motion_window_size * p.geom_scale_num
            / p.geom_scale_den))),
        predgeom=(p.geometry_codec == hls.GeometryCodecType.PREDICTIVE),
        angular=bool(p.angular_enabled and p.laser_theta),
        angular_head=tuple(p.angular_origin or (0, 0, 0)),
        lasers_theta=p.laser_theta, lasers_z=p.laser_z,
        lasers_num_phi=p.laser_npt,
        max_points_per_slice=(cfg.slice_max_trisoup
                              if cfg.slice_max_trisoup
                              and p.trisoup_node_size_log2
                              else 1_100_000),
        trisoup_node_size_log2=p.trisoup_node_size_log2,
        colors=colors, reflectances=refls,
        attr_qp=attr_cfg.qp if attr_cfg else 34,
        attr_qp_chroma_offset=(attr_cfg.qp_chroma_offset
                               if attr_cfg else 0),
        attr_bitdepth=((attr_cfg.bitdepth + 1)
                       if (attr_cfg and colors is not None
                           and cfg.convert_colourspace
                           and attr_cfg.cicp_matrix == 8)
                       else attr_cfg.bitdepth if attr_cfg else 8),
        integer_haar=(attr_cfg.raht_integer_haar
                      if attr_cfg else False),
        attr_cicp_matrix=(attr_cfg.cicp_matrix
                          if attr_cfg else 1),
        bypass_no_update=cfg.bypass_no_update,
        cabac_bypass=cfg.cabac_bypass,
        attr_slice_rdo=cfg.attr_slice_rdo,
        attr_inter_translation_threshold=(
            cfg.attr_inter_translation_threshold),
        adjacent_child=cfg.adjacent_child,
        bitwise_occupancy=cfg.bitwise_occ,
        neighbour_avail_boundary_log2=cfg.neighbour_avail_log2,
        secondary_residual_disabled=cfg.secondary_residual_disabled,
        azimuth_quantization=cfg.azimuth_quantization,
        gps_overrides=cfg.ref_gps_overrides,
        aps_overrides=cfg.ref_aps_overrides,
        attr_aps=(refenc.derive_default_aps(
            {hls.AttributeEncoding.RAHT: 0,
             hls.AttributeEncoding.PRED: 1,
             hls.AttributeEncoding.LIFT: 2}[attr_cfg.encoding],
            attr_qp=attr_cfg.qp,
            attr_qp_chroma_offset=attr_cfg.qp_chroma_offset,
            integer_haar=attr_cfg.raht_integer_haar,
            num_detail_levels_minus1=(
                attr_cfg.ref_num_detail_levels_minus1),
            lod_decimation_type=0,
            dist2=attr_cfg.dist2,
            inter_component_prediction=(
                attr_cfg.inter_component_prediction),
            last_component_prediction=(
                attr_cfg.last_component_prediction),
            attr_inter_prediction=attr_cfg.inter_pred,
            raht_send_inter_filters=getattr(
                attr_cfg, "raht_send_inter_filters", False))
                  if attr_cfg else None))
    # record the coding scale in the SPS-equivalent position: our
    # decoder descales by sps.seq_scale (tmc3 treats it as seq unit)
    if p.geom_scale_num != 1 or p.geom_scale_den != 1:
        # rewrite the SPS with the coding scale
        parts = []
        for t, payload in ref_hls.iter_ref_tlv(stream):
            if t == ref_hls.T_SPS:
                sps = ref_hls.parse_sps(payload)
                sps.seq_scale_num = p.geom_scale_num
                sps.seq_scale_den = p.geom_scale_den
                payload = ref_hls.write_sps(sps)
            parts.append(ref_hls.write_ref_tlv(t, payload))
        stream = b"".join(parts)
    with open(cfg.compressed_path, "wb") as f:
        f.write(stream)
    sw.stop()
    geom_b = sum(len(pl) for t, pl in ref_hls.iter_ref_tlv(stream)
                 if t == ref_hls.T_GEOM_BRICK)
    attr_b = sum(len(pl) for t, pl in ref_hls.iter_ref_tlv(stream)
                 if t == ref_hls.T_ATTR_BRICK)
    n = max(npts, 1)
    print(f"positions bitstream size {geom_b} B "
          f"({8 * geom_b / n:.3f} bpp)")
    if attr_b:
        label = ("colors" if colors is not None else "reflectances")
        print(f"{label} bitstream size {attr_b} B "
              f"({8 * attr_b / n:.3f} bpp)")
    print(f"Total bitstream size {len(stream)} B")
    print(f"Processing time (user): {sw.user:.3f} s")
    print(f"Processing time (wall): {sw.wall:.3f} s")
    return 0


def decode_sequence_ref_syntax(cfg: Config) -> int:
    """Decode a reference-syntax (tmc3) stream (geometry + RAHT
    attributes)."""
    from ..conformance import decoder as refdec
    from ..conformance import ref_hls
    from ..ops import processing
    from ..utils.timing import Stopwatch
    sw = Stopwatch().start()
    data = open(cfg.compressed_path, "rb").read()
    frames, attrs = refdec.decode_stream(data, want_attrs=True)
    # descale by the signalled sequence scale; colour handling needs
    # the attribute label (colour vs reflectance)
    scale = (1.0, 1.0)
    attr_labels = []
    cicp = None
    for t, payload in ref_hls.iter_ref_tlv(data):
        if t == ref_hls.T_SPS:
            sps = ref_hls.parse_sps(payload)
            scale = (float(sps.seq_scale_num),
                     float(sps.seq_scale_den))
            attr_labels = list(sps.attr_labels or [])
            if sps.attr_cicp_matrix:
                cicp = sps.attr_cicp_matrix[0]
            break
    is_colour = bool(attr_labels) and attr_labels[0] == 0
    for i, pos in enumerate(frames):
        out = pos.astype(np.float64)
        if scale != (1.0, 1.0):
            out = out * (scale[1] / scale[0])
        col = refl = None
        a = attrs[i] if attrs and i < len(attrs) else None
        if a is not None and is_colour:
            if cfg.convert_colourspace and cicp == 8:
                # signalled bitdepth is chroma width (bitdepth+1);
                # the offset is 1 << (true bitdepth)
                bd = (sps.attr_bitdepths[0] - 1
                      if sps.attr_bitdepths else 8)
                ycc = a.astype(np.int64)
                ycc[..., 1] -= 1 << bd
                ycc[..., 2] -= 1 << bd
                col = processing.ycgcor_to_rgb(ycc, bitdepth=bd)
            elif cfg.convert_colourspace and cicp:
                col = processing.ycbcr_bt709_to_rgb(
                    a.astype(np.int64), bitdepth=8)
            else:
                # internal GBR -> ply RGB
                col = np.asarray(a)[:, [2, 0, 1]]
            col = np.asarray(col, dtype=np.uint8)
        elif a is not None:
            refl = np.asarray(a[:, 0], dtype=np.uint16)
        sw.stop()   # ply write outside the clock (TMC3.cpp:2437)
        if cfg.reconstructed_path:
            path = ply.expand_num(cfg.reconstructed_path,
                                  cfg.first_frame + i)
            ply.write(ply.PlyCloud(positions=out, colors=col,
                                   reflectances=refl), path,
                      ascii=not cfg.output_binary_ply)
        sw.start()
        print(f"frame {cfg.first_frame + i}: {pos.shape[0]} points")
    sw.stop()
    print(f"Processing time (user): {sw.user:.3f} s")
    print(f"Processing time (wall): {sw.wall:.3f} s")
    return 0


def encode_sequence(cfg: Config) -> int:
    _notice_accepted(cfg)
    from ..bitstream.tlv import PayloadType
    from ..utils.timing import Stopwatch
    enc = FrameEncoder(cfg.params)
    sw = Stopwatch().start()
    with open(cfg.compressed_path, "wb") as fout:
        sizes = {"total": 0, "geom": 0, "npts": 0}
        attr_sizes: dict = {}

        def emit(buf):
            sizes["total"] += len(buf.data) + 5
            if buf.type == PayloadType.GEOMETRY_BRICK:
                sizes["geom"] += len(buf.data)
            elif buf.type == PayloadType.ATTRIBUTE_BRICK:
                # first ue in the ABH is the aps id -> attribute label
                from ..bitstream.hls import (
                    AttributeBrickHeader)
                abh, _ = AttributeBrickHeader.parse(buf.data)
                label = (enc.sps.attributes[abh.sps_attr_idx].label
                         if enc.sps else str(abh.sps_attr_idx))
                attr_sizes[label] = attr_sizes.get(label, 0) \
                    + len(buf.data)
            write_tlv(buf, fout)

        for i in range(cfg.frame_count):
            # PLY reading sits outside the processing clock, like the
            # reference (TMC3.cpp:2231 clock->start() after ply::read)
            sw.stop()
            path = ply.expand_num(cfg.uncompressed_path, cfg.first_frame + i)
            src = _ply_to_cloud(ply.read(path))
            sw.start()
            sizes["npts"] += src.count
            enc.compress(src, emit)
            print(f"frame {cfg.first_frame + i}: {src.count} points")
        enc.flush(emit)
    sw.stop()
    n = max(sizes["npts"], 1)
    # per-payload stats in the reference's log shape (encoder.cpp:1009)
    print(f"positions bitstream size {sizes['geom']} B "
          f"({8 * sizes['geom'] / n:.3f} bpp)")
    for label, nbytes in attr_sizes.items():
        print(f"{label}s bitstream size {nbytes} B "
              f"({8 * nbytes / n:.3f} bpp)")
    print(f"Total bitstream size {sizes['total']} B")
    print(f"Processing time (user): {sw.user:.3f} s")
    print(f"Processing time (wall): {sw.wall:.3f} s")
    return 0


def decode_sequence(cfg: Config) -> int:
    from ..utils.timing import Stopwatch
    frames = []
    sw = Stopwatch().start()
    dec = FrameDecoder(frames.append,
                       skip_layers=cfg.skip_octree_layers,
                       max_points=cfg.decode_max_points,
                       max_lod_levels=cfg.max_lod_levels,
                       device=cfg.params.device)
    with open(cfg.compressed_path, "rb") as f:
        for buf in iter_tlv(f):
            dec.decompress(buf)
    dec.flush()
    # PLY writing sits outside the processing clock, like the
    # reference (TMC3.cpp:2437 onOutputCloud pauses the clock)
    sw.stop()
    for i, cloud in enumerate(frames):
        if cfg.reconstructed_path:
            path = ply.expand_num(cfg.reconstructed_path,
                                  cfg.first_frame + i)
            ply.write(_cloud_to_ply(cloud), path,
                      ascii=not cfg.output_binary_ply)
        print(f"frame {cfg.first_frame + i}: {cloud.count} points")
    print(f"Processing time (user): {sw.user:.3f} s")
    print(f"Processing time (wall): {sw.wall:.3f} s")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    print(f"mpeg_pcc_tmc13_tpu_torch v{__version__} "
          f"(G-PCC on PyTorch + CUDA)")
    try:
        cfg = parse_command_line(sys.argv[1:] if argv is None else argv)
    except opt.OptionError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    if cfg.ignored:
        print("ignored options (not yet meaningful on this framework): "
              + ", ".join(sorted(set(cfg.ignored))))
    # resolve deferred/cross-option effects
    p = cfg.params
    if (cfg.slice_max_trisoup
            and p.geometry_codec == hls.GeometryCodecType.TRISOUP):
        p.max_points_per_slice = cfg.slice_max_trisoup
    if cfg.seq_origin is not None:
        p.seq_origin = cfg.seq_origin
    if cfg.seq_bbox_whd is not None:
        p.seq_bbox_whd = cfg.seq_bbox_whd
    if p.recolour_params is not None:
        p.recolour_window = cfg.recolour_window
    if not cfg.compressed_path:
        print("error: compressedStreamPath required", file=sys.stderr)
        return 1
    if p.shard_devices > 1 and p.device is not None:
        # the slice workers go round-robin over the first N cards; an
        # explicit --device would pin every one of them to one device
        print(f"error: --shardDevices={p.shard_devices} places the slice "
              f"workers on the first {p.shard_devices} CUDA devices and "
              f"cannot be combined with --device={p.device}; give one of "
              "the two", file=sys.stderr)
        return 1
    if cfg.mode == 0 and not cfg.uncompressed_path:
        print("error: uncompressedDataPath required", file=sys.stderr)
        return 1
    if cfg.mode != 0 and cfg.ref_syntax is None:
        cfg.ref_syntax = detect_ref_syntax(cfg.compressed_path)
    try:
        if cfg.mode == 0:
            if cfg.ref_syntax:
                _apply_ref_syntax_defaults(cfg)
                return encode_sequence_ref_syntax(cfg)
            return encode_sequence(cfg)
        if cfg.ref_syntax:
            return decode_sequence_ref_syntax(cfg)
        return decode_sequence(cfg)
    except (NotImplementedError, NoDeviceError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


def detect_ref_syntax(path) -> bool:
    """Syntax-family detection from the stream itself.

    Both families are TLV-framed (io_tlv.cpp framing); the SPS payload
    bit layout differs and each parser rejects the other's with a
    bounds error, so decode needs no --refSyntax flag (reference
    decoder dispatch: decoder.cpp:302-418).  Native syntax wins an
    (unobserved) ambiguous double-parse."""
    import io as _io

    from ..bitstream import hls, tlv
    from ..conformance import ref_hls
    try:
        head = open(path, "rb").read(1 << 16)
    except OSError:
        return False
    try:
        for buf in tlv.iter_tlv(_io.BytesIO(head)):
            if buf.type == tlv.PayloadType.SEQUENCE_PARAMETER_SET:
                s = hls.SequenceParameterSet.parse(buf.data)
                # a foreign SPS can parse "successfully" into garbage;
                # require plausible field ranges before accepting the
                # stream as native syntax
                if (0 <= s.sps_id < 16
                        and 0 < s.frame_ctr_bits <= 32
                        and s.geom_scale_num > 0
                        and s.geom_scale_den > 0):
                    return False
            break   # SPS is the first unit in well-formed streams
    except Exception:
        pass
    try:
        for t, pl in ref_hls.iter_ref_tlv(head):
            if t == ref_hls.T_SPS:
                ref_hls.parse_sps(pl)
                return True
            break
    except Exception:
        pass
    return False


if __name__ == "__main__":
    sys.exit(main())
