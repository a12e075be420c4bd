"""Payload dispatcher & frame reassembly.

Counterpart of `PCCTMC3Decoder3::decompress` (reference
decoder.cpp:302-418): parameter-set storage/activation, frame-boundary
detection via `frame_ctr_lsb` (decoder.cpp:101-140), geometry/attribute
brick decode, slice accumulation into the output cloud, inverse global
scale on output.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np

from ..bitstream import entropy, hls
from ..bitstream.tlv import PayloadBuffer, PayloadType
from ..models import pointcloud as pc
from .framestore import FrameStore

from ..models import attributes as attr_model
from ..models import geometry_octree, geometry_predictive, geometry_trisoup
from ..ops import processing
from ..utils import timing
from ..utils.device import cuda_or_none


def _grid_positions(local: np.ndarray,
                    gbh: "hls.GeometryBrickHeader") -> np.ndarray:
    """Slice-local coded positions -> frame grid (undo in-tree
    quantisation to voxel centres, add the slice origin)."""
    if gbh.geom_qp_boxes:
        local = local.copy()
        for origin, size, shift in gbh.geom_qp_boxes:
            o = np.asarray(origin, dtype=np.int64)
            inb = np.all((local >= o)
                         & (local < o + np.asarray(size,
                                                   dtype=np.int64)),
                         axis=1)
            local[inb] += (1 << shift) >> 1
    if gbh.geom_qp_shift:
        local = ((local << gbh.geom_qp_shift)
                 + (1 << (gbh.geom_qp_shift - 1)))
    return local + np.asarray(gbh.slice_origin, dtype=np.int64)


@dataclass
class _SliceState:
    positions: np.ndarray                 # grid coords, coding order
    local: np.ndarray                     # slice-local, coding order
    attrs: Dict[int, np.ndarray] = field(default_factory=dict)
    gbh: Optional[hls.GeometryBrickHeader] = None


class FrameDecoder:
    """Feed TLV payloads in stream order; frames come out via callback.

    skip_layers / max_points: scalable partial decode (reference
    skipOctreeLayers / decodeMaxPoints, decoder.cpp:698-710).
    device: torch device of the rANS brick decode; None = the current
    CUDA device, raising when there is none (utils/device.resolve).
    The stream decides that a brick is rANS, so such a stream never
    decodes on the host unasked.  A float predicted RAHT colour brick
    runs its transform, and a QT/BT octree brick its level walk, on that
    device when it is a CUDA device (None: where one exists), on the
    host otherwise; the values are the same.  The counter
    ``geom.card_levels`` (opened at 0 a geometry brick) counts the QT/BT
    levels whose context bases the card computed.
    """

    def __init__(self, on_output_cloud: Callable[[pc.PointCloud], None],
                 skip_layers: int = 0, max_points: int = 0,
                 max_lod_levels: int = 0, device=None):
        self.device = device
        self.skip_layers = skip_layers
        self.max_points = max_points
        # progressive attribute decode (PRED transform): only the first
        # N LoD chunks are entropy-decoded, finer points predict-only
        self.max_lod_levels = max_lod_levels
        self.on_output_cloud = on_output_cloud
        self.sps: Dict[int, hls.SequenceParameterSet] = {}
        self.gps: Dict[int, hls.GeometryParameterSet] = {}
        self.aps: Dict[int, hls.AttributeParameterSet] = {}
        # received user-data units (opaque; surfaced to the application)
        self.user_data: List[hls.UserData] = []
        # soft default attribute values from param inventories
        self._attr_defaults: Dict[int, tuple] = {}
        self.active_sps: Optional[hls.SequenceParameterSet] = None
        self._slices: List[_SliceState] = []
        self._frame_ctr_lsb: Optional[int] = None
        self._geom_ctx: Optional[geometry_octree.OctreeContexts] = None
        self._trisoup_ctx: Optional[geometry_trisoup.TrisoupContexts] = None
        self._predgeom_ctx: Optional[
            geometry_predictive.PredGeomContexts] = None
        self._attr_ctx: Dict[int, attr_model.AttributeContexts] = {}
        # decoded frames' grid positions by frame_ctr_lsb (reference
        # storeCurrentCloudAsRef decoder.cpp:165; bi-pred ref lists
        # PCCTMC3Common.h:345) + display-order reorder buffer
        # (processHierarchicalGOF, decoder.cpp:500-557); retention
        # policy shared with the encoder (framestore.py)
        self._frames = FrameStore()
        self._pending: Dict[int, pc.PointCloud] = {}
        self._next_out: Optional[int] = None

    # ------------------------------------------------------------------
    def decompress(self, buf: PayloadBuffer):
        t = buf.type
        if t == PayloadType.SEQUENCE_PARAMETER_SET:
            s = hls.SequenceParameterSet.parse(buf.data)
            self.sps[s.sps_id] = s
            self.active_sps = s
        elif t == PayloadType.GEOMETRY_PARAMETER_SET:
            g = hls.GeometryParameterSet.parse(buf.data)
            self.gps[g.gps_id] = g
        elif t == PayloadType.ATTRIBUTE_PARAMETER_SET:
            a = hls.AttributeParameterSet.parse(buf.data)
            self.aps[a.aps_id] = a
        elif t == PayloadType.FRAME_BOUNDARY_MARKER:
            m = hls.FrameBoundaryMarker.parse(buf.data)
            self._detect_frame_boundary(m.frame_ctr_lsb)
        elif t == PayloadType.GEOMETRY_BRICK:
            with timing.span("geom.brick"):
                self._decode_geometry_brick(buf.data)
        elif t == PayloadType.ATTRIBUTE_BRICK:
            with timing.span("attr.brick"):
                self._decode_attribute_brick(buf.data)
        elif t == PayloadType.CONSTANT_ATTRIBUTE:
            c = hls.ConstantAttribute.parse(buf.data)
            if self._slices:
                sl = self._slices[-1]
                n = sl.positions.shape[0]
                desc = self.active_sps.attributes[c.sps_attr_idx]
                bias = 1 << (desc.bitdepth + 1)
                vals = np.asarray(c.values, dtype=np.int64) - bias
                sl.attrs[c.sps_attr_idx] = (
                    np.full(n, vals[0], dtype=np.int64) if vals.size == 1
                    else np.tile(vals, (n, 1)))
        elif t == PayloadType.ATTR_PARAM_INVENTORY:
            inv = hls.AttributeParamInventory.parse(buf.data)
            # parameters apply from inv.frame_ctr_lsb on: flush any
            # buffered earlier frame under the OLD parameters first
            self._detect_frame_boundary(inv.frame_ctr_lsb)
            if (self.active_sps is not None
                    and inv.sps_attr_idx
                    < len(self.active_sps.attributes)):
                desc = self.active_sps.attributes[inv.sps_attr_idx]
                if inv.cicp_matrix is not None:
                    desc.cicp_matrix = inv.cicp_matrix
                if inv.attr_scale is not None:
                    desc.attr_scale = inv.attr_scale
                    desc.attr_offset = inv.attr_offset
                if inv.default_value is not None:
                    self._attr_defaults[inv.sps_attr_idx] = \
                        inv.default_value
        elif t == PayloadType.USER_DATA:
            self.user_data.append(hls.UserData.parse(buf.data))
        elif t in (PayloadType.TILE_INVENTORY,
                   PayloadType.DEFAULT_ATTRIBUTE):
            pass  # informational
        else:
            raise ValueError(f"unknown payload type {t}")

    def flush(self):
        """End of stream: emit pending frames (display order)."""
        if self._slices:
            self._output_frame()
        for ctr in sorted(self._pending):
            self.on_output_cloud(self._pending.pop(ctr))

    # -- frame boundary (reference dectectFrameBoundary,
    #    decoder.cpp:101) ---------------------------------------------
    def _detect_frame_boundary(self, frame_ctr_lsb: int):
        if (self._frame_ctr_lsb is not None
                and frame_ctr_lsb != self._frame_ctr_lsb
                and self._slices):
            self._output_frame()
        self._frame_ctr_lsb = frame_ctr_lsb

    # -- geometry brick (reference decodeGeometryBrick,
    #    decoder.cpp:573) ---------------------------------------------
    def _decode_geometry_brick(self, data: bytes):
        gbh, off = hls.GeometryBrickHeader.parse(data)
        self._detect_frame_boundary(gbh.frame_ctr_lsb)
        timing.count("geom.card_levels", 0)
        gps = self.gps[gbh.gps_id]

        continuing = gbh.entropy_continuation and self._geom_ctx is not None
        if not continuing:
            self._geom_ctx = geometry_octree.OctreeContexts()
            self._trisoup_ctx = geometry_trisoup.TrisoupContexts()
            self._predgeom_ctx = geometry_predictive.PredGeomContexts()
            self._attr_ctx = {i: attr_model.AttributeContexts()
                              for i in self.aps}

        from ..ops import octree as octree_ops
        ctx_mode = (octree_ops.CTX_MODE_NEIGH
                    if gps.neighbour_context_enabled
                    else octree_ops.CTX_MODE_PARENT)
        streams = []
        pos = off
        for ln in gbh.stream_lens:
            streams.append(data[pos:pos + ln])
            pos += ln
        if (gps.rans_engine
                and gps.codec_type == hls.GeometryCodecType.OCTREE
                and not gbh.is_inter):
            from ..models import geometry_rans
            if self.skip_layers or self.max_points:
                raise NotImplementedError(
                    "scalable decode of rANS bricks")
            local = geometry_rans.decode(
                streams[-1], gbh.num_points, gbh.root_node_size_log2,
                device=self.device)
            grid = _grid_positions(local, gbh)
            self._slices.append(
                _SliceState(positions=grid, local=local, gbh=gbh))
            return
        if (gps.obuf_engine
                and gps.codec_type == hls.GeometryCodecType.OCTREE):
            from ..models import geometry_obuf
            ref_u = None
            if gbh.is_inter:
                from ..ops import motion as motion_ops
                from ..utils import morton as morton_mod
                pts = self._ref_points_for_gbh(gbh)
                if (pts is not None and len(pts)
                        and gps.lpu_motion_enabled
                        and len(streams) > 1):
                    # LPU refinement table leads the brick as its own
                    # range-coded stream
                    lpu_dec = entropy.RangeDecoder(streams[0])
                    if gbh.lpu_ground_thr > 0:
                        pts = motion_ops.decode_lpu_motion_split(
                            lpu_dec, self._geom_ctx.lpu, pts,
                            gps.lpu_size_log2,
                            gbh.root_node_size_log2,
                            gbh.lpu_ground_z0, gbh.lpu_ground_thr)
                    else:
                        pts = motion_ops.decode_lpu_motion(
                            lpu_dec, self._geom_ctx.lpu, pts,
                            gps.lpu_size_log2,
                            gbh.root_node_size_log2)
                if pts is not None and len(pts):
                    ref_u = morton_mod.decode(
                        np.unique(morton_mod.encode(pts)))
            local = geometry_obuf.decode(
                streams[-1], gbh.num_points, gbh.root_node_size_log2,
                gbh.axis_bits, gps, ref_local=ref_u,
                skip_layers=self.skip_layers,
                max_points=self.max_points)
            grid = _grid_positions(local, gbh)
            self._slices.append(
                _SliceState(positions=grid, local=local, gbh=gbh))
            return
        if (len(streams) > 1
                and gps.codec_type == hls.GeometryCodecType.OCTREE
                and self.skip_layers == 0 and self.max_points == 0):
            local = geometry_octree.decode_multistream(
                gbh.num_points, gbh.root_node_size_log2, streams,
                self._geom_ctx, ctx_mode=ctx_mode,
                bytewise=gps.bytewise_occupancy)
            grid = _grid_positions(local, gbh)
            self._slices.append(
                _SliceState(positions=grid, local=local, gbh=gbh))
            return
        stream = streams[0]
        dec = entropy.RangeDecoder(stream)
        if (gps.codec_type == hls.GeometryCodecType.TRISOUP
                and gps.trisoup_node_size_log2 > 0):
            local = geometry_trisoup.decode(
                gbh.root_node_size_log2, gps.trisoup_node_size_log2, dec,
                self._geom_ctx, self._trisoup_ctx,
                max_nodes=gbh.num_points, ctx_mode=ctx_mode,
                face_vertices=gps.trisoup_face_vertex_enabled,
                halo=gps.trisoup_halo_enabled,
                centroid=gps.trisoup_centroid_enabled,
                bbox_max=(np.asarray(gbh.slice_whd, dtype=np.int64) - 1
                          if any(gbh.slice_whd) else None),
                obuf_gps=(gps if gps.obuf_engine else None))
        elif gps.codec_type == hls.GeometryCodecType.PREDICTIVE:
            ref_pos = None
            if gbh.is_inter:
                ref_pos = self._ref_points_for_gbh(gbh)
            lasers = None
            if gps.angular_enabled and gps.laser_theta_q:
                lasers = (np.asarray(gps.laser_theta_q,
                                     dtype=np.int64),
                          np.asarray(gps.laser_z, dtype=np.int64),
                          np.asarray(gps.laser_npt,
                                     dtype=np.int64))
            pg_origin = None
            if gps.angular_enabled:
                pg_origin = (np.asarray(gps.angular_origin,
                                        dtype=np.int64)
                             - np.asarray(gbh.slice_origin,
                                          dtype=np.int64))
            local = geometry_predictive.decode(
                gbh.num_points, dec, self._predgeom_ctx,
                angular=gps.angular_enabled, ref_positions=ref_pos,
                lasers=lasers, origin=pg_origin)
        else:
            ref_codes = None
            if gbh.is_inter:
                from ..ops import motion as motion_ops
                from ..utils import morton as morton_mod
                pts = self._ref_points_for_gbh(gbh)
                if (pts is not None and len(pts)
                        and gps.lpu_motion_enabled):
                    if gbh.lpu_ground_thr > 0:
                        pts = motion_ops.decode_lpu_motion_split(
                            dec, self._geom_ctx.lpu, pts,
                            gps.lpu_size_log2,
                            gbh.root_node_size_log2,
                            gbh.lpu_ground_z0, gbh.lpu_ground_thr)
                    else:
                        pts = motion_ops.decode_lpu_motion(
                            dec, self._geom_ctx.lpu, pts,
                            gps.lpu_size_log2,
                            gbh.root_node_size_log2)
                if pts is not None and len(pts):
                    ref_codes = np.unique(morton_mod.encode(pts))
            from .encoder import _angular_for
            local = geometry_octree.decode(
                gbh.num_points, gbh.root_node_size_log2, dec,
                self._geom_ctx, unique_points=gps.unique_points,
                ctx_mode=ctx_mode, ref_codes=ref_codes,
                idcm=gps.inferred_direct_coding_mode > 0,
                skip_layers=self.skip_layers,
                max_points=self.max_points,
                planar=gps.planar_mode_enabled,
                bytewise=gps.bytewise_occupancy,
                axis_bits=gbh.axis_bits,
                angular=_angular_for(gps, gbh.slice_origin),
                device=cuda_or_none(self.device))
        loc_grid = local
        if (gbh.geom_qp_node_depth > 0 and self.skip_layers == 0
                and not self.max_points):
            # per-node geometry QP: shifts follow the tree in Morton
            # node order; recentre each node's points by half a cell
            from ..utils import morton as morton_mod
            d = gbh.root_node_size_log2 - gbh.geom_qp_node_depth
            nid = morton_mod.encode(local) >> np.int64(3 * d)
            uq = np.unique(nid)
            sh = dec.ueg(self._geom_ctx.node_qp,
                         np.zeros(uq.size, dtype=np.int32),
                         4, 1).astype(np.int64)
            if sh.any():
                idx = np.searchsorted(uq, nid)
                sp = sh[idx]
                loc_grid = local + (((np.int64(1) << sp) >> 1)
                                    * (sp > 0))[:, None]
        grid = _grid_positions(loc_grid, gbh)
        self._slices.append(_SliceState(positions=grid, local=local,
                                        gbh=gbh))

    @property
    def _ctr_mask(self) -> int:
        """frame_ctr mask from the active SPS (single source of truth
        with the encoder's sps.frame_ctr_bits)."""
        bits = self.active_sps.frame_ctr_bits if self.active_sps else 8
        return (1 << bits) - 1

    def _ref_points_for_gbh(self, gbh):
        """Compensated in-bounds reference points for an inter brick
        (mirrors FrameEncoder._ref_points_for_slice exactly).

        Raises on a missing reference frame rather than silently
        decoding an inter-coded stream through intra contexts, which
        would produce garbage points or a misleading capacity error.
        """
        from ..ops import motion as motion_ops
        mask = self._ctr_mask
        depth = gbh.root_node_size_log2
        origin = np.asarray(gbh.slice_origin, dtype=np.int64)
        refs = [((gbh.frame_ctr_lsb - gbh.ref0_delta) & mask,
                 gbh.gm_matrix, gbh.gm_trans)]
        if gbh.is_bi:
            refs.append(((gbh.frame_ctr_lsb + gbh.ref1_delta) & mask,
                         gbh.gm_matrix1, gbh.gm_trans1))
        parts = []
        for rc, mat, trans in refs:
            grid = self._frames.get(rc)
            if grid is None:
                raise ValueError(
                    f"inter brick (frame_ctr_lsb={gbh.frame_ctr_lsb}) "
                    f"references frame {rc} which is not in the "
                    f"decoded-frame store (lost or evicted)")
            comp = motion_ops.apply_global_motion(
                grid, np.asarray(mat, dtype=np.int64).reshape(3, 3),
                np.asarray(trans, dtype=np.int64)) - origin
            inb = np.all((comp >= 0) & (comp < (1 << depth)), axis=1)
            parts.append(comp[inb])
        return np.concatenate(parts) if parts else None

    # -- attribute brick (reference decodeAttributeBrick,
    #    decoder.cpp:781) ---------------------------------------------
    def _decode_attribute_brick(self, data: bytes):
        if self.skip_layers > 0 or self.max_points > 0:
            # partial geometry decode: attribute streams describe the
            # full-resolution cloud — geometry-only output (scalable
            # attribute decode needs scalable lifting, later round)
            return
        abh, off = hls.AttributeBrickHeader.parse(data)
        aps = self.aps[abh.aps_id]
        desc = self.active_sps.attributes[abh.sps_attr_idx]
        assert self._slices, "attribute brick before geometry brick"
        sl = self._slices[-1]
        # inter attribute prediction (mirrors the encoder exactly)
        ref = None
        gbh = sl.gbh
        if (aps.inter_prediction_enabled and gbh is not None
                and gbh.is_inter):
            from ..ops import motion as motion_ops
            stored = self._frames.attrs(
                (gbh.frame_ctr_lsb - gbh.ref0_delta) & self._ctr_mask)
            if abh.sps_attr_idx in stored:
                rp, rv = stored[abh.sps_attr_idx]
                mat = np.asarray(gbh.gm_matrix,
                                 dtype=np.int64).reshape(3, 3)
                trans = np.asarray(gbh.gm_trans, dtype=np.int64)
                comp = motion_ops.apply_global_motion(rp, mat, trans) \
                    - np.asarray(gbh.slice_origin, dtype=np.int64)
                depth = gbh.root_node_size_log2
                inb = np.all((comp >= 0) & (comp < (1 << depth)),
                             axis=1)
                if inb.any():
                    ref = (comp[inb], np.asarray(rv)[inb])
        values = attr_model.decode(
            data[off:], sl.local, aps, desc,
            self._attr_ctx.get(abh.aps_id, attr_model.AttributeContexts()),
            ref=ref, max_lod_levels=self.max_lod_levels, abh=abh,
            device=cuda_or_none(self.device))
        sl.attrs[abh.sps_attr_idx] = values

    # -- frame output (reference outputCurrentCloud / inverse scale) --
    def _output_frame(self):
        sps = self.active_sps
        clouds = []
        for sl in self._slices:
            colors = None
            refl = None
            # loss resilience: a lost attribute brick still yields a
            # valid cloud with default values (reference decoder.cpp:
            # 665-694)
            for idx, desc in enumerate(sps.attributes):
                if idx not in sl.attrs:
                    n = sl.positions.shape[0]
                    dflt = self._attr_defaults.get(idx)
                    if dflt is not None and desc.num_components > 1:
                        sl.attrs[idx] = np.tile(
                            np.asarray(dflt, dtype=np.int64), (n, 1))
                    elif dflt is not None:
                        sl.attrs[idx] = np.full(
                            n, int(dflt[0]), dtype=np.int64)
                    else:
                        mid = 1 << (desc.bitdepth - 1)
                        sl.attrs[idx] = (
                            np.full((n, desc.num_components), mid,
                                    dtype=np.int64)
                            if desc.num_components > 1
                            else np.full(n, mid, dtype=np.int64))
            for idx, vals in sl.attrs.items():
                desc = sps.attributes[idx]
                vals = np.asarray(vals)
                if desc.attr_scale != 1 or desc.attr_offset != 0:
                    vals = (vals.astype(np.int64) * desc.attr_scale
                            + desc.attr_offset)
                if desc.label == "color":
                    if desc.cicp_matrix == 8:
                        vals = processing.ycgcor_to_rgb(
                            vals, desc.bitdepth)
                    elif desc.cicp_matrix == 1:
                        vals = processing.ycbcr_bt709_to_rgb(
                            vals, desc.bitdepth)
                    colors = vals
                elif desc.label == "reflectance":
                    refl = vals
            pos = processing.dequantize_positions(
                sl.positions, sps.geom_scale_num, sps.geom_scale_den,
                (0, 0, 0))
            gps = self.gps.get(sl.gbh.gps_id)
            z_comp = (gps is not None and gps.angular_enabled
                      and gps.z_compensation_enabled
                      and len(gps.laser_theta_q) > 1
                      and sps.geom_scale_num != sps.geom_scale_den)
            if sps.geom_scale_num != sps.geom_scale_den and not z_comp:
                # reference output conversion (TMC3.cpp:2505
                # writeOutputFrame): positions leave as coding-grid
                # ints times the double plyScale, NOT rounded to the
                # output grid — rounding costs up to 1.8 dB D1 at
                # coarse scales.  The angular z-comp path keeps the
                # integer grid (compensate_z reconstructs sub-grid z).
                pos = sl.positions.astype(np.float64) * (
                    sps.geom_scale_den / sps.geom_scale_num)
            if z_comp:
                # z compensation onto the laser cones (reference
                # compensateZCoordinate, geometry_octree.cpp:781)
                from ..ops import angular as angular_ops
                info = angular_ops.laser_info(
                    gps.laser_theta_q, gps.laser_z, gps.laser_npt)
                org = processing.dequantize_positions(
                    np.asarray([gps.angular_origin], dtype=np.int64),
                    sps.geom_scale_num, sps.geom_scale_den,
                    (0, 0, 0))[0]
                tol = -(-sps.geom_scale_den
                        // (2 * sps.geom_scale_num))
                pos = angular_ops.compensate_z(pos, info, org, tol)
            # stv -> xyz output order (reference toXyz, hls.h:164)
            pos = pos[:, sps.geom_axis_order.inv_perm]
            clouds.append(pc.PointCloud(pos, colors, refl))
        ctr = self._frame_ctr_lsb if self._frame_ctr_lsb is not None \
            else 0
        # reference frame for inter prediction: grid coordinates
        if self._slices:
            # coded-space attribute store for inter attr prediction
            per_idx: Dict[int, list] = {}
            for sl in self._slices:
                for idx, vals in sl.attrs.items():
                    a = self.aps.get(idx)
                    if a is not None and a.inter_prediction_enabled:
                        per_idx.setdefault(idx, []).append(
                            (sl.positions, np.asarray(vals)))
            attrs = {
                idx: (np.concatenate([p for p, _ in prs]),
                      np.concatenate([v for _, v in prs]))
                for idx, prs in per_idx.items()} if per_idx else None
            self._frames.store(
                ctr,
                np.concatenate([sl.positions for sl in self._slices]),
                attrs)
        self._slices = []
        # display-order emission (hierarchical GOF reorder)
        self._pending[ctr] = pc.concat(clouds)
        if self._next_out is None:
            self._next_out = ctr
        while self._next_out in self._pending:
            self.on_output_cloud(self._pending.pop(self._next_out))
            self._next_out = (self._next_out + 1) & self._ctr_mask
