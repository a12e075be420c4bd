"""Octree geometry codec: counterpart of
``mpeg_pcc_tmc13_tpu/models/geometry_octree.py``.

The encoder derives the whole tree from sorted Morton codes, then
serialises occupancy bytes level by level through the batched range
coder; the decoder alternates entropy decode and vectorised expansion
(reference BFS octree coder, geometry_octree_encoder.cpp:1853,
geometry_octree_decoder.cpp:1559).

Three interchangeable engines emit byte-identical streams:
  "numpy"  — host mirror (executable spec),
  "native" — one C++ call for the whole tree (the port's native
             library); the fast path on a single host core,
  "device" — the full-depth analysis on a torch device
             (``ops.octree.encode_analysis_packed``), compacted there so
             the host fetches only ~4 bytes per node.

Context modes: ``ops.octree.CTX_MODE_NEIGH`` / ``CTX_MODE_PARENT``.
Planar mode, implicit QT/BT, IDCM, multistream coding and duplicate
counts are host numpy code carried across unchanged; only the imports
point at the port (its Morton codes and octree module), so nothing here
reaches jax.  The one addition: ``decode_qtbt_card``, the QT/BT decode
with its level walk on a torch device (the host keeping the range
decoder), which ``decode`` takes when it is given a device.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field, fields

import numpy as np
import torch

from ..bitstream import entropy

from ..ops import octree as ops
from ..ops.motion import LPU_CTX_SIZE
from ..utils import morton, timing
from ..utils.device import resolve as resolve_device

# dup-count ueg: 2 prefix contexts + escape; see entropy ueg layout
_DUP_PREFIX_MAX = 2
_DUP_K = 0
DUP_CTX_SIZE = _DUP_PREFIX_MAX + 8

# Planar mode (reference planar coding, geometry_octree_encoder.cpp
# determinePlanarMode / eligibility OctreeNeighMap.h): per node and
# axis, a flag "all occupied children lie in one half-plane" plus the
# plane position; occupancy is then coded only over the surviving
# child slots (4/2/1-bit sub-symbols instead of the 8-bit symbol).
# TPU-first redesign: eligibility is LEVEL-causal — an axis is planar-
# eligible at level l iff the fraction of planar nodes at level l-1
# reached PLANAR_THRESHOLD (both sides derive this from decoded data),
# so all signalling stays one data-parallel pass per level.
# ctx layout: flags 6 (axis * 2 | prev-node flag) + positions 3.
PLANAR_CTX_SIZE = 9
PLANAR_THRESHOLD = 0.6
# sub-symbol trees: k=1 planar axis -> 15-node tree per (axis, side)
# [6 * 15]; k=2 -> 3-node tree per (free axis, side pair) [12 * 3].
PLANAR_OCC_CTX_SIZE = 6 * 15 + 12 * 3
_PLN_K2_OFF = 6 * 15
# child-slot axis bits of the octant index (Morton interleave order)
_AXIS_BIT = (4, 2, 1)

# IDCM (inferred direct coding mode, reference encodeDirectPosition
# geometry_octree_encoder.cpp:1577, mkIdcmEnableMask geometry_octree.cpp:
# 264): an *only-child* node at level >= 2 holding <= 2 unique points
# codes their remaining coordinate bits directly and leaves the tree.
# ctx layout: [0] idcm flag, [1] point-count bit.
IDCM_CTX_SIZE = 2
IDCM_MIN_LEVEL = 2
IDCM_MAX_POINTS = 2


@dataclass
class OctreeContexts:
    """Entropy context memories for the octree coder.

    Survives across slices/frames when entropy continuation is enabled
    (reference GeometryOctreeContexts, geometry_octree.h:841-912).
    """
    occupancy: np.ndarray = field(
        default_factory=lambda: entropy.new_contexts(ops.OCC_CTX_SIZE))
    dups: np.ndarray = field(
        default_factory=lambda: entropy.new_contexts(DUP_CTX_SIZE))
    # inter bricks: base = child_idx << 8 | reference pred-occupancy
    occupancy_inter: np.ndarray = field(
        default_factory=lambda: entropy.new_contexts(ops.OCC_CTX_SIZE))
    idcm: np.ndarray = field(
        default_factory=lambda: entropy.new_contexts(IDCM_CTX_SIZE))
    planar: np.ndarray = field(
        default_factory=lambda: entropy.new_contexts(PLANAR_CTX_SIZE))
    planar_occ: np.ndarray = field(
        default_factory=lambda: entropy.new_contexts(PLANAR_OCC_CTX_SIZE))
    # angular planar-side contexts: [0..3] z theta contexts,
    # [4..11] x phi, [12..19] y phi (ops/angular.py)
    angular: np.ndarray = field(
        default_factory=lambda: entropy.new_contexts(20))
    lpu: np.ndarray = field(
        default_factory=lambda: entropy.new_contexts(LPU_CTX_SIZE))
    # per-node geometry QP shifts (GBH geom_qp_node_depth)
    node_qp: np.ndarray = field(
        default_factory=lambda: entropy.new_contexts(16))
    # bytewise (Fenwick 256-symbol) occupancy models — the default
    # coder: one multisymbol range op per node, ~1.6x faster and
    # ~3% smaller than the binary context tree (which remains for
    # planar/IDCM sub-symbols and as a GPS-switchable fallback)
    occupancy_sym: np.ndarray = field(
        default_factory=lambda: entropy.new_sym_contexts(
            ops.NUM_OCC_BASES))
    occupancy_inter_sym: np.ndarray = field(
        default_factory=lambda: entropy.new_sym_contexts(
            ops.NUM_OCC_BASES))

    def copy(self) -> "OctreeContexts":
        return OctreeContexts(self.occupancy.copy(), self.dups.copy(),
                              self.occupancy_inter.copy(),
                              self.idcm.copy(), self.planar.copy(),
                              self.planar_occ.copy(),
                              self.angular.copy(),
                              self.lpu.copy(),
                              self.node_qp.copy(),
                              self.occupancy_sym.copy(),
                              self.occupancy_inter_sym.copy())


def contexts_from_reference(ctx) -> OctreeContexts:
    """Carry a reference ``OctreeContexts`` across: every one of its
    eleven context memories, as numpy copies (the codec's trained state,
    which continues across slices and frames)."""
    return OctreeContexts(*(np.array(getattr(ctx, f.name), copy=True)
                            for f in fields(OctreeContexts)))


def _dedup_sorted(codes_sorted: np.ndarray):
    """(unique_codes, dup_count_per_unique) of sorted codes."""
    if codes_sorted.size == 0:
        return codes_sorted, np.zeros(0, dtype=np.int64)
    keep = np.empty(codes_sorted.shape, dtype=bool)
    keep[0] = True
    np.not_equal(codes_sorted[1:], codes_sorted[:-1], out=keep[1:])
    uniq = codes_sorted[keep]
    counts = np.diff(np.append(np.nonzero(keep)[0], codes_sorted.size))
    return uniq, counts


def resolve_engine(engine: str) -> str:
    if engine != "auto":
        return engine
    return "native" if entropy.native_available() else "numpy"


def encode(positions: np.ndarray, depth: int, enc, ctx: OctreeContexts,
           unique_points: bool = True, engine: str = "auto",
           ctx_mode: int = ops.CTX_MODE_NEIGH,
           ref_codes: np.ndarray = None, idcm: bool = False,
           need_order: bool = True, planar: bool = False,
           bytewise: bool = True, axis_bits=None, angular=None,
           device=None):
    """Encode integer positions in [0, 2**depth)^3.

    ref_codes: sorted unique Morton codes of the motion-compensated
    reference frame (slice-local) — enables inter occupancy contexts.
    need_order=False skips the sort permutation (geometry-only slices).
    device: the torch device of the ``"device"`` engine's analysis;
    None takes the current CUDA device and raises when there is none
    (``"cpu"`` runs the same torch ops on the host).

    Returns the permutation `order` mapping input points to coding
    (Morton+dup) order — attributes must be coded in this order so the
    decoder's point order matches (reference reorders points into
    decode order, geometry_octree_encoder.cpp:2637-2659).
    """
    engine = resolve_engine(engine)
    if engine == "device":
        device = resolve_device(device)
    if engine == "native":
        codes_sorted, order = entropy.morton_sort(
            positions, return_perm=need_order)
    else:
        codes = morton.encode(positions.astype(np.int64))
        order = np.argsort(codes, kind="stable")
        codes_sorted = codes[order]
    uniq, dup_counts = _dedup_sorted(codes_sorted)

    qtbt = (axis_bits is not None
            and tuple(axis_bits) != (depth,) * 3
            and (ref_codes is None or ref_codes.size == 0)
            and not idcm and not planar)
    if depth == 0 or uniq.size == 0:
        pass
    elif qtbt:
        encode_qtbt_np(uniq, depth, enc, ctx, ctx_mode, axis_bits,
                       bytewise=bytewise,
                       levels=(_device_levels(uniq, depth, ctx_mode, device)
                               if engine == "device" else None))
    elif planar and (ref_codes is None or ref_codes.size == 0) \
            and not idcm:
        # planar mode runs the numpy engine (native planar: r2);
        # the empty-ref gate must match decode()'s exactly
        encode_planar_np(uniq, depth, enc, ctx, ctx_mode,
                         bytewise=bytewise, angular=angular)
    elif idcm and unique_points and ref_codes is None:
        encode_idcm_np(uniq, depth, enc, ctx, ctx_mode,
                       bytewise=bytewise)
    elif ref_codes is not None and ref_codes.size:
        # inter brick: contexts keyed by reference occupancy
        ictx = ctx.occupancy_inter_sym if bytewise \
            else ctx.occupancy_inter
        if engine == "native" and hasattr(enc, "octree_inter"):
            enc.octree_inter(ictx, uniq, depth, ref_codes,
                             use_sym=bytewise)
        else:
            levels = ops.build_levels_np(uniq, depth,
                                         ops.CTX_MODE_PARENT)
            for l, lvl in enumerate(levels):
                ref_l1 = np.unique(ref_codes >> (3 * (depth - l - 1)))
                pred = ops.pred_occupancy_np(lvl["nodes"], ref_l1)
                base = ((lvl["nodes"] & 7).astype(np.int32) << 8) | pred
                if bytewise:
                    enc.occupancy_sym(ictx, base, lvl["occ"])
                else:
                    enc.occupancy(ictx, base, lvl["occ"])
    elif engine == "native" and hasattr(enc, "octree"):
        enc.octree(ctx.occupancy_sym if bytewise else ctx.occupancy,
                   uniq, depth, ctx_mode, use_sym=bytewise)
    elif engine == "device":
        for base, occ in _device_levels(uniq, depth, ctx_mode, device):
            if bytewise:
                enc.occupancy_sym(ctx.occupancy_sym, base,
                                  occ.astype(np.uint8))
            else:
                enc.occupancy(ctx.occupancy, base, occ)
    else:
        levels = ops.build_levels_np(uniq, depth, ctx_mode)
        for lvl in levels:
            if bytewise:
                enc.occupancy_sym(ctx.occupancy_sym, lvl["ctx_base"],
                                  lvl["occ"])
            else:
                enc.occupancy(ctx.occupancy, lvl["ctx_base"],
                              lvl["occ"])

    if not unique_points:
        enc.ueg(ctx.dups, np.zeros(dup_counts.size, dtype=np.int32),
                (dup_counts - 1).astype(np.uint32), _DUP_PREFIX_MAX, _DUP_K)
    return order


# occ-bit masks of the "low" half-plane per axis (axis order of
# _AXIS_BIT: octant bits 4, 2, 1)
_PLN_LO = (0x0F, 0x33, 0x55)


def _planar_flags(occ: np.ndarray):
    """(planar (N,3) bool, side (N,3) int32) from occupancy bytes."""
    n = occ.shape[0]
    planar = np.zeros((n, 3), dtype=bool)
    side = np.zeros((n, 3), dtype=np.int32)
    for a in range(3):
        lo = (occ & ~np.int32(_PLN_LO[a]) & 0xFF) == 0
        hi = (occ & np.int32(_PLN_LO[a])) == 0
        planar[:, a] = lo | hi
        side[:, a] = hi.astype(np.int32)
    return planar, side


def _planar_groups(eff: np.ndarray, side: np.ndarray):
    """Canonical sub-symbol coding groups for a level.

    Yields (node_index_array, allowed_child_slots, tree_ctx_offset,
    tree_bits) — k=1 then k=2 patterns in fixed order; k=3 nodes are
    fully determined (single allowed slot, nothing to code)."""
    k = eff.sum(axis=1)
    for a in range(3):
        for s in range(2):
            sel = (k == 1) & eff[:, a] & (side[:, a] == s)
            idx = np.nonzero(sel)[0]
            if idx.size:
                allowed = [i for i in range(8)
                           if ((i & _AXIS_BIT[a]) != 0) == bool(s)]
                yield idx, allowed, (a * 2 + s) * 15, 4
    for free_a in range(3):
        pa = [a for a in range(3) if a != free_a]
        for sp in range(4):
            s0, s1 = sp >> 1, sp & 1
            sel = ((k == 2) & ~eff[:, free_a]
                   & (side[:, pa[0]] == s0) & (side[:, pa[1]] == s1))
            idx = np.nonzero(sel)[0]
            if idx.size:
                allowed = [i for i in range(8)
                           if ((i & _AXIS_BIT[pa[0]]) != 0) == bool(s0)
                           and ((i & _AXIS_BIT[pa[1]]) != 0) == bool(s1)]
                yield idx, allowed, _PLN_K2_OFF + (free_a * 4 + sp) * 3, 2


def _planar_k3_occ(eff: np.ndarray, side: np.ndarray):
    """Occupancy bytes of fully-planar (k=3) nodes: one allowed slot."""
    slot = np.zeros(eff.shape[0], dtype=np.int32)
    for a in range(3):
        slot |= np.where(side[:, a] > 0, _AXIS_BIT[a], 0)
    return (np.int32(1) << slot).astype(np.uint8)


def _angular_side_ids(a: int, ctx_z, ctx_phi, phi_axis):
    """Per-node ids into OctreeContexts.angular for axis a's plane
    position bit; -1 where the node is not angular-eligible."""
    if a == 2:
        return np.where(ctx_z >= 0, ctx_z, -1)
    want = 1 if a == 1 else 0
    ok = (ctx_phi >= 0) & (phi_axis == want)
    return np.where(ok, 4 + 8 * a + ctx_phi, -1)


def _enc_side_bits(enc, ctx, a, bits, aid):
    if aid is not None and (aid >= 0).any():
        use = aid >= 0
        enc.bits(ctx.angular, aid[use].astype(np.int32), bits[use])
        rest = ~use
        if rest.any():
            enc.bits(ctx.planar,
                     np.full(int(rest.sum()), 6 + a, dtype=np.int32),
                     bits[rest])
    else:
        enc.bits(ctx.planar,
                 np.full(bits.size, 6 + a, dtype=np.int32), bits)


def _dec_side_bits(dec, ctx, a, n, aid):
    out = np.zeros(n, dtype=np.int32)
    if aid is not None and (aid >= 0).any():
        use = aid >= 0
        out[use] = dec.bits(ctx.angular, aid[use].astype(np.int32))
        rest = ~use
        if rest.any():
            out[rest] = dec.bits(
                ctx.planar,
                np.full(int(rest.sum()), 6 + a, dtype=np.int32))
    else:
        out[:] = dec.bits(ctx.planar,
                          np.full(n, 6 + a, dtype=np.int32))
    return out


def encode_planar_np(uniq: np.ndarray, depth: int, enc,
                     ctx: OctreeContexts, ctx_mode: int,
                     bytewise: bool = True, angular=None):
    """Intra octree coding with planar mode (GPS planar_mode_enabled).

    Per level, for each planar-eligible axis: a chained planar flag and
    a position bit per node; the occupancy symbol is then coded only
    over the surviving child slots.  Eligibility per axis is derived
    from the PREVIOUS level's planarity fraction on both sides."""
    from ..ops import angular as angular_ops
    levels = ops.build_levels_np(uniq, depth, ctx_mode)
    elig = np.zeros(3, dtype=bool)
    for l, lvl in enumerate(levels):
        occ = lvl["occ"].astype(np.int32)
        planar, side = _planar_flags(occ)
        eff = planar & elig[None, :]
        eff_side = np.where(eff, side, 0)
        ang = None
        if angular is not None and elig.any():
            info, origin = angular
            ang = angular_ops.node_angular_ctx(
                lvl["nodes"], depth - l, origin, info)
        for a in range(3):
            if not elig[a]:
                continue
            f = planar[:, a].astype(np.uint8)
            prev = np.concatenate([[0], f[:-1]]).astype(np.int32)
            enc.bits(ctx.planar, a * 2 + prev, f)
            sel = f.astype(bool)
            if sel.any():
                bits = side[sel, a].astype(np.uint8)
                aid = (_angular_side_ids(a, ang[0][sel], ang[1][sel],
                                         ang[2][sel])
                       if ang is not None else None)
                _enc_side_bits(enc, ctx, a, bits, aid)
        k = eff.sum(axis=1)
        sel0 = k == 0
        if sel0.any():
            if bytewise:
                enc.occupancy_sym(ctx.occupancy_sym,
                                  lvl["ctx_base"][sel0],
                                  lvl["occ"][sel0])
            else:
                enc.occupancy(ctx.occupancy, lvl["ctx_base"][sel0],
                              lvl["occ"][sel0])
        for idx, allowed, off, nbits in _planar_groups(eff, eff_side):
            node = np.ones(idx.size, dtype=np.int32)
            for j in range(nbits):
                bit = ((occ[idx] >> allowed[j]) & 1).astype(np.uint8)
                enc.bits(ctx.planar_occ, off + node - 1, bit)
                node = node * 2 + bit
        elig = (planar.mean(axis=0) >= PLANAR_THRESHOLD
                if occ.size else elig)


def decode_planar_np(depth: int, dec, ctx: OctreeContexts,
                     ctx_mode: int, stop_at: int = None,
                     max_points: int = 0, bytewise: bool = True,
                     angular=None):
    """Mirror of encode_planar_np; returns (nodes, levels_decoded)."""
    from ..ops import angular as angular_ops
    nodes = np.zeros(1, dtype=np.int64)
    parent_occ = np.zeros(1, dtype=np.int32)
    elig = np.zeros(3, dtype=bool)
    stop = depth if stop_at is None else stop_at
    lvl_done = 0
    for l in range(stop):
        if max_points and nodes.size >= max_points:
            break
        n = nodes.size
        planar = np.zeros((n, 3), dtype=bool)
        side = np.zeros((n, 3), dtype=np.int32)
        ang = None
        if angular is not None and elig.any():
            info, origin = angular
            ang = angular_ops.node_angular_ctx(
                nodes, depth - l, origin, info)
        for a in range(3):
            if not elig[a]:
                continue
            f = dec.bits_chain(
                ctx.planar[a * 2:a * 2 + 2], n).astype(bool)
            planar[:, a] = f
            npl = int(f.sum())
            if npl:
                aid = (_angular_side_ids(a, ang[0][f], ang[1][f],
                                         ang[2][f])
                       if ang is not None else None)
                side[f, a] = _dec_side_bits(dec, ctx, a, npl, aid)
        eff = planar  # flags only decoded for eligible axes
        eff_side = np.where(eff, side, 0)
        k = eff.sum(axis=1)
        occ = np.zeros(n, dtype=np.int32)
        sel0 = k == 0
        if sel0.any():
            base = _level_base_np(nodes, parent_occ, l, ctx_mode)
            got = (dec.occupancy_sym(ctx.occupancy_sym, base[sel0])
                   if bytewise
                   else dec.occupancy(ctx.occupancy, base[sel0]))
            occ[sel0] = got.astype(np.int32)
        for idx, allowed, off, nbits in _planar_groups(eff, eff_side):
            node = np.ones(idx.size, dtype=np.int32)
            vals = np.zeros(idx.size, dtype=np.int32)
            for j in range(nbits):
                bit = dec.bits(ctx.planar_occ,
                               (off + node - 1).astype(np.int32))
                vals |= bit.astype(np.int32) << allowed[j]
                node = node * 2 + bit.astype(np.int32)
            occ[idx] = vals
        sel3 = k == 3
        if sel3.any():
            occ[sel3] = _planar_k3_occ(eff, eff_side)[sel3]
        # a decoded occupancy of zero means a corrupt stream; guard the
        # expansion (zero-occupancy nodes would silently vanish)
        occ = np.where(occ == 0, 1, occ)
        u8 = occ.astype(np.uint8)
        # full planarity for the next level's eligibility
        full_planar, _ = _planar_flags(occ)
        nodes = ops.expand_level_np(nodes, u8)
        if ctx_mode == ops.CTX_MODE_PARENT:
            parent_occ = np.repeat(occ, ops.popcount8_np(u8))
        elig = (full_planar.mean(axis=0) >= PLANAR_THRESHOLD
                if n else elig)
        lvl_done = l + 1
    return nodes, lvl_done


def _device_levels(uniq: np.ndarray, depth: int, ctx_mode: int, device):
    """The ``"device"`` engine's analysis: per level, (context bases,
    occupancy bytes) of its nodes, computed on ``device`` and fetched in
    two steps (the counts, then 4 bytes a tree node)."""
    compact, counts = ops.encode_analysis_packed(
        torch.as_tensor(uniq, device=device), depth, ctx_mode)
    counts = counts.cpu().numpy()
    packed = compact[:int(counts.sum())].cpu().numpy()
    bounds = np.concatenate([[0], np.cumsum(counts)])
    return [(packed[a:b] >> 8, packed[a:b] & 0xFF)
            for a, b in zip(bounds[:-1], bounds[1:])]


def encode_qtbt_np(uniq: np.ndarray, depth: int, enc,
                   ctx: OctreeContexts, ctx_mode: int, axis_bits,
                   bytewise: bool = True, levels=None):
    """Implicit QT/BT for non-cubic bounding boxes (reference implicit
    geometry partitions): at levels where an axis is exhausted
    (level < depth - axis_bits[a], i.e. every point's bit is zero) the
    axis is treated as a FORCED planar-low axis with no signalling —
    occupancy codes over the surviving 4/2 child slots only.  Both
    sides derive the forced set from the GBH per-axis root sizes.
    ``levels``: per level (context bases, occupancy bytes) from the
    device engine (``_device_levels``); None builds them on the host."""
    if levels is None:
        levels = [(lvl["ctx_base"], lvl["occ"])
                  for lvl in ops.build_levels_np(uniq, depth, ctx_mode)]
    for l, (base, occ) in enumerate(levels):
        forced = np.array([l < depth - axis_bits[a] for a in range(3)])
        occ32 = occ.astype(np.int32)
        n = occ32.size
        if not forced.any():
            if bytewise:
                enc.occupancy_sym(ctx.occupancy_sym, base,
                                  occ.astype(np.uint8))
            else:
                enc.occupancy(ctx.occupancy, base, occ)
            continue
        eff = np.broadcast_to(forced, (n, 3))
        side = np.zeros((n, 3), dtype=np.int32)
        for idx, allowed, off, nbits in _planar_groups(eff, side):
            node = np.ones(idx.size, dtype=np.int32)
            for j in range(nbits):
                bit = ((occ32[idx] >> allowed[j]) & 1).astype(np.uint8)
                enc.bits(ctx.planar_occ, off + node - 1, bit)
                node = node * 2 + bit


def _decode_forced_occ(n: int, forced, dec, ctx: OctreeContexts):
    """A QT/BT level with forced axes: its n occupancy bytes, decoded
    from the surviving child slots' planar bits (both walkers)."""
    eff = np.broadcast_to(np.asarray(forced), (n, 3))
    side = np.zeros((n, 3), dtype=np.int32)
    occ = np.zeros(n, dtype=np.int32)
    for idx, allowed, off, nbits in _planar_groups(eff, side):
        node = np.ones(idx.size, dtype=np.int32)
        vals = np.zeros(idx.size, dtype=np.int32)
        for j in range(nbits):
            bit = dec.bits(ctx.planar_occ, (off + node - 1).astype(np.int32))
            vals |= bit.astype(np.int32) << allowed[j]
            node = node * 2 + bit.astype(np.int32)
        occ[idx] = vals
    return occ


def decode_qtbt_np(depth: int, dec, ctx: OctreeContexts, ctx_mode: int,
                   axis_bits, bytewise: bool = True,
                   stop_at: int = None, max_points: int = 0):
    """Mirror of encode_qtbt_np; returns (nodes, levels_decoded)."""
    nodes = np.zeros(1, dtype=np.int64)
    parent_occ = np.zeros(1, dtype=np.int32)
    stop = depth if stop_at is None else stop_at
    lvl_done = 0
    for l in range(stop):
        if max_points and nodes.size >= max_points:
            break
        n = nodes.size
        forced = np.array([l < depth - axis_bits[a] for a in range(3)])
        if not forced.any():
            base = _level_base_np(nodes, parent_occ, l, ctx_mode)
            occ = (dec.occupancy_sym(ctx.occupancy_sym, base)
                   if bytewise
                   else dec.occupancy(ctx.occupancy,
                                      base)).astype(np.int32)
        else:
            occ = _decode_forced_occ(n, forced, dec, ctx)
        occ = np.where(occ == 0, 1, occ)   # corrupt-stream guard
        u8 = occ.astype(np.uint8)
        nodes = ops.expand_level_np(nodes, u8)
        if ctx_mode == ops.CTX_MODE_PARENT:
            parent_occ = np.repeat(occ, ops.popcount8_np(u8))
        lvl_done = l + 1
    return nodes, lvl_done


def decode_qtbt_card(depth: int, dec, ctx: OctreeContexts, ctx_mode: int,
                     axis_bits, bytewise: bool = True, stop_at: int = None,
                     max_points: int = 0, device=None):
    """``decode_qtbt_np`` with the level walk on ``device``: the same
    arguments and result, (leaf codes on the host, levels decoded).

    The node codes stay on the device.  A level with no forced axis has
    its context bases computed there (``ops.octree.octree_neigh_ctx``;
    counter ``geom.card_levels`` on a card) and fetched in one copy; the
    host range decoder decodes its bytes; a forced level's bytes decode
    on the host from the node count alone.  The host sizes the children
    from its own popcount of the bytes, so any stream, a damaged one too,
    decodes as ``decode_qtbt_np`` decodes it; the bytes go up in one copy
    and ``ops.octree._expand_level`` expands them, the level padded to
    its child count.  The leaf codes come back once, at the end.  A CPU
    device runs the plain versions."""
    dev = torch.device(device)
    pinned = dev.type == "cuda"
    stop = depth if stop_at is None else stop_at
    nodes = torch.zeros(1, dtype=torch.int64, device=dev)    # the root
    occ_up = src = None  # PARENT: the level above's bytes, each node's row
    n, lvl_done = 1, 0
    for l in range(stop):
        if max_points and n >= max_points:
            break
        forced = [l < depth - axis_bits[a] for a in range(3)]
        if not any(forced):
            base = ops.octree_neigh_ctx(nodes, l, ctx_mode, occ_up, src)
            host = torch.empty(n, dtype=torch.int32, pin_memory=pinned)
            host.copy_(base)
            if pinned:
                timing.count("geom.card_levels", 1)
            occ = (dec.occupancy_sym(ctx.occupancy_sym, host.numpy())
                   if bytewise
                   else dec.occupancy(ctx.occupancy,
                                      host.numpy())).astype(np.int32)
        else:
            occ = _decode_forced_occ(n, forced, dec, ctx)
        u8 = np.where(occ == 0, 1, occ).astype(np.uint8)  # corrupt guard
        nchild = int(np.unpackbits(u8).sum())
        host = torch.empty(n, dtype=torch.uint8, pin_memory=pinned)
        host.numpy()[:] = u8
        occ_up = torch.zeros(nchild, dtype=torch.uint8, device=dev)
        occ_up[:n].copy_(host, non_blocking=True)
        padded = torch.empty(nchild, dtype=torch.int64, device=dev)
        padded[:n] = nodes
        padded[n:] = ops.I64_MAX
        nodes, _, src = ops._expand_level(padded, occ_up, nchild)
        if ctx_mode != ops.CTX_MODE_PARENT:
            occ_up = src = None
        n, lvl_done = nchild, l + 1
    return nodes.cpu().numpy(), lvl_done


def _level_base_np(nodes: np.ndarray, parent_occ: np.ndarray, l: int,
                   ctx_mode: int) -> np.ndarray:
    if ctx_mode == ops.CTX_MODE_NEIGH:
        return ops.occ_context_base_np(nodes, l)
    return ((nodes & 7).astype(np.int32) << 8) | parent_occ


def encode_idcm_np(uniq: np.ndarray, depth: int, enc,
                   ctx: OctreeContexts, ctx_mode: int,
                   bytewise: bool = True):
    """Octree encode with inferred direct coding mode.

    Per level, in this stream order: (1) IDCM flags of eligible nodes
    (only children at level >= IDCM_MIN_LEVEL), (2) per-IDCM-node
    point-count bit + direct x,y,z coordinate bits, (3) the occupancy
    batch of the surviving nodes.  IDCM subtrees leave the wavefront —
    the tree never descends into them (reference early-exit,
    geometry_octree_encoder.cpp:2400-2446).
    """
    alive = np.zeros(1, dtype=np.int64)
    parent_occ = np.zeros(1, dtype=np.int32)
    for l in range(depth):
        r = depth - l
        # child boundaries via one batched search: (M,9)
        q = ((alive[:, None] << 3)
             + np.arange(9, dtype=np.int64)) << (3 * (r - 1))
        bounds = np.searchsorted(uniq, q)
        has = bounds[:, 1:] > bounds[:, :-1]
        occ = np.sum(has.astype(np.int32)
                     << np.arange(8, dtype=np.int32)[None, :], axis=1)

        elig = (np.asarray(ops.popcount8_np(
            parent_occ.astype(np.uint8)) == 1)
            if l >= IDCM_MIN_LEVEL else np.zeros(alive.size, bool))
        cnt = bounds[:, 8] - bounds[:, 0]
        use = elig & (cnt <= IDCM_MAX_POINTS)
        if elig.any():
            enc.bits(ctx.idcm, np.zeros(int(elig.sum()), dtype=np.int32),
                     use[elig].astype(np.uint8))
        if use.any():
            enc.bits(ctx.idcm,
                     np.ones(int(use.sum()), dtype=np.int32),
                     (cnt[use] - 1).astype(np.uint8))
            # direct coordinates: node order, point order, x,y,z
            # (ragged gather over the [lo, lo+cnt) subtree ranges)
            sel = np.nonzero(use)[0]
            cnts = cnt[sel]
            total = int(cnts.sum())
            prefix = np.concatenate([[0], np.cumsum(cnts)[:-1]])
            offs = np.arange(total) - np.repeat(prefix, cnts)
            idxs = np.repeat(bounds[sel, 0], cnts) + offs
            node_rep = np.repeat(sel, cnts)
            pts = uniq[idxs] - (alive[node_rep] << (3 * r))
            xyz = morton.decode(pts)
            enc.bypass(xyz.reshape(-1).astype(np.uint32),
                       np.full(3 * total, r, dtype=np.int32))
        surv = ~use
        base = _level_base_np(alive, parent_occ, l, ctx_mode)
        if bytewise:
            enc.occupancy_sym(ctx.occupancy_sym, base[surv],
                              occ[surv])
        else:
            enc.occupancy(ctx.occupancy, base[surv], occ[surv])
        # expand survivors
        s_occ = occ[surv].astype(np.uint8)
        alive = ops.expand_level_np(alive[surv], s_occ)
        parent_occ = np.repeat(s_occ.astype(np.int32),
                               ops.popcount8_np(s_occ))


def decode_idcm_np(depth: int, dec, ctx: OctreeContexts,
                   ctx_mode: int, bytewise: bool = True,
                   skip_layers: int = 0, max_points: int = 0):
    """Mirror of encode_idcm_np; supports scalable truncation (IDCM
    points are exact even when the tree is truncated)."""
    alive = np.zeros(1, dtype=np.int64)
    parent_occ = np.zeros(1, dtype=np.int32)
    finals = []          # full-resolution leaf codes from IDCM
    stop_at = depth - min(skip_layers, depth)
    lvl = 0
    for l in range(depth):
        if l >= stop_at or (max_points and alive.size >= max_points):
            break
        r = depth - l
        elig = (np.asarray(ops.popcount8_np(
            parent_occ.astype(np.uint8)) == 1)
            if l >= IDCM_MIN_LEVEL else np.zeros(alive.size, bool))
        use = np.zeros(alive.size, dtype=bool)
        if elig.any():
            flags = dec.bits(ctx.idcm,
                             np.zeros(int(elig.sum()), dtype=np.int32))
            use[np.nonzero(elig)[0]] = flags.astype(bool)
        if use.any():
            cnts = dec.bits(ctx.idcm,
                            np.ones(int(use.sum()), dtype=np.int32)
                            ).astype(np.int64) + 1
            total = int(cnts.sum())
            nbits = np.full(3 * total, r, dtype=np.int32)
            coords = dec.bypass(nbits).astype(np.int64).reshape(-1, 3)
            codes = morton.encode(coords)
            node_of_pt = np.repeat(np.nonzero(use)[0], cnts)
            finals.append((alive[node_of_pt] << (3 * r)) + codes)
        surv = ~use
        base = _level_base_np(alive, parent_occ, l, ctx_mode)
        occ = (dec.occupancy_sym(ctx.occupancy_sym, base[surv])
               if bytewise
               else dec.occupancy(ctx.occupancy, base[surv]))
        alive = ops.expand_level_np(alive[surv], occ)
        parent_occ = np.repeat(occ.astype(np.int32),
                               ops.popcount8_np(occ))
        lvl = l + 1
    shift = depth - lvl
    nodes = alive << (3 * 0)
    if shift > 0:
        # truncated: scale tree nodes to centres; IDCM points are exact
        pos = morton.decode(nodes) << shift
        pos += (1 << shift) >> 1
        tree_codes = morton.encode(pos)
    else:
        tree_codes = nodes
    all_codes = np.concatenate([tree_codes] + finals) if finals else \
        tree_codes
    return morton.decode(np.sort(all_codes))


def encode_multistream(positions: np.ndarray, depth: int,
                       ctx: OctreeContexts, num_streams: int,
                       ctx_mode: int = ops.CTX_MODE_NEIGH,
                       bytewise: bool = True):
    """Encode with the last num_streams-1 levels in separate entropy
    streams so they decode independently (reference multiple octree
    entropy streams, §2.9.3: shared context state saved at the split,
    geometry_octree_encoder.cpp:2133-2142).

    Returns (streams: list[bytes], order).  Requires unique points.
    """
    codes = morton.encode(positions.astype(np.int64))
    order = np.argsort(codes, kind="stable")
    uniq, _ = _dedup_sorted(codes[order])
    num_streams = max(1, min(num_streams, depth))
    split = depth - (num_streams - 1)
    levels = ops.build_levels_np(uniq, depth, ctx_mode)

    cmem = ctx.occupancy_sym if bytewise else ctx.occupancy
    code = (lambda e, c, b, o: e.occupancy_sym(c, b, o)) if bytewise \
        else (lambda e, c, b, o: e.occupancy(c, b, o))
    enc0 = entropy.RangeEncoder()
    for lvl in levels[:split]:
        code(enc0, cmem, lvl["ctx_base"], lvl["occ"])
    streams = [enc0.get_bytes()]
    snapshot = cmem.copy()
    for lvl in levels[split:]:
        enc_l = entropy.RangeEncoder()
        ctx_l = snapshot.copy()
        code(enc_l, ctx_l, lvl["ctx_base"], lvl["occ"])
        streams.append(enc_l.get_bytes())
    return streams, order


def decode_multistream(num_points: int, depth: int, streams,
                       ctx: OctreeContexts,
                       ctx_mode: int = ops.CTX_MODE_NEIGH,
                       bytewise: bool = True):
    """Mirror of encode_multistream.  Deep-level streams share the
    stream-0 context snapshot, so they could run concurrently; here
    they run in order but with independent decoders."""
    if num_points == 0:
        return np.zeros((0, 3), dtype=np.int64)
    num_streams = len(streams)
    split = depth - (num_streams - 1)
    dec0 = entropy.RangeDecoder(streams[0])
    nodes = np.zeros(1, dtype=np.int64)
    parent_occ = np.zeros(1, dtype=np.int32)

    def level_base(nodes, parent_occ, l):
        if ctx_mode == ops.CTX_MODE_NEIGH:
            return ops.occ_context_base_np(nodes, l)
        return ((nodes & 7).astype(np.int32) << 8) | parent_occ

    cmem = ctx.occupancy_sym if bytewise else ctx.occupancy
    read = (lambda d, c, b: d.occupancy_sym(c, b)) if bytewise \
        else (lambda d, c, b: d.occupancy(c, b))
    for l in range(split):
        base = level_base(nodes, parent_occ, l)
        occ = read(dec0, cmem, base)
        if ctx_mode == ops.CTX_MODE_PARENT:
            parent_occ = np.repeat(
                occ.astype(np.int32), ops.popcount8_np(occ))
        nodes = ops.expand_level_np(nodes, occ)
    snapshot = cmem.copy()
    for k, l in enumerate(range(split, depth)):
        dec_l = entropy.RangeDecoder(streams[1 + k])
        ctx_l = snapshot.copy()
        base = level_base(nodes, parent_occ, l)
        occ = read(dec_l, ctx_l, base)
        if ctx_mode == ops.CTX_MODE_PARENT:
            parent_occ = np.repeat(
                occ.astype(np.int32), ops.popcount8_np(occ))
        nodes = ops.expand_level_np(nodes, occ)
    return morton.decode(nodes)


def decode(num_points: int, depth: int, dec, ctx: OctreeContexts,
           unique_points: bool = True, engine: str = "auto",
           ctx_mode: int = ops.CTX_MODE_NEIGH,
           ref_codes: np.ndarray = None, idcm: bool = False,
           skip_layers: int = 0, max_points: int = 0,
           planar: bool = False, bytewise: bool = True,
           axis_bits=None, angular=None, device=None):
    """Decode positions (coding order).

    num_points (total, incl. duplicates — signalled in the GBH) only
    gates the empty-slice case and bounds the leaf count.

    skip_layers > 0 enables scalable partial decode (reference
    decodeGeometryOctreeScalable, geometry_octree_decoder.cpp:2244 and
    skipOctreeLayers, decoder.cpp:698-710): the last `skip_layers`
    octree levels are not decoded; node centres at the truncated level
    are returned, scaled back to full resolution.  max_points > 0
    additionally stops descending once a level has that many nodes.
    device: the torch device of a QT/BT brick's level walk
    (``decode_qtbt_card``); None walks it on the host (``decode_qtbt_np``).
    """
    if num_points == 0:
        return np.zeros((0, 3), dtype=np.int64)
    engine = resolve_engine(engine)
    qtbt = (axis_bits is not None
            and tuple(axis_bits) != (depth,) * 3
            and (ref_codes is None or ref_codes.size == 0)
            and not idcm and not planar)
    if qtbt:
        walk = (decode_qtbt_np if device is None else
                functools.partial(decode_qtbt_card, device=device))
        nodes, lvl = walk(
            depth, dec, ctx, ctx_mode, axis_bits, bytewise=bytewise,
            stop_at=depth - min(skip_layers, depth),
            max_points=max_points)
        if lvl < depth:
            shift = depth - lvl
            pos = morton.decode(nodes) << shift
            pos += (1 << shift) >> 1
            return pos
        if not unique_points:
            dup = dec.ueg(ctx.dups,
                          np.zeros(nodes.size, dtype=np.int32),
                          _DUP_PREFIX_MAX,
                          _DUP_K).astype(np.int64) + 1
            nodes = np.repeat(nodes, dup)
        return morton.decode(nodes)
    if planar and (ref_codes is None or ref_codes.size == 0) \
            and not idcm:
        nodes, lvl = decode_planar_np(
            depth, dec, ctx, ctx_mode,
            stop_at=depth - min(skip_layers, depth),
            max_points=max_points, bytewise=bytewise,
            angular=angular)
        if lvl < depth:
            shift = depth - lvl
            pos = morton.decode(nodes) << shift
            pos += (1 << shift) >> 1
            return pos
        if not unique_points:
            dup = dec.ueg(ctx.dups,
                          np.zeros(nodes.size, dtype=np.int32),
                          _DUP_PREFIX_MAX,
                          _DUP_K).astype(np.int64) + 1
            nodes = np.repeat(nodes, dup)
        return morton.decode(nodes)
    if idcm and unique_points and ref_codes is None:
        return decode_idcm_np(depth, dec, ctx, ctx_mode,
                              bytewise=bytewise,
                              skip_layers=skip_layers,
                              max_points=max_points)
    truncated = skip_layers > 0 or max_points > 0
    inter = ref_codes is not None and ref_codes.size > 0
    if not truncated and inter and engine == "native" \
            and hasattr(dec, "octree_inter") and depth > 0:
        ictx = ctx.occupancy_inter_sym if bytewise \
            else ctx.occupancy_inter
        nodes = dec.octree_inter(ictx, num_points, depth,
                                 ref_codes, use_sym=bytewise)
    elif not truncated and not inter and engine == "native" \
            and hasattr(dec, "octree") and depth > 0:
        nodes = dec.octree(
            ctx.occupancy_sym if bytewise else ctx.occupancy,
            num_points, depth, ctx_mode, use_sym=bytewise)
    else:
        nodes, lvl = _walk_levels_np(
            depth, dec, ctx, ctx_mode, ref_codes=ref_codes,
            stop_at=depth - min(skip_layers, depth),
            max_points=max_points, sanity_cap=max(num_points, 1) * 64,
            bytewise=bytewise)
        if lvl < depth:
            # truncated: emit node centres at full-resolution scale
            shift = depth - lvl
            pos = morton.decode(nodes) << shift
            pos += (1 << shift) >> 1
            return pos
    if not unique_points:
        dup = dec.ueg(ctx.dups, np.zeros(nodes.size, dtype=np.int32),
                      _DUP_PREFIX_MAX, _DUP_K).astype(np.int64) + 1
        nodes = np.repeat(nodes, dup)
    return morton.decode(nodes)


def _walk_levels_np(depth: int, dec, ctx: OctreeContexts, ctx_mode: int,
                    ref_codes=None, stop_at: int = None,
                    max_points: int = 0, sanity_cap: int = 0,
                    bytewise: bool = True):
    """The single numpy level walker behind every decode variant:
    intra (both context modes), inter (reference-keyed contexts), and
    scalable truncation.  Returns (nodes, levels_decoded).

    sanity_cap bounds node growth against corrupt streams (the GBH
    point count is trusted only as an order of magnitude)."""
    inter = ref_codes is not None and getattr(ref_codes, "size", 0) > 0
    nodes = np.zeros(1, dtype=np.int64)  # root
    parent_occ = np.zeros(1, dtype=np.int32)
    stop = depth if stop_at is None else stop_at
    lvl = 0
    for l in range(stop):
        if max_points and nodes.size >= max_points:
            break
        if sanity_cap and nodes.size > sanity_cap:
            raise ValueError("corrupt geometry stream: node count "
                             f"{nodes.size} exceeds sanity cap")
        if inter:
            ref_l1 = np.unique(ref_codes >> (3 * (depth - l - 1)))
            pred = ops.pred_occupancy_np(nodes, ref_l1)
            base = ((nodes & 7).astype(np.int32) << 8) | pred
            occ = (dec.occupancy_sym(ctx.occupancy_inter_sym, base)
                   if bytewise
                   else dec.occupancy(ctx.occupancy_inter, base))
        else:
            base = _level_base_np(nodes, parent_occ, l, ctx_mode)
            occ = (dec.occupancy_sym(ctx.occupancy_sym, base)
                   if bytewise
                   else dec.occupancy(ctx.occupancy, base))
        nodes = ops.expand_level_np(nodes, occ)
        if not inter and ctx_mode == ops.CTX_MODE_PARENT:
            parent_occ = np.repeat(
                occ.astype(np.int32), ops.popcount8_np(occ))
        lvl = l + 1
    return nodes, lvl
