"""Array-op mirror of the level-sweep OBUF analysis pass.

This module re-expresses the batched per-level analysis of the
level-sweep engine (native/obuf_ls.cc) as pure array operations —
gathers over sorted key arrays and branch-free bit arithmetic — i.e.
exactly the shape a device lowering takes (every op here is a
searchsorted/gather/where/shift).  It produces, for one octree level,
the complete token stream the C++ batched pass emits (context ids
c1/c2, map selector, bit values, inferred-bit skips), demonstrating
that everything outside the thin serial OBUF-evolve + arithmetic-coding
loop is device-runnable.

Semantics mirrored (reference TMC13 citations):
  * neighbour pattern + adjacency words:
    tmc3/OctreeNeighMap.cpp:137-376
  * the eight per-bit context derivations
    (makeGeometryAdvancedNeighPattern0..7):
    tmc3/OctreeNeighMap.cpp:409-1358
  * occupancy bit skip/inference (coded0 counters):
    tmc3/geometry_octree_encoder.cpp:815-982

Scope: intra, planar off, unique points (the numerically heavy
occupancy machinery).  tests/test_torch_obuf_mirror.py holds THIS
mirror token-identical to the port's C++ batched pass and to the JAX
package's mirror.

The PyTorch + CUDA port's copy of ``mpeg_pcc_tmc13_tpu/ops/
octree_obuf.py`` (numpy only); only this docstring changed.
"""

from __future__ import annotations

import numpy as np

# token kinds (native/obuf_ls.cc TokKind)
TOK_ADAPT = 0
TOK_BYPASS = 1
TOK_OCC = 2

CTX_SINGLE_CHILD = 0

_KNN4 = np.array([0, 1, 1, 2, 1, 2, 2, 3, 1, 2, 2, 3, 2, 3, 3, 4],
                 dtype=np.int64)

# kInitCoded0 (geometry_octree_decoder.cpp LUTinitCoded0)
_INIT_CODED0 = np.array([
    [0, 0, 0, 0, 0, 0], [4, 0, 2, 2, 2, 2], [0, 4, 2, 2, 2, 2],
    [2, 2, 4, 0, 2, 2], [4, 2, 4, 2, 3, 3], [2, 4, 4, 2, 3, 3],
    [2, 2, 0, 4, 2, 2], [4, 2, 2, 4, 3, 3], [2, 4, 2, 4, 3, 3],
    [2, 2, 2, 2, 4, 0], [4, 2, 3, 3, 4, 2], [2, 4, 3, 3, 4, 2],
    [3, 3, 4, 2, 4, 2], [4, 3, 4, 3, 4, 3], [3, 4, 4, 3, 4, 3],
    [3, 3, 2, 4, 4, 2], [4, 3, 3, 4, 4, 3], [3, 4, 3, 4, 4, 3],
    [2, 2, 2, 2, 0, 4], [4, 2, 3, 3, 2, 4], [2, 4, 3, 3, 2, 4],
    [3, 3, 4, 2, 2, 4], [4, 3, 4, 3, 3, 4], [3, 4, 4, 3, 3, 4],
    [3, 3, 2, 4, 2, 4], [4, 3, 3, 4, 3, 4], [3, 4, 3, 4, 3, 4]],
    dtype=np.int64)

# 20-neighbour probe offsets (OctreeNeighMap.cpp:287-292)
_DX20 = np.array([-1, -1, -1, -1, -1, -1, -1, -1, 0, 0, 0, 0, 1, 1, 1,
                  1, 1, 1, 1, 1])
_DY20 = np.array([-1, -1, -1, 0, 0, 1, 1, 1, -1, -1, 1, 1, -1, -1, -1,
                  0, 0, 1, 1, 1])
_DZ20 = np.array([-1, 0, 1, -1, 1, -1, 0, 1, -1, 1, -1, 1, -1, 0, 1,
                  -1, 1, -1, 0, 1])


def node_keys(px, py, pz, coded_axes, depth):
    """Generalised Morton key of nodes at `depth` (3 bits/level in
    coding order), from their STV path coordinates."""
    px = np.asarray(px, dtype=np.int64)
    py = np.asarray(py, dtype=np.int64)
    pz = np.asarray(pz, dtype=np.int64)
    key = np.zeros_like(px)
    xx, yy, zz = px, py, pz
    shift = 0
    for d in range(depth - 1, -1, -1):
        coded = int(coded_axes[d])
        bx = (xx & 1) if (coded & 4) else np.zeros_like(xx)
        by = (yy & 1) if (coded & 2) else np.zeros_like(yy)
        bz = (zz & 1) if (coded & 1) else np.zeros_like(zz)
        if coded & 4:
            xx = xx >> 1
        if coded & 2:
            yy = yy >> 1
        if coded & 1:
            zz = zz >> 1
        key = key | ((bx << 2 | by << 1 | bz) << shift)
        shift += 3
    return key


def _gb(w, *ns):
    out = np.zeros_like(w)
    m = len(ns)
    for k, n in enumerate(ns):
        out = out | (((w >> n) & 1) << (m - 1 - k))
    return out


class _LevelLookup:
    """Existence + child-occupancy lookup over one level's sorted node
    keys — the array form of the reference's occupancy atlas
    (MortonMap3D).  All queries are in-cube clipped exactly as the
    atlas's availability boundary does."""

    def __init__(self, keys, occ, px, py, pz, coded_axes, depth,
                 cube_log2):
        self.keys = keys
        self.occ = np.asarray(occ, dtype=np.int64)
        self.coded_axes = coded_axes
        self.depth = depth
        self.log2 = cube_log2
        self.cube = (px >> cube_log2, py >> cube_log2,
                     pz >> cube_log2)
        # per-axis coordinate range of this level (bits consumed so
        # far); out-of-range probes must not alias through the key
        self.hi = [1 << sum(1 for d in range(depth)
                            if int(coded_axes[d]) & a)
                   for a in (4, 2, 1)]

    def probe(self, px, py, pz, dx, dy, dz):
        """(exists, child_occ) of the node at offset (dx,dy,dz)."""
        tx, ty, tz = px + dx, py + dy, pz + dz
        in_cube = ((tx >> self.log2) == self.cube[0]) \
            & ((ty >> self.log2) == self.cube[1]) \
            & ((tz >> self.log2) == self.cube[2]) \
            & (tx >= 0) & (tx < self.hi[0]) \
            & (ty >= 0) & (ty < self.hi[1]) \
            & (tz >= 0) & (tz < self.hi[2])
        tkey = node_keys(np.maximum(tx, 0), np.maximum(ty, 0),
                         np.maximum(tz, 0), self.coded_axes,
                         self.depth)
        idx = np.searchsorted(self.keys, tkey)
        idx = np.minimum(idx, len(self.keys) - 1)
        found = (self.keys[idx] == tkey) & in_cube
        return found.astype(np.int64), \
            np.where(found, self.occ[idx], 0)


def analyze_level(px, py, pz, occ, coded_axes, depth,
                  coded_axes_cur, cube_log2=8):
    """Batched context analysis for one level (intra, planar off).

    Returns the level's token stream as a uint32 array — identical to
    the C++ batched pass (native/obuf_ls.cc token layout
    kind(3)|sel(5)|c1(8)|c2(13)|bit(1)).
    """
    px = np.asarray(px, dtype=np.int64)
    py = np.asarray(py, dtype=np.int64)
    pz = np.asarray(pz, dtype=np.int64)
    occ = np.asarray(occ, dtype=np.int64)
    n = px.shape[0]
    keys = node_keys(px, py, pz, coded_axes, depth)
    lut = _LevelLookup(keys, occ, px, py, pz, coded_axes, depth,
                       cube_log2)

    # 6-neighbour pattern (makeGeometryNeighPattern)
    ex_px, _ = lut.probe(px, py, pz, 1, 0, 0)
    ex_mx, co_mx = lut.probe(px, py, pz, -1, 0, 0)
    ex_my, co_my = lut.probe(px, py, pz, 0, -1, 0)
    ex_py_, _ = lut.probe(px, py, pz, 0, 1, 0)
    ex_mz, co_mz = lut.probe(px, py, pz, 0, 0, -1)
    ex_pz, _ = lut.probe(px, py, pz, 0, 0, 1)
    pattern = (ex_px | (ex_mx << 1) | (ex_my << 2) | (ex_py_ << 3)
               | (ex_mz << 4) | (ex_pz << 5))

    # adjacency words: child occupancy of the -x/-y/-z neighbours,
    # gated on the pattern exactly as the reference
    occ_left = np.where(pattern & 2, co_mx, 0)
    occ_front = np.where(pattern & 4, co_my, 0)
    occ_bottom = np.where(pattern & 16, co_mz, 0)

    # 20-neighbour word
    n20 = np.zeros(n, dtype=np.int64)
    for k in range(20):
        ex, _ = lut.probe(px, py, pz, int(_DX20[k]), int(_DY20[k]),
                          int(_DZ20[k]))
        n20 = n20 | (ex << k)

    # NeighInfo (prepareNeighInfo)
    occL = occ_left >> 4
    occF = ((occ_front >> 2) & 3) | ((occ_front >> 4) & 12)
    occB = ((occ_bottom >> 1) & 1) | ((occ_bottom >> 2) & 2) \
        | ((occ_bottom >> 3) & 4) | ((occ_bottom >> 4) & 8)
    occ_or = occ_left | occ_front | occ_bottom

    _, co_lb = lut.probe(px, py, pz, -1, 0, -1)
    _, co_fb = lut.probe(px, py, pz, 0, -1, -1)
    _, co_lf = lut.probe(px, py, pz, -1, -1, 0)
    edge = np.where((n20 >> 3) & 1,
                    ((co_lb & 32) >> 5) | ((co_lb & 128) >> 6), 0)
    edge = edge | np.where((n20 >> 8) & 1,
                           ((co_fb & 8) >> 1) | ((co_fb & 128) >> 4),
                           0)
    edge = edge | np.where((n20 >> 1) & 1, (co_lf & 0xC0) >> 2, 0)

    N3 = ((pattern >> 3) & 4) | ((pattern >> 2) & 2) | (pattern & 1)
    lfb = ((pattern & 6) >> 1) | ((pattern & 16) >> 2)

    nf = dict(occLeft=occ_left, occFront=occ_front,
              occBottom=occ_bottom, occL=occL, occF=occF, occB=occB,
              occOr=occ_or, edge=edge, N3=N3, lfb=lfb, n20=n20,
              pattern=pattern)

    # per-bit contexts for all 8 bits (vectorised ctxBit0..7)
    c1s, c2s, sps = [], [], []
    for i in range(8):
        c1, c2, sp = _CTXBIT[i](nf, occ)
        c1s.append(c1)
        c2s.append(c2)
        sps.append(sp)

    return _assemble_tokens(nf, occ, coded_axes_cur, c1s, c2s, sps)


def _assemble_tokens(nf, occ, coded_axes_cur, c1s, c2s, sps):
    """Replicates encodeOccupancy's emission order (planar off):
    single-child signalling, inferred-bit skips via the coded0
    counters, per-bit OBUF tokens.  Fully unrolled vector ops; the
    final interleave packs the per-node token matrix row-wise."""
    n = occ.shape[0]
    pattern = nf["pattern"]

    # planar masks from non-coded axes (maskPlanar,
    # geometry_octree.cpp:541)
    mask = [0, 0, 0]
    for k in range(3):
        if not (coded_axes_cur & (4 >> k)):
            mask[k] = (0xf0, 0xcc, 0xaa)[k]
    mx, my, mz = mask
    masked = mx | my | mz

    toks = np.zeros((n, 12), dtype=np.uint32)
    vals = np.zeros((n, 12), dtype=bool)
    col = np.zeros(n, dtype=np.int64)

    all_masked = bool(mx and my and mz)
    if all_masked:
        return np.zeros(0, dtype=np.uint32)

    pat0 = pattern == 0
    pc = occ & (occ - 1)
    single = pat0 & (pc == 0)
    # planar off: planarPossible = 7 -> single-child flag always coded
    # on the pattern==0 path
    tok_sc = (np.uint32(TOK_ADAPT) << 29 \
              | np.uint32(CTX_SINGLE_CHILD) << 16).astype(np.uint32) \
        | (single & True).astype(np.uint32)
    toks[pat0, 0] = tok_sc[pat0]
    vals[pat0, 0] = True
    col[pat0] = 1

    # single-child: bypass bits for non-masked axes (z, y, x order)
    for m, b in ((mz, 0xaa), (my, 0xcc), (mx, 0xf0)):
        if m:
            continue
        bit = ((occ & b) != 0).astype(np.uint32)
        t = (np.uint32(TOK_BYPASS) << 29) | bit
        sel = single
        toks[sel, col[sel]] = t[sel]
        vals[sel, col[sel]] = True
        col[sel] += 1

    flag_no_single = pat0 & ~single
    two_masked = bool((mx and my) or (my and mz) or (mx and mz))

    # occupancy-bit emission for nodes not fully resolved above
    emit = ~single
    if two_masked:
        emit = emit & ~flag_no_single

    max_all = np.where(flag_no_single, 6, 7)
    mppx = np.where(flag_no_single & bool(mx), 2, 3)
    mppy = np.where(flag_no_single & bool(my), 2, 3)
    mppz = np.where(flag_no_single & bool(mz), 2, 3)

    mask_config = ((1 if mx else 0) * (1 + (mx != 0x0F))
                   + (1 if my else 0) * 3 * (1 + (my != 0x33))
                   + (1 if mz else 0) * 9 * (1 + (mz != 0x55)))
    coded0 = np.tile(_INIT_CODED0[mask_config], (n, 1)).T.copy()

    for i in range(8):
        if (masked >> i) & 1:
            continue
        m0x = (0xf0 >> i) & 1
        m0y = 2 + ((0xcc >> i) & 1)
        m0z = 4 + ((0xaa >> i) & 1)
        bit_is_one = np.zeros(n, dtype=bool)
        if mx:
            bit_is_one |= coded0[m0x] >= mppx
        bit_is_one |= coded0[0] + coded0[1] >= max_all
        if my:
            bit_is_one |= coded0[m0y] >= mppy
        bit_is_one |= coded0[2] + coded0[3] >= max_all
        if mz:
            bit_is_one |= coded0[m0z] >= mppz
        bit_is_one |= coded0[4] + coded0[5] >= max_all

        code_it = emit & ~bit_is_one
        bitv = ((occ >> i) & 1).astype(np.uint32)
        sel = (sps[i].astype(np.uint32) << 3) | np.uint32(i)
        t = (np.uint32(TOK_OCC) << 29) | (sel << 24) \
            | (c1s[i].astype(np.uint32) << 16) \
            | (c2s[i].astype(np.uint32) << 1) | bitv
        toks[code_it, col[code_it]] = t[code_it]
        vals[code_it, col[code_it]] = True
        col[code_it] += 1

        zero = code_it & (bitv == 0)
        coded0[m0x] += zero
        coded0[m0y] += zero
        coded0[m0z] += zero

    return toks[vals]


# ---------------------------------------------------------------------------
# vectorised ctxBit0..7 (OctreeNeighMap.cpp:409-1358); `z` denotes a
# logical-not-as-bit ((x)==0), mirroring the reference's `!` on ints
# ---------------------------------------------------------------------------

def _z(x):
    return (x == 0).astype(np.int64)


def _nz(x):
    return (x != 0).astype(np.int64)


def _ctxbit0(o, occ):
    N20 = o["n20"]
    occL, occF, occB = o["occL"], o["occF"], o["occB"]
    NN = _KNN4[occL] + _KNN4[occF] + _KNN4[occB]
    NLFB = _nz(occL) + _nz(occF) + _nz(occB)

    # dense: NLFB == 3
    i3 = (0b100 << 16) | ((occB & 1) << 15) | ((occF & 1) << 14) \
        | ((occL & 1) << 13) | ((occB & 0b110) << (11 - 1)) \
        | ((occF & 0b110) << (9 - 1)) | ((occL & 0b110) << (7 - 1)) \
        | (o["N3"] << 4) | _gb(N20, 8, 3, 1, 0)

    # dense: NLFB == 2 (three sub-cases; the reference applies them in
    # sequence so L&F wins over F&B wins over L&B)
    i2_lb = (0b101 << 16) | ((occB & 1) << 15) | ((occL & 1) << 14) \
        | ((occB & 0b110) << (12 - 1)) | ((occL & 0b110) << (10 - 1)) \
        | (_z(occB & 8) << 9) | (_z(occL & 8) << 8) \
        | (_z(o["N3"] & 2) << 7)
    i2_fb = (0b110 << 16) | ((occB & 1) << 15) | ((occF & 1) << 14) \
        | ((occB & 0b110) << (12 - 1)) | ((occF & 0b110) << (10 - 1)) \
        | (_z(occB & 8) << 9) | (_z(occF & 8) << 8) \
        | (_z(o["N3"] & 1) << 7)
    i2_lf = (0b111 << 16) | ((occF & 1) << 15) | ((occL & 1) << 14) \
        | ((occF & 0b110) << (12 - 1)) | ((occL & 0b110) << (10 - 1)) \
        | (_z(occF & 8) << 9) | (_z(occL & 8) << 8) \
        | (_z(o["N3"] & 4) << 7)
    i2 = np.where(_nz(occL) & _nz(occB), i2_lb, 0)
    i2 = np.where(_nz(occF) & _nz(occB), i2_fb, i2)
    i2 = np.where(_nz(occL) & _nz(occF), i2_lf, i2)

    # dense: NLFB == 1
    i1_l = (0b000 << 16) | ((occL & 1) << 15) \
        | ((occL & 0b110) << (13 - 1)) | (_z(occL & 8) << 12) \
        | ((o["edge"] & 0b001100) << (10 - 2))
    i1_f = (0b001 << 16) | ((occF & 1) << 15) \
        | ((occF & 0b110) << (13 - 1)) | (_z(occF & 8) << 12) \
        | ((o["edge"] & 0b000011) << 10)
    i1_b = (0b010 << 16) | ((occB & 1) << 15) \
        | ((occB & 0b110) << (13 - 1)) | (_z(occB & 8) << 12) \
        | ((o["edge"] & 0b110000) << (10 - 4))
    i1 = np.where(_nz(occL), i1_l, np.where(_nz(occF), i1_f, i1_b))
    i1 = i1 | (o["N3"] << 7)

    i12 = np.where(NLFB == 2, i2, i1) | (_gb(N20, 8, 3, 1, 0) << 3) \
        | _gb(N20, 18, 19, 11)
    dense = np.where(NLFB == 3, i3, i12)

    # sparse path (NN <= 1)
    lfb = o["lfb"]
    s_l = (1 << 14) | (_z(occL & 1) << 13) | (_z(lfb & 4) << 12) \
        | (_z(lfb & 2) << 11)
    s_f = (2 << 14) | (_z(occF & 1) << 13) | (_z(lfb & 4) << 12) \
        | (_z(lfb & 1) << 11)
    s_b = (3 << 14) | (_z(occB & 1) << 13) | (_z(lfb & 2) << 12) \
        | (_z(lfb & 1) << 11)
    s_nn = np.where(_nz(occL), s_l, np.where(_nz(occF), s_f, s_b))
    s0 = lfb << 11
    sp = np.where(NN != 0, s_nn, s0)
    sp = sp | (_gb(N20, 1, 3) << 9) | (_gb(N20, 8, 0) << 7)
    lfb_t = (1 << 6) | ((o["occBottom"] & 1) << 5) \
        | ((o["occFront"] & 1) << 4) | ((o["occLeft"] & 1) << 3)
    lfb_f = (_z(o["edge"]) << 5) \
        | ((_nz(o["occLeft"] & 4) | _nz(o["occFront"] & 2)
            | _nz(o["occBottom"] & 4)) << 4) \
        | ((_nz(o["occLeft"] & 2) | _nz(o["occFront"] & 16)
            | _nz(o["occBottom"] & 16)) << 3)
    with_lfb = np.where(_nz(o["occOr"] & 1), lfb_t, lfb_f)
    no_lfb = (_z(o["edge"] & 0b110000) << 6) \
        | (_z(o["edge"] & 0b001100) << 5) \
        | (_z(o["edge"] & 0b000011) << 4)
    sp = sp | np.where(_nz(lfb), with_lfb, no_lfb)
    sp = sp | _gb(N20, 18, 19, 11)

    is_dense = NN > 1
    c1 = np.where(is_dense, dense >> 13, sp >> 12)
    c2 = np.where(is_dense, dense & 0x1FFF, sp & 0x0FFF)
    return c1, c2, ~is_dense


def _ctxbit1(o, occ):
    N20 = o["n20"]
    occL, occF, occB = o["occL"], o["occF"], o["occB"]
    # dense: occF != 0
    base = ((occ & 1) << 18) | (_z(occF & 0b0010) << 17) \
        | (_z(occL) << 16)
    d_l = (_z(occL & 0b0010) << 15) | (_z(o["N3"] & 4) << 14) \
        | (_z(occF & 0b0001) << 13) | (_z(occF & 0b1000) << 12) \
        | (_z(occL & 0b0001) << 11) | (_z(occL & 0b1000) << 10) \
        | (_z(occF & 0b0100) << 9) | (_z(occL & 0b0100) << 8) \
        | ((o["N3"] & 1) << 7) | (_gb(N20, 9, 4, 1, 2) << 3)
    d_nl = (_z(o["N3"] & 4) << 15) | (_z(occF & 0b0001) << 14) \
        | (_z(occF & 0b1000) << 13) | (_z(occF & 0b0100) << 12) \
        | (_gb(N20, 9, 4, 1, 2) << 8) \
        | (_z(o["occBottom"] & 2) << 7) \
        | (_z(o["occFront"] & 2) << 6) \
        | (_z(o["occLeft"] & 2) << 5) | ((o["N3"] & 3) << 3)
    dense = base | np.where(_nz(occL), d_l, d_nl)
    dense = dense | _gb(N20, 11, 16, 19)

    sp = ((occ & 1) << 18) | (_z(occL & 0b0010) << 17) \
        | (_z(o["N3"] & 4) << 16) | (_z(occL & 0b0001) << 15) \
        | (_z(occL & 0b1000) << 14) | (_z(occL & 0b0100) << 13) \
        | ((o["N3"] & 1) << 12) | (_gb(N20, 1, 4) << 10) \
        | (_gb(N20, 9, 2) << 8)
    t = (1 << 7) | (_z(o["occBottom"] & 2) << 6) \
        | (_z(o["occFront"] & 2) << 5) | (_z(o["occLeft"] & 2) << 4)
    f = (_z(o["edge"] & 0b110101) << 6) \
        | ((_nz(o["occLeft"] & 8) | _nz(o["occFront"] & 32)) << 5) \
        | ((_nz(o["occLeft"] & 1) | _nz(o["occFront"] & 1)) << 4)
    sp = sp | np.where(_nz(o["occOr"] & 2), t, f)
    sp = sp | (_z(occB) << 3) | _gb(N20, 11, 16, 19)

    is_dense = _nz(occF).astype(bool)
    c1 = np.where(is_dense, dense >> 13, sp >> 12)
    c2 = np.where(is_dense, dense & 0x1FFF, sp & 0x0FFF)
    return c1, c2, ~is_dense


def _ctxbit2(o, occ):
    N20 = o["n20"]
    occL, occB = o["occL"], o["occB"]
    base = ((occ & 1) << 18) | (_z(occB & 0b0010) << 17) \
        | (_z(occL) << 16)
    d_l = (_z(occL & 0b0100) << 15) | (_z(o["N3"] & 2) << 14) \
        | (_z(occ & 2) << 13) | (_z(occB & 0b1000) << 12) \
        | (_z(occL & 0b1000) << 11) | (_z(occL & 0b0001) << 10) \
        | (_z(occB & 0b0001) << 9) | (_gb(N20, 10, 6, 3) << 6) \
        | (_z(occB & 0b0100) << 5) | (_z(occL & 0b0010) << 4)
    d_nl = (_z(o["N3"] & 2) << 15) | (_z(occ & 2) << 14) \
        | (_z(occB & 0b0001) << 13) | (_z(occB & 0b1000) << 12) \
        | (_z(occB & 0b0100) << 11) | (_gb(N20, 10, 6, 3) << 8) \
        | (_z(o["N3"] & 4) << 7) | (_z(o["occLeft"] & 4) << 6) \
        | (_z(o["occBottom"] & 4) << 5) | (_z(o["occFront"] & 4) << 4)
    dense = base | np.where(_nz(occL), d_l, d_nl)
    dense = dense | (_gb(N20, 0) << 3) | _gb(N20, 18, 19, 11)

    sp = ((occ & 1) << 18) | (_z(occL & 0b0100) << 17) \
        | (_z(o["N3"] & 2) << 16) | (_z(occ & 2) << 15) \
        | (_z(occL & 0b1000) << 14) | (_z(occL & 0b0001) << 13) \
        | (_z(occL & 0b0010) << 12) | (_gb(N20, 3, 6, 10, 5) << 8)
    t = (1 << 7) | (_z(o["occLeft"] & 4) << 6) \
        | (_z(o["occBottom"] & 4) << 5) | (_z(o["occFront"] & 4) << 4)
    f = ((_nz(o["occLeft"] & 1) | _nz(o["occBottom"] & 1)) << 6) \
        | ((_nz(o["occLeft"] & 8) | _nz(o["occBottom"] & 64)) << 5) \
        | (_z(o["edge"] & 0b000011) << 4)
    sp = sp | np.where(_nz(o["occOr"] & 4), t, f)
    sp = sp | (_z(o["occF"]) << 3) | _gb(N20, 18, 19, 11)

    is_dense = _nz(occB).astype(bool)
    c1 = np.where(is_dense, dense >> 13, sp >> 12)
    c2 = np.where(is_dense, dense & 0x1FFF, sp & 0x0FFF)
    return c1, c2, ~is_dense


def _ctxbit3(o, occ):
    N20 = o["n20"]
    occL = o["occL"]
    NN = _KNN4[occL] + _KNN4[occ & 7]
    dense = (_z(occ & 4) << 16) | (_z(occ & 2) << 15) \
        | (_z(occL & 8) << 14) | (o["N3"] << 11) \
        | (_z(occ & 1) << 10) | (_z(occL & 4) << 9) \
        | (_z(occL & 2) << 8) | ((occL & 1) << 7) \
        | (_gb(N20, 11, 6, 4, 0) << 3) | _gb(N20, 16, 19, 18)

    occup = occ & 7
    cnt_o = _nz(occup) + _nz(occup >> 1) + _nz(occup >> 2)
    cnt_l = _nz(occL >> 1) + _nz(occL >> 2) + _nz(occL >> 3)
    sp = (_z(occup) << 17) \
        | (np.where(_nz(occup).astype(bool), cnt_o, cnt_l) << 15) \
        | ((o["N3"] >> 1) << 13) | (_gb(N20, 4, 6, 11, 7) << 9)
    t = (1 << 8) | (_z(o["occBottom"] & 8) << 7) \
        | (_z(o["occFront"] & 8) << 6) | (_z(o["occLeft"] & 8) << 5)
    f = ((o["occLeft"] & 0b110) << 5) \
        | (_z(o["edge"] & 0b110010) << 5)
    sp = sp | np.where(_nz(o["occOr"] & 8), t, f)
    sp = sp | (_z(o["occB"]) << 4) | (_z(o["occF"]) << 3) \
        | _gb(N20, 18, 19, 16)

    is_dense = NN > 1
    c1 = np.where(is_dense, dense >> 11, sp >> 12)
    c2 = np.where(is_dense, dense & 0x07FF, sp & 0x0FFF)
    return c1, c2, ~is_dense


def _ctxbit4(o, occ):
    N20 = o["n20"]
    occF, occB = o["occF"], o["occB"]
    occL4 = occ & 15
    NN = _KNN4[occL4] + _KNN4[occF] + _KNN4[occB]
    NLFB = _nz(occL4) + _nz(occF) + _nz(occB)

    i3 = (0b1000 << 15) | (_z(occB & 4) << 17) | (_z(occF & 4) << 16) \
        | ((occL4 & 1) << 15) | (_z(o["N3"] & 1) << 14) \
        | (_z(occB & 1) << 13) | (_z(occB & 8) << 12) \
        | (_z(occF & 1) << 11) | (_z(occF & 8) << 10) \
        | (_z(occL4 & 2) << 9) | (_z(occL4 & 4) << 8) \
        | (_z(occB & 2) << 7) | (_z(occF & 2) << 6) \
        | ((o["N3"] >> 1) << 4) | _gb(N20, 15, 13, 8, 12)

    i2_lb = (0b0100 << 15) | (_z(occB & 4) << 14) \
        | (_z(occL4 & 1) << 13) | (_z(o["N3"] & 1) << 12) \
        | (_z(occB & 1) << 11) | (_z(occB & 8) << 10) \
        | (_z(occL4 & 2) << 9) | (_z(occL4 & 4) << 8) \
        | (_z(occB & 2) << 7) | (_z(occL4 & 8) << 6)
    i2_fb = (0b0101 << 15) | (_z(occB & 4) << 14) \
        | (_z(occF & 4) << 13) | (_z(o["N3"] & 1) << 12) \
        | (_z(occB & 1) << 11) | (_z(occB & 8) << 10) \
        | (_z(occF & 1) << 9) | (_z(occF & 8) << 8) \
        | (_z(occB & 2) << 7) | (_z(occF & 2) << 6)
    i2_lf = (0b0110 << 15) | (_z(occF & 4) << 14) \
        | (_z(occL4 & 1) << 13) | (_z(o["N3"] & 1) << 12) \
        | (_z(occF & 1) << 11) | (_z(occF & 8) << 10) \
        | (_z(occL4 & 2) << 9) | (_z(occL4 & 4) << 8) \
        | (_z(occF & 2) << 7) | (_z(occL4 & 8) << 6)
    i2 = np.where(_nz(occL4) & _nz(occB), i2_lb,
                  np.where(_nz(occF) & _nz(occB), i2_fb, i2_lf))
    i2 = i2 | (_gb(N20, 15, 13, 8) << 3) | _gb(N20, 12, 16, 18)

    i1_l = (0b0000 << 15) | ((occL4 & 1) << 14) \
        | (_z(o["N3"] & 1) << 13) | ((occL4 & 0b110) << (11 - 1)) \
        | (_z(occL4 & 8) << 10) | ((o["edge"] & 0b001100) << (8 - 2))
    i1_f = (0b0001 << 15) | (_z(occF & 0b0100) << 14) \
        | (_z(o["N3"] & 1) << 13) | (_z(occF & 0b0001) << 12) \
        | (_z(occF & 0b1000) << 11) | (_z(occF & 0b0010) << 10) \
        | ((o["edge"] & 0b000011) << 8)
    i1_b = (0b0010 << 15) | (_z(occB & 0b0100) << 14) \
        | (_z(o["N3"] & 1) << 12) | (_z(occB & 0b0001) << 12) \
        | (_z(occB & 0b1000) << 11) | (_z(occB & 0b0010) << 10) \
        | ((o["edge"] & 0b110000) << (8 - 4))
    i1 = np.where(_nz(occL4), i1_l, np.where(_nz(occF), i1_f, i1_b))
    i1 = i1 | ((o["N3"] >> 1) << 6) | (_gb(N20, 15, 13, 8) << 3) \
        | _gb(N20, 12, 16, 18)

    dense = np.where(NLFB == 3, i3, np.where(NLFB == 2, i2, i1))

    lfb = o["lfb"]
    s_l = (1 << 14) | (_z(occL4 & 1) << 13) | (_z(lfb & 4) << 12) \
        | (_z(lfb & 2) << 11)
    s_f = (2 << 14) | (_z(occF & 1) << 13) | (_z(lfb & 4) << 12) \
        | (_z(lfb & 1) << 11)
    s_b = (3 << 14) | (_z(occB & 1) << 13) | (_z(lfb & 2) << 12) \
        | (_z(lfb & 1) << 11)
    s_nn = np.where(_nz(occL4), s_l, np.where(_nz(occF), s_f, s_b))
    sp = np.where(NN != 0, s_nn, lfb << 11)
    sp = sp | (_gb(N20, 8, 13, 15, 12) << 7)
    t = (1 << 6) | (_z(o["occBottom"] & 16) << 5) \
        | (_z(o["occFront"] & 16) << 4) | (_z(o["occLeft"] & 16) << 3)
    f = (_z(o["edge"]) << 5) \
        | ((_nz(o["occLeft"] & 64) | _nz(o["occFront"] & 8)
            | _nz(o["occBottom"] & 8)) << 4) \
        | ((_nz(o["occLeft"] & 32) | _nz(o["occFront"] & 64)
            | _nz(o["occBottom"] & 32)) << 3)
    with_lfb = np.where(_nz(o["occOr"] & 16), t, f)
    no_lfb = (_z(o["edge"] & 0b110000) << 6) \
        | (_z(o["edge"] & 0b001100) << 5) \
        | (_z(o["edge"] & 0b000011) << 4)
    sp = sp | np.where(_nz(lfb), with_lfb, no_lfb)
    sp = sp | _gb(N20, 16, 18, 19)

    is_dense = NN > 1
    c1 = np.where(is_dense, dense >> 13, sp >> 12)
    c2 = np.where(is_dense, dense & 0x1FFF, sp & 0x0FFF)
    return c1, c2, ~is_dense


def _ctxbit5(o, occ):
    N20 = o["n20"]
    occF = o["occF"]
    occL4 = occ & 15
    base = (((occ >> 4) & 1) << 18) | (_z(occF & 0b1000) << 17) \
        | (_z(occL4) << 16)
    d_l = (_z(occL4 & 0b0010) << 15) | (_z(o["N3"] & 4) << 14) \
        | (_z(o["N3"] & 1) << 13) | (_z(occF & 0b0010) << 12) \
        | (_z(occF & 0b0100) << 11) | (_z(occL4 & 0b0001) << 10) \
        | (_z(occL4 & 0b1000) << 9) | (_z(occF & 0b0001) << 8) \
        | (_z(occL4 & 0b0100) << 7) | (_gb(N20, 16, 13, 9, 14) << 3)
    d_nl = (_z(o["N3"] & 4) << 15) | (_z(o["N3"] & 1) << 14) \
        | (_z(occF & 0b0010) << 13) | (_z(occF & 0b0100) << 12) \
        | (_z(occF & 0b0001) << 11) | (_gb(N20, 16, 13, 9, 14) << 7) \
        | (_z(o["occBottom"] & 32) << 6) \
        | (_z(o["occFront"] & 32) << 5) \
        | (_z(o["occLeft"] & 32) << 4) | (_z(o["N3"] & 2) << 3)
    dense = base | np.where(_nz(occL4), d_l, d_nl)
    dense = dense | _gb(N20, 18, 19, 11)

    sp = (_z((occ >> 4) & 1) << 18) | (_z(occL4 & 0b0010) << 17) \
        | (_z(o["N3"] & 4) << 16) | (_z(o["N3"] & 1) << 15) \
        | (_z(occL4 & 0b0001) << 14) | (_z(occL4 & 0b1000) << 13) \
        | (_z(o["occL"] & 0b0100) << 12) \
        | (_gb(N20, 9, 13, 16, 14) << 8)
    t = (1 << 7) | (_z(o["occBottom"] & 32) << 6) \
        | (_z(o["occFront"] & 32) << 5) | (_z(o["occLeft"] & 32) << 4)
    f = (_z(o["edge"] & 0b111100) << 6) \
        | ((_nz(o["occLeft"] & 128) | _nz(o["occFront"] & 2)) << 5) \
        | ((_nz(o["occLeft"] & 16) | _nz(o["occFront"] & 16)) << 4)
    sp = sp | np.where(_nz(o["occOr"] & 32), t, f)
    sp = sp | (_z(o["occB"]) << 3) | _gb(N20, 18, 19, 11)

    is_dense = _nz(occF).astype(bool)
    c1 = np.where(is_dense, dense >> 13, sp >> 12)
    c2 = np.where(is_dense, dense & 0x1FFF, sp & 0x0FFF)
    return c1, c2, ~is_dense


def _ctxbit6(o, occ):
    N20 = o["n20"]
    occB = o["occB"]
    occL4 = occ & 15
    base = (_z((occ >> 4) & 1) << 18) | (_z(occB & 0b1000) << 17) \
        | (_z(occL4) << 16)
    d_l = (_z(occL4 & 0b0100) << 15) | (_z(o["N3"] & 1) << 14) \
        | (_z(o["N3"] & 2) << 13) | (_z((occ >> 4) & 2) << 12) \
        | (_z(occB & 0b0010) << 11) | (_z(occL4 & 0b0001) << 10) \
        | (_z(occL4 & 0b1000) << 9) | (_z(occB & 0b0100) << 8) \
        | (_gb(N20, 18, 15, 10) << 5) | (_z(occB & 0b0001) << 4) \
        | (_z(occL4 & 0b0010) << 3) | (_gb(N20, 17) << 2) \
        | (_gb(N20, 0) << 1) | (_gb(N20, 11) << 0)
    d_nl = (_z(o["N3"] & 2) << 15) | (_z(o["N3"] & 1) << 14) \
        | (_z((occ >> 4) & 2) << 13) | (_z(occB & 0b0010) << 12) \
        | (_z(occB & 0b0100) << 11) | (_z(occB & 0b0001) << 10) \
        | (_z(o["occLeft"] & 64) << 9) \
        | (_z(o["occBottom"] & 64) << 8) \
        | (_z(o["occFront"] & 64) << 7) \
        | (_gb(N20, 18, 15, 10, 17) << 3) | (_gb(N20, 0) << 2) \
        | _gb(N20, 11, 19)
    dense = base | np.where(_nz(occL4), d_l, d_nl)

    sp = (_z((occ >> 4) & 1) << 18) | (_z(occL4 & 0b0100) << 17) \
        | (_z(o["N3"] & 1) << 16) | (_z((occ >> 4) & 2) << 15) \
        | (_z(occL4 & 0b1000) << 14) | (_z(occL4 & 0b0001) << 13) \
        | (_z(occL4 & 0b0010) << 12) \
        | (_gb(N20, 17, 18, 15, 10) << 8)
    t = (1 << 7) | (_z(o["occLeft"] & 64) << 6) \
        | (_z(o["occBottom"] & 64) << 5) | (_z(o["occFront"] & 64) << 4)
    f = ((_nz(o["occLeft"] & 1) | _nz(o["occBottom"] & 1)) << 6) \
        | ((_nz(o["occLeft"] & 8) | _nz(o["occBottom"] & 64)) << 5) \
        | (_z(o["edge"] & 0b000011) << 4)
    sp = sp | np.where(_nz(o["occOr"] & 64), t, f)
    sp = sp | (_z(o["occF"]) << 3) | _gb(N20, 19, 16, 11)

    is_dense = _nz(occB).astype(bool)
    c1 = np.where(is_dense, dense >> 13, sp >> 12)
    c2 = np.where(is_dense, dense & 0x1FFF, sp & 0x0FFF)
    return c1, c2, ~is_dense


def _ctxbit7(o, occ):
    N20 = o["n20"]
    occL4 = occ & 15
    occH = (occ >> 4) & 7
    NN = _KNN4[occL4] + _KNN4[occH]
    dense = (_z((occ >> 4) & 4) << 16) | (_z((occ >> 4) & 2) << 15) \
        | (_z(occL4 & 8) << 14) | (o["N3"] << 11) \
        | (_z((occ >> 4) & 1) << 10) | (_gb(N20, 11) << 9) \
        | (_z(occL4 & 4) << 8) | (_gb(N20, 16) << 7) \
        | (_z(occL4 & 2) << 6) | (_gb(N20, 18) << 5) \
        | ((occL4 & 1) << 4) | (_gb(N20, 19) << 3) \
        | (_gb(N20, 0) << 2) | _gb(N20, 17, 10)

    cnt_h = _nz(occH) + _nz(occH >> 1) + _nz(occH >> 2)
    cnt_l = _nz(occL4 >> 1) + _nz(occL4 >> 2) + _nz(occL4 >> 3)
    sp = (_z(occH) << 17) \
        | np.where(_nz(occH).astype(bool),
                   (cnt_h << 15) | (_z(o["N3"] & 2) << 14),
                   (cnt_l << 15) | (_z(o["N3"] & 1) << 14))
    sp = sp | (_z(o["N3"] & 4) << 13) \
        | (_gb(N20, 11, 16, 18, 19) << 9)
    t = (1 << 8) | (_z(o["occLeft"] & 128) << 7) \
        | (_z(o["occFront"] & 128) << 6) \
        | (_z(o["occBottom"] & 128) << 5)
    f = ((o["occLeft"] & 0b01100000) << 1) \
        | ((_nz(o["occF"] & 0b0011) | _nz(o["occB"] & 0b0110)) << 5)
    sp = sp | np.where(_nz(o["occOr"] & 128), t, f)
    sp = sp | (_z(o["occB"]) << 4) | (_z(o["occF"]) << 3) \
        | _gb(N20, 7, 17, 10)

    is_dense = NN > 1
    c1 = np.where(is_dense, dense >> 11, sp >> 12)
    c2 = np.where(is_dense, dense & 0x07FF, sp & 0x0FFF)
    return c1, c2, ~is_dense


_CTXBIT = [_ctxbit0, _ctxbit1, _ctxbit2, _ctxbit3, _ctxbit4, _ctxbit5,
           _ctxbit6, _ctxbit7]
