"""Port parity: the host modules of the frame codec
(mpeg_pcc_tmc13_tpu_torch ops/processing, partition, recolour, motion,
lod; models/attr_raht, attr_predlift, attributes, geometry_predictive,
geometry_obuf) against the JAX package's, on the same numpy inputs made
from a seed.

Every output is integer data or bytes from the shared native range
coder, so the tolerance is 0: arrays and streams must be equal exactly.
The attribute codecs run both their native fast path and their numpy
path (the fast path turned off on both sides).
"""

import dataclasses

import numpy as np
import pytest

from mpeg_pcc_tmc13_tpu.bitstream import entropy, hls
from mpeg_pcc_tmc13_tpu.models import attr_predlift as jpl
from mpeg_pcc_tmc13_tpu.models import attr_raht as jraht
from mpeg_pcc_tmc13_tpu.models import attributes as jattr
from mpeg_pcc_tmc13_tpu.models import geometry_obuf as jobuf
from mpeg_pcc_tmc13_tpu.models import geometry_predictive as jpred
from mpeg_pcc_tmc13_tpu.models.pointcloud import PointCloud
from mpeg_pcc_tmc13_tpu.ops import lod as jlod
from mpeg_pcc_tmc13_tpu.ops import motion as jmotion
from mpeg_pcc_tmc13_tpu.ops import partition as jpart
from mpeg_pcc_tmc13_tpu.ops import processing as jproc
from mpeg_pcc_tmc13_tpu.ops import recolour as jrec
from mpeg_pcc_tmc13_tpu_torch.models import attr_predlift as tpl
from mpeg_pcc_tmc13_tpu_torch.models import attr_raht as traht
from mpeg_pcc_tmc13_tpu_torch.models import attributes as tattr
from mpeg_pcc_tmc13_tpu_torch.models import geometry_obuf as tobuf
from mpeg_pcc_tmc13_tpu_torch.models import geometry_predictive as tpred
from mpeg_pcc_tmc13_tpu_torch.ops import lod as tlod
from mpeg_pcc_tmc13_tpu_torch.ops import motion as tmotion
from mpeg_pcc_tmc13_tpu_torch.ops import partition as tpart
from mpeg_pcc_tmc13_tpu_torch.ops import processing as tproc
from mpeg_pcc_tmc13_tpu_torch.ops import recolour as trec
from mpeg_pcc_tmc13_tpu_torch.utils import morton

AE = hls.AttributeEncoding


def _pos(n, bits, seed, dups=False):
    rng = np.random.default_rng(seed)
    p = rng.integers(0, 1 << bits, (n, 3)).astype(np.int64)
    if dups:
        p = np.concatenate([p, p[rng.integers(0, n, n // 4)]])
    return p


def _morton_cloud(n, bits, seed, ncomp=3):
    """Unique Morton-ordered positions with smooth, noisy values."""
    rng = np.random.default_rng(seed)
    codes = np.unique(morton.encode(_pos(n, bits, seed)))
    pos = morton.decode(codes)
    base = (pos @ np.array([3, 5, 7]))[:, None] * np.arange(1, ncomp + 1)
    vals = (base + rng.integers(0, 40, (pos.shape[0], ncomp))) % 256
    return pos, vals.astype(np.int64)


def _eq(a, b):
    if isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _eq(x, y)
    elif isinstance(a, PointCloud):
        for f in ("positions", "colors", "reflectances"):
            _eq(getattr(a, f), getattr(b, f))
    elif a is None:
        assert b is None
    else:
        assert np.array_equal(np.asarray(a), np.asarray(b))


# -- ops/processing ------------------------------------------------------

def test_processing_matches_jax():
    rng = np.random.default_rng(1)
    src = rng.uniform(-50, 900, (2000, 3))
    for num, den in ((1, 1), (1, 4), (3, 7)):
        _eq(tproc.quantize_positions(src, num, den, (1, 2, 3)),
            jproc.quantize_positions(src, num, den, (1, 2, 3)))
        grid = jproc.quantize_positions(src, num, den, (0, 0, 0))
        _eq(tproc.dequantize_positions(grid, num, den, (0, 0, 0)),
            jproc.dequantize_positions(grid, num, den, (0, 0, 0)))
    pos = _pos(1500, 6, 2, dups=True)
    cols = rng.integers(0, 256, (pos.shape[0], 3))
    refl = rng.integers(0, 1024, pos.shape[0])
    cloud = PointCloud(pos, cols, refl)
    _eq(tproc.dedup_with_attributes(cloud), jproc.dedup_with_attributes(cloud))
    _eq(tproc.rgb_to_ycgcor(cols), jproc.rgb_to_ycgcor(cols))
    ycc = jproc.rgb_to_ycgcor(cols)
    _eq(tproc.ycgcor_to_rgb(ycc, 8), jproc.ycgcor_to_rgb(ycc, 8))
    for bd in (8, 10):
        _eq(tproc.rgb_to_ycbcr_bt709(cols, bd),
            jproc.rgb_to_ycbcr_bt709(cols, bd))
        y = jproc.rgb_to_ycbcr_bt709(cols, bd)
        _eq(tproc.ycbcr_bt709_to_rgb(y, bd), jproc.ycbcr_bt709_to_rgb(y, bd))


# -- ops/partition -------------------------------------------------------

@pytest.mark.parametrize("method", list(jpart.PartitionMethod))
def test_partition_matches_jax(method):
    pos = _pos(3000, 9, 3)
    kw = dict(max_points=700, min_points=100, octree_depth=2)
    _eq(tpart.partition_slices(pos, tpart.PartitionMethod(int(method)), **kw),
        jpart.partition_slices(pos, method, **kw))
    _eq(tpart.tile_partition(pos, 128), jpart.tile_partition(pos, 128))


# -- ops/recolour --------------------------------------------------------

def test_recolour_matches_jax():
    rng = np.random.default_rng(4)
    src = _pos(2500, 8, 5)
    cols = rng.integers(0, 256, (src.shape[0], 3))
    refl = rng.integers(0, 1024, src.shape[0])
    tgt = np.unique(src >> 1, axis=0)
    q = _pos(400, 8, 6)
    _eq(trec.knn(src, q, k=3), jrec.knn(src, q, k=3))
    _eq(trec.nearest_neighbor(src, q), jrec.nearest_neighbor(src, q))
    for params in (None, dict(num_neighbours_fwd=4,
                              skip_avg_if_identical_bwd=True)):
        tp = trec.RecolourParams(**params) if params else None
        jp = jrec.RecolourParams(**params) if params else None
        _eq(trec.recolour(PointCloud(src, cols, refl), tgt, 1, 2, params=tp),
            jrec.recolour(PointCloud(src, cols, refl), tgt, 1, 2, params=jp))


# -- ops/motion ----------------------------------------------------------

def test_global_motion_matches_jax():
    ref = _pos(2000, 8, 7)
    cur = ref + np.array([3, -2, 1])
    gm_t = tmotion.estimate_global_motion(ref, cur)
    gm_j = jmotion.estimate_global_motion(ref, cur)
    _eq(gm_t, gm_j)
    _eq(tmotion.apply_global_motion(ref, *gm_j),
        jmotion.apply_global_motion(ref, *gm_j))
    _eq(tmotion.identity_motion(), jmotion.identity_motion())


@pytest.mark.parametrize("split", [False, True])
def test_lpu_motion_matches_jax(split):
    """Cuboid LPU local motion: the search, its signalling through the
    range coder, and the decoder's mirror."""
    depth, lpu = 8, 5
    cur = _pos(3000, depth, 8)
    ref = np.clip(cur + np.random.default_rng(9).integers(-2, 3, cur.shape),
                  0, (1 << depth) - 1)
    out, streams = [], []
    for m in (tmotion, jmotion):
        enc = entropy.RangeEncoder()
        ctx = entropy.new_contexts(m.LPU_CTX_SIZE)
        if split:
            z0, thr = m.estimate_ground(ref)
            out.append((z0, thr))
            out.append(m.encode_lpu_motion_split(enc, ctx, ref, cur, lpu,
                                                 depth, z0, thr))
        else:
            out.append(m.encode_lpu_motion(enc, ctx, ref, cur, lpu, depth))
        streams.append(enc.get_bytes())
    assert streams[0] == streams[1]
    half = len(out) // 2
    _eq(out[:half], out[half:])
    dec = entropy.RangeDecoder(streams[0])
    ctx = entropy.new_contexts(tmotion.LPU_CTX_SIZE)
    if split:
        got = tmotion.decode_lpu_motion_split(dec, ctx, ref, lpu, depth,
                                              *out[0])
    else:
        got = tmotion.decode_lpu_motion(dec, ctx, ref, lpu, depth)
    _eq(got, out[-1])


# -- ops/lod -------------------------------------------------------------

@pytest.mark.parametrize("native", [True, False])
def test_lod_matches_jax(native, monkeypatch):
    if not native:
        monkeypatch.setattr(entropy, "_LIB", None)
    # the numpy KNN fallback is slow: fewer points there
    pos, _ = _morton_cloud(2500 if native else 400, 8, 10)
    assert tlod.estimate_dist2(pos) == jlod.estimate_dist2(pos)
    lv_d = jlod.assign_lod_levels_dist2(pos, 5, 16 ** 2)
    _eq(tlod.assign_lod_levels_dist2(pos, 5, 16 ** 2), lv_d)
    lv = jlod.assign_lod_levels(pos.shape[0], 6)
    _eq(tlod.assign_lod_levels(pos.shape[0], 6), lv)
    _eq(tlod.lod_order(lv), jlod.lod_order(lv))
    ref = _pos(500 if native else 100, 8, 11)
    for levels in (lv, lv_d):
        nb_t = tlod.knn_predictors(pos, levels, 3, ref_positions=ref,
                                   intra_lod0=True)
        nb_j = jlod.knn_predictors(pos, levels, 3, ref_positions=ref,
                                   intra_lod0=True)
        _eq(nb_t, nb_j)
    vals = np.random.default_rng(12).integers(
        0, 256, (pos.shape[0] + ref.shape[0], 3)).astype(np.int64)
    nbr, wq = nb_j[0], nb_j[1]
    _eq(tlod.predict_q16(vals, nbr, wq), jlod.predict_q16(vals, nbr, wq))


# -- models/attr_raht, attr_predlift, attributes --------------------------

def _attr_case(kind):
    """(values, Morton-ordered positions, aps, desc, abh) of one
    attribute-codec configuration."""
    pos, vals = _morton_cloud(1500, 7, 13)
    desc = hls.AttributeDescription("color", 3, 8)
    abh = hls.AttributeBrickHeader()
    if kind == "raht_fixed_point":
        aps = hls.AttributeParameterSet(init_qp=28)
    elif kind == "raht_float":
        aps = hls.AttributeParameterSet(init_qp=28, raht_fixed_point=False)
    elif kind == "raht_haar_mono":
        aps = hls.AttributeParameterSet(init_qp=4, raht_integer_haar=True,
                                        raht_fixed_point=False)
        desc = hls.AttributeDescription("reflectance", 1, 8)
        vals = vals[:, 0]
    elif kind == "raht_layer_qp":
        aps = hls.AttributeParameterSet(init_qp=30)
        abh = hls.AttributeBrickHeader(layer_qp_deltas_luma=[2, -1],
                                       layer_qp_deltas_chroma=[1])
    elif kind == "pred":
        aps = hls.AttributeParameterSet(attr_encoding=AE.PRED, init_qp=16,
                                        lod_levels=6)
    elif kind == "pred_dist2":
        aps = hls.AttributeParameterSet(attr_encoding=AE.PRED, init_qp=4,
                                        dist2=16 ** 2)
    else:
        aps = hls.AttributeParameterSet(attr_encoding=AE.LIFT, init_qp=22,
                                        lod_levels=6)
    return vals, pos, aps, desc, abh


_ATTR_KINDS = ["raht_fixed_point", "raht_float", "raht_haar_mono",
               "raht_layer_qp", "pred", "pred_dist2", "lift"]


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("kind", _ATTR_KINDS)
def test_attribute_codecs_match_jax(kind, native, monkeypatch):
    """attr_raht / attr_predlift encode and decode: same bytes, same
    trained contexts, same decoded values."""
    if not native:
        # the numpy path: RAHT's native brick off, and LoD/KNN on
        # their numpy fallbacks (no native library at all)
        for m in (traht, jraht):
            monkeypatch.setattr(m, "_native_fastpath_ok", lambda *a: False)
        if kind.startswith(("pred", "lift")):
            monkeypatch.setattr(entropy, "_LIB", None)
    vals, pos, aps, desc, abh = _attr_case(kind)
    tmod, jmod = (traht, jraht) if kind.startswith("raht") else (tpl, jpl)
    ct, cj = tattr.AttributeContexts(), jattr.AttributeContexts()
    bt = tmod.encode(vals, pos, aps, desc, ct, abh=abh)
    bj = jmod.encode(vals, pos, aps, desc, cj, abh=abh)
    assert bt == bj
    for f in dataclasses.fields(cj):
        _eq(getattr(ct, f.name), getattr(cj, f.name))
    dt = tmod.decode(bj, pos, aps, desc, tattr.AttributeContexts(), abh=abh)
    dj = jmod.decode(bj, pos, aps, desc, jattr.AttributeContexts(), abh=abh)
    _eq(dt, dj)


@pytest.mark.parametrize("encoding", list(AE))
def test_attribute_dispatch_matches_jax(encoding):
    """models/attributes encode/decode over positions in predictive
    chain order (not Morton), so the Morton permutation matters; inter
    prediction from a reference for the transform codecs."""
    vals, pos, _, desc, _ = _attr_case("pred")
    order = np.random.default_rng(14).permutation(pos.shape[0])
    vals, pos = vals[order], pos[order]
    aps = hls.AttributeParameterSet(attr_encoding=encoding, init_qp=22,
                                    inter_prediction_enabled=True)
    ref = (pos[::3] + 1, vals[::3])
    bt = tattr.encode(vals, pos, aps, desc, tattr.AttributeContexts(),
                      ref=ref)
    bj = jattr.encode(vals, pos, aps, desc, jattr.AttributeContexts(),
                      ref=ref)
    assert bt == bj
    _eq(tattr.decode(bj, pos, aps, desc, tattr.AttributeContexts(), ref=ref),
        jattr.decode(bj, pos, aps, desc, jattr.AttributeContexts(), ref=ref))


def test_attribute_contexts_are_shared():
    """AttributeContexts is the reference's own class (a jax-free
    module), so a trained reference state needs no carrying function."""
    assert tattr.AttributeContexts is jattr.AttributeContexts
    assert tattr.encode_raw is jattr.encode_raw
    assert tattr.RES_CTX_SIZE == jattr.RES_CTX_SIZE


# -- models/geometry_predictive -------------------------------------------

@pytest.mark.parametrize("case", ["morton", "azimuth", "inter", "angular"])
def test_predictive_geometry_matches_jax(case):
    pos = np.unique(_pos(2000, 8, 15), axis=0)
    kw, dkw = {}, {}
    if case == "azimuth":
        kw = dict(sort_mode=jpred.SortMode.AZIMUTH)
    elif case == "inter":
        ref = pos[::2] + 1
        kw = dkw = dict(ref_positions=ref)
    elif case == "angular":
        lasers = (np.array([-20000, -5000, 0, 9000], np.int64),
                  np.zeros(4, np.int64), np.full(4, 512, np.int64))
        kw = dkw = dict(angular=True, lasers=lasers,
                        origin=np.array([128, 128, 128], np.int64))
    et, ej = entropy.RangeEncoder(), entropy.RangeEncoder()
    ct, cj = tpred.PredGeomContexts(), jpred.PredGeomContexts()
    tkw = dict(kw)
    if "sort_mode" in tkw:
        tkw["sort_mode"] = tpred.SortMode(int(kw["sort_mode"]))
    ot = tpred.encode(pos, et, ct, **tkw)
    oj = jpred.encode(pos, ej, cj, **kw)
    _eq(ot, oj)
    stream = ej.get_bytes()
    assert et.get_bytes() == stream
    _eq(ct.ctx, cj.ctx)
    _eq(tpred.decode(len(pos), entropy.RangeDecoder(stream),
                     tpred.PredGeomContexts(), **dkw),
        jpred.decode(len(pos), entropy.RangeDecoder(stream),
                     jpred.PredGeomContexts(), **dkw))


def test_predictive_contexts_carry_across():
    """contexts_from_reference copies a trained reference state; the
    next slice then codes to the reference's bytes."""
    cj = jpred.PredGeomContexts()
    jpred.encode(_pos(1500, 8, 16), entropy.RangeEncoder(), cj)
    ct = tpred.contexts_from_reference(cj)
    assert ct.ctx is not cj.ctx
    _eq(ct.ctx, cj.ctx)
    nxt = _pos(1500, 8, 17)
    et, ej = entropy.RangeEncoder(), entropy.RangeEncoder()
    tpred.encode(nxt, et, ct)
    jpred.encode(nxt, ej, cj)
    assert et.get_bytes() == ej.get_bytes()


# -- models/geometry_obuf -------------------------------------------------

@pytest.mark.parametrize("case", ["intra", "planar", "inter", "scalable"])
def test_obuf_decode_matches_jax(case):
    pos = np.unique(_pos(3000, 8, 18), axis=0)
    gps = hls.GeometryParameterSet(planar_mode_enabled=case == "planar")
    axis_bits = (8, 8, 8)
    ref = np.unique(pos[::2] ^ 1, axis=0) if case == "inter" else None
    payload = jobuf.encode(pos, 8, axis_bits, gps, ref_local=ref)
    assert tobuf.encode is jobuf.encode
    kw = dict(ref_local=ref)
    if case == "scalable":
        kw = dict(skip_layers=2)
    _eq(tobuf.decode(payload, len(pos), 8, axis_bits, gps, **kw),
        jobuf.decode(payload, len(pos), 8, axis_bits, gps, **kw))
