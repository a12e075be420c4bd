"""Trisoup geometry of the port held to the JAX package's.

The port has one trisoup ops module (``ops/trisoup.py``): the JAX
package's ``ops/trisoup2.py`` plus the edge helpers of its older
``ops/trisoup.py``.  The same seeded surface goes through both packages,
function by function, then through ``models.geometry_trisoup`` and the
frame codec.  Every output is integer or bytes: tolerance 0.
"""

import io

import numpy as np
import pytest
import torch

from mpeg_pcc_tmc13_tpu.bitstream import entropy as jentropy
from mpeg_pcc_tmc13_tpu.bitstream.tlv import write_tlv as jwrite_tlv
from mpeg_pcc_tmc13_tpu.models import geometry_octree as jgo
from mpeg_pcc_tmc13_tpu.models import geometry_trisoup as jgt
from mpeg_pcc_tmc13_tpu.models.pointcloud import PointCloud as JPointCloud
from mpeg_pcc_tmc13_tpu.ops import trisoup as jv1
from mpeg_pcc_tmc13_tpu.ops import trisoup2 as jv2
from mpeg_pcc_tmc13_tpu.ops import trisoup_ref as jref
from mpeg_pcc_tmc13_tpu.runtime import encoder as jenc
from mpeg_pcc_tmc13_tpu_torch.bitstream import entropy as tentropy
from mpeg_pcc_tmc13_tpu_torch.bitstream.tlv import (PayloadType, iter_tlv,
                                                    write_tlv)
from mpeg_pcc_tmc13_tpu_torch.models import geometry_octree as tgo
from mpeg_pcc_tmc13_tpu_torch.models import geometry_trisoup as tgt
from mpeg_pcc_tmc13_tpu_torch.models.pointcloud import PointCloud
from mpeg_pcc_tmc13_tpu_torch.ops import trisoup as tts
from mpeg_pcc_tmc13_tpu_torch.ops import trisoup_ref as tref
from mpeg_pcc_tmc13_tpu_torch.runtime import decoder as tdec
from mpeg_pcc_tmc13_tpu_torch.runtime import encoder as tenc
from mpeg_pcc_tmc13_tpu_torch.utils import morton
from mpeg_pcc_tmc13_tpu_torch.utils.device import NoDeviceError

torch.set_num_threads(2)

DEPTH, S = 7, 2


def surface_cloud(n, depth, seed=0):
    """tests/test_trisoup.py::surface_cloud: a smooth height field."""
    rng = np.random.default_rng(seed)
    size = 1 << depth
    xy = rng.integers(0, size, (n, 2))
    z = (size / 2 + (size / 4) * np.sin(2 * np.pi * xy[:, 0] / size)
         * np.cos(2 * np.pi * xy[:, 1] / size)).astype(np.int64)
    pos = np.column_stack([xy[:, 0], xy[:, 1], np.clip(z, 0, size - 1)])
    return morton.decode(np.unique(morton.encode(pos)))


@pytest.fixture(scope="module")
def stages():
    """The encoder's stages on one surface, from the JAX package: the
    inputs of each function under test."""
    pos = surface_cloud(3000, DEPTH, seed=1)
    codes = np.sort(morton.encode(pos))
    node_codes = np.unique(codes >> (3 * S))
    pts = morton.decode(codes)
    point_node = np.searchsorted(node_codes, codes >> (3 * S))
    dse = jv2.distance_search(node_codes.size, codes.size, 1 << S)
    uniq, present, vpos = jv2.determine_vertices(pts, node_codes,
                                                 point_node, S, dse)
    verts, mask = jv2.node_vertices_fp(node_codes, uniq, present, vpos, S)
    ns = jv2.build_surface(verts, mask, S)
    _, origin = jv1.edge_keys_for_nodes(node_codes, S)
    driftq = jv2.determine_drift(pts, point_node, origin, ns, S)
    return dict(pos=pos, node_codes=node_codes, pts=pts,
                point_node=point_node, dse=dse, uniq=uniq, present=present,
                vpos=vpos, verts=verts, mask=mask, origin=origin,
                driftq=driftq, n_points=int(codes.size))


def _same(a, b):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _same(a[k], b[k])
    elif a is None:
        assert b is None
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)


def _surface_state(ns):
    return {k: v for k, v in vars(ns).items()}


# -- module parity ---------------------------------------------------------

def test_edge_tables_equal():
    for name in ("_EDGE_AXIS", "_EDGE_C1", "_EDGE_C2"):
        _same(getattr(tts, name), getattr(jv1, name))
    assert tts._PERP == jv1._PERP
    assert (tts.FP, tts.FPONE, tts.FPHALF) == (jv2.FP, jv2.FPONE,
                                               jv2.FPHALF)


def test_edge_keys_for_nodes(stages):
    _same(tts.edge_keys_for_nodes(stages["node_codes"], S),
          jv1.edge_keys_for_nodes(stages["node_codes"], S))


def test_unique_edges(stages):
    keys, _ = jv1.edge_keys_for_nodes(stages["node_codes"], S)
    got, want = tts.unique_edges(keys), jv1.unique_edges(keys)
    _same(got, want)
    assert got[0].size < keys.size             # neighbours share edges


@pytest.mark.parametrize("nodes,points,w", [(100, 3000, 4), (5000, 5000, 8),
                                            (1, 0, 4), (900, 100, 16)])
def test_distance_search(nodes, points, w):
    assert tts.distance_search(nodes, points, w) == \
        jv2.distance_search(nodes, points, w)


def test_determine_vertices(stages):
    s = stages
    got = tts.determine_vertices(s["pts"], s["node_codes"], s["point_node"],
                                 S, s["dse"])
    _same(got, (s["uniq"], s["present"], s["vpos"]))
    assert got[1].any()


def test_edge_coder_features(stages):
    _same(tts.edge_coder_features(stages["node_codes"], stages["uniq"], S),
          jv2.edge_coder_features(stages["node_codes"], stages["uniq"], S))


def test_node_vertices_fp(stages):
    s = stages
    _same(tts.node_vertices_fp(s["node_codes"], s["uniq"], s["present"],
                               s["vpos"], S), (s["verts"], s["mask"]))


def test_build_surface(stages):
    got = tts.build_surface(stages["verts"], stages["mask"], S)
    want = jv2.build_surface(stages["verts"], stages["mask"], S)
    _same(_surface_state(got), _surface_state(want))
    assert got.drift_ok.any()


def test_determine_drift(stages):
    s = stages
    ns = tts.build_surface(s["verts"], s["mask"], S)
    got = tts.determine_drift(s["pts"], s["point_node"], s["origin"], ns, S)
    _same(got, s["driftq"])
    assert np.any(got != 0)


def test_apply_drift(stages):
    s = stages
    nt = tts.build_surface(s["verts"], s["mask"], S)
    nj = jv2.build_surface(s["verts"], s["mask"], S)
    tts.apply_drift(nt, s["driftq"], S)
    jv2.apply_drift(nj, s["driftq"], S)
    _same(_surface_state(nt), _surface_state(nj))


@pytest.mark.parametrize("halo,target", [(True, None), (False, None),
                                         (True, 400)])
def test_reconstruct(stages, halo, target):
    """The sampling loop at the signalled budget, and at a budget small
    enough to force sub-sampled passes (where the halo acts)."""
    s = stages
    target = s["n_points"] if target is None else target
    args = (s["node_codes"], s["uniq"], s["present"], s["vpos"], S,
            s["driftq"], target)
    got = tts.reconstruct(*args, halo_flag=halo, bbox_max=(1 << DEPTH) - 1)
    want = jv2.reconstruct(*args, halo_flag=halo, bbox_max=(1 << DEPTH) - 1)
    _same(got, want)
    assert got.shape[0] > 0


def test_trisoup_neighbours(stages):
    leaves = morton.decode(stages["node_codes"]) << S
    got = tref.trisoup_neighbours(leaves, 1 << S)
    want = jref.trisoup_neighbours(leaves, 1 << S)
    _same(got, want)
    assert got["neighb"].size == got["pattern"].shape[0] > 0


def test_one_trisoup_module_without_v1_functions():
    """The fold: none of the older module's own vertex, face, raster or
    reconstruct functions came along (``determine_vertices`` and
    ``reconstruct`` here are the v2 ones, by signature)."""
    import inspect

    import mpeg_pcc_tmc13_tpu_torch.ops as tops
    import pkgutil
    names = [m.name for m in pkgutil.iter_modules(tops.__path__)]
    assert [n for n in names if "trisoup" in n] == ["trisoup",
                                                    "trisoup_ref"]
    for name in ("derive_face_vertices", "_raster_triangles",
                 "_sample_triangles", "edge_neighbor_structure",
                 "face_keys_for_nodes", "determine_face_vertices"):
        assert not hasattr(tts, name), name
    for name in ("determine_vertices", "reconstruct"):
        assert (list(inspect.signature(getattr(tts, name)).parameters)
                == list(inspect.signature(getattr(jv2, name)).parameters))


# -- models.geometry_trisoup -----------------------------------------------

def _obuf_gps(mod, pc_cls, pos):
    e = mod.FrameEncoder(mod.EncoderParams(trisoup_node_size_log2=S,
                                           engine="obuf",
                                           planar_enabled=True))
    e._derive_parameter_sets(pc_cls(pos))
    assert e.gps.obuf_engine
    return e.gps


def _pad_points(pos):
    """Points of a neighbouring slice near the x = 0 face, slice-local:
    a copy of the first rows of voxels, some in nodes this slice holds."""
    near = pos[pos[:, 0] < 6].copy()
    near[:, 2] = np.clip(near[:, 2] + 1, 0, (1 << DEPTH) - 1)
    return near


MODEL_CASES = {
    "default": dict(),
    "no_halo": dict(halo=False),
    "no_centroid": dict(centroid=False),
    "face_vertices": dict(face_vertices=True),
    "pad_points": dict(pad=True),
    "parent_ctx": dict(ctx_mode=0),
    "numpy_engine": dict(engine="numpy"),
    "obuf": dict(obuf=True),
    "obuf_face_no_halo": dict(obuf=True, face_vertices=True, halo=False),
    "obuf_no_centroid": dict(obuf=True, centroid=False),
}


@pytest.mark.parametrize("name", list(MODEL_CASES))
def test_geometry_trisoup_matches_jax(name):
    kw = dict(MODEL_CASES[name])
    pos = surface_cloud(3000, DEPTH, seed=2)
    obuf, pad = kw.pop("obuf", False), kw.pop("pad", False)
    kw_j, kw_t = dict(kw), dict(kw)
    if obuf:
        kw_j["obuf_gps"] = _obuf_gps(jenc, JPointCloud, pos)
        kw_t["obuf_gps"] = _obuf_gps(tenc, PointCloud, pos)
    enc_kw = dict(pad_points=_pad_points(pos)) if pad else {}
    ej, et = jentropy.RangeEncoder(), tentropy.RangeEncoder()
    cj, ct = jgt.TrisoupContexts(), tgt.TrisoupContexts()
    rec_j = jgt.encode(pos, DEPTH, S, ej, jgo.OctreeContexts(), cj,
                       **kw_j, **enc_kw)
    rec_t = tgt.encode(pos, DEPTH, S, et, tgo.OctreeContexts(), ct,
                       **kw_t, **enc_kw)
    data = et.get_bytes()
    assert data == ej.get_bytes()
    _same(rec_t, rec_j)
    _same([ct.vertex, ct.centroid, ct.face], [cj.vertex, cj.centroid,
                                              cj.face])
    dec = tentropy.RangeDecoder(data)
    out = tgt.decode(DEPTH, S, dec, tgo.OctreeContexts(),
                     tgt.TrisoupContexts(), max_nodes=len(pos), **kw_t)
    _same(out, jgt.decode(DEPTH, S, jentropy.RangeDecoder(data),
                          jgo.OctreeContexts(), jgt.TrisoupContexts(),
                          max_nodes=len(pos), **kw_j))
    assert np.array_equal(out, rec_t)


def test_pad_points_change_the_stream():
    """The padding case above is not vacuous: the neighbours' points
    join the vertex voting and move the stream."""
    pos = surface_cloud(3000, DEPTH, seed=2)
    sizes = []
    for pad in (None, _pad_points(pos)):
        enc = tentropy.RangeEncoder()
        tgt.encode(pos, DEPTH, S, enc, tgo.OctreeContexts(),
                   tgt.TrisoupContexts(), pad_points=pad)
        sizes.append(enc.get_bytes())
    assert sizes[0] != sizes[1]


@pytest.mark.parametrize("ctx_mode", [0, 1])
def test_device_engine_equals_native(ctx_mode):
    """engine="device" runs the octree front-end's analysis as torch ops
    (here on the CPU): the same stream and reconstruction as native."""
    pos = surface_cloud(3000, DEPTH, seed=3)
    out = {}
    for engine, kw in (("native", {}), ("device", dict(device="cpu"))):
        enc = tentropy.RangeEncoder()
        rec = tgt.encode(pos, DEPTH, S, enc, tgo.OctreeContexts(),
                         tgt.TrisoupContexts(), engine=engine,
                         ctx_mode=ctx_mode, **kw)
        out[engine] = (enc.get_bytes(), rec)
    assert out["device"][0] == out["native"][0]
    _same(out["device"][1], out["native"][1])


def test_device_engine_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; it is the default device")
    pos = surface_cloud(500, DEPTH, seed=4)
    with pytest.raises(NoDeviceError):
        tgt.encode(pos, DEPTH, S, tentropy.RangeEncoder(),
                   tgo.OctreeContexts(), tgt.TrisoupContexts(),
                   engine="device")


def test_contexts_carried_from_reference():
    """Both codecs continue from the same adapted state: the JAX
    encoder codes a first cloud, its trisoup and octree contexts are
    carried into the port, and the second cloud codes to the same
    bytes."""
    first = surface_cloud(2000, DEPTH, seed=5)
    second = surface_cloud(2000, DEPTH, seed=6)
    oj, cj = jgo.OctreeContexts(), jgt.TrisoupContexts()
    jgt.encode(first, DEPTH, S, jentropy.RangeEncoder(), oj, cj)
    ot, ct = tgo.contexts_from_reference(oj), tgt.contexts_from_reference(cj)
    assert isinstance(ct, tgt.TrisoupContexts)
    assert ct.vertex is not cj.vertex
    assert not np.array_equal(ct.vertex, tgt.TrisoupContexts().vertex)
    ej, et = jentropy.RangeEncoder(), tentropy.RangeEncoder()
    rec_j = jgt.encode(second, DEPTH, S, ej, oj, cj)
    rec_t = tgt.encode(second, DEPTH, S, et, ot, ct)
    assert et.get_bytes() == ej.get_bytes()
    _same(rec_t, rec_j)
    _same([ct.vertex, ct.centroid, ct.face], [cj.vertex, cj.centroid,
                                              cj.face])


# -- the frame codec -------------------------------------------------------

def _compress(mod, pc_cls, wtlv, pos, cols, **params):
    bs = io.BytesIO()
    enc = mod.FrameEncoder(mod.EncoderParams(**params))
    enc.compress(pc_cls(pos.copy(), cols), lambda b: wtlv(b, bs))
    enc.flush(lambda b: wtlv(b, bs))
    return bs.getvalue()


@pytest.mark.parametrize("name,params", [
    ("single_slice", dict()),
    ("three_slices_seam_padding", dict(max_points_per_slice=1100)),
    ("obuf_brick", dict(engine="obuf", planar_enabled=True)),
])
def test_frame_codec_trisoup_matches_jax(name, params):
    pos = surface_cloud(3000, 8, seed=7)
    rng = np.random.default_rng(7)
    cols = rng.integers(0, 256, (len(pos), 3)).astype(np.int64)
    stream_j = _compress(
        jenc, JPointCloud, jwrite_tlv, pos, cols, trisoup_node_size_log2=S,
        attributes=[jenc.AttributeConfig(label="color", qp=22)], **params)
    stream_t = _compress(
        tenc, PointCloud, write_tlv, pos, cols, trisoup_node_size_log2=S,
        attributes=[tenc.AttributeConfig(label="color", qp=22)], **params)
    assert stream_t == stream_j
    bricks = sum(b.type == PayloadType.GEOMETRY_BRICK
                 for b in iter_tlv(io.BytesIO(stream_t)))
    assert bricks == (3 if name == "three_slices_seam_padding" else 1)
    outs = []
    dec = tdec.FrameDecoder(outs.append)
    for buf in iter_tlv(io.BytesIO(stream_t)):
        dec.decompress(buf)
    dec.flush()
    assert len(outs) == 1 and outs[0].count > 0
    assert outs[0].colors.shape == (outs[0].count, 3)
    # lossy geometry: every decoded point within one node of the source
    rec = outs[0].positions.astype(np.int64)
    d = np.abs(rec[:, None, :] - pos[None, :, :]).max(-1).min(axis=1)
    assert d.max() <= (1 << S) * 2
