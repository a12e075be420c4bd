"""Port parity: the octree geometry codec
(mpeg_pcc_tmc13_tpu_torch.models.geometry_octree, with the port's
ops/angular.py) against the JAX package's geometry_octree, on CPU.

The streams come from the shared native range coder, so the port's must
be byte-identical to the reference's, and decoding must give the same
positions, across the engines (numpy, native, device), both context
modes, the bytewise and binary occupancy coders, and the coding tools
(planar with and without angular contexts, implicit QT/BT, IDCM,
duplicate points, scalable truncation, multistream).
"""

import dataclasses

import numpy as np
import pytest
import torch

from mpeg_pcc_tmc13_tpu.bitstream import entropy
from mpeg_pcc_tmc13_tpu.models import geometry_octree as jgo
from mpeg_pcc_tmc13_tpu.ops import angular as jang
from mpeg_pcc_tmc13_tpu.ops import motion as jmotion
from mpeg_pcc_tmc13_tpu_torch.models import geometry_octree as tgo
from mpeg_pcc_tmc13_tpu_torch.ops import angular as tang
from mpeg_pcc_tmc13_tpu_torch.ops import motion as tmotion
from mpeg_pcc_tmc13_tpu_torch.ops import octree as tops
from mpeg_pcc_tmc13_tpu_torch.utils import morton

torch.set_num_threads(2)

MODES = [tops.CTX_MODE_NEIGH, tops.CTX_MODE_PARENT]


def _random(n, depth, seed, dups=False):
    rng = np.random.default_rng(seed)
    pos = rng.integers(0, 1 << depth, (n, 3)).astype(np.int64)
    if dups:
        pos = np.concatenate([pos, pos[rng.integers(0, n, n // 3)]])
    return pos


def _surface(n, depth, seed=7):
    rng = np.random.default_rng(seed)
    size = 1 << depth
    xy = rng.integers(0, size, (n, 2))
    z = (size / 2 + (size / 4) * np.sin(2 * np.pi * xy[:, 0] / size)
         * np.cos(2 * np.pi * xy[:, 1] / size)).astype(np.int64)
    return np.column_stack([xy[:, 0], xy[:, 1], np.clip(z, 0, size - 1)])


def _flat(n, seed=18):
    rng = np.random.default_rng(seed)
    return np.column_stack([rng.integers(0, 256, n), rng.integers(0, 256, n),
                            rng.integers(0, 8, n)]).astype(np.int64)


def _scan(bits=11, n_lasers=12, steps=300, seed=0):
    """A small spinning-scanner frame and its laser description."""
    rng = np.random.default_rng(seed)
    el = np.linspace(-0.4, 0.05, n_lasers)
    az = np.repeat(np.arange(steps) * (2 * np.pi / steps), n_lasers)
    elv = np.tile(el, steps)
    r = 150 + 700 * rng.random(az.shape[0]) ** 2
    xyz = np.stack([r * np.cos(elv) * np.cos(az),
                    r * np.cos(elv) * np.sin(az), r * np.sin(elv)], axis=1)
    org = 1 << (bits - 1)
    pos = np.clip(np.round(xyz).astype(np.int64) + org, 0, (1 << bits) - 1)
    theta = np.round(np.tan(el) * (1 << 18)).astype(np.int64)
    return np.unique(pos, axis=0), theta, [0] * n_lasers, [steps] * n_lasers, \
        (org, org, org)


def _both(pos, depth, enc_kw, dec_kw=None, num_points=None):
    """Encode with both packages and decode the stream with both; the
    streams, decoded positions and coding orders must agree.  Returns
    (stream, positions decoded by the port)."""
    dec_kw = enc_kw if dec_kw is None else dec_kw
    ej, et = entropy.RangeEncoder(), entropy.RangeEncoder()
    oj = jgo.encode(pos, depth, ej, jgo.OctreeContexts(), **enc_kw)
    ot = tgo.encode(pos, depth, et, tgo.OctreeContexts(), device="cpu",
                    **enc_kw)
    sj, st = ej.get_bytes(), et.get_bytes()
    assert st == sj
    num = len(pos) if num_points is None else num_points
    dt = tgo.decode(num, depth, entropy.RangeDecoder(st),
                    tgo.OctreeContexts(), **dec_kw)
    dj = jgo.decode(num, depth, entropy.RangeDecoder(st),
                    jgo.OctreeContexts(), **dec_kw)
    assert np.array_equal(dt, dj)
    if oj is not None:
        assert np.array_equal(ot, oj)
    return st, dt


@pytest.mark.parametrize("bytewise", [True, False])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("engine", ["numpy", "native", "device"])
def test_engines_match_jax(engine, mode, bytewise):
    depth = 7
    pos = _random(3000, depth, 11)
    kw = dict(engine=engine, ctx_mode=mode, bytewise=bytewise)
    _, out = _both(pos, depth, kw)
    assert np.array_equal(morton.encode(out), np.unique(morton.encode(pos)))
    # the device engine's stream is the numpy spec's
    et = entropy.RangeEncoder()
    tgo.encode(pos, depth, et, tgo.OctreeContexts(), engine="numpy",
               ctx_mode=mode, bytewise=bytewise)
    ed = entropy.RangeEncoder()
    tgo.encode(pos, depth, ed, tgo.OctreeContexts(), engine=engine,
               ctx_mode=mode, bytewise=bytewise, device="cpu")
    assert ed.get_bytes() == et.get_bytes()


def _tool_case(tool, mode):
    """(positions, depth, encode kwargs, decode kwargs or None)."""
    base = dict(ctx_mode=mode, engine="numpy")
    if tool == "duplicates":
        kw = dict(base, unique_points=False)
        return _random(1500, 6, 3, dups=True), 6, kw, None
    if tool == "planar":
        return _surface(3000, 8), 8, dict(base, planar=True), None
    if tool == "planar_dups":
        pos = np.repeat(_surface(1000, 7), 2, axis=0)
        kw = dict(base, planar=True, unique_points=False)
        return pos, 7, kw, None
    if tool == "planar_angular":
        pos, theta, z, npt, org = _scan()
        kw = dict(base, planar=True,
                  angular=(tang.laser_info(theta, z, npt), org))
        return pos, 11, kw, None
    if tool == "qtbt":
        return _flat(3000), 8, dict(base, axis_bits=(8, 8, 3)), None
    if tool == "idcm":
        return _random(400, 12, 5), 12, dict(base, idcm=True), None
    if tool == "skip_layers":
        return _random(2000, 8, 6), 8, base, dict(base, skip_layers=2)
    if tool == "planar_skip":
        kw = dict(base, planar=True)
        return _surface(2000, 8), 8, kw, dict(kw, skip_layers=3)
    if tool == "idcm_skip":
        kw = dict(base, idcm=True)
        return _random(600, 12, 4), 12, kw, dict(kw, skip_layers=3)
    if tool == "qtbt_max_points":
        kw = dict(base, axis_bits=(8, 8, 3))
        return _flat(2000), 8, kw, dict(kw, max_points=500)
    raise AssertionError(tool)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("tool", [
    "duplicates", "planar", "planar_dups", "planar_angular", "qtbt", "idcm",
    "skip_layers", "planar_skip", "idcm_skip", "qtbt_max_points"])
def test_coding_tools_match_jax(tool, mode):
    pos, depth, enc_kw, dec_kw = _tool_case(tool, mode)
    if tool == "planar_angular":
        # the JAX side gets its own LaserInfo (the same numbers)
        info, org = enc_kw["angular"]
        jkw = dict(enc_kw, angular=(jang.laser_info(
            info.theta, info.z, [300] * info.theta.size), org))
        ej, et = entropy.RangeEncoder(), entropy.RangeEncoder()
        jgo.encode(pos, depth, ej, jgo.OctreeContexts(), **jkw)
        tgo.encode(pos, depth, et, tgo.OctreeContexts(), **enc_kw)
        assert et.get_bytes() == ej.get_bytes()
        plain = entropy.RangeEncoder()    # the laser contexts are in use
        tgo.encode(pos, depth, plain, tgo.OctreeContexts(),
                   **dict(enc_kw, angular=None))
        assert len(et.get_bytes()) < len(plain.get_bytes())
        out = tgo.decode(len(pos), depth, entropy.RangeDecoder(
            et.get_bytes()), tgo.OctreeContexts(), **enc_kw)
        assert np.array_equal(out, morton.decode(np.unique(
            morton.encode(pos))))
        return
    _both(pos, depth, enc_kw, dec_kw)


@pytest.mark.parametrize("num_streams", [1, 3])
@pytest.mark.parametrize("bytewise", [True, False])
def test_multistream_matches_jax(num_streams, bytewise):
    depth = 7
    pos = _random(2500, depth, 9)
    for mode in MODES:
        st, ot = tgo.encode_multistream(pos, depth, tgo.OctreeContexts(),
                                        num_streams, mode, bytewise)
        sj, oj = jgo.encode_multistream(pos, depth, jgo.OctreeContexts(),
                                        num_streams, mode, bytewise)
        assert st == sj and np.array_equal(ot, oj)
        out = tgo.decode_multistream(len(pos), depth, st,
                                     tgo.OctreeContexts(), mode, bytewise)
        assert np.array_equal(out, jgo.decode_multistream(
            len(pos), depth, st, jgo.OctreeContexts(), mode, bytewise))


def test_inter_contexts_match_jax():
    """ref_codes (inter occupancy contexts) through the numpy and native
    engines."""
    depth = 7
    pos = _random(2000, depth, 21)
    ref = np.unique(morton.encode(_random(2000, depth, 22)))
    for engine in ("numpy", "native"):
        kw = dict(engine=engine, ref_codes=ref)
        _both(pos, depth, kw)


def test_empty_and_depth0():
    for depth, pos in ((5, np.zeros((0, 3), np.int64)),
                       (0, np.zeros((3, 3), np.int64))):
        et = entropy.RangeEncoder()
        tgo.encode(pos, depth, et, tgo.OctreeContexts())
        ej = entropy.RangeEncoder()
        jgo.encode(pos, depth, ej, jgo.OctreeContexts())
        assert et.get_bytes() == ej.get_bytes()
    assert tgo.decode(0, 5, None, tgo.OctreeContexts()).shape == (0, 3)


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="a CUDA device is present; it is the default")
def test_device_engine_has_no_host_default():
    """engine="device" with no device takes the current CUDA device and
    raises where there is none; the host engines need no device."""
    pos = _random(100, 5, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgo.encode(pos, 5, entropy.RangeEncoder(), tgo.OctreeContexts(),
                   engine="device")
    tgo.encode(pos, 5, entropy.RangeEncoder(), tgo.OctreeContexts(),
               engine="numpy")


def test_lpu_ctx_size_pinned_to_reference():
    """The octree contexts take LPU_CTX_SIZE from the port's ops/motion.py,
    as the reference takes it from its own; the two modules agree."""
    assert tmotion.LPU_CTX_SIZE == jmotion.LPU_CTX_SIZE
    assert tgo.LPU_CTX_SIZE is tmotion.LPU_CTX_SIZE
    assert tgo.OctreeContexts().lpu.size == jgo.OctreeContexts().lpu.size


def test_contexts_fields_copy_and_carry_across():
    """All eleven context memories, their sizes and initial values equal
    the reference's; copy() and contexts_from_reference() copy each."""
    t, j = tgo.OctreeContexts(), jgo.OctreeContexts()
    fields = [f.name for f in dataclasses.fields(tgo.OctreeContexts)]
    assert len(fields) == 11
    assert fields == [f.name for f in dataclasses.fields(j)]
    for f in fields:
        assert np.array_equal(getattr(t, f), getattr(j, f)), f
    # train a reference context state, then carry it across
    depth = 6
    pos = _random(1500, depth, 2, dups=True)
    jgo.encode(pos, depth, entropy.RangeEncoder(), j, unique_points=False,
               planar=True, engine="numpy")
    jgo.encode(pos, depth, entropy.RangeEncoder(), j, bytewise=False,
               idcm=True, engine="numpy")
    carried = tgo.contexts_from_reference(j)
    cp = carried.copy()
    for f in fields:
        assert np.array_equal(getattr(carried, f), getattr(j, f)), f
        assert getattr(carried, f) is not getattr(j, f)
        assert getattr(cp, f) is not getattr(carried, f)
    # the carried state codes the next frame exactly as the reference
    nxt = _random(1500, depth, 3)
    et, ej = entropy.RangeEncoder(), entropy.RangeEncoder()
    tgo.encode(nxt, depth, et, carried, planar=True, engine="numpy")
    jgo.encode(nxt, depth, ej, j, planar=True, engine="numpy")
    assert et.get_bytes() == ej.get_bytes()


def test_angular_copy_matches_reference():
    pos, theta, z, npt, org = _scan()
    codes = np.unique(morton.encode(pos >> 3))
    ti = tang.laser_info(theta, z, npt)
    ji = jang.laser_info(theta, z, npt)
    for got, ref in zip(tang.node_angular_ctx(codes, 3, org, ti),
                        jang.node_angular_ctx(codes, 3, org, ji)):
        assert np.array_equal(got, ref)
    assert np.array_equal(tang.compensate_z(pos, ti, org, 2),
                          jang.compensate_z(pos, ji, org, 2))
