"""Port parity: the OBUF array-op mirror (``ops/octree_obuf.py``) and the
decoder's level expansion.

The port's copy of the mirror is held token-identical, level by level,
to the port's C++ batched pass (its own native library) and to the JAX
package's mirror, on the three trees of tests/test_obuf_mirror.py (cubic,
surface, QTBT; intra, planar off).  The port's ``_expand_level`` /
``decode_expand_stream`` on the CPU are held to the JAX package's
``decode_expand_jax`` (the leaf codes and their count) and, level by
level, their node codes to ``decode_level_jax``'s context bases.
Tolerance 0 everywhere (integers).
"""

import ast
import ctypes
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mpeg_pcc_tmc13_tpu.ops import octree as jops
from mpeg_pcc_tmc13_tpu.ops import octree_obuf as jmirror
from mpeg_pcc_tmc13_tpu_torch.bitstream import hls
from mpeg_pcc_tmc13_tpu_torch.conformance.decoder import _load
from mpeg_pcc_tmc13_tpu_torch.models import geometry_obuf as go
from mpeg_pcc_tmc13_tpu_torch.ops import octree as tops
from mpeg_pcc_tmc13_tpu_torch.ops import octree_obuf as mirror
from mpeg_pcc_tmc13_tpu_torch.utils import morton

torch.set_num_threads(2)

I64_MAX = np.iinfo(np.int64).max


def _cxx_tokens(pos, axes, gp):
    """Per-level token words of the port's C++ batched pass (its debug
    dump)."""
    lib = _load()
    c = ctypes
    lib.obufls_encode_octree_dbg.argtypes = [
        c.POINTER(c.c_int32), c.c_int,
        c.POINTER(c.c_int32), c.c_int,
        c.POINTER(c.c_int32), c.c_int,
        c.POINTER(c.c_int32), c.POINTER(c.c_uint8), c.c_int,
        c.POINTER(c.c_uint32), c.c_int, c.POINTER(c.c_int32)]
    lib.obufls_encode_octree_dbg.restype = c.c_int
    cap = pos.shape[0] * 16 + (1 << 16)
    out = np.empty(cap, dtype=np.uint8)
    toks = np.zeros(pos.shape[0] * 24 + (1 << 12), dtype=np.uint32)
    lvl_counts = np.zeros(len(axes), dtype=np.int32)
    ref = np.zeros(3, dtype=np.int32)
    n = lib.obufls_encode_octree_dbg(
        pos.ctypes.data_as(c.POINTER(c.c_int32)), pos.shape[0],
        ref.ctypes.data_as(c.POINTER(c.c_int32)), 0,
        axes.ctypes.data_as(c.POINTER(c.c_int32)), len(axes),
        gp.ctypes.data_as(c.POINTER(c.c_int32)),
        out.ctypes.data_as(c.POINTER(c.c_uint8)), cap,
        toks.ctypes.data_as(c.POINTER(c.c_uint32)), len(toks),
        lvl_counts.ctypes.data_as(c.POINTER(c.c_int32)))
    assert n > 0
    per_level, at = [], 0
    for cnt in lvl_counts:
        per_level.append(toks[at:at + int(cnt)].copy())
        at += int(cnt)
    return per_level


def _levels(pos, axes, depth):
    """Bottom-up levels in numpy: per level the sorted node keys and
    their child-occupancy words."""
    keys = np.sort(mirror.node_keys(pos[:, 0], pos[:, 1], pos[:, 2],
                                    axes, depth))
    lvl = [None] * (depth + 1)
    lvl[depth] = np.unique(keys)
    occs = [None] * depth
    for d in range(depth - 1, -1, -1):
        parents, idx = np.unique(lvl[d + 1] >> 3, return_inverse=True)
        occ = np.zeros(len(parents), dtype=np.int64)
        np.bitwise_or.at(occ, idx, 1 << (lvl[d + 1] & 7))
        lvl[d] = parents
        occs[d] = occ
    return lvl, occs


def _keys_to_pos(keys, axes, depth):
    n = len(keys)
    px = np.zeros(n, dtype=np.int64)
    py = np.zeros(n, dtype=np.int64)
    pz = np.zeros(n, dtype=np.int64)
    for d in range(depth):
        b = (keys >> (3 * (depth - 1 - d))) & 7
        coded = int(axes[d])
        if coded & 4:
            px = (px << 1) | ((b >> 2) & 1)
        if coded & 2:
            py = (py << 1) | ((b >> 1) & 1)
        if coded & 1:
            pz = (pz << 1) | (b & 1)
    return px, py, pz


def _cubic():
    rng = np.random.default_rng(7)
    pos = np.unique(rng.integers(0, 256, (4000, 3)).astype(np.int64), axis=0)
    return pos, go.axes_for(None, 8)


def _surface():
    side = 80
    xs, ys = np.meshgrid(np.arange(side), np.arange(side))
    zs = (20 + 10 * np.sin(xs / 9.0) + 8 * np.cos(ys / 7.0)).astype(np.int64)
    pos = np.unique(np.stack([xs.ravel(), ys.ravel(), zs.ravel()], 1),
                    axis=0)
    return pos, go.axes_for(None, 7)


def _qtbt():
    rng = np.random.default_rng(11)
    pos = np.unique(
        np.stack([rng.integers(0, 256, 3000), rng.integers(0, 64, 3000),
                  rng.integers(0, 16, 3000)], 1).astype(np.int64), axis=0)
    return pos, go.axes_for((8, 6, 4), 8)


@pytest.mark.parametrize("tree", [_cubic, _surface, _qtbt],
                         ids=["cubic", "surface", "qtbt"])
def test_mirror_matches_cxx_and_reference(tree):
    pos, axes = tree()
    gps = hls.GeometryParameterSet(planar_mode_enabled=False)
    gp = go.geom_params_array(go._gps_flags(gps))
    cxx = _cxx_tokens(np.ascontiguousarray(pos, dtype=np.int32), axes, gp)
    depth = len(axes)
    lvl, occs = _levels(pos.astype(np.int64), axes, depth)
    for d in range(depth):
        px, py, pz = _keys_to_pos(lvl[d], axes, d)
        got = mirror.analyze_level(px, py, pz, occs[d], axes, d,
                                   int(axes[d]))
        want = jmirror.analyze_level(px, py, pz, occs[d], axes, d,
                                     int(axes[d]))
        assert got.dtype == want.dtype and np.array_equal(got, want), d
        assert got.shape == cxx[d].shape, (d, got.shape, cxx[d].shape)
        bad = np.nonzero(got != cxx[d])[0]
        assert bad.size == 0, (d, bad[:5])


def _body(path):
    """A module's statements after its docstring, as an AST dump."""
    with open(path) as f:
        tree = ast.parse(f.read())
    return [ast.dump(s) for s in tree.body[1:]]


def test_mirror_is_a_copy_of_the_reference():
    """Only the docstring differs: the code is the reference's."""
    assert _body(mirror.__file__) == _body(jmirror.__file__)
    assert os.path.dirname(mirror.__file__).endswith(
        os.path.join("mpeg_pcc_tmc13_tpu_torch", "ops"))


def _decode_case(n, depth, seed):
    rng = np.random.default_rng(seed)
    codes = np.unique(morton.encode(
        rng.integers(0, 1 << depth, (n, 3), dtype=np.int64)))
    levels = tops.build_levels_np(codes, depth, tops.CTX_MODE_NEIGH)
    return codes, levels


@pytest.mark.parametrize("n,depth,seed", [(300, 5, 1), (3000, 9, 2),
                                          (2000, 12, 3)])
def test_decode_expand_stream_matches_decode_expand_jax(n, depth, seed):
    codes, levels = _decode_case(n, depth, seed)
    counts = np.array([lv["occ"].size for lv in levels], dtype=np.int64)
    nmax = codes.size + 64
    occ_levels = np.zeros((depth, nmax), dtype=np.int32)
    for l, lv in enumerate(levels):
        occ_levels[l, :lv["occ"].size] = lv["occ"]
    jnodes, jcnt = jops.decode_expand_jax(jnp.asarray(occ_levels),
                                          jnp.asarray(counts), depth)
    flat = np.concatenate([lv["occ"] for lv in levels]).astype(np.uint8)
    tnodes, tcnt = tops.decode_expand_stream(
        torch.as_tensor(flat), torch.as_tensor(counts), depth, nmax)
    assert int(tcnt) == int(jcnt) == codes.size
    assert np.array_equal(tnodes.numpy(), np.asarray(jnodes))
    assert np.array_equal(tnodes.numpy()[:codes.size], codes)


@pytest.mark.parametrize("n,depth,seed", [(300, 5, 1), (3000, 9, 2)])
def test_expand_level_nodes_give_decode_level_jax_contexts(n, depth, seed):
    """Level by level, ``_expand_level`` rebuilds the encoder's node
    codes, and ``decode_level_jax`` on them gives the encoder's NEIGH
    context bases."""
    codes, levels = _decode_case(n, depth, seed)
    nmax = codes.size + 64
    nth_bit = tops._nth_set_bit_table("cpu")
    popcnt = tops._popcount8_table("cpu")
    nodes = torch.full((nmax,), I64_MAX, dtype=torch.int64)
    nodes[0] = 0
    row = np.arange(nmax)
    for l, lv in enumerate(levels):
        m = lv["nodes"].size
        assert np.array_equal(nodes.numpy()[:m], lv["nodes"]), l
        assert (nodes.numpy()[m:] == I64_MAX).all(), l
        ctx = jops.decode_level_jax(jnp.asarray(nodes.numpy()),
                                    jnp.asarray(row < m), l)
        assert np.array_equal(np.asarray(ctx)[:m], lv["ctx_base"]), l
        occ = torch.zeros(nmax, dtype=torch.int64)
        occ[:m] = torch.as_tensor(lv["occ"].astype(np.int64))
        nodes, cnt, _ = tops._expand_level(nodes, occ, nmax, nth_bit,
                                           popcnt)
        assert int(cnt) == (levels[l + 1]["nodes"].size
                            if l + 1 < depth else codes.size)
    assert np.array_equal(nodes.numpy()[:codes.size], codes)
