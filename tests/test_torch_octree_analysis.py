"""Port parity: the octree analysis with context bases and the packed
link (mpeg_pcc_tmc13_tpu_torch.ops.octree: the numpy host half,
``encode_analysis``, ``encode_analysis_packed``, ``occ_code_tables``,
``encode_occ_packed_hdr``) against the JAX package, on CPU tensors.

Integer outputs, so every comparison is exact.  ``encode_analysis`` is
int64 in the reference too, so it is held to JAX at depth 21 as well.
``encode_occ_packed_hdr`` is built on ``encode_occ_u8``, which the JAX
package gets wrong at depth 21 (C1), so there it is held to the numpy
level builder through the native unpacker.
"""

import ctypes

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mpeg_pcc_tmc13_tpu.bitstream import entropy
from mpeg_pcc_tmc13_tpu.ops import octree as jops
from mpeg_pcc_tmc13_tpu_torch.ops import octree as tops
from mpeg_pcc_tmc13_tpu_torch.utils import morton

torch.set_num_threads(2)

MODES = [tops.CTX_MODE_NEIGH, tops.CTX_MODE_PARENT]


def _codes(n, depth, seed, dups=False):
    rng = np.random.default_rng(seed)
    pos = rng.integers(0, 1 << depth, (n, 3), dtype=np.int64)
    c = np.unique(morton.encode(pos))
    if dups:
        c = np.sort(np.concatenate([c, c[::3], c[-1:].repeat(4)]))
    return c


def _unpack(buf, depth, total):
    h = buf.numpy()
    packed = np.ascontiguousarray(h[4 * depth + 4:])
    out = np.empty(total, dtype=np.uint8)
    entropy._LIB.occ_unpack(
        packed.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), total)
    return out


def test_constants_match_reference():
    assert tops.CTX_MODE_PARENT == jops.CTX_MODE_PARENT
    assert tops.CTX_MODE_NEIGH == jops.CTX_MODE_NEIGH
    assert tops.NUM_OCC_BASES == jops.NUM_OCC_BASES
    assert tops.OCC_CTX_SIZE == jops.OCC_CTX_SIZE
    assert np.array_equal(tops._FACE_OFFSETS, jops._FACE_OFFSETS)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("depth", [1, 5, 9, 21])
def test_build_levels_np_matches_reference(depth, mode):
    uniq = _codes(800, depth, depth)
    got = tops.build_levels_np(uniq, depth, mode)
    ref = jops.build_levels_np(uniq, depth, mode)
    assert len(got) == len(ref) == depth
    for g, r in zip(got, ref):
        for k in ("nodes", "occ", "ctx_base"):
            assert np.array_equal(g[k], r[k])


def test_build_levels_np_defaults_to_neigh():
    uniq = _codes(500, 6, 1)
    got = tops.build_levels_np(uniq, 6)
    ref = jops.build_levels_np(uniq, 6)
    assert all(np.array_equal(g["ctx_base"], r["ctx_base"])
               for g, r in zip(got, ref))
    assert any(not np.array_equal(g["ctx_base"], p["ctx_base"])
               for g, p in zip(got, tops.build_levels_np(
                   uniq, 6, tops.CTX_MODE_PARENT)))


@pytest.mark.parametrize("depth", [3, 12])
def test_host_helpers_match_reference(depth):
    uniq = _codes(1200, depth, 30 + depth)
    lv = jops.build_levels_np(uniq, depth, jops.CTX_MODE_PARENT)
    for l in (0, depth // 2, depth - 1):
        nodes, occ = lv[l]["nodes"], lv[l]["occ"]
        assert np.array_equal(tops.neighbor_pattern_np(nodes, l),
                              jops.neighbor_pattern_np(nodes, l))
        assert np.array_equal(tops.occ_context_base_np(nodes, l),
                              jops.occ_context_base_np(nodes, l))
        assert np.array_equal(tops.expand_level_np(nodes, occ),
                              jops.expand_level_np(nodes, occ))
        ref_children = _codes(900, depth, 7)[::2] >> (3 * (depth - l - 1))
        ref_children = np.unique(ref_children)
        assert np.array_equal(
            tops.pred_occupancy_np(nodes, ref_children),
            jops.pred_occupancy_np(nodes, ref_children))
    empty = np.zeros(0, np.int64)
    assert tops.neighbor_pattern_np(empty, 3).size == 0
    assert tops.pred_occupancy_np(uniq[:4] >> 3, empty).tolist() == [0] * 4


@pytest.mark.parametrize("dups", [False, True])
@pytest.mark.parametrize("depth", [1, 6, 10, 21])
def test_encode_analysis_matches_jax(depth, dups):
    c = _codes(1500, depth, 40 + depth, dups)
    for mode in MODES:
        ref = jops.encode_analysis_jax(jnp.asarray(c), depth, mode)
        got = tops.encode_analysis(torch.as_tensor(c), depth, mode)
        mask = np.asarray(ref["node_mask"])
        assert np.array_equal(got["node_mask"].numpy(), mask)
        for k in ("occ", "ctx_base", "node_code"):
            assert np.array_equal(got[k].numpy()[mask],
                                  np.asarray(ref[k])[mask]), (k, mode)
        # and the numpy level builder, level by level
        levels = tops.build_levels_np(np.unique(c), depth, mode)
        for l, lv in enumerate(levels):
            m = mask[l]
            assert np.array_equal(got["occ"][l].numpy()[m], lv["occ"])
            assert np.array_equal(got["ctx_base"][l].numpy()[m],
                                  lv["ctx_base"])


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("depth", [4, 11])
def test_encode_analysis_packed_matches_jax(depth, mode):
    c = _codes(2500, depth, 60 + depth, dups=True)
    compact_j, counts_j = jops.encode_analysis_packed(jnp.asarray(c), depth,
                                                      mode)
    compact_t, counts_t = tops.encode_analysis_packed(torch.as_tensor(c),
                                                      depth, mode)
    counts_j = np.asarray(counts_j)
    assert counts_t.dtype == torch.int32 and compact_t.dtype == torch.int32
    assert np.array_equal(counts_t.numpy(), counts_j)
    assert compact_t.shape[0] == int(counts_j.sum())
    assert np.array_equal(compact_t.numpy(),
                          np.asarray(compact_j)[:compact_t.shape[0]])


def test_encode_analysis_empty():
    res = tops.encode_analysis(torch.zeros(0, dtype=torch.int64), 4,
                               tops.CTX_MODE_NEIGH)
    assert res["occ"].shape == (4, 0)


def test_occ_code_tables_match_reference():
    lens, rev = tops.occ_code_tables()
    lens_j, rev_j = jops._occ_code_tables()
    assert np.array_equal(lens, lens_j) and np.array_equal(rev, rev_j)


@pytest.mark.parametrize("depth,cap_f,packed_f", [
    (1, 4, 2), (6, 4, 2), (9, 3, 1.2), (14, 3, 2), (20, 3, 2),
    (7, 3, 0.2)])            # an undersized packed budget drops words
def test_encode_occ_packed_hdr_matches_jax(depth, cap_f, packed_f):
    uniq = _codes(2000, depth, 80 + depth)
    cap = int(cap_f * uniq.size) + 64
    cap_packed = (int(packed_f * uniq.size) + 64) & ~3
    got = tops.encode_occ_packed_hdr(torch.as_tensor(uniq), depth, cap,
                                     cap_packed)
    ref = jops.encode_occ_packed_hdr(jnp.asarray(uniq), depth, cap,
                                     cap_packed)
    assert got.dtype == torch.uint8
    assert np.array_equal(got.numpy(), np.asarray(ref))


def test_encode_occ_packed_hdr_depth21_unpacks_to_build_levels_np():
    """C1 carried into the packed link: at depth 21 the port's packed
    bytes unpack to the numpy builder's occupancy."""
    depth = 21
    uniq = _codes(2000, depth, 21)
    ref = np.concatenate([lv["occ"] for lv in tops.build_levels_np(
        uniq, depth, tops.CTX_MODE_PARENT)])
    buf = tops.encode_occ_packed_hdr(torch.as_tensor(uniq), depth,
                                     ref.size + 64, 2 * ref.size)
    h = buf.numpy()
    assert int(h[:4 * depth].view(np.uint32).sum()) == ref.size
    lens, _ = tops.occ_code_tables()
    assert int(h[4 * depth:4 * depth + 4].view(np.uint32)[0]) == \
        int(lens[ref].sum())
    assert np.array_equal(_unpack(buf, depth, ref.size), ref)
