"""Port parity: octree occupancy passes (mpeg_pcc_tmc13_tpu_torch.ops.octree)
against the JAX device kernels and the numpy level builder.

Integer outputs, so every comparison is exact.  Depth 21 is held to
the numpy builder only: the JAX ``encode_occ_u8`` splits each code at
bit 30 into int32 words, and ``chi = (c >> 30).astype(int32)``
(mpeg_pcc_tmc13_tpu/ops/octree.py:471) overflows for 63-bit codes, so
its bytes are wrong there while the port's native int64 pass is right.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mpeg_pcc_tmc13_tpu.ops import octree as jops
from mpeg_pcc_tmc13_tpu.utils import morton as jmorton
from mpeg_pcc_tmc13_tpu_torch.ops import octree as tops
from mpeg_pcc_tmc13_tpu_torch.utils import morton as tmorton

torch.set_num_threads(2)


def _codes(n, depth, seed):
    rng = np.random.default_rng(seed)
    pos = rng.integers(0, 1 << depth, (n, 3), dtype=np.int64)
    return np.unique(tmorton.encode(pos))


def _host_bytes(uniq, depth):
    levels = tops.build_levels_np(uniq, depth, tops.CTX_MODE_PARENT)
    return (np.concatenate([lv["occ"] for lv in levels]),
            [lv["occ"].size for lv in levels])


def _port(uniq, depth, cap):
    occ, counts = tops.encode_occ_u8(torch.as_tensor(uniq), depth, cap)
    counts = counts.numpy()
    return occ.numpy()[:int(counts.sum())], counts


@pytest.mark.parametrize("depth", range(1, 21))
def test_encode_occ_u8_matches_jax(depth):
    uniq = _codes(300, depth, depth)
    cap = depth * uniq.size + 64
    got, counts = _port(uniq, depth, cap)
    occ_j, counts_j = jops.encode_occ_u8(jnp.asarray(uniq), depth, cap)
    counts_j = np.asarray(counts_j)
    assert counts.tolist() == counts_j.tolist()
    assert np.array_equal(got, np.asarray(occ_j)[:int(counts_j.sum())])


@pytest.mark.parametrize("depth", range(1, 21))
def test_encode_occ_u8_matches_build_levels_np(depth):
    uniq = _codes(500, depth, 100 + depth)
    ref, ref_counts = _host_bytes(uniq, depth)
    got, counts = _port(uniq, depth, ref.size + 64)
    assert counts.tolist() == ref_counts
    assert np.array_equal(got, ref)


def test_encode_occ_u8_depth21_matches_build_levels_np():
    """C1: at depth 21 the port equals the numpy builder (the JAX kernel
    does not, see the module docstring)."""
    depth = 21
    uniq = _codes(2000, depth, 21)
    assert uniq.max() >= 1 << 60          # codes use the top octant bits
    ref, ref_counts = _host_bytes(uniq, depth)
    got, counts = _port(uniq, depth, ref.size + 64)
    assert counts.tolist() == ref_counts
    assert np.array_equal(got, ref)


def test_encode_occ_u8_collapses_duplicates():
    depth = 5
    uniq = _codes(500, depth, 5)
    dup = np.sort(np.concatenate([uniq, uniq[::3], uniq[-1:].repeat(7)]))
    cap = 4 * uniq.size
    o1, c1 = _port(uniq, depth, cap)
    o2, c2 = _port(dup, depth, cap)
    assert np.array_equal(c1, c2)
    assert np.array_equal(o1, o2)


def test_encode_occ_u8_undersized_cap_drops_and_reports():
    """Slots past cap are dropped (JAX segment_sum semantics) and the
    counts still report the true total, so the caller can retry."""
    depth = 6
    uniq = _codes(800, depth, 6)
    ref, _ = _host_bytes(uniq, depth)
    cap = ref.size // 2
    occ, counts = tops.encode_occ_u8(torch.as_tensor(uniq), depth, cap)
    assert occ.shape == (cap,)
    assert int(counts.sum()) == ref.size
    occ_j, _ = jops.encode_occ_u8(jnp.asarray(uniq), depth, cap)
    assert np.array_equal(occ.numpy(), np.asarray(occ_j))


def test_encode_occ_u8_hdr_matches_jax():
    depth = 7
    uniq = _codes(1000, depth, 7)
    cap = 4 * uniq.size
    got = tops.encode_occ_u8_hdr(torch.as_tensor(uniq), depth, cap)
    ref = jops.encode_occ_u8_hdr(jnp.asarray(uniq), depth, cap)
    assert got.dtype == torch.uint8
    assert np.array_equal(got.numpy(), np.asarray(ref))


def test_min_levels_matches_jax():
    depth = 9
    uniq = _codes(1000, depth, 9)
    c = np.sort(np.concatenate([uniq, uniq[::4]]))   # with duplicates
    got = tops._min_levels(torch.as_tensor(c), depth).numpy()
    ref = np.asarray(jops._min_levels(jnp.asarray(c), depth))
    assert np.array_equal(got, ref)


def test_nth_set_bit_table_matches_jax():
    got = tops._nth_set_bit_table("cpu").numpy()
    ref = jops._nth_set_bit_table().astype(np.int64)
    pop = tops._popcount8_table("cpu").numpy()
    for b in range(256):       # past the popcount the entry is unused
        assert np.array_equal(got[b, :pop[b]], ref[b, :pop[b]])
    assert np.array_equal(pop, tops.popcount8_np(np.arange(256)))


@pytest.mark.parametrize("depth", [1, 4, 11, 21])
def test_decode_expand_stream_matches_jax(depth):
    uniq = _codes(700, depth, 200 + depth)
    occ, counts = _host_bytes(uniq, depth)
    pad = np.zeros(occ.size + 37, dtype=np.uint8)    # padding is ignored
    pad[:occ.size] = occ
    counts = np.asarray(counts, dtype=np.int32)
    nmax = uniq.size + 5
    nodes, cnt = tops.decode_expand_stream(
        torch.as_tensor(pad), torch.as_tensor(counts), depth, nmax)
    assert int(cnt) == uniq.size
    assert np.array_equal(nodes.numpy()[:uniq.size], uniq)
    nodes_j, cnt_j = jops.decode_expand_stream(
        jnp.asarray(pad), jnp.asarray(counts), depth, nmax)
    assert int(np.asarray(cnt_j)) == int(cnt)
    assert np.array_equal(nodes.numpy(), np.asarray(nodes_j))


@pytest.mark.parametrize("depth", [3, 13, 21])
def test_morton_matches_reference(depth):
    rng = np.random.default_rng(depth)
    pos = rng.integers(0, 1 << depth, (1000, 3), dtype=np.int64)
    ref = jmorton.encode(pos)
    assert np.array_equal(tmorton.encode(pos), ref)
    assert np.array_equal(tmorton.encode(torch.as_tensor(pos)).numpy(), ref)
    assert np.array_equal(tmorton.decode(ref), pos)
    assert np.array_equal(tmorton.decode(torch.as_tensor(ref)).numpy(), pos)
