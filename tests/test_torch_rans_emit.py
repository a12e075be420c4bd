"""The arithmetic of the redesigned rANS emission kernel
(``rans_encode_emit_kernel`` in ``csrc/rans_lanes.cu``), held on the CPU
to the plain version and to the JAX package's ``octree_rans``.

The kernel runs only on the card (``chip_smoke.py`` holds it to
``encode_emit_ref`` there).  Its step takes no division: each (step,
lane) frequency becomes a multiply-high reciprocal off the lane's chain,
``nvalid`` is folded into the prepared parameters, and the step is
``x + c + (x // f) * (M - f)``.  ``ops.rans_lanes`` keeps that integer
formula in numpy (``emit_reciprocal``, ``emit_quotient``,
``encode_emit_mirror``); here it must give the same integers as ``//``
and as the plain version.  Every comparison is exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mpeg_pcc_tmc13_tpu.ops import octree_rans as jr
from mpeg_pcc_tmc13_tpu_torch.ops import octree as tops
from mpeg_pcc_tmc13_tpu_torch.ops import octree_rans as tr
from mpeg_pcc_tmc13_tpu_torch.ops import rans_lanes as lanes
from mpeg_pcc_tmc13_tpu_torch.utils import morton

torch.set_num_threads(2)

ALL_F = np.arange(1, lanes.M + 1, dtype=np.uint64)
TOP = np.uint64(0xFFFFFFFF)


def _x_cases(f, seed):
    """name -> x (< 2^32) for each frequency of ``f``: the edges of the
    quotient's steps, the largest state the loop can present after
    renormalisation ((f << 18) - 1), the largest before, and random."""
    rng = np.random.default_rng(seed)
    k = rng.integers(2, 1 << 18, f.size).astype(np.uint64)
    return {
        "zero": np.zeros_like(f),
        "f-1": f - 1,
        "f": f,
        "kf-1": k * f - 1,
        "kf": np.minimum(k * f, TOP),
        "(f<<18)-1": np.minimum((f << np.uint64(18)) - 1, TOP),
        "2^32-1": np.full_like(f, TOP),
        "random": rng.integers(0, 1 << 32, f.size, dtype=np.uint64),
        "random_below_f<<18": (rng.random(f.size) * np.minimum(
            f << np.uint64(18), TOP).astype(np.float64)).astype(np.uint64),
    }


@pytest.mark.parametrize("case", list(_x_cases(ALL_F[:1], 0)))
def test_reciprocal_quotient_is_exact_for_every_frequency(case):
    m, inc, sh = lanes.emit_reciprocal(ALL_F)
    assert int(m.max()) < 1 << 32 and int(sh.max()) == 13
    for seed in range(4):
        x = _x_cases(ALL_F, seed)[case]
        assert np.array_equal(lanes.emit_quotient(x, m, inc, sh), x // ALL_F)


def test_reciprocal_of_one_is_exact_to_the_top():
    m, inc, sh = lanes.emit_reciprocal(np.ones(1, np.uint64))
    rng = np.random.default_rng(1)
    x = np.concatenate([np.arange(0, 4096, dtype=np.uint64),
                        TOP - np.arange(0, 4096, dtype=np.uint64),
                        rng.integers(0, 1 << 32, 1 << 16, dtype=np.uint64)])
    assert np.array_equal(lanes.emit_quotient(x, m, inc, sh), x)


@pytest.mark.parametrize("f", [2, 3, 5, 7, 4095, 4097, 8191, 8193, 12289,
                               16383, 16384])
def test_reciprocal_quotient_dense_near_the_top(f):
    """Every x of the last 2^16 below 2^32 and below f << 18, where a
    reciprocal's excess is multiplied most."""
    fa = np.full(1, f, np.uint64)
    m, inc, sh = lanes.emit_reciprocal(fa)
    for top in (1 << 32, min(1 << 32, f << 18)):
        x = np.arange(top - (1 << 16), top, dtype=np.uint64)
        assert np.array_equal(lanes.emit_quotient(x, m, inc, sh), x // fa)


def test_double_division_gives_the_round_down_magic():
    """The kernel takes floor(2^N / f) from one double division (its
    comment argues why that is exact); the same in float64 here."""
    f = ALL_F[1:]
    sh = (np.frexp((f - 1).astype(np.float64))[1] - 1).astype(np.uint64)
    two_n = np.uint64(1) << (np.uint64(32) + sh)
    by_double = np.floor(two_n.astype(np.float64) / f.astype(np.float64))
    assert np.array_equal(by_double.astype(np.uint64), two_n // f)


def test_reciprocal_refuses_frequencies_outside_the_table():
    for bad in (0, lanes.M + 1):
        with pytest.raises(ValueError):
            lanes.emit_reciprocal(np.array([1, bad]))


def _random_steps(G, K, seed, extremes=False):
    rng = np.random.default_rng(seed)
    f = rng.integers(1, lanes.M - 254, (G, K))
    if extremes and G:
        f[rng.random((G, K)) < 0.2] = 1
        f[rng.random((G, K)) < 0.1] = lanes.M
    c = rng.integers(0, lanes.M, (G, K))
    c = np.minimum(c, lanes.M - f)
    nvalid = rng.integers(0, K + 1, G)
    if G:
        nvalid[rng.random(G) < 0.5] = K
    return (f.astype(np.int32), c.astype(np.int32), nvalid.astype(np.int32))


@pytest.mark.parametrize("G,K,extremes", [
    (0, 5, False), (1, 1, False), (7, 33, True), (16, 64, False),
    (17, 100, True), (200, 70, False), (300, 31, True)])
def test_mirror_matches_plain_version(G, K, extremes):
    f, c, nvalid = _random_steps(G, K, G + K, extremes)
    want = lanes.encode_emit_ref(torch.as_tensor(f), torch.as_tensor(c),
                                 torch.as_tensor(nvalid))
    got = lanes.encode_emit_mirror(f, c, nvalid)
    for g, w in zip(got, want):
        assert g.dtype == w.numpy().dtype and np.array_equal(g, w.numpy())


def test_mirror_ignores_what_invalid_lanes_hold():
    """nvalid is folded into the prepared parameters: an invalid lane's
    f and c never reach its state."""
    f, c, nvalid = _random_steps(40, 50, 3)
    want = lanes.encode_emit_mirror(f, c, nvalid)
    dead = np.arange(50)[None, :] >= nvalid[:, None]
    f2, c2 = f.copy(), c.copy()
    f2[dead] = 12345
    c2[dead] = 999
    for g, w in zip(lanes.encode_emit_mirror(f2, c2, nvalid), want):
        assert np.array_equal(g, w)


@pytest.mark.parametrize("n,depth,K", [(500, 6, 72), (4000, 8, 100),
                                       (900, 7, 33)])
def test_mirror_payload_matches_jax(n, depth, K):
    """A small cloud, K no multiple of 64 and levels whose last tile is
    partial: the mirror's states and words give the JAX payload."""
    rng = np.random.default_rng(n)
    pos = rng.integers(0, 1 << depth, (n, 3)).astype(np.int64)
    uniq = tops.unique_sorted(np.sort(morton.encode(pos)))
    nmax = max(64, uniq.size)
    leaf = np.full(nmax, uniq[-1], dtype=np.int64)
    leaf[:uniq.size] = uniq
    occ2, ctx2, cnt = tr._analysis(torch.as_tensor(leaf), depth, nmax)
    counts = cnt.tolist()
    assert any(c % K for c in counts)
    f, c, _ = lanes.table_pass(occ2, ctx2, counts, K)
    nvalid = tr._nvalid(counts, K)
    want = lanes.encode_emit_ref(f, c, torch.as_tensor(nvalid))
    states, wdense, flags = lanes.encode_emit_mirror(
        f.numpy(), c.numpy(), nvalid)
    for g, w in zip((states, wdense, flags), want):
        assert np.array_equal(g, w.numpy())
    buf = tr._payload(cnt, torch.as_tensor(states),
                      torch.as_tensor(wdense[flags]))
    buf_j, used_j = jr.encode_device(jnp.asarray(leaf), depth, nmax, K)
    assert buf.numel() == int(used_j)
    assert np.array_equal(buf.numpy(), np.asarray(buf_j)[:int(used_j)])
