"""The integer block butterfly ``raht_fwd_blocks_int``
(mpeg_pcc_tmc13_tpu_torch.ops.raht_fp_device.fwd_blocks_int): its fast
path's arithmetic, mirrored in plain torch, against the plain version's
``isqrt64_dev(floor((w << 30) / ws))``; its channel runs; and the wrapper
at more channels than one launch takes, against the JAX package's
``fwd_blocks_int``.  Tolerance 0 everywhere (integers).  The CUDA kernel
itself is held to its plain version on the card by chip_smoke.py (m).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mpeg_pcc_tmc13_tpu.ops import raht_fp_device as jfpd
from mpeg_pcc_tmc13_tpu_torch.ops import raht_fp_device as fpd
from mpeg_pcc_tmc13_tpu_torch.ops import raht_plan as rp

torch.set_num_threads(2)

LIMIT = fpd.FAST_WEIGHT_SUM
I64 = torch.int64


def _plain_coeffs(w0, w1):
    ws = (w0 + w1).clamp(min=1)
    return (rp.isqrt64_dev(fpd._floordiv(w0 << 30, ws)),
            rp.isqrt64_dev(fpd._floordiv(w1 << 30, ws)))


def _assert_pairs(w0, w1):
    a, b = fpd.fast_pair_coeffs_mirror(w0, w1)
    ra, rb = _plain_coeffs(w0, w1)
    assert torch.equal(a, ra) and torch.equal(b, rb)


def test_fast_pairs_exhaustive_to_2_10():
    """Every pair with w0, w1 <= 2^10, zero weights included."""
    r = torch.arange((1 << 10) + 1, dtype=I64)
    w0, w1 = torch.meshgrid(r, r, indexing="ij")
    _assert_pairs(w0.reshape(-1), w1.reshape(-1))


def test_fast_isqrt_around_every_square():
    """q = n^2 - 1, n^2, n^2 + 1 for every n <= 2^15 (the fp32 seed's
    truncation is one off at squares' edges; the corrections fix it)."""
    n = torch.arange((1 << 15) + 1, dtype=I64)
    q = torch.cat([n * n - 1, n * n, n * n + 1]).clamp(min=0)
    assert int(q.max()) == (1 << 30) + 1
    assert torch.equal(fpd.isqrt_fast_mirror(q), rp.isqrt64_dev(q))


def test_fast_pairs_random_below_2_22():
    """10^6 random pairs whose sum is below 2^22, spread over all sums."""
    rng = np.random.default_rng(22)
    ws = rng.integers(0, LIMIT, 1_000_000)
    w0 = np.minimum((rng.random(ws.size) * (ws + 1)).astype(np.int64), ws)
    ws[:4] = LIMIT - 1                    # the top edge, both ends
    w0[:4] = [0, 1, LIMIT - 2, LIMIT - 1]
    _assert_pairs(torch.as_tensor(w0), torch.as_tensor(ws - w0))


def _edge_blocks(total, nb=64, nc=3, seed=0):
    """Blocks whose eight weights sum to ``total`` exactly (some slots
    empty), with Q13 values."""
    rng = np.random.default_rng(seed)
    cut = np.sort(rng.integers(0, total + 1, (nb, 7)), axis=1)
    w = np.diff(np.concatenate([np.zeros((nb, 1), np.int64), cut,
                                np.full((nb, 1), total)], axis=1), axis=1)
    w[rng.random((nb, 8)) < 0.3] = 0
    w[:, 0] += total - w.sum(axis=1)      # back to the exact sum
    v = rng.integers(-1 << 21, 1 << 21, (nb, 8, nc))
    v[w == 0] = 0
    return torch.as_tensor(v), torch.as_tensor(w)


@pytest.mark.parametrize("total,fast", [(LIMIT - 1, True), (LIMIT, False)])
def test_fast_path_edge(total, fast):
    """At a weight sum of 2^22 - 1 a block takes the fast path, at 2^22
    the general one; either way the kernel's arithmetic (mirrored) equals
    the plain version's."""
    v, w = _edge_blocks(total, seed=total)
    assert torch.equal(fpd.fast_blocks(w), torch.full((w.shape[0],), fast))
    for got, want in zip(fpd.fwd_blocks_int_mirror(v, w),
                         fpd.fwd_blocks_int_ref(v, w)):
        assert torch.equal(got, want)


def test_mirror_mixes_fast_and_general_blocks():
    """Fast blocks beside blocks with weights of 2^22-2^32 (the general
    path) and values over the whole int64 range (the mix wraps)."""
    rng = np.random.default_rng(32)
    nb = 512
    w = np.where(rng.random((nb, 8)) < 0.7, rng.integers(1, 65, (nb, 8)), 0)
    big = rng.random(nb) < 0.1
    w[big] = rng.integers(0, 1 << 29, (int(big.sum()), 8))
    w[0] = [(1 << 32) - 1, 0, 3, 0, 0, 0, 0, 0]
    v = rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max,
                     (nb, 8, 2), dtype=np.int64)
    v, w = torch.as_tensor(v), torch.as_tensor(w.astype(np.int64))
    fast = fpd.fast_blocks(w)
    assert 0 < int(fast.sum()) < nb
    for got, want in zip(fpd.fwd_blocks_int_mirror(v, w),
                         fpd.fwd_blocks_int_ref(v, w)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("nc", [1, 2, 3, 4, 5, 7, 8, 9, 28, 32])
def test_channel_runs(nc):
    """Each channel once, in order, in runs of at most KERNEL_RUN_MAX: one
    launch a run, ceil(C / 4) launches (chip_smoke (m) checks the count)."""
    runs = fpd.channel_runs(nc)
    assert [c for c0, n in runs for c in range(c0, c0 + n)] == list(range(nc))
    assert all(1 <= n <= fpd.KERNEL_RUN_MAX for _, n in runs)
    assert len(runs) == -(-nc // fpd.KERNEL_RUN_MAX)


@functools.lru_cache(maxsize=None)
def _wide_blocks(nc):
    rng = np.random.default_rng(nc)
    nb = 300
    pat = rng.integers(0, 256, nb)
    pat[:256] = np.arange(256)
    occ = ((pat[:, None] >> np.arange(8)) & 1).astype(bool)
    w = np.where(occ, rng.integers(1, 1 << 12, (nb, 8)), 0).astype(np.int64)
    v = rng.integers(-1 << 21, 1 << 21, (nb, 8, nc)).astype(np.int64)
    v[~occ] = 0
    want = jax.jit(jfpd.fwd_blocks_int)(jnp.asarray(v), jnp.asarray(w))
    return v, w, [np.asarray(r) for r in want]


@pytest.mark.parametrize("nc", [28, 32])
def test_fwd_blocks_int_many_channels_matches_jax(nc):
    """C8: the wrapper takes more channels than one launch holds; on the
    CPU it equals the JAX package's fwd_blocks_int at C = 28 and 32."""
    v, w, want = _wide_blocks(nc)
    got = fpd.fwd_blocks_int(torch.as_tensor(v), torch.as_tensor(w))
    for g, r in zip(got, want):
        assert g.dtype == torch.int64 and np.array_equal(g.numpy(), r)


@pytest.mark.parametrize("nc", [5, 28, 32])
def test_channel_runs_reassemble(nc):
    """The wrapper's split (``_in_channel_runs``) with the plain version
    in place of a launch: each run sees at most 4 contiguous channels and
    the reassembled outputs equal one call over all C."""
    if nc in (28, 32):
        v, w = (torch.as_tensor(a) for a in _wide_blocks(nc)[:2])
    else:
        v, w = _edge_blocks(1000, nb=200, nc=nc, seed=nc)
    seen = []

    def run(part, weights):
        assert part.is_contiguous() and part.shape[2] <= fpd.KERNEL_RUN_MAX
        seen.append(part.shape[2])
        return fpd.fwd_blocks_int_ref(part, weights)

    got = fpd._in_channel_runs(run, v, w)
    assert seen == [n for _, n in fpd.channel_runs(nc)]
    for g, r in zip(got, fpd.fwd_blocks_int_ref(v, w)):
        assert torch.equal(g, r)


def test_fwd_blocks_int_takes_any_layout_on_the_cpu():
    """A non-contiguous view gives the same as its contiguous copy."""
    v, w = _edge_blocks(5000, nb=40, nc=3, seed=9)
    vt = v.permute(0, 2, 1).contiguous().permute(0, 2, 1)
    assert not vt.is_contiguous()
    for g, r in zip(fpd.fwd_blocks_int(vt, w), fpd.fwd_blocks_int(v, w)):
        assert torch.equal(g, r)
