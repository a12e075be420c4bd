"""Port parity: RAHT block butterflies
(mpeg_pcc_tmc13_tpu_torch.ops.raht_blocks) and the float RAHT lane
(ops.raht_device) against the Pallas kernels of
mpeg_pcc_tmc13_tpu/ops/pallas_raht.py run in interpret mode.

On CPU tensors the wrappers run their plain PyTorch versions; the CUDA
kernels are compared with those on the card by ``chip_smoke.py``.
Tolerances: ``mask`` and ``wout`` exact (integer weights sum exactly in
float32); values within 1e-5 * max(1, max|ref|), float32 rounding of
the same butterflies evaluated in another order; the lane-level cases
of tests/test_pallas_raht.py keep that file's tolerances.
"""

import sys
import threading
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mpeg_pcc_tmc13_tpu.ops import pallas_raht
from mpeg_pcc_tmc13_tpu.ops import raht_device as jrd
from mpeg_pcc_tmc13_tpu_torch.ops import _kernels
from mpeg_pcc_tmc13_tpu_torch.ops import raht_blocks as rb
from mpeg_pcc_tmc13_tpu_torch.ops import raht_device as trd
from mpeg_pcc_tmc13_tpu_torch.ops import rans_lanes as lanes
from mpeg_pcc_tmc13_tpu_torch.utils import morton as tmorton

torch.set_num_threads(2)

RTOL = 1e-5


def _blocks(nblocks, nchan, seed):
    """Integer weights 1..64 on occupied slots (0 elsewhere), values
    N(0, 50); the first 256 blocks take every occupancy pattern."""
    rng = np.random.default_rng(seed)
    pat = rng.integers(0, 256, nblocks)
    pat[:256] = np.arange(256)
    occ = ((pat[:, None] >> np.arange(8)) & 1).astype(bool)
    w = np.where(occ, rng.integers(1, 65, (nblocks, 8)), 0)
    v = rng.normal(0, 50, (nblocks, 8, nchan))
    return v.astype(np.float32), w.astype(np.float32)


def _close(got, ref):
    ref = np.asarray(ref)
    tol = RTOL * max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0, atol=tol)


@pytest.mark.parametrize("nchan", [1, 3])
def test_fwd_blocks_matches_pallas(nchan):
    v, w = _blocks(700, nchan, nchan)           # 700: not a multiple of 256
    coeffs, wout, mask = rb.fwd_blocks(torch.as_tensor(v),
                                       torch.as_tensor(w))
    rc, rw, rm = pallas_raht.fwd_blocks(jnp.asarray(v), jnp.asarray(w),
                                        interpret=True)
    assert coeffs.dtype == torch.float32 and mask.dtype == torch.int32
    assert np.array_equal(mask.numpy(), np.asarray(rm))
    assert np.array_equal(wout.numpy(), np.asarray(rw))
    _close(coeffs.numpy(), rc)


@pytest.mark.parametrize("nchan", [1, 3])
def test_inv_blocks_matches_pallas(nchan):
    v, w = _blocks(700, nchan, 10 + nchan)
    # arbitrary coefficients, so empty slots carry values too: the
    # inverse must reproduce the Pallas outputs slot for slot, including
    # the DC it leaves in an empty lo slot
    back = rb.inv_blocks(torch.as_tensor(v), torch.as_tensor(w))
    ref = pallas_raht.inv_blocks(jnp.asarray(v), jnp.asarray(w),
                                 interpret=True)
    _close(back.numpy(), ref)


def test_inv_blocks_inverts_fwd_blocks():
    v, w = _blocks(300, 3, 5)
    v = np.where(w[..., None] > 0, v, 0.0).astype(np.float32)
    coeffs, _, _ = rb.fwd_blocks(torch.as_tensor(v), torch.as_tensor(w))
    back = rb.inv_blocks(coeffs, torch.as_tensor(w)).numpy()
    occ = w > 0
    np.testing.assert_allclose(back[occ], v[occ], atol=1e-3)


def test_kernel_single_full_block():
    vals = np.arange(8, dtype=np.float32).reshape(1, 8, 1)
    w = np.ones((1, 8), dtype=np.float32)
    coeffs, wout, mask = rb.fwd_blocks(torch.as_tensor(vals),
                                       torch.as_tensor(w))
    assert float(wout[0, 0]) == 8.0
    assert int(mask.sum()) == 7   # 7 ACs for 8 children
    np.testing.assert_allclose(float(coeffs[0, 0, 0]),
                               np.sqrt(8) * vals.mean(), rtol=1e-5)


def test_kernel_sparse_collapse():
    # slots {1, 2} only: must merge at stage 2 via positional collapse
    vals = np.zeros((1, 8, 1), dtype=np.float32)
    w = np.zeros((1, 8), dtype=np.float32)
    vals[0, 1, 0] = 10.0
    vals[0, 2, 0] = 20.0
    w[0, 1] = w[0, 2] = 1.0
    coeffs, wout, mask = rb.fwd_blocks(torch.as_tensor(vals),
                                       torch.as_tensor(w))
    assert float(wout[0, 0]) == 2.0
    assert int(mask.sum()) == 1
    np.testing.assert_allclose(float(coeffs[0, 0, 0]), 30.0 / np.sqrt(2),
                               rtol=1e-5)


def test_empty_batch():
    coeffs, wout, mask = rb.fwd_blocks(torch.zeros(0, 8, 3),
                                       torch.zeros(0, 8))
    assert coeffs.shape == (0, 8, 3) and mask.shape == (0, 8)
    assert rb.inv_blocks(torch.zeros(0, 8, 2), torch.zeros(0, 8)).shape \
        == (0, 8, 2)


def test_cpu_tensor_never_touches_kernels(monkeypatch):
    def no_kernels(*a, **k):
        raise AssertionError("CPU path reached ops/_kernels.py")
    monkeypatch.setattr(_kernels, "load", no_kernels)
    monkeypatch.setattr(_kernels, "build", no_kernels)
    rb.reset_launch_counts()
    v, w = _blocks(300, 3, 7)
    coeffs, _, _ = rb.fwd_blocks(torch.as_tensor(v), torch.as_tensor(w))
    rb.inv_blocks(coeffs, torch.as_tensor(w))
    assert rb.LAUNCHES == {"fwd_blocks": 0, "inv_blocks": 0}


def test_other_devices_raise():
    """Neither CPU nor CUDA: no kernel and no fallback."""
    v = torch.zeros(4, 8, 3, device="meta")
    w = torch.zeros(4, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        rb.fwd_blocks(v, w)
    with pytest.raises(ValueError, match="no kernel"):
        rb.inv_blocks(v, w)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_kernels, "_find_nvcc", lambda: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _kernels.build()


def test_library_path_keys_on_sources(monkeypatch, tmp_path):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "a.cu").write_text("// one\n")
    monkeypatch.setattr(_kernels, "SRC_DIR", src)
    first = _kernels.library_path()
    assert first == _kernels.library_path()
    (src / "a.cu").write_text("// two\n")
    assert _kernels.library_path() != first


def test_load_builds_once_under_concurrent_first_use(monkeypatch):
    """Two threads that reach the kernels for the first time together
    (the CLI's slice workers): the slow build runs once and both get the
    same library."""
    built = []

    def slow_build():
        built.append(threading.get_ident())
        time.sleep(0.3)
        return tmp_so, 0.0

    tmp_so = _kernels.BUILD_DIR / "fake.so"     # never opened
    monkeypatch.setattr(_kernels, "_LIB", None)
    monkeypatch.setattr(_kernels, "_build", slow_build)
    monkeypatch.setattr(_kernels, "_open", lambda so: object())
    start = threading.Barrier(2, timeout=30)
    got = []

    def first_use():
        start.wait()
        got.append(_kernels.load())

    threads = [threading.Thread(target=first_use) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert len(built) == 1
    assert len(got) == 2 and got[0] is got[1]


def test_launch_counts_are_thread_safe():
    """The launch counters of both wrapper modules add up exactly when
    the CLI's worker threads count at once."""
    def count(mod, name):
        for _ in range(20_000):
            mod._count(name)

    # switch threads as often as the interpreter can, so a race shows
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for mod, name in ((rb, "fwd_blocks"), (lanes, "decode_tiles")):
            mod.reset_launch_counts()
            threads = [threading.Thread(target=count, args=(mod, name))
                       for _ in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
                assert not t.is_alive()
            assert mod.LAUNCHES[name] == 80_000
            mod.reset_launch_counts()
            assert set(mod.LAUNCHES.values()) == {0}
    finally:
        sys.setswitchinterval(interval)


def _cloud(n, depth, c=3, seed=0):
    rng = np.random.default_rng(seed)
    pos = rng.integers(0, 1 << depth, size=(n, 3), dtype=np.int64)
    codes = np.unique(tmorton.encode(pos))
    return codes, rng.normal(0, 50, (codes.size, c))


@pytest.mark.parametrize("n,depth", [(40, 2), (500, 3), (3000, 4)])
def test_forward_device_matches_jax(n, depth):
    codes, vals = _cloud(n, depth, seed=n)
    acs_t, root_t = trd.forward_device(codes, vals, depth)
    acs_j, root_j = jrd.forward_device(codes, vals, depth, interpret=True)
    # tests/test_pallas_raht.py:55-60 tolerance
    np.testing.assert_allclose(root_t.numpy(), np.asarray(root_j), atol=1e-2)
    assert len(acs_t) == len(acs_j) == depth
    for (ct, mt), (cj, mj) in zip(acs_t, acs_j):
        assert np.array_equal(mt.numpy(), np.asarray(mj))
        np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-2)


def test_forward_device_preserves_energy():
    codes, vals = _cloud(800, 3, c=1, seed=9)
    acs, root = trd.forward_device(codes, vals, 3)
    total = float(np.sum(root.numpy().astype(np.float64) ** 2))
    for coeffs, mask in acs:
        sel = mask.numpy() > 0
        total += float(np.sum(coeffs.numpy()[sel].astype(np.float64) ** 2))
    np.testing.assert_allclose(total, np.sum(vals ** 2), rtol=1e-4)


def test_inverse_device_matches_jax():
    rng = np.random.default_rng(3)
    pos = np.unique(rng.integers(0, 16, (400, 3)).astype(np.int64), axis=0)
    codes = np.sort(tmorton.encode(pos))
    vals = rng.normal(100, 30, (codes.size, 3)).astype(np.float32)
    depth = 4
    staged = trd.stage_plan(codes, depth, "cpu")
    acs, root = trd.forward_device(codes, vals, depth, staged=staged)
    rec = trd.inverse_device(codes, acs, root, depth, staged=staged)
    # tests/test_pallas_raht.py:120 tolerance
    np.testing.assert_allclose(rec.numpy(), vals, atol=2e-3)
    acs_j, root_j = jrd.forward_device(codes, vals, depth, interpret=True)
    rec_j = jrd.inverse_device(codes, acs_j, root_j, depth, interpret=True)
    np.testing.assert_allclose(rec.numpy(), np.asarray(rec_j), atol=2e-3)


def test_build_block_plan_matches_reference():
    codes, _ = _cloud(2000, 5, seed=4)
    for a, b in zip(trd.build_block_plan(codes, 5),
                    jrd.build_block_plan(codes, 5)):
        assert np.array_equal(a["gather"], b["gather"])
        assert np.array_equal(a["parent_codes"], b["parent_codes"])
