"""Port parity: the rANS geometry engine (mpeg_pcc_tmc13_tpu_torch.ops.
octree_rans, .ops.rans_lanes, .models.geometry_rans) against the JAX
package's octree_rans / geometry_rans, on CPU tensors.

Integer outputs, so every comparison is exact.  Depth 21 is held to the
numpy level builder only: the JAX ``_analysis`` splits each code at bit
30 into int32 words (mpeg_pcc_tmc13_tpu/ops/octree_rans.py:103-109), which
overflows for 63-bit codes, so its depth-21 payload decodes a different
cloud, while the port's native int64 pass is right.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import bench
import chip_smoke
from mpeg_pcc_tmc13_tpu.models import geometry_rans as jgr
from mpeg_pcc_tmc13_tpu.ops import octree_rans as jr
from mpeg_pcc_tmc13_tpu_torch.models import geometry_rans as tgr
from mpeg_pcc_tmc13_tpu_torch.ops import _kernels
from mpeg_pcc_tmc13_tpu_torch.ops import octree as tops
from mpeg_pcc_tmc13_tpu_torch.ops import octree_rans as tr
from mpeg_pcc_tmc13_tpu_torch.ops import rans_lanes as lanes
from mpeg_pcc_tmc13_tpu_torch.utils import morton

torch.set_num_threads(2)

# the (n, depth, lanes) cases of tests/test_rans.py, plus a surface cloud
CASES = [(1, 4, 64), (63, 5, 64), (500, 6, 64), (4000, 9, 128)]


def _uniq(n, depth, seed):
    rng = np.random.default_rng(seed)
    pos = rng.integers(0, 1 << depth, (n, 3)).astype(np.int64)
    return tops.unique_sorted(np.sort(morton.encode(pos)))


def _leaf(uniq, nmax=None):
    nmax = max(64, uniq.size) if nmax is None else nmax
    pad = np.empty(nmax, dtype=np.int64)
    pad[:uniq.size] = uniq
    pad[uniq.size:] = uniq[-1]
    return pad


def _surface():
    return tops.unique_sorted(np.sort(morton.encode(
        bench.make_surface_cloud(20000, 9))))


@pytest.fixture(scope="module")
def hist():
    """A (N_CTX, 256) histogram with empty, sparse and heavy rows."""
    rng = np.random.default_rng(3)
    h = rng.integers(0, 4, (lanes.N_CTX, 256)).astype(np.int32)
    h[::7] = 0
    h[5, 17] = 1_500_000
    h[9] = rng.integers(0, 60_000, 256)
    return h


@pytest.mark.parametrize("n,depth,K", CASES)
def test_encode_device_payload_matches_jax(n, depth, K):
    uniq = _uniq(n, depth, n)
    leaf = _leaf(uniq)
    buf_j, used_j = jr.encode_device(jnp.asarray(leaf), depth, leaf.size, K)
    buf_t, used_t = tr.encode_device(torch.as_tensor(leaf), depth,
                                     leaf.size, K)
    assert used_t == int(used_j)
    assert buf_t.dtype == torch.uint8
    assert np.array_equal(buf_t.numpy(), np.asarray(buf_j)[:used_t])


def test_encode_device_surface_matches_jax():
    uniq = _surface()
    leaf = _leaf(uniq, tgr._bucket(uniq.size))
    buf_j, used_j = jr.encode_device(jnp.asarray(leaf), 9, leaf.size, 256)
    buf_t, used_t = tr.encode_device(torch.as_tensor(leaf), 9, leaf.size,
                                     256)
    assert np.array_equal(buf_t.numpy(), np.asarray(buf_j)[:int(used_j)])


@pytest.mark.parametrize("n,depth,K", CASES)
def test_decode_device_matches_jax(n, depth, K):
    uniq = _uniq(n, depth, 50 + n)
    leaf = _leaf(uniq)
    buf, _ = tr.encode_device(torch.as_tensor(leaf), depth, leaf.size, K)
    counts, states, words = tr.parse_payload(buf.numpy(), depth, K)
    wp = np.zeros(max(64, words.size) + 3, np.int32)   # zero padding
    wp[:words.size] = words
    nodes_j, cnt_j = jr.decode_device(
        jnp.asarray(counts), jnp.asarray(states), jnp.asarray(wp), depth,
        leaf.size, K)
    nodes_t, cnt_t = tr.decode_device(
        counts, torch.as_tensor(states.astype(np.int64)),
        torch.as_tensor(wp), depth, leaf.size, K)
    assert int(cnt_t) == int(np.asarray(cnt_j)) == uniq.size
    assert np.array_equal(nodes_t.numpy(), np.asarray(nodes_j))
    assert np.array_equal(nodes_t.numpy()[:uniq.size], uniq)


@pytest.mark.parametrize("n,depth,K", CASES)
def test_roundtrip_host(n, depth, K):
    uniq = _uniq(n, depth, n)
    nodes, used = tr.roundtrip_host(uniq, depth, lanes=K, device="cpu")
    assert np.array_equal(nodes, uniq)
    assert used >= 4 * (depth + K + 1)


@pytest.mark.parametrize("depth,dups", [(6, False), (9, True), (20, True)])
def test_analysis_matches_jax(depth, dups):
    uniq = _uniq(1500, depth, depth)
    if dups:
        uniq = np.sort(np.concatenate([uniq, uniq[::5]]))
    leaf = _leaf(uniq, 2048)
    occ_j, ctx_j, cnt_j = jr._analysis(jnp.asarray(leaf), depth, leaf.size)
    occ_t, ctx_t, cnt_t = tr._analysis(torch.as_tensor(leaf), depth,
                                       leaf.size)
    assert np.array_equal(occ_t.numpy(), np.asarray(occ_j))
    assert np.array_equal(ctx_t.numpy(), np.asarray(ctx_j))
    assert np.array_equal(cnt_t.numpy(), np.asarray(cnt_j))


def test_quantize_cfull_matches_jax(hist):
    got = tr._quantize_cfull(torch.as_tensor(hist)).numpy()
    ref = np.asarray(jr._quantize_cfull(jnp.asarray(hist)))
    assert np.array_equal(got, ref)
    assert (got[:, 0] == 0).all() and (got[:, 255] == lanes.M).all()
    assert (np.diff(got, axis=1) >= 1).all()


def test_search_sym_matches_jax(hist):
    c_flat = np.array(jr._quantize_cfull(jnp.asarray(hist))).reshape(-1)
    rng = np.random.default_rng(4)
    ctxv = rng.integers(0, lanes.N_CTX, 4096).astype(np.int32)
    ctxv[:4] = (5, 9, 0, 7)
    slot = rng.integers(0, lanes.M, 4096).astype(np.int32)
    slot[4:8] = (0, lanes.M - 1, 0, lanes.M - 1)
    ref = np.asarray(jr._search_sym(jnp.asarray(c_flat), jnp.asarray(ctxv),
                                    jnp.asarray(slot)))
    got = tr._search_sym(torch.as_tensor(c_flat),
                         torch.as_tensor(ctxv).to(torch.int64),
                         torch.as_tensor(slot).to(torch.int64))
    assert np.array_equal(got.numpy(), ref)


@pytest.mark.parametrize("K", [64, 1024])
def test_step_maps_matches_jax(K):
    counts = np.array([1, 8, 59, 340, 1545, 6279, 0, 3], dtype=np.int32)
    s_cap = 8 * (-(-6279 // K)) + 9
    lj, bj, gj = jr._step_maps(jnp.asarray(counts), K, s_cap)
    lt, bt, gt = tr._step_maps(torch.as_tensor(counts), K, s_cap)
    assert gt == int(np.asarray(gj))
    assert np.array_equal(lt.numpy(), np.asarray(lj))
    assert np.array_equal(bt.numpy(), np.asarray(bj))
    # the refresh windows the port walks cover the reference's G steps
    # in order, each step at the reference's (level, base), and a new
    # window starts exactly where the reference refreshes its table
    lj, bj = np.asarray(lj), np.asarray(bj)
    steps = [(l, (t0 + i) * K, i == 0)
             for l, t0, nt, _ in lanes.windows(counts, K) for i in range(nt)]
    assert len(steps) == gt
    assert [(l, b) for l, b, _ in steps] == list(zip(lj[:gt], bj[:gt]))
    assert [w for *_, w in steps] == \
        list((bj[:gt] // K) % lanes.UPD_TILES == 0)
    assert [g0 for *_, g0 in lanes.windows(counts, K)] == \
        [g for g, (*_, w) in enumerate(steps) if w]


def test_model_encode_matches_jax_with_duplicates():
    rng = np.random.default_rng(11)
    depth = 7
    pos = rng.integers(0, 1 << depth, (2000, 3)).astype(np.int64)
    pos = np.concatenate([pos, pos[:100]])           # duplicates
    payload = tgr.encode(pos, depth, device="cpu")
    assert payload == jgr.encode(pos, depth)
    out = tgr.decode(payload, pos.shape[0], depth, device="cpu")
    assert np.array_equal(out, jgr.decode(payload, pos.shape[0], depth))
    assert np.array_equal(morton.encode(out),
                          np.unique(morton.encode(pos)))


def test_model_empty_and_lane_choice():
    assert tgr.encode(np.zeros((0, 3), np.int64), 5, device="cpu") \
        == bytes([0])
    assert tgr.decode(bytes([0]), 0, 5, device="cpu").shape == (0, 3)
    for n in (1, 63, 64, 8191, 8192, 131071, 131072, 10 ** 6):
        assert tgr._lanes_for(n) == jgr._lanes_for(n)
        assert tgr._bucket(n) == jgr._bucket(n)


def test_depth21_roundtrip_and_analysis_match_numpy_spec():
    """C4: at depth 21 the port round-trips exactly and its analysis
    equals build_levels_np (PARENT); the JAX engine does neither."""
    depth = 21
    uniq = _uniq(3000, depth, 21)
    assert uniq.max() >= 1 << 60
    nodes, _ = tr.roundtrip_host(uniq, depth, lanes=64, device="cpu")
    assert np.array_equal(nodes, uniq)
    leaf = _leaf(uniq, 4096)
    occ, ctx, counts = tr._analysis(torch.as_tensor(leaf), depth, leaf.size)
    levels = tops.build_levels_np(uniq, depth, tops.CTX_MODE_PARENT)
    for l, lv in enumerate(levels):
        k = lv["occ"].size
        assert int(counts[l]) == k
        assert np.array_equal(occ[l, :k].numpy(), lv["occ"])
        assert np.array_equal(ctx[l, :k].numpy(), lv["ctx_base"])
    pos = morton.decode(uniq)
    assert np.array_equal(
        tgr.decode(tgr.encode(pos, depth, device="cpu"), uniq.size, depth,
                   device="cpu"), pos)


def test_plain_lane_versions_on_cpu_count_no_launches():
    """On CPU tensors the wrappers run the plain versions (and count no
    launch); plain=True gives the same payload and decode."""
    uniq = _uniq(800, 6, 8)
    leaf = torch.as_tensor(_leaf(uniq))
    _kernels.reset_launch_counts()
    a, _ = tr.encode_device(leaf, 6, leaf.shape[0], 64)
    b, _ = tr.encode_device(leaf, 6, leaf.shape[0], 64, plain=True)
    assert torch.equal(a, b)
    counts, states, words = tr.parse_payload(a.numpy(), 6, 64)
    wp = torch.as_tensor(np.concatenate([words, np.zeros(64, np.int32)]))
    st = torch.as_tensor(states.astype(np.int64))
    for plain in (False, True):
        nodes, cnt = tr.decode_device(counts, st, wp, 6, leaf.shape[0], 64,
                                      plain=plain)
        assert np.array_equal(nodes[:int(cnt)].numpy(), uniq)
    assert set(_kernels.LAUNCHES.values()) == {0}


def test_kernel_wrappers_raise_off_cuda():
    """A tensor on a device other than the CPU launches the kernel or
    raises; it never takes the plain version."""
    meta = torch.device("meta")
    z = torch.zeros(3, 64, dtype=torch.int32, device=meta)
    _kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="no kernel for device"):
        lanes.table_pass(z, z, [64, 64, 10], 64)
    with pytest.raises(ValueError, match="no kernel for device"):
        lanes.encode_emit(z, z, torch.zeros(3, dtype=torch.int32,
                                            device=meta))
    with pytest.raises(ValueError, match="no kernel for device"):
        st = torch.zeros(64, dtype=torch.int64, device=meta)
        i32 = torch.zeros(64, dtype=torch.int32, device=meta)
        lanes.decode_level(i32, i32, i32, st, st[:1], i32, i32, 10)
    assert set(_kernels.LAUNCHES.values()) == {0}


def _recorded_decode(K=64):
    """chip_smoke.py's level record of a small decode: (uniq, counts,
    words, the analysis rows, the record)."""
    uniq = _uniq(3000, 8, 9)
    leaf = torch.as_tensor(_leaf(uniq))
    buf, _ = tr.encode_device(leaf, 8, leaf.shape[0], K)
    counts, states, words = tr.parse_payload(buf.numpy(), 8, K)
    occ2, ctx2, _ = tr._analysis(leaf, 8, leaf.shape[0])
    rec = chip_smoke._level_record(
        occ2, ctx2, counts.tolist(), torch.as_tensor(states.astype(np.int64)),
        torch.as_tensor(np.concatenate([words, np.zeros(64, np.int32)])), K)
    return uniq, counts, words, (occ2, ctx2), rec


def test_record_replays_the_decode():
    """The per-level record chip_smoke.py builds from the encoder's
    analysis (to check and time decode_level level by level), replayed
    through decode_level from the initial state, reproduces the decode:
    every word consumed, every symbol counted, every level's occupancy
    decoded, the state after each level the recorded start of the next,
    and the table left current."""
    uniq, counts, words, _, rec = _recorded_decode()
    assert len(rec.starts) == len(rec.counts) + 1 == 9
    st, cur, hist, table, syms = chip_smoke._replay_levels(
        lanes.decode_level, rec, chip_smoke._new_level_state(rec))
    assert int(cur) == words.size          # every word consumed
    assert int(hist.sum()) == int(counts.sum())
    for got, want in zip((st, cur, hist, table), rec.starts[-1]):
        assert torch.equal(got, want)
    assert torch.equal(table.view(-1, 256),
                       lanes.quantize_tables_ref(hist.view(-1, 256)))
    levels = tops.build_levels_np(uniq, 8, tops.CTX_MODE_PARENT)
    for l, lv in enumerate(levels):
        assert np.array_equal(syms[l][:counts[l]].numpy(), lv["occ"])
        assert torch.equal(syms[l], rec.syms[l])
    assert chip_smoke._decode_level_check(lanes.decode_level, rec,
                                          torch.device("cpu")) == 0.0


def test_tiles_bytes_counts_what_the_data_needs():
    """The byte bound chip_smoke.py gives decode_level counts this run's
    data, per launch (one a level): 8 B for each decoded symbol (context
    id in, symbol out), 4 B for each word it pops, the states in and out,
    and 4 KB for each distinct context row the level touches (its counts
    and its table row, each in and out once).  Not the whole 2048 x 256
    table and histogram, nor a touched row once per refresh window; the
    touched rows are still reported per window."""
    _, counts, words, (occ2, ctx2), rec = _recorded_decode()
    K = 64
    want = words.size * 4 + sum(1 for n in counts if n) * 2 * K * 8
    for l, n in enumerate(counts):
        want += int(n) * 8 + len(set(ctx2[l, :n].tolist())) * 4096
    touched = [len(set(ctx2[l, t0 * K:(t0 + nt) * K][:int(counts[l]) - t0 * K]
                       .tolist()))
               for l, t0, nt, _ in lanes.windows(counts, K)]
    assert chip_smoke._level_bytes(rec) == (want, touched)
    assert want < len(counts) * lanes.N_CTX * 256 * 4


def test_wide_row_check_runs_both_plain_versions():
    """chip_smoke.py's check of both kernels on context rows past 2^23
    counts, on CPU tensors (the wrappers take the plain versions, so it
    must find no difference and count no launch): the decode's raised
    rows hold more than 2^23 counts, and the table pass row the given
    occurrences plus its Laplace prior."""
    *_, rec = _recorded_decode()
    _kernels.reset_launch_counts()
    errs, wide, total = chip_smoke._wide_row_check(
        rec, torch.device("cpu"), occurrences=3000)
    assert errs == {"decode_level": 0.0, "table_pass": 0.0}
    assert wide >= 1 << 23 and total == 3000 + 255
    assert set(_kernels.LAUNCHES.values()) == {0}


@pytest.mark.parametrize("call", ["encode", "decode", "roundtrip_host"])
def test_device_engine_has_no_host_default(call):
    """With no device given, the rANS engine takes the current CUDA
    device, and raises where there is none instead of running on the
    host."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; it is the default")
    pos = np.zeros((4, 3), np.int64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if call == "encode":
            tgr.encode(pos, 5)
        elif call == "decode":
            tgr.decode(bytes([6]) + bytes(300), 4, 5)
        else:
            tr.roundtrip_host(np.arange(4, dtype=np.int64), 5)
