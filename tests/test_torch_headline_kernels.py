"""The bench headline's device path: the plain versions (``_ref``) of the
four hand-written kernels of ``csrc/octree_levels.cu`` and
``csrc/raht_fp_loop.cu`` against the JAX package, the kernels'
algorithms mirrored in plain torch against those plain versions, and
the dispatch (a CPU tensor takes the plain version and launches
nothing).

* ``_truth_level_ref``, ``_enc_group_ref``, ``_dec_group_ref`` against
  the JAX ``_truth_level``, ``_enc_group``, ``_dec_group`` group by
  group on plans of ``build_fp_plan`` (200-2,000 points, C in {1, 3});
  ``_expand_level_ref`` against the JAX ``_expand_level`` level by
  level; ``encode_occ_u8_hdr_ref`` against the JAX ``encode_occ_u8_hdr``
  at depths 1-12 with a cap that overflows.
* The mirrors: the clz first-level formula (depth 21 against
  ``build_levels_np``), the occupancy pass's tiles, the expansion's
  scan and scatter, and the group kernel's fused predict, forward
  network, quantisation and inverse network with its floor division,
  also driven through ``DeviceFpRaht``'s kernel loop
  (``MIRROR_LAUNCHERS``: the roots (de)quantised in the first group,
  the children's means handed on, the last decode group's shift).

* The redesigned kernels (``raht_fp_group``'s exact FP64 division with
  its int64 general path, tiles, gather and prologue; ``octree_expand``'s
  rounds of one row a lane, its tile-plus-round prefixes and its
  ping-pong buffers with no intermediate padding): ``fdiv_mirror`` and
  ``quant_f_mirror`` against Python's floor division and ``_quant``
  (seeded and ``hypothesis`` numerators, every divisor kind), the group
  mirror at the kernel's tile and a ragged one on clouds of depth 1, 3
  (one with exactly one tile of 32 parent blocks) and 10, at 1, 3 and 5
  channels (5: two channel windows), against the plain loop and the JAX
  ``DeviceFpRaht``, the expansion mirrors at the kernel's round, one
  warp's and a ragged one against the plain versions and the JAX
  ``decode_expand_stream``/``_expand_level``.

Tolerance everywhere: exact equality (every lane is integer).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mpeg_pcc_tmc13_tpu.ops import octree as jops
from mpeg_pcc_tmc13_tpu.ops import raht_fp_device as jfp
from mpeg_pcc_tmc13_tpu_torch.ops import _kernels
from mpeg_pcc_tmc13_tpu_torch.ops import octree as tops
from mpeg_pcc_tmc13_tpu_torch.ops import raht_fp_device as tfp
from mpeg_pcc_tmc13_tpu_torch.ops import raht_plan as rp
from mpeg_pcc_tmc13_tpu_torch.utils import morton as tmorton

torch.set_num_threads(2)

# (points, extent, depth): the extent of the second exceeds 2^depth, so
# its top group has several roots
CLOUDS = {"n300": (300, 16, 4), "n2000": (2000, 64, 6),
          "roots8": (600, 64, 5)}
STEPS = [13000, 17000, 9000]


def _cloud(name, nchan, seed=5):
    n, extent, depth = CLOUDS[name]
    rng = np.random.default_rng(seed)
    pos = np.unique(rng.integers(0, extent, (n, 3)), axis=0)
    codes = np.sort(tmorton.encode(pos))
    base = (pos[np.argsort(tmorton.encode(pos))] @ np.array([3, 5, 7]))
    vals = ((base[:, None] * np.arange(1, nchan + 1)
             + rng.integers(0, 60, (codes.size, nchan))) % 256)
    return codes, vals.astype(np.int64), depth


def _plain_chain(dv, vals):
    """Inputs of every truth level and encode/decode group, propagated
    with the plain versions: (truth, enc, dec) lists of (args, kw)."""
    truth, enc, dec = [], [], []
    cur = torch.as_tensor(vals) << tfp.F
    acs = []
    for p in dv.plans:
        truth.append(((cur, p), {}))
        cur, z, y, x = tfp._truth_level_ref(cur, p)
        acs.append((z, y, x))
    recon = tfp._dequant(tfp._quant(cur, dv.steps), dv.steps)
    grand = torch.zeros(dv.n_roots, dtype=torch.int64)
    for gi in range(dv.depth):
        g = dv.depth - 1 - gi
        kw = dv._group_kw(gi)
        args = (recon, grand, *acs[g], dv.steps, dv.plans[g])
        enc.append((args, kw, g))
        qz, qy, qx, recon2, grand2 = tfp._enc_group_ref(*args, **kw)
        dec.append(((recon, grand, qz, qy, qx, dv.steps, dv.plans[g]), kw,
                    g))
        recon, grand = recon2, grand2
    return truth, enc, dec


FP_CASES = [(c, k) for c in ("n300", "n2000") for k in (1, 3)]
# the cases held to the JAX package (its jitted level steps compile once
# per group shape, seconds each)
JAX_CASES = [("n300", 1), ("n2000", 3)]
_CASES = {}


def _case(case):
    """(plain plan, values, plain chain, JAX plans) of a cloud, built
    once per worker."""
    if case not in _CASES:
        codes, vals, depth = _cloud(*case)
        steps = STEPS[:case[1]]
        dv = tfp.DeviceFpRaht(codes, depth, steps, device="cpu")
        jplans = (jfp.DeviceFpRaht(codes, depth, steps).plans
                  if case in JAX_CASES else None)
        _CASES[case] = (dv, vals, _plain_chain(dv, vals), jplans)
    return _CASES[case]


@pytest.fixture(params=FP_CASES, ids=lambda p: f"{p[0]}-C{p[1]}")
def fp_case(request):
    return _case(request.param)


def _np(t):
    return np.asarray(t)


def _same(ours, theirs):
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        a, b = _np(a), _np(b)
        assert a.shape == b.shape and np.array_equal(a, b)


def _to_jax(args):
    return [jnp.asarray(a.numpy()) if isinstance(a, torch.Tensor) else a
            for a in args]


# ---- the plain versions against the JAX package ------------------------

@pytest.mark.parametrize("case", JAX_CASES, ids=str)
def test_truth_level_ref_matches_jax(case):
    _, _, (truth, _, _), jplans = _case(case)
    truth_j, _, _ = jfp._jits()
    for g, ((cur, p), _) in enumerate(truth):
        _same(tfp._truth_level_ref(cur, p),
              truth_j(jnp.asarray(cur.numpy()), jplans[g]))


@pytest.mark.parametrize("case", JAX_CASES, ids=str)
def test_enc_group_ref_matches_jax(case):
    _, _, (_, enc, _), jplans = _case(case)
    _, enc_j, _ = jfp._jits()
    for args, kw, g in enc:
        jargs = _to_jax(args[:6]) + [jplans[g]]
        _same(tfp._enc_group_ref(*args, **kw), enc_j(*jargs, **kw))


@pytest.mark.parametrize("case", JAX_CASES, ids=str)
def test_dec_group_ref_matches_jax(case):
    _, _, (_, _, dec), jplans = _case(case)
    _, _, dec_j = jfp._jits()
    for args, kw, g in dec:
        jargs = _to_jax(args[:6]) + [jplans[g]]
        _same(tfp._dec_group_ref(*args, **kw), dec_j(*jargs, **kw))


def _stream(depth, n=1500, seed=7):
    rng = np.random.default_rng(seed)
    codes = np.unique(tmorton.encode(rng.integers(0, 1 << depth, (n, 3))))
    occ, counts = tops.encode_occ_u8_ref(torch.as_tensor(codes), depth,
                                         depth * codes.size + 64)
    return codes, occ, counts


def _level_inputs(occ, counts, depth, nmax):
    """(nodes, occ) of every level, chained with ``_expand_level_ref``."""
    nodes = torch.full((nmax,), tops.I64_MAX, dtype=torch.int64)
    nodes[0] = 0
    out, off = [], 0
    for l in range(depth):
        k = int(counts[l])
        o = torch.zeros(nmax, dtype=torch.int64)
        o[:k] = occ[off:off + k]
        off += k
        out.append((nodes, o))
        nodes = tops._expand_level_ref(nodes, o, nmax)[0]
    return out, nodes


@pytest.mark.parametrize("depth", [3, 7, 10])
def test_expand_level_ref_matches_jax(depth):
    codes, occ, counts = _stream(depth)
    nmax = codes.size + 37
    levels, last = _level_inputs(occ, counts, depth, nmax)
    for nodes, o in levels:
        out, cnt, _ = tops._expand_level_ref(nodes, o, nmax)
        jout, jcnt = jops._expand_level(jnp.asarray(nodes.numpy()),
                                        jnp.asarray(o.numpy()), nmax)
        assert np.array_equal(out.numpy(), np.asarray(jout))
        assert int(cnt) == int(jcnt)
    assert np.array_equal(last[:codes.size].numpy(), codes)


@pytest.mark.parametrize("depth", range(1, 13))
def test_encode_occ_u8_hdr_ref_matches_jax_with_overflowing_cap(depth):
    rng = np.random.default_rng(depth)
    codes = np.sort(tmorton.encode(rng.integers(0, 1 << depth, (700, 3))))
    total = int(tops.encode_occ_u8_ref(torch.as_tensor(codes), depth,
                                       64)[1].sum())
    for cap in (total + 64, max(1, total // 2)):
        ours = tops.encode_occ_u8_hdr_ref(torch.as_tensor(codes), depth, cap)
        theirs = jops.encode_occ_u8_hdr(jnp.asarray(codes), depth, cap)
        assert np.array_equal(ours.numpy(), np.asarray(theirs))
        assert int(ours[:4 * depth].view(torch.int32).sum()) == total


# ---- the kernels' algorithms, mirrored, against the plain versions ------

def test_msb_mirror_is_the_highest_set_bit():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.integers(-(1 << 62), 1 << 62, 4000,
                                     dtype=np.int64),
                        (np.int64(1) << np.arange(63)), [0, -1]])
    want = np.array([63 if v < 0 else int(v).bit_length() - 1 for v in x])
    assert np.array_equal(tops._msb_mirror(torch.as_tensor(x)).numpy(), want)


@pytest.mark.parametrize("depth", [1, 2, 5, 11, 16, 20, 21])
def test_first_level_mirror_matches_min_levels(depth):
    rng = np.random.default_rng(depth)
    codes = np.sort(tmorton.encode(rng.integers(0, 1 << depth, (3000, 3))))
    codes = np.concatenate([codes[:5], codes])      # duplicates
    codes.sort()
    c = torch.as_tensor(codes)
    assert torch.equal(tops.first_level_mirror(c, depth),
                       tops._min_levels(c, depth))


def test_occ_u8_mirror_depth21_matches_build_levels_np():
    rng = np.random.default_rng(21)
    codes = np.unique(tmorton.encode(rng.integers(0, 1 << 21, (3000, 3))))
    ref = np.concatenate([lv["occ"] for lv in tops.build_levels_np(
        codes, 21, tops.CTX_MODE_PARENT)])
    occ, counts = tops.occ_u8_mirror(torch.as_tensor(codes), 21,
                                     ref.size + 64, tile=512)
    assert int(counts.sum()) == ref.size
    assert np.array_equal(occ[:ref.size].numpy(), ref)


@pytest.mark.parametrize("tile", [64, tops.KERNEL_TILE])
@pytest.mark.parametrize("overflow", [False, True])
def test_occ_u8_mirror_matches_ref(tile, overflow):
    depth = 9
    rng = np.random.default_rng(9)
    codes = np.sort(tmorton.encode(rng.integers(0, 1 << depth, (5000, 3))))
    c = torch.as_tensor(codes)
    total = int(tops.encode_occ_u8_ref(c, depth, 64)[1].sum())
    cap = total // 3 if overflow else total + 100
    got = tops.occ_u8_mirror(c, depth, cap, tile=tile)
    want = tops.encode_occ_u8_ref(c, depth, cap)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert int(got[1].sum()) == total


@pytest.mark.parametrize("tile", [64, tops.KERNEL_TILE])
@pytest.mark.parametrize("depth", [4, 9])
def test_expand_level_mirror_matches_ref(depth, tile):
    codes, occ, counts = _stream(depth, n=2500)
    nmax = codes.size + 11
    levels, _ = _level_inputs(occ, counts, depth, nmax)
    for nodes, o in levels:
        for occ_in in (o, o.to(torch.uint8)):
            got = tops.expand_level_mirror(nodes, occ_in, nmax, threads=tile)
            want = tops._expand_level_ref(nodes, o, nmax)
            assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_expand_level_mirror_drops_children_past_nmax():
    codes, occ, counts = _stream(6, n=800)
    levels, _ = _level_inputs(occ, counts, 6, codes.size)
    l = int(torch.argmax(counts[1:] - counts[:-1]))  # the widest fan-out
    nodes, o = levels[l]
    nmax = int(counts[l]) + 3                  # fewer slots than children
    got = tops.expand_level_mirror(nodes[:nmax], o[:nmax], nmax, threads=64)
    want = tops._expand_level_ref(nodes[:nmax], o[:nmax], nmax)
    assert int(want[1]) > nmax
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_floordiv_mirror_rounds_negative_numerators_down():
    rng = np.random.default_rng(3)
    a = torch.as_tensor(rng.integers(-(1 << 50), 1 << 50, 20000))
    b = torch.as_tensor(rng.integers(1, 1 << 31, 20000))
    a[:4] = torch.tensor([-7, -6, 7, 0])
    b[:4] = 3
    assert torch.equal(rp.floordiv_mirror(a, b),
                       torch.div(a, b, rounding_mode="floor"))
    assert rp.floordiv_mirror(torch.tensor([-7]), torch.tensor([3])) == -3


def test_children_means_hand_on_to_the_next_group():
    """The group kernel writes its children's means with its own sw_c,
    and the next group reads them as its parents' (sw_p)."""
    codes, _, depth = _cloud("n2000", 1)
    plans = tfp.build_fp_plan(codes, depth)
    for g in range(1, depth):
        assert np.array_equal(plans[g - 1].sw_p, plans[g].sw_c)


def test_row_offsets_put_pairs_in_zrow_order():
    codes, _, depth = _cloud("n2000", 1)
    for p in tfp.plans_to_torch(tfp.build_fp_plan(codes, depth), "cpu"):
        cf = tfp._coef_mirror(p)
        rows = tfp._pair_rows_mirror(rp.row_offsets(p), cf[2])
        for ks, flat, k in ((range(4), p["flat_z"], 4),
                            (range(4, 6), p["flat_y"], 2),
                            ((6,), p["flat_x"], 1)):
            got = torch.full((p["az"].shape[0] * k,), -1, dtype=torch.int64)
            got[flat] = torch.arange(flat.numel())
            assert torch.equal(rows[:, list(ks)].reshape(-1), got)


def _group_mirror_call(args, kw, decode):
    p = args[6]
    mp, mc, counts = tfp._group_shapes(p)
    c = args[5].shape[0]
    q = [None] * 3 if decode else \
        [torch.empty(n, c, dtype=torch.int64) for n in counts]
    recon_c = torch.empty(mc, c, dtype=torch.int64)
    cnt = torch.empty(mc, dtype=torch.int64)
    mode = (tfp.MODE_DECODE if decode else 0) | \
        (tfp.MODE_HAVE_GRAND if kw["have_grand"] else 0)
    tfp.group_mirror(p, rp.row_offsets(p), mp, mode, args[0], None,
                     args[1] if kw["have_grand"] else None, args[5],
                     list(args[2:5]), None, q, None, recon_c, None, cnt,
                     kw["t0"], kw["weights"])
    return q, recon_c, cnt


def test_group_mirror_matches_enc_group_ref(fp_case):
    _, _, (_, enc, _), _ = fp_case
    for args, kw, _ in enc:
        q, recon_c, cnt = _group_mirror_call(args, kw, decode=False)
        want = tfp._enc_group_ref(*args, **kw)
        assert all(torch.equal(a, b)
                   for a, b in zip((*q, recon_c, cnt), want))


def test_group_mirror_matches_dec_group_ref(fp_case):
    _, _, (_, _, dec), _ = fp_case
    for args, kw, _ in dec:
        _, recon_c, cnt = _group_mirror_call(args, kw, decode=True)
        want = tfp._dec_group_ref(*args, **kw)
        assert torch.equal(recon_c, want[0]) and torch.equal(cnt, want[1])


def test_truth_level_mirror_matches_ref(fp_case):
    _, _, (truth, _, _), _ = fp_case
    for (cur, p), _ in truth:
        want = tfp._truth_level_ref(cur, p)
        got = [torch.empty_like(t) for t in want]
        tfp.truth_level_mirror(p, rp.row_offsets(p), p["az"].shape[0], cur,
                               0, *got)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("name", ["n300", "n2000", "roots8"])
@pytest.mark.parametrize("nchan", [1, 3])
def test_mirror_launchers_drive_the_loop_like_the_plain_versions(name,
                                                                  nchan):
    """``DeviceFpRaht``'s kernel loop (the card's) on the mirrors: the
    same q rows in coded order, reconstruction and decode as the plain
    loop; the top group of ``roots8`` has eight roots."""
    codes, vals, depth = _cloud(name, nchan)
    dv = tfp.DeviceFpRaht(codes, depth, STEPS[:nchan], device="cpu")
    if name == "roots8":
        assert dv.n_roots == 8
    qs = []
    recon = dv._encode_plain(torch.as_tensor(vals), qs.append)
    recon_k, qbuf = dv._encode_kernels(torch.as_tensor(vals),
                                       tfp.MIRROR_LAUNCHERS)
    assert qbuf.dtype == torch.int32 and torch.equal(recon_k, recon)
    cuts = dv.rows.slices()
    assert len(cuts) == len(qs)
    assert all(np.array_equal(qbuf[c].numpy(), q) for c, q in zip(cuts, qs))
    rows = torch.as_tensor(np.concatenate(qs).astype(np.int64))
    want = dv._decode_plain(rows, [c.stop - c.start for c in cuts])
    assert torch.equal(dv._decode_kernels(rows, tfp.MIRROR_LAUNCHERS), want)


def test_mirror_launchers_at_depth_one():
    """One group is both the first (roots) and the last (the shift)."""
    codes = np.arange(8, dtype=np.int64)[[0, 3, 5, 6]]
    vals = np.array([[10], [200], [37], [90]], dtype=np.int64)
    dv = tfp.DeviceFpRaht(codes, 1, [9000], device="cpu")
    qs = []
    dv._encode_plain(torch.as_tensor(vals), qs.append)
    _, qbuf = dv._encode_kernels(torch.as_tensor(vals), tfp.MIRROR_LAUNCHERS)
    assert np.array_equal(qbuf.numpy(), np.concatenate(qs))
    rows = torch.as_tensor(np.concatenate(qs).astype(np.int64))
    assert torch.equal(dv._decode_kernels(rows, tfp.MIRROR_LAUNCHERS),
                       dv._decode_plain(rows, [q.shape[0] for q in qs]))


# ---- dispatch ------------------------------------------------------------

def _no_build():
    raise AssertionError("a CPU tensor reached the kernel loader")


def _public_calls():
    codes, vals, depth = _cloud("n300", 3)
    dv = tfp.DeviceFpRaht(codes, depth, STEPS, device="cpu")
    truth, enc, dec = _plain_chain(dv, vals)
    c = torch.as_tensor(codes)
    _, occ, counts = _stream(5)
    levels, _ = _level_inputs(occ, counts, 5, 1600)
    return {
        "encode_occ_u8": (tops.encode_occ_u8, tops.encode_occ_u8_ref,
                          (c, depth, 900), {}),
        "encode_occ_u8_hdr": (tops.encode_occ_u8_hdr,
                              tops.encode_occ_u8_hdr_ref, (c, depth, 900),
                              {}),
        "_expand_level": (tops._expand_level, tops._expand_level_ref,
                          (*levels[2], 1600), {}),
        "decode_expand_stream": (tops.decode_expand_stream,
                                 tops.decode_expand_stream_ref,
                                 (occ, counts, 5, 1600), {}),
        "_truth_level": (tfp._truth_level, tfp._truth_level_ref,
                         *truth[1]),
        "_enc_group": (tfp._enc_group, tfp._enc_group_ref, *enc[1][:2]),
        "_dec_group": (tfp._dec_group, tfp._dec_group_ref, *dec[1][:2]),
    }


@pytest.mark.parametrize("name", ["encode_occ_u8", "encode_occ_u8_hdr",
                                  "_expand_level", "decode_expand_stream",
                                  "_truth_level", "_enc_group", "_dec_group"])
def test_cpu_tensor_takes_the_plain_version(name, monkeypatch):
    """A CPU tensor reaches the ``_ref`` function: same outputs, no
    launch counted, the kernel library never loaded."""
    fn, ref, args, kw = _public_calls()[name]
    monkeypatch.setattr(_kernels, "load", _no_build)
    _kernels.reset_launch_counts()
    got, want = fn(*args, **kw), ref(*args, **kw)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert set(_kernels.LAUNCHES.values()) == {0}


def test_device_fp_raht_on_cpu_launches_nothing(monkeypatch):
    codes, vals, depth = _cloud("n300", 3)
    monkeypatch.setattr(_kernels, "load", _no_build)
    _kernels.reset_launch_counts()
    dv = tfp.DeviceFpRaht(codes, depth, STEPS, device="cpu")
    qs = []
    dv.encode(vals, qs.append)
    it = iter(qs)
    dv.decode(lambda m: next(it), 3)
    assert set(_kernels.LAUNCHES.values()) == {0}


@pytest.mark.parametrize("fn", [
    lambda t: tops.encode_occ_u8(t, 3, 64),
    lambda t: tops.encode_occ_u8_hdr(t, 3, 64),
    lambda t: tops.decode_expand_stream(t.to(torch.uint8), t, 3, 8),
    lambda t: tops._expand_level(t, t, 8),
    lambda t: tfp._truth_level(t[:, None], {}),
    lambda t: rp.build_plan(t, 3),
])
def test_other_devices_raise(fn):
    with pytest.raises(ValueError, match="no kernel for device"):
        fn(torch.zeros(8, dtype=torch.int64, device="meta"))


@pytest.mark.cuda
def test_cuda_tensor_launches_the_kernels():
    """On a card the public names launch the kernels and equal the plain
    versions (chip_smoke.py phase (p) does this at the bench size)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")
    codes, vals, depth = _cloud("n2000", 3)
    dev = torch.device("cuda:0")
    _kernels.reset_launch_counts()
    c = torch.as_tensor(codes, device=dev)
    got = tops.encode_occ_u8_hdr(c, depth, 6000)
    assert torch.equal(got.cpu(), tops.encode_occ_u8_hdr_ref(c.cpu(), depth,
                                                             6000))
    dv = tfp.DeviceFpRaht(codes, depth, STEPS, device=dev)
    qs = []
    dv.encode(vals, qs.append)
    plain = []
    tfp.DeviceFpRaht(codes, depth, STEPS, device="cpu").encode(
        vals, plain.append)
    assert all(np.array_equal(a, b) for a, b in zip(qs, plain))
    assert _kernels.LAUNCHES["octree_occ_u8"] == 2
    assert _kernels.LAUNCHES["raht_fp_truth_level"] == depth
    assert _kernels.LAUNCHES["raht_fp_group"] == depth
    assert _kernels.LAUNCHES["raht_fp_plan"] == 3


# ---- the redesigned kernels: exact divisions, staged tiles, real rows ----

I64_MIN, I64_MAX = -(1 << 63), (1 << 63) - 1
FAST = rp.FAST_DIV_LIMIT


def _floor_py(a, d):
    """Python's exact floor division, as int64 tensors."""
    return torch.tensor([int(x) // int(y) for x, y in zip(a, d)],
                        dtype=torch.int64)


def _divisors(rng, n):
    """The group kernel's divisor kinds across their ranges: 3 st for
    steps of every size, the prediction's weight sums (w_self plus up to
    six neighbour weights; custom weights up to past the fast limit),
    and Q15 square roots of subtree weights 1..2^31."""
    st = rng.integers(1, 1 << 40, n)
    three_st = 3 * st
    wsum = np.concatenate([rng.integers(1, 22, n // 2),
                           rng.integers(1, FAST + 1000, n - n // 2)])
    sw = np.floor(np.sqrt(rng.integers(1, 1 << 31, n).astype(np.float64))
                  * (1 << 15)).astype(np.int64)
    return {"3st": three_st, "wsum": wsum, "sw": sw}


def _numerators(rng, n):
    """Seeded int64 numerators: small and Q13-sized, near and past the
    fast limit, +-2^62, INT64_MIN + 1, negative means."""
    parts = [rng.integers(-(1 << 20), 1 << 20, n),
             rng.integers(-(1 << 46), 1 << 46, n),
             rng.integers(-FAST - 5, FAST + 6, n),
             rng.integers(I64_MIN + 1, I64_MAX, n, dtype=np.int64),
             np.array([FAST, -FAST, FAST + 1, -FAST - 1, 1 << 62,
                       -(1 << 62), I64_MIN + 1, I64_MAX, 0, -1, 1])]
    return np.concatenate(parts)


@pytest.mark.parametrize("kind", ["3st", "wsum", "sw"])
def test_fdiv_mirror_equals_floor_division(kind):
    """Both paths of the group kernel's division against Python's floor
    division, for each divisor kind: the fast path exactly where |a| <=
    2^51 and 1 <= d <= 2^51."""
    rng = np.random.default_rng(14)
    a = _numerators(rng, 3000)
    d = _divisors(rng, a.size)[kind]
    a_t, d_t = torch.as_tensor(a), torch.as_tensor(d)
    count = torch.zeros(2, dtype=torch.int64)
    q = rp.fdiv_mirror(a_t, d_t, rp.fast_rcp_mirror(d_t), count)
    assert torch.equal(q, _floor_py(a, d))
    fast = (np.abs(a.astype(object)) <= FAST) & (d >= 1) & (d <= FAST)
    assert int(count[0]) == int(fast.sum()) > 0
    assert int(count[1]) == a.size - int(fast.sum()) > 0


def test_fdiv_mirror_fast_path_at_its_edges():
    """Numerators at and around multiples of the divisor, both signs, at
    the fast limit's edge: the FP64 quotient's one-step correction."""
    d = torch.tensor([1, 3, 7, 21, 3 * 13000, 1 << 15, (1 << 25) + 1,
                      FAST - 1, FAST], dtype=torch.int64)
    k = torch.tensor([0, 1, 2, 3, 1 << 20, (1 << 36) + 1], dtype=torch.int64)
    a = (k[:, None, None] * d[None, :, None]
         + torch.tensor([-1, 0, 1])[None, None, :])
    a = torch.cat([a, -a]).reshape(-1)
    a = a.clamp(-FAST, FAST)
    dd = d[None, :, None].expand(12, -1, 3).reshape(-1)
    count = torch.zeros(2, dtype=torch.int64)
    q = rp.fdiv_mirror(a, dd, rp.fast_rcp_mirror(dd), count)
    assert torch.equal(q, _floor_py(a.tolist(), dd.tolist()))
    assert int(count[1]) == 0


def test_quant_f_mirror_equals_quant_where_24_res_wraps():
    """The kernel's quantiser against the plain ``_quant`` on residuals
    whose 24 |res| + st wraps int64 (general path) and on ordinary ones
    (fast path)."""
    rng = np.random.default_rng(7)
    steps = torch.tensor([13000, 17000, 9000])
    res = np.concatenate([rng.integers(-(1 << 30), 1 << 30, (500, 3)),
                          rng.integers(1 << 58, 1 << 62, (200, 3)),
                          -rng.integers(1 << 58, 1 << 62, (200, 3)),
                          np.full((1, 3), I64_MIN + 1),
                          np.full((1, 3), I64_MIN)])
    res = torch.as_tensor(res)
    count = torch.zeros(2, dtype=torch.int64)
    got = tfp.quant_f_mirror(res, steps, 3 * steps,
                             rp.fast_rcp_mirror(3 * steps), count)
    assert torch.equal(got, tfp._quant(res, steps))
    assert int(count[0]) > 0 and int(count[1]) > 0


try:
    from hypothesis import given, settings, strategies as hst
except ImportError:                      # pragma: no cover
    given = None

if given is not None:
    @settings(max_examples=400, deadline=None, database=None)
    @given(a=hst.one_of(hst.integers(-FAST, FAST),
                        hst.integers(I64_MIN + 1, I64_MAX),
                        hst.sampled_from([1 << 62, -(1 << 62),
                                          I64_MIN + 1])),
           d=hst.one_of(hst.integers(1, 21), hst.integers(1, FAST),
                        hst.integers(FAST + 1, I64_MAX)))
    def test_fdiv_mirror_hypothesis(a, d):
        """Any int64 numerator over any positive divisor."""
        q = rp.fdiv_mirror(torch.tensor([a]), torch.tensor([d]),
                           rp.fast_rcp_mirror(torch.tensor([d])))
        assert int(q) == a // d


def _one_warp_cloud(depth, nchan, seed=11):
    """A cloud whose finest group has exactly 32 parent blocks (one tile
    of the kernel, one warp of its blocks), 1-8 children each."""
    rng = np.random.default_rng(seed)
    side = 1 << (depth - 1)
    cells = rng.choice(side ** 3, 32, replace=False)
    parents = np.stack(np.unravel_index(cells, (side,) * 3), 1)
    pts = []
    for par in parents:
        kids = rng.choice(8, rng.integers(1, 9), replace=False)
        for k in kids:
            pts.append(2 * par + [(k >> 2) & 1, (k >> 1) & 1, k & 1])
    pos = np.unique(np.array(pts), axis=0)
    codes = np.sort(tmorton.encode(pos))
    vals = rng.integers(0, 256, (codes.size, nchan)).astype(np.int64)
    return codes, vals


def _deep_cloud(depth, nchan, n, seed=12):
    rng = np.random.default_rng(seed)
    pos = np.unique(rng.integers(0, 1 << depth, (n, 3)), axis=0)
    codes = np.sort(tmorton.encode(pos))
    vals = rng.integers(0, 256, (codes.size, nchan)).astype(np.int64)
    return codes, vals


REDESIGN_CLOUDS = {
    "d1": lambda c: (np.arange(8, dtype=np.int64)[[0, 2, 3, 7]],
                     np.arange(4 * c).reshape(4, c).astype(np.int64) * 37),
    "d3": lambda c: _deep_cloud(3, c, 90),
    "d3_one_warp": lambda c: _one_warp_cloud(3, c),
    "d10": lambda c: _deep_cloud(10, c, 400),
}
REDESIGN_DEPTH = {"d1": 1, "d3": 3, "d3_one_warp": 3, "d10": 10}


# the group kernel's channel counts: one, the colours, and more than its
# window (tfp.GROUP_WINDOW) of 4
REDESIGN_STEPS = STEPS + [11000, 21000]


@pytest.mark.parametrize("nchan", [1, 3, 5])
@pytest.mark.parametrize("name", list(REDESIGN_CLOUDS))
def test_group_mirror_tiles_match_plain_and_jax(name, nchan):
    """``group_mirror`` (the kernel's tiles, gather, prologue and fast
    divisions; at 5 channels two windows, the second gathering its means
    again) driven through ``DeviceFpRaht``'s card loop at the kernel's
    tile and at a ragged 7-block tile: the same q rows, reconstruction
    and decode as the plain loop and as the JAX package's
    ``DeviceFpRaht`` (its jitted ``_enc_group``/``_dec_group``)."""
    import functools

    codes, vals = REDESIGN_CLOUDS[name](nchan)
    depth = REDESIGN_DEPTH[name]
    steps = REDESIGN_STEPS[:nchan]
    assert (nchan > tfp.GROUP_WINDOW) == (nchan == 5)
    dv = tfp.DeviceFpRaht(codes, depth, steps, device="cpu")
    if name == "d3_one_warp":
        assert dv.plans[0]["az"].shape[0] == 32
    qs = []
    recon = dv._encode_plain(torch.as_tensor(vals), qs.append)
    jq = []
    jdv = jfp.DeviceFpRaht(codes, depth, steps)
    jrecon = jdv.encode(vals, jq.append)
    assert np.array_equal(np.asarray(jrecon), recon.numpy())
    assert all(np.array_equal(np.asarray(a), b) for a, b in zip(jq, qs))
    rows = torch.as_tensor(np.concatenate(qs).astype(np.int64))
    it = iter(np.asarray(q) for q in jq)
    jdec = np.asarray(jdv.decode(lambda m: next(it), nchan))
    cuts = dv.rows.slices()
    for tile in (tfp.GROUP_TILE, 7):
        launchers = (tfp.truth_level_mirror,
                     functools.partial(tfp.group_mirror, tile=tile))
        recon_k, qbuf = dv._encode_kernels(torch.as_tensor(vals), launchers)
        assert torch.equal(recon_k, recon)
        assert all(np.array_equal(qbuf[c].numpy(), q)
                   for c, q in zip(cuts, qs))
        dec = dv._decode_kernels(rows, launchers)
        assert np.array_equal(dec.numpy(), jdec)


def test_group_mirror_counts_general_divisions_on_extreme_values():
    """A group called alone on parents' reconstructions of +-2^62 (their
    means wrap) takes the general path and still equals ``_enc_group_ref``
    and ``_dec_group_ref``; ordinary values take only the fast path."""
    _, _, (_, enc, dec), _ = _case(("n2000", 3))
    args, kw, _ = enc[2]
    rng = np.random.default_rng(2)
    big = args[0].clone()
    big[::5] = torch.as_tensor(rng.integers(-(1 << 62), 1 << 62,
                                            big[::5].shape))
    for recon, general in ((args[0], False), (big, True)):
        a = (recon,) + tuple(args[1:])
        p = a[6]
        mp, mc, counts = tfp._group_shapes(p)
        c = a[5].shape[0]
        q = [torch.empty(n, c, dtype=torch.int64) for n in counts]
        recon_c = torch.empty(mc, c, dtype=torch.int64)
        cnt = torch.empty(mc, dtype=torch.int64)
        stats = torch.zeros(2, dtype=torch.int64)
        tfp.group_mirror(p, rp.row_offsets(p), mp, tfp.MODE_HAVE_GRAND,
                         a[0], None, a[1], a[5], list(a[2:5]), None, q, None,
                         recon_c, None, cnt, kw["t0"], kw["weights"], stats)
        want = tfp._enc_group_ref(*a, **kw)
        assert all(torch.equal(x, y) for x, y in zip((*q, recon_c, cnt),
                                                     want))
        assert int(stats[0]) > 0
        assert (int(stats[1]) > 0) == general
        dq = tfp._dec_group_ref(recon, a[1], *want[:3], a[5], p, **kw)
        recon_d = torch.empty(mc, c, dtype=torch.int64)
        tfp.group_mirror(p, rp.row_offsets(p), mp,
                         tfp.MODE_DECODE | tfp.MODE_HAVE_GRAND, recon, None,
                         a[1], a[5], list(want[:3]), None, [None] * 3, None,
                         recon_d, None, cnt, kw["t0"], kw["weights"])
        assert torch.equal(recon_d, dq[0])


# rows a round: the kernel's, one warp's, and one that no level's rows
# fill evenly
EXPAND_ROUNDS = [tops.EXPAND_ROUND, 32, 96]


@pytest.mark.parametrize("threads", EXPAND_ROUNDS,
                         ids=["kernel", "one_warp", "ragged"])
@pytest.mark.parametrize("depth", [1, 3, 10])
def test_expand_stream_mirror_matches_ref_and_jax(depth, threads):
    """The expansion's walk (counting pass, rounds of one row a lane,
    ping-pong buffers that start unwritten, padding only at the last
    level) against ``decode_expand_stream_ref`` and the JAX
    ``decode_expand_stream``, with nmax the leaf count exactly and with
    room to spare: codes, count, and the padding rows."""
    n = {1: 6, 3: 60, 10: 1500}[depth]
    codes, occ, counts = _stream(depth, n=n, seed=depth)
    for nmax in (codes.size, codes.size + 37):
        got = tops.expand_stream_mirror(occ, counts, depth, nmax,
                                        threads=threads)
        want = tops.decode_expand_stream_ref(occ, counts, depth, nmax)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        jcodes, jcnt = jops.decode_expand_stream(
            jnp.asarray(occ.numpy()), jnp.asarray(counts.numpy()), depth,
            nmax)
        assert np.array_equal(got[0].numpy(), np.asarray(jcodes))
        assert int(got[1]) == int(jcnt) == codes.size
        assert np.array_equal(got[0][:codes.size].numpy(), codes)
        assert bool((got[0][codes.size:] == tops.I64_MAX).all())


def test_expand_stream_mirror_one_node_first_levels():
    """A stream whose first levels hold one node each (every point in
    one small corner), nmax filled exactly."""
    rng = np.random.default_rng(4)
    pos = np.unique(rng.integers(0, 4, (40, 3)), axis=0)
    codes = np.sort(tmorton.encode(pos))
    depth = 8
    occ, counts = tops.encode_occ_u8_ref(torch.as_tensor(codes), depth,
                                         depth * codes.size + 64)
    assert counts[:6].tolist() == [1] * 6
    got = tops.expand_stream_mirror(occ, counts, depth, codes.size,
                                    threads=32)
    want = tops.decode_expand_stream_ref(occ, counts, depth, codes.size)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("threads", EXPAND_ROUNDS,
                         ids=["kernel", "one_warp", "ragged"])
def test_expand_level_mirror_pads_and_sources(threads):
    """``expand_level_mirror`` at the kernel's tile, one warp a round and
    a ragged tile: each level's codes, count and source rows equal
    ``_expand_level_ref``'s, the rows past the count INT64_MAX with
    source row nmax - 1, and the JAX ``_expand_level``'s codes."""
    codes, occ, counts = _stream(7, n=900, seed=5)
    nmax = codes.size + 5
    levels, _ = _level_inputs(occ, counts, 7, nmax)
    for nodes, o in levels:
        got = tops.expand_level_mirror(nodes, o, nmax, threads=threads)
        want = tops._expand_level_ref(nodes, o, nmax)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        total = int(got[1])
        if total < nmax:
            assert bool((got[0][total:] == tops.I64_MAX).all())
            assert bool((got[2][total:] == nmax - 1).all())
        jout, _ = jops._expand_level(jnp.asarray(nodes.numpy()),
                                     jnp.asarray(o.numpy()), nmax)
        assert np.array_equal(got[0].numpy(), np.asarray(jout))

