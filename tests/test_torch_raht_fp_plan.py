"""The RAHT planner (``ops/raht_plan.py``: ``build_plan``, its kernels in
``csrc/raht_fp_plan.cu`` and its plain version ``build_plan_ref``) held
to the host spec, ``plans_to_torch(build_fp_plan(...))`` with
``row_offsets``, tensor for tensor with zero difference; its coded-order
rows held to what both closed loops emit; and ``DeviceFpRaht``'s choice
of planner: the kernels on a CUDA device, the host spec elsewhere.

On the CPU the spec is the JAX package's host numpy ``build_fp_plan``
(``mpeg_pcc_tmc13_tpu/ops/raht_fp_device.py``, which loads no jax),
so every case also holds the port's copy of it.  The tests marked
``cuda`` run where the JAX package is not installed, and take the
port's copy; they skip themselves without a card.  On the card run
``python -m pytest tests/test_torch_raht_fp_plan.py -m cuda``."""

import numpy as np
import pytest
import torch

from mpeg_pcc_tmc13_tpu_torch.ops import _kernels
from mpeg_pcc_tmc13_tpu_torch.ops import raht_float_device as rfd
from mpeg_pcc_tmc13_tpu_torch.ops import raht_fp_device as fpd
from mpeg_pcc_tmc13_tpu_torch.ops import raht_plan as rp
from mpeg_pcc_tmc13_tpu_torch.scripts.gen_clouds import make_lidar_frame
from mpeg_pcc_tmc13_tpu_torch.utils import morton

torch.set_num_threads(2)


def _codes(pos):
    return np.unique(morton.encode(np.asarray(pos, dtype=np.int64)))


def _grid(*axes):
    return np.array(np.meshgrid(*axes, indexing="ij")).reshape(3, -1).T


def _body_patch():
    """A closed surface one voxel thick in a 10-bit cube: a sphere shell
    of radius 24 (~7,200 points, ~3.6 a parent node)."""
    g = _grid(*[np.arange(-26, 27)] * 3)
    r = np.sqrt((g ** 2).sum(axis=1))
    return _codes(g[np.abs(r - 24) < 0.5] + [512, 300, 700]), 10


def _lidar():
    """An 18-level spinning-scanner frame (8 lasers): sparse, with chains
    of one-child nodes."""
    pos, _ = make_lidar_frame(0, n_lasers=8, steps=256)
    return _codes(pos), 18


def _edges(depth):
    """Every coordinate in {0, 1, 2^d - 2, 2^d - 1}: neighbour steps that
    carry out of the level and steps off the low edge."""
    top = (1 << depth) - 1
    vals = sorted({0, 1, top - 1, top})
    return _codes(_grid(vals, vals, vals)), depth


def _depth21():
    """Depth 21 (60 code bits at the first parent level): both corners of
    the grid dense, the rest scattered."""
    rng = np.random.default_rng(21)
    top = (1 << 21) - 1
    pos = np.concatenate([rng.integers(0, 6, (150, 3)),
                          top - rng.integers(0, 6, (150, 3)),
                          rng.integers(0, 1 << 21, (200, 3))])
    return _codes(pos), 21


CASES = {
    "body_patch": _body_patch,
    "lidar_18": _lidar,
    "single_point": lambda: (_codes([[1023, 0, 511]]), 10),
    "depth_1": lambda: (np.array([1, 2, 5], dtype=np.int64), 1),
    "full_block": lambda: (np.arange(8, dtype=np.int64), 1),
    "full_block_depth_4": lambda: (_codes(_grid([6, 7], [0, 1], [14, 15])),
                                   4),
    "edges_2": lambda: _edges(2),
    "edges_5": lambda: _edges(5),
    "edges_9": lambda: _edges(9),
    "depth_21": _depth21,
    "empty": lambda: (np.zeros(0, dtype=np.int64), 6),
    "depth_0": lambda: (np.array([3, 9, 40], dtype=np.int64), 0),
}

UNSORTED = {
    "repeated": np.array([1, 5, 5, 9], dtype=np.int64),
    "descending": np.array([1, 9, 5], dtype=np.int64),
    "negative": np.array([-8, 1, 2], dtype=np.int64),
}


def _jax_planner():
    from mpeg_pcc_tmc13_tpu.ops import raht_fp_device as jfp
    return jfp.build_fp_plan


def _spec(codes, depth, device="cpu", planner=None):
    """The host planner's plan as ``DeviceFpRaht`` held it before:
    ``planner`` (default: the port's ``build_fp_plan``), then
    ``plans_to_torch`` and ``row_offsets``."""
    host = (planner or fpd.build_fp_plan)(codes, depth)
    plans = fpd.plans_to_torch(host, device)
    return rp.FramePlan(
        plans, [rp.row_offsets(p) for p in plans],
        [(hp.flat_z.size, hp.flat_y.size, hp.flat_x.size) for hp in host],
        host[-1].mp if host else codes.shape[0])


def _assert_same(got, want):
    assert got.n_roots == want.n_roots
    assert got.pair_counts == want.pair_counts
    assert len(got.plans) == len(want.plans) == len(got.offsets)
    for g, (a, b) in enumerate(zip(got.plans, want.plans)):
        assert a.keys() == b.keys()
        for k in b:
            x, y = a[k].cpu(), b[k]
            assert (x.dtype, x.shape) == (y.dtype, y.shape), (g, k)
            assert torch.equal(x, y), f"level {g}: {k} differs"
        for k, x, y in zip(("off_z", "off_y", "off_x"), got.offsets[g],
                           want.offsets[g]):
            assert x.dtype == y.dtype and torch.equal(x.cpu(), y), (g, k)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_planner_equals_host_spec(case):
    codes, depth = CASES[case]()
    want = _spec(codes, depth, planner=_jax_planner())
    _assert_same(rp.build_plan(torch.as_tensor(codes), depth), want)
    _assert_same(_spec(codes, depth), want)


@pytest.mark.parametrize("case", sorted(UNSORTED))
def test_plain_planner_refuses_unsorted_codes(case):
    with pytest.raises(ValueError, match="increasing"):
        rp.build_plan(torch.as_tensor(UNSORTED[case]), 5)


def test_device_fp_raht_off_the_card_keeps_the_host_planner(monkeypatch):
    codes, depth = _body_patch()

    def refuse(*a, **k):
        raise AssertionError("the card planner ran off the card")
    monkeypatch.setattr(rp, "build_plan", refuse)
    dv = fpd.DeviceFpRaht(codes, depth, [1 << 16] * 3, device="cpu")
    _assert_same(rp.FramePlan(dv.plans, dv.offsets, dv.pair_counts,
                              dv.n_roots),
                 _spec(codes, depth, planner=_jax_planner()))


@pytest.mark.parametrize("case", sorted(CASES))
def test_coded_rows_match_both_loops(case):
    """``FramePlan.coded_rows``: the root's rows, then each level's z, y,
    x rows, coarsest first, are the row counts the fixed-point loop
    emits and the float loop hands its quantiser, on one cloud."""
    codes, depth = CASES[case]()
    rows = rp.build_plan(torch.as_tensor(codes), depth).coded_rows()
    want = [s.stop - s.start for s in rows.slices()]
    assert rows.total == sum(want) and rows.root == slice(0, want[0])
    assert len(rows.levels) == depth
    assert [s.start for s in rows.slices()[1:]] == \
        [s.stop for s in rows.slices()[:-1]]
    vals = (np.arange(codes.size * 3).reshape(-1, 3) * 37) % 256
    fixed = []
    fpd.DeviceFpRaht(codes, depth, [1 << 16] * 3, device="cpu").encode(
        vals, lambda q: fixed.append(q.shape[0]))
    assert fixed == want
    if depth and codes.size:  # the float loop codes no empty brick
        floats = []

        def quant(res, tag):
            floats.append(res.shape[0])
            return np.round(res)
        rfd.encode(codes, vals, depth, quant, lambda q, tag: q, (2, 6),
                   (9, 3, 1), torch.device("cpu"))
        assert floats == want


def test_chip_smoke_plan_check_rehearses_on_the_cpu(monkeypatch):
    """``chip_smoke.py``'s check of the planner at the bench size, on a
    small cloud: 0 when the plan equals both references, a failure when
    one tensor of one level differs."""
    import chip_smoke
    codes, depth = _body_patch()
    t = torch.as_tensor(codes)
    assert chip_smoke._plan_checks(t, codes, depth) == 0.0
    plain = rp.build_plan

    def off_by_one(c, d):
        plan = plain(c, d)
        plan.plans[3]["sw_p"] = plan.plans[3]["sw_p"] + 1
        return plan
    monkeypatch.setattr(rp, "build_plan", off_by_one)
    with pytest.raises(AssertionError, match="raht_fp_plan differs"):
        chip_smoke._plan_checks(t, codes, depth)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the planner's kernels have no CPU "
                    "form")
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_card_planner_equals_host_spec(case):
    dev = _card()
    codes, depth = CASES[case]()
    _kernels.reset_launch_counts()
    got = rp.build_plan(torch.as_tensor(codes, device=dev), depth)
    _assert_same(got, _spec(codes, depth))
    launched = 3 if depth and codes.size else 0
    assert _kernels.LAUNCHES["raht_fp_plan"] == launched
    for p, offs in zip(got.plans, got.offsets):
        assert all(t.device == dev and t.is_contiguous()
                   and t.data_ptr() % 16 == 0
                   for t in list(p.values()) + list(offs))


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(UNSORTED))
def test_card_planner_refuses_unsorted_codes(case):
    dev = _card()
    with pytest.raises(ValueError, match="increasing"):
        rp.build_plan(torch.as_tensor(UNSORTED[case], device=dev), 5)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["body_patch", "lidar_18", "depth_21"])
def test_card_round_trip_equals_the_host_planners(case, monkeypatch):
    """``DeviceFpRaht`` on the card plans only through the kernels (no
    ``build_fp_plan``), and its q rows, reconstruction and decoded values
    equal those of a CPU instance, which plans on the host."""
    dev = _card()
    codes, depth = CASES[case]()
    rng = np.random.default_rng(depth)
    vals = rng.integers(0, 256, (codes.size, 3))
    steps = [3 << 16, 5 << 16, 9 << 16]
    cpu = fpd.DeviceFpRaht(codes, depth, steps, device="cpu")
    want_q = []
    want_rec = cpu.encode(vals, want_q.append)
    it = iter(want_q)
    want_dec = cpu.decode(lambda m: next(it), 3)

    def refuse(*a, **k):
        raise AssertionError("build_fp_plan ran for a card")
    monkeypatch.setattr(fpd, "build_fp_plan", refuse)
    _kernels.reset_launch_counts()
    card = fpd.DeviceFpRaht(codes, depth, steps, device=dev)
    assert _kernels.LAUNCHES["raht_fp_plan"] == 3
    got_q = []
    got_rec = card.encode(vals, got_q.append)
    assert len(got_q) == len(want_q)
    assert all(np.array_equal(a, b) for a, b in zip(got_q, want_q))
    assert torch.equal(got_rec.cpu(), want_rec)
    it = iter(want_q)
    assert torch.equal(card.decode(lambda m: next(it), 3).cpu(), want_dec)
