"""The QT/BT octree decode's level walk on a torch device
(``models/geometry_octree.py`` ``decode_qtbt_card``, the kernel
``octree_neigh_ctx`` of ``csrc/octree_ctx.cu`` with its plain version
``ops/octree.py`` ``octree_neigh_ctx_ref``, and the padded level it
hands ``ops/octree.py`` ``_expand_level``) held bit for bit to the JAX
package (the reference: its ``decode_qtbt_np`` on its own range decoder
and contexts, its ``occ_context_base_np``, ``_level_base_np`` and
``expand_level_np``) and to the port's host walker and numpy bases.

On the CPU the walk runs the plain versions on CPU tensors.  The tests
marked ``cuda`` run the kernels and skip themselves without a card; on
the card run ``python -m pytest --noconftest -m cuda
tests/test_torch_geometry_card_decode.py``.  They hold the kernels to
the plain versions and the port's host walker, and call nothing of the
JAX package."""

import numpy as np
import pytest
import torch

from mpeg_pcc_tmc13_tpu.bitstream import entropy as jentropy
from mpeg_pcc_tmc13_tpu.models import geometry_octree as jgo
from mpeg_pcc_tmc13_tpu.ops import octree as jops
from mpeg_pcc_tmc13_tpu_torch.bitstream import entropy
from mpeg_pcc_tmc13_tpu_torch.models import geometry_octree as go
from mpeg_pcc_tmc13_tpu_torch.ops import _kernels
from mpeg_pcc_tmc13_tpu_torch.ops import octree as ops
from mpeg_pcc_tmc13_tpu_torch.utils import morton, timing

torch.set_num_threads(2)

MODES = {"neigh": ops.CTX_MODE_NEIGH, "parent": ops.CTX_MODE_PARENT}


def _level_nodes(level, seed, n=3000):
    """Sorted unique node codes of a level: uniform nodes, a dense box at
    the low corner and one at the high corner (so faces at 0 and
    2^level - 1 and many present neighbours), and nodes on each face."""
    rng = np.random.default_rng(seed)
    hi = (1 << level) - 1
    parts = [rng.integers(0, hi + 1, (n, 3))]
    for corner in (0, hi):
        box = rng.integers(0, min(6, hi + 1), (n, 3))
        parts.append(box if corner == 0 else hi - box)
    for a in range(3):
        face = rng.integers(0, hi + 1, (n // 4, 3))
        face[: n // 8, a] = 0
        face[n // 8:, a] = hi
        parts.append(face)
    pos = np.concatenate(parts).astype(np.int64)
    return np.unique(morton.encode(pos))


@pytest.mark.parametrize("level", range(22))
def test_neigh_bases_equal_the_numpy_bases(level):
    codes = _level_nodes(level, seed=level)
    want = jops.occ_context_base_np(codes, level)
    np.testing.assert_array_equal(ops.occ_context_base_np(codes, level),
                                  want)
    t = torch.as_tensor(codes)
    for fn in (ops.octree_neigh_ctx_ref, ops.octree_neigh_ctx):
        got = fn(t, level, ops.CTX_MODE_NEIGH)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def _parent_level(level, seed):
    """(parent codes at level - 1, their occupancy bytes, the level's
    nodes, each node's parent row)."""
    rng = np.random.default_rng(seed)
    parents = _level_nodes(level - 1, seed) if level else np.zeros(1, np.int64)
    occ = rng.integers(1, 256, parents.size).astype(np.uint8)
    nodes = ops.expand_level_np(parents, occ)
    src = np.repeat(np.arange(parents.size), ops.popcount8_np(occ))
    return parents, occ, nodes, src


@pytest.mark.parametrize("level", [1, 2, 5, 10, 21])
def test_parent_bases_equal_the_numpy_bases(level):
    _, occ, nodes, src = _parent_level(level, seed=100 + level)
    parent_occ = np.repeat(occ.astype(np.int32), ops.popcount8_np(occ))
    want = jgo._level_base_np(nodes, parent_occ, level, ops.CTX_MODE_PARENT)
    np.testing.assert_array_equal(
        go._level_base_np(nodes, parent_occ, level, ops.CTX_MODE_PARENT),
        want)
    got = ops.octree_neigh_ctx(torch.as_tensor(nodes), level,
                               ops.CTX_MODE_PARENT, torch.as_tensor(occ),
                               torch.as_tensor(src))
    np.testing.assert_array_equal(got.numpy(), want)


def test_parent_bases_at_the_root_read_no_parent():
    root = torch.zeros(1, dtype=torch.int64)
    got = ops.octree_neigh_ctx(root, 0, ops.CTX_MODE_PARENT)
    for pkg in (jgo, go):
        want = pkg._level_base_np(np.zeros(1, np.int64),
                                  np.zeros(1, np.int32), 0,
                                  ops.CTX_MODE_PARENT)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("level", [0, 3, 12])
def test_padded_level_expands_as_expand_level_np(level):
    """The walk's expansion: a level's n nodes and bytes padded to its
    child count (nodes with INT64_MAX, bytes with 0) give the children
    and their parent rows, no more."""
    parents, occ, nodes, src = _parent_level(level + 1, seed=level)
    n, m = parents.size, nodes.size
    padded = torch.full((m,), ops.I64_MAX, dtype=torch.int64)
    padded[:n] = torch.as_tensor(parents)
    occ_p = torch.zeros(m, dtype=torch.uint8)
    occ_p[:n] = torch.as_tensor(occ)
    out, cnt, rows = ops._expand_level(padded, occ_p, m)
    np.testing.assert_array_equal(jops.expand_level_np(parents, occ), nodes)
    np.testing.assert_array_equal(out.numpy(), nodes)
    np.testing.assert_array_equal(rows.numpy(), src)
    assert int(cnt) == m


def _flat(n, seed=18):
    rng = np.random.default_rng(seed)
    return np.column_stack([rng.integers(0, 256, n), rng.integers(0, 256, n),
                            rng.integers(0, 8, n)]).astype(np.int64)


def _slab(n, seed=5):
    """A surface-like slab 9 voxels deep on y in an 8-level box."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 200, n)
    z = rng.integers(0, 256, n)
    y = (4 + 4 * np.sin(x / 17.0)).astype(np.int64)
    return np.column_stack([x, y, z]).astype(np.int64)


# (positions, depth, axis_bits): two forced axes, one forced axis, and
# forced axes of different lengths
TREES = {
    "flat_z3": (lambda: _flat(3000), 8, (8, 8, 3)),
    "slab_y4": (lambda: _slab(4000), 8, (8, 4, 8)),
    "thin_x2_z5": (lambda: _flat(2500, 3) % np.array([4, 256, 32]), 8,
                   (2, 8, 5)),
}


def _stream(tree, mode, bytewise):
    make, depth, axis_bits = TREES[tree]
    uniq = np.unique(morton.encode(make()))
    enc = entropy.RangeEncoder()
    go.encode_qtbt_np(uniq, depth, enc, go.OctreeContexts(), mode,
                      axis_bits, bytewise=bytewise)
    return uniq, depth, axis_bits, enc.get_bytes()


def _walk(walk, ent, ctxs, stream, depth, mode, axis_bits, **kw):
    """One walk of a stream with fresh contexts: (nodes, levels, the
    decoder's next 16 bits, the final occupancy and planar contexts)."""
    ctx = ctxs()
    dec = ent.RangeDecoder(stream)
    nodes, lvl = walk(depth, dec, ctx, mode, axis_bits, **kw)
    tail = dec.bits(ctx.planar, np.zeros(16, dtype=np.int32))
    return (nodes, lvl, tail, ctx.occupancy_sym.copy(),
            ctx.occupancy.copy(), ctx.planar_occ.copy())


def _both(stream, depth, mode, axis_bits, device="cpu", **kw):
    """(host walk, card walk) of one stream; on the CPU the JAX
    package's walk of the same bytes must end as the card walk does."""
    args = (stream, depth, mode, axis_bits)
    host = _walk(go.decode_qtbt_np, entropy, go.OctreeContexts, *args, **kw)
    card = _walk(go.decode_qtbt_card, entropy, go.OctreeContexts, *args,
                 device=device, **kw)
    if torch.device(device).type == "cpu":
        ref = _walk(jgo.decode_qtbt_np, jentropy, jgo.OctreeContexts,
                    *args, **kw)
        _assert_same(ref, card)
    return host, card


def _assert_same(host, card):
    (hn, hl, *hrest), (cn, cl, *crest) = host, card
    assert cn.dtype == np.int64 and cl == hl
    np.testing.assert_array_equal(cn, hn)
    for a, b in zip(hrest, crest):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("bytewise", [True, False], ids=["sym", "binary"])
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("tree", sorted(TREES))
def test_card_walk_equals_the_host_walk(tree, mode, bytewise):
    uniq, depth, axis_bits, stream = _stream(tree, MODES[mode], bytewise)
    host, card = _both(stream, depth, MODES[mode], axis_bits,
                       bytewise=bytewise)
    _assert_same(host, card)
    np.testing.assert_array_equal(card[0], uniq)


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("cut", [{"stop_at": 0}, {"stop_at": 1},
                                 {"stop_at": 5}, {"max_points": 1},
                                 {"max_points": 200},
                                 {"stop_at": 6, "max_points": 900}],
                         ids=["stop0", "stop1", "stop5", "max1", "max200",
                              "stop6_max900"])
def test_card_walk_truncates_as_the_host_walk(mode, cut):
    _, depth, axis_bits, stream = _stream("slab_y4", MODES[mode], True)
    host, card = _both(stream, depth, MODES[mode], axis_bits, **cut)
    _assert_same(host, card)
    assert card[1] < depth


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("where", [0.1, 0.5, 0.9])
def test_a_damaged_stream_decodes_as_on_the_host(mode, where):
    make = lambda: _flat(400, 11) % np.array([64, 64, 8])  # noqa: E731
    uniq = np.unique(morton.encode(make()))
    enc = entropy.RangeEncoder()
    go.encode_qtbt_np(uniq, 6, enc, go.OctreeContexts(), MODES[mode],
                      (6, 6, 3))
    stream = bytearray(enc.get_bytes())
    at = int(where * len(stream))
    stream[at:at + 3] = bytes(b ^ 0xA5 for b in stream[at:at + 3])
    host, card = _both(bytes(stream), 6, MODES[mode], (6, 6, 3))
    _assert_same(host, card)


@pytest.mark.parametrize("unique_points", [True, False])
def test_decode_walks_qtbt_bricks_on_the_given_device(unique_points,
                                                      monkeypatch):
    """``decode`` takes the card walk when it is given a device, the host
    walk without one, and both give the same positions; a CPU device
    counts no card level."""
    pos = np.unique(_slab(3000), axis=0)
    if not unique_points:
        pos = np.concatenate([pos, pos[:700]])
    kw = dict(ctx_mode=ops.CTX_MODE_NEIGH, axis_bits=(8, 4, 8),
              unique_points=unique_points, engine="numpy")
    enc = entropy.RangeEncoder()
    go.encode(pos, 8, enc, go.OctreeContexts(), **kw)
    stream = enc.get_bytes()
    walks = []
    for name in ("decode_qtbt_np", "decode_qtbt_card"):
        fn = getattr(go, name)
        monkeypatch.setattr(go, name, lambda *a, fn=fn, name=name, **k:
                            walks.append(name) or fn(*a, **k))

    class Sink:
        spans, counters = {}, {}
    got = []
    with timing.tracing(Sink, "decode"):
        for device in (None, "cpu"):
            got.append(go.decode(pos.shape[0], 8,
                                 entropy.RangeDecoder(stream),
                                 go.OctreeContexts(), device=device, **kw))
    assert walks == ["decode_qtbt_np", "decode_qtbt_card"]
    np.testing.assert_array_equal(got[1], got[0])
    assert got[0].shape == (pos.shape[0], 3)
    assert "decode.geom.card_levels" not in Sink.counters


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: octree_neigh_ctx has no CPU form")
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("level", [0, 1, 4, 10, 21])
def test_kernel_equals_its_plain_version(level):
    dev = _card()
    codes = torch.as_tensor(_level_nodes(level, seed=level), device=dev)
    _kernels.reset_launch_counts()
    got = ops.octree_neigh_ctx(codes, level, ops.CTX_MODE_NEIGH)
    want = ops.octree_neigh_ctx_ref(codes, level, ops.CTX_MODE_NEIGH)
    assert torch.equal(got, want)
    _, occ, nodes, src = _parent_level(max(level, 1), seed=level)
    t = [torch.as_tensor(x, device=dev) for x in (nodes, occ, src)]
    got = ops.octree_neigh_ctx(t[0], max(level, 1), ops.CTX_MODE_PARENT,
                               t[1], t[2])
    want = ops.octree_neigh_ctx_ref(t[0], max(level, 1),
                                    ops.CTX_MODE_PARENT, t[1], t[2])
    assert torch.equal(got, want)
    assert _kernels.LAUNCHES["octree_neigh_ctx"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("tree", sorted(TREES))
def test_card_walk_on_the_card_equals_the_host_walk(tree, mode):
    dev = _card()
    uniq, depth, axis_bits, stream = _stream(tree, MODES[mode], True)
    _kernels.reset_launch_counts()

    class Sink:
        spans, counters = {}, {}
    with timing.tracing(Sink):
        host, card = _both(stream, depth, MODES[mode], axis_bits,
                           device=dev)
    _assert_same(host, card)
    free = sum(all(l >= depth - b for b in axis_bits) for l in range(depth))
    assert _kernels.LAUNCHES["octree_neigh_ctx"] == free
    assert Sink.counters["geom.card_levels"] == free
    assert _kernels.LAUNCHES["octree_expand"] == 2 * depth
