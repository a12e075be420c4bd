"""Port parity: the multi-device layer (mpeg_pcc_tmc13_tpu_torch.parallel)
against the JAX package's parallel/ on the same numpy inputs.

The JAX side runs on the conftest's virtual CPU devices
(``make_mesh(n, backend="cpu")``), the port on a mesh of n host entries
(``make_mesh(n, backend="cpu")``), where every kernel wrapper runs its
plain version.  Tolerance 0 (integers, payload bytes) everywhere but B1's
float coefficients: 1e-5 * max(1, max|ref|), with mask and weights exact,
as tests/test_torch_raht_blocks.py states.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mpeg_pcc_tmc13_tpu.bitstream import entropy as jentropy
from mpeg_pcc_tmc13_tpu.models import geometry_octree as jgo
from mpeg_pcc_tmc13_tpu.ops import octree as jops
from mpeg_pcc_tmc13_tpu.ops import raht_fp as jraht_fp
from mpeg_pcc_tmc13_tpu.ops import raht_fp_device as jfpd
from mpeg_pcc_tmc13_tpu.parallel import frame as jframe
from mpeg_pcc_tmc13_tpu.parallel import slices as jpar
from mpeg_pcc_tmc13_tpu_torch.ops import octree as tops
from mpeg_pcc_tmc13_tpu_torch.ops import raht_fp_device as tfpd
from mpeg_pcc_tmc13_tpu_torch.ops import raht_plan
from mpeg_pcc_tmc13_tpu_torch.parallel import frame as tframe
from mpeg_pcc_tmc13_tpu_torch.parallel import slices as tpar
from mpeg_pcc_tmc13_tpu_torch.parallel.dryrun import dryrun_multichip
from mpeg_pcc_tmc13_tpu_torch.utils import morton

torch.set_num_threads(2)

RTOL = 1e-5
I64_MAX = np.iinfo(np.int64).max


def _codes(n, depth, seed):
    rng = np.random.default_rng(seed)
    pos = rng.integers(0, 1 << depth, size=(n, 3), dtype=np.int64)
    return np.unique(morton.encode(pos))


def _meshes(n):
    return (jpar.make_mesh(n, backend="cpu"),
            tpar.make_mesh(n, backend="cpu"))


def test_make_mesh_on_the_host():
    mesh = tpar.make_mesh(3, backend="cpu")
    assert mesh.size == 3 and mesh.axis == "slices"
    assert mesh.devices == (torch.device("cpu"),) * 3
    assert tframe.devices_for(2, backend="cpu") == [torch.device("cpu")] * 2


@pytest.mark.parametrize("n,n_slices", [(300, 4), (301, 3), (3, 5)])
def test_partition_codes_padded(n, n_slices):
    """Equal to the reference's, including S > n, where the reference
    pads its empty chunks with the last code."""
    codes = _codes(n, 6, seed=n)
    want = jpar.partition_codes_padded(codes, n_slices)
    got = tpar.partition_codes_padded(codes, n_slices)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("n_dev,n_slices", [(2, 4), (4, 4), (1, 3)])
def test_sharded_encode_analysis(n_dev, n_slices):
    depth = 6
    blocks = jpar.partition_codes_padded(_codes(400, depth, seed=2),
                                         n_slices)
    jmesh, tmesh = _meshes(n_dev)
    jres, jhist = jpar.sharded_encode_analysis(blocks, depth, jmesh)
    tres, thist = tpar.sharded_encode_analysis(blocks, depth, tmesh)
    assert len(tres["occ"]) == n_dev
    got = tpar.gather(tres)
    for k in tpar.ANALYSIS_KEYS:
        want = np.asarray(jres[k])
        assert got[k].shape == want.shape and np.array_equal(got[k], want), k
    assert thist.dtype == torch.int32
    assert np.array_equal(thist.numpy(), np.asarray(jhist))
    # the histogram is the host sum of the masked bases
    m = got["node_mask"]
    host = np.bincount(got["ctx_base"][m], minlength=tops.NUM_OCC_BASES)
    assert np.array_equal(thist.numpy(), host)


def _inter_inputs(depth, n_slices, seed):
    cur = _codes(500, depth, seed=seed)
    ref = _codes(500, depth, seed=seed + 1)
    blocks = jpar.partition_codes_padded(cur, n_slices)
    m = 512
    refs = np.full((n_slices, m), I64_MAX, dtype=np.int64)
    counts = np.zeros(n_slices, dtype=np.int32)
    for s in range(n_slices):
        lo, hi = blocks[s].min(), blocks[s].max()
        rs = ref[(ref >= lo) & (ref <= hi)]
        refs[s, :rs.size] = rs
        counts[s] = rs.size
    return blocks, refs, counts


@pytest.mark.parametrize("depth,n_dev", [(5, 2), (6, 4)])
def test_sharded_encode_analysis_inter(depth, n_dev):
    blocks, refs, counts = _inter_inputs(depth, 4, seed=depth)
    jmesh, tmesh = _meshes(n_dev)
    jres = jpar.sharded_encode_analysis_inter(
        jnp.asarray(blocks), depth, jnp.asarray(refs), jnp.asarray(counts),
        jmesh)
    got = tpar.gather(tpar.sharded_encode_analysis_inter(
        blocks, depth, refs, counts, tmesh))
    for k in tpar.ANALYSIS_KEYS:
        assert np.array_equal(got[k], np.asarray(jres[k])), k
    # and each level's bases equal the numpy spec
    for s in range(4):
        rs = refs[s, :counts[s]]
        levels = tops.build_levels_np(np.unique(blocks[s]), depth,
                                      tops.CTX_MODE_PARENT)
        for l, lvl in enumerate(levels):
            pred = tops.pred_occupancy_np(
                lvl["nodes"], np.unique(rs >> (3 * (depth - l - 1))))
            want = ((lvl["nodes"] & 7).astype(np.int32) << 8) | pred
            m = got["node_mask"][s, l]
            assert np.array_equal(got["occ"][s, l][m], lvl["occ"])
            assert np.array_equal(got["ctx_base"][s, l][m], want)


def test_isqrt64_dev():
    rng = np.random.default_rng(5)
    r = rng.integers(1, 1 << 15, 400)
    x = np.concatenate([[0, 1, 2, 3], r * r, r * r - 1, r * r + 1,
                        rng.integers(0, 1 << 31, 2000)]).astype(np.int64)
    got = raht_plan.isqrt64_dev(torch.as_tensor(x)).numpy()
    assert np.array_equal(got, np.asarray(jfpd.isqrt64_dev(jnp.asarray(x))))
    assert np.array_equal(got, jraht_fp.isqrt64(x))


def _fp_blocks(shape, seed, wmax=5):
    """int64 Q13 values and weights over every occupancy pattern (empty
    blocks, single slots, full pairs) from a seed."""
    rng = np.random.default_rng(seed)
    *lead, c = shape
    nb = int(np.prod(lead))
    pat = rng.integers(0, 256, nb)
    pat[:min(nb, 256)] = np.arange(min(nb, 256))
    occ = ((pat[:, None] >> np.arange(8)) & 1).astype(bool)
    w = np.where(occ, rng.integers(1, wmax, (nb, 8)), 0).astype(np.int64)
    v = rng.integers(-1 << 20, 1 << 20, (nb, 8, c)).astype(np.int64)
    v[~occ] = 0
    return v.reshape(*lead, 8, c), w.reshape(*lead, 8)


@functools.lru_cache(maxsize=1)
def _fp_blocks_and_jax():
    """Blocks of every occupancy pattern with small weights, and with
    weights up to 2^16, and the JAX butterfly's outputs on them (one
    compile for all cases)."""
    parts = [_fp_blocks((300, 3), seed=3, wmax=5),
             _fp_blocks((257, 3), seed=4, wmax=1 << 16),
             _fp_blocks((40, 3), seed=5, wmax=3)]
    v = np.concatenate([p[0] for p in parts])
    w = np.concatenate([p[1] for p in parts])
    # jitted as the reference's mesh runs it (one compile, not one per op)
    want = jax.jit(jfpd.fwd_blocks_int)(jnp.asarray(v), jnp.asarray(w))
    return v, w, [np.asarray(r) for r in want]


@pytest.mark.parametrize("nc", [3, 1, 2])
def test_fwd_blocks_int_matches_jax(nc):
    """The port's butterfly on the first ``nc`` channels equals the JAX
    one's (channels are independent), dtypes and shapes included."""
    v, w, want = _fp_blocks_and_jax()
    nb = v.shape[0]
    got = tfpd.fwd_blocks_int(torch.as_tensor(v[..., :nc].copy()),
                              torch.as_tensor(w))
    shapes = [(nb, nc), (nb, 4, nc), (nb, 2, nc), (nb, 1, nc)]
    for g, r, shape in zip(got, want, shapes):
        assert g.dtype == torch.int64 and tuple(g.shape) == shape
        assert np.array_equal(g.numpy(), r[..., :nc])


def test_fwd_blocks_int_has_no_kernel_for_other_devices():
    """The wrapper's plain version is for CPU tensors only; a device
    that is neither the host nor CUDA has no kernel."""
    v, w = _fp_blocks((4, 3), seed=1)
    with pytest.raises(ValueError, match="no kernel"):
        tfpd.fwd_blocks_int(torch.as_tensor(v).to("meta"),
                            torch.as_tensor(w).to("meta"))


@pytest.mark.parametrize("n_dev", [2, 4])
def test_sharded_raht_fp_blocks(n_dev):
    v, w = _fp_blocks((4, 24, 3), seed=7)
    w[:, :, 0] = np.maximum(w[:, :, 0], 1)
    jmesh, tmesh = _meshes(n_dev)
    want = jpar.sharded_raht_fp_blocks(jnp.asarray(v), jnp.asarray(w), jmesh)
    got = tpar.gather(tpar.sharded_raht_fp_blocks(v, w, tmesh))
    for g, r in zip(got, want):
        assert np.array_equal(g, np.asarray(r))


@pytest.mark.parametrize("n_dev", [2, 4])
def test_sharded_raht_blocks(n_dev):
    rng = np.random.default_rng(n_dev)
    fv = rng.normal(0, 50, (4, 40, 8, 3)).astype(np.float32)
    fw = np.where(rng.random((4, 40, 8)) > 0.4,
                  rng.integers(1, 65, (4, 40, 8)), 0).astype(np.float32)
    jmesh, tmesh = _meshes(n_dev)
    jc, jw, jm = jpar.sharded_raht_blocks(jnp.asarray(fv), jnp.asarray(fw),
                                          jmesh, interpret=True)
    tc, tw, tm = tpar.gather(tpar.sharded_raht_blocks(fv, fw, tmesh))
    jc = np.asarray(jc)
    tol = RTOL * max(1.0, float(np.abs(jc).max()))
    np.testing.assert_allclose(tc, jc, rtol=0, atol=tol)
    assert np.array_equal(tw, np.asarray(jw))
    assert np.array_equal(tm, np.asarray(jm))


@pytest.mark.parametrize("n_dev,n_slices", [(2, 4), (4, 4)])
def test_sharded_slice_codec_roundtrip(n_dev, n_slices):
    depth = 6
    codes = _codes(1500, depth, seed=9)
    jmesh, tmesh = _meshes(n_dev)
    want = jpar.sharded_slice_codec_roundtrip(codes, depth, jmesh, n_slices)
    got = tpar.sharded_slice_codec_roundtrip(codes, depth, tmesh, n_slices)
    assert len(got) == n_slices and got == want


def _frame_inputs(n_slices, depth=6):
    rng = np.random.default_rng(11)
    slice_codes, slice_vals = [], []
    for s in range(n_slices):
        codes = _codes(200 + 137 * s, depth, seed=20 + s)
        slice_codes.append(codes)
        slice_vals.append(
            rng.integers(0, 256, (codes.size, 3)).astype(np.int64))
    return slice_codes, slice_vals


STEPS = [9000, 12000, 12000]


def _spec_attr_bytes(codes, vals, depth):
    """The JAX package's host fixed-point spec, zrow-coded."""
    from mpeg_pcc_tmc13_tpu.models.attributes import AttributeContexts
    aenc = jentropy.RangeEncoder()
    actx = AttributeContexts()
    jraht_fp.forward_predicted_fp(
        codes, vals, depth, lambda c, tag: STEPS[c],
        emit=lambda q, tag: aenc.zrow_residuals(actx.zrow,
                                                q.astype(np.int32)))
    return aenc.get_bytes()


@pytest.mark.parametrize("n_slices,n_dev", [(3, 2), (5, 4)])
def test_encode_frame_sharded(n_slices, n_dev):
    """Uneven slices round-robined over the devices: geometry payloads
    equal the JAX package's encode_frame_sharded's and its host engine's,
    attribute payloads the JAX package's fixed-point spec (which its own
    sharded encode equals, tests/test_parallel.py)."""
    depth = 6
    slice_codes, slice_vals = _frame_inputs(n_slices, depth)
    jgeom, _ = jframe.encode_frame_sharded(
        slice_codes, depth, jframe.devices_for(n_dev, backend="cpu"),
        num_threads=n_dev)
    geom, attr = tframe.encode_frame_sharded(
        slice_codes, depth, tframe.devices_for(n_dev, backend="cpu"),
        values=slice_vals, steps_q16=STEPS, num_threads=n_dev)
    assert geom == jgeom
    for s in range(n_slices):
        assert attr[s] == _spec_attr_bytes(slice_codes[s], slice_vals[s],
                                           depth), s
    # geometry: the host engine's PARENT-context stream
    enc = jentropy.RangeEncoder()
    jgo.encode(morton.decode(slice_codes[0]), depth, enc,
               jgo.OctreeContexts(), unique_points=True, engine="native",
               need_order=False, ctx_mode=jops.CTX_MODE_PARENT)
    assert geom[0] == enc.get_bytes()


def test_encode_frame_sharded_matches_jax_device_codec():
    """Both payloads equal the JAX package's sharded encode with its
    device fixed-point codec (one slice with values, at depth 4: its
    compiles cost seconds a slice; the other slice geometry only)."""
    depth = 4
    rng = np.random.default_rng(12)
    slice_codes = [_codes(80, depth, seed=50), _codes(60, depth, seed=51)]
    slice_vals = [rng.integers(0, 256, (slice_codes[0].size, 3)), None]
    want = jframe.encode_frame_sharded(
        slice_codes, depth, jframe.devices_for(2, backend="cpu"),
        values=slice_vals, steps_q16=STEPS, num_threads=2)
    got = tframe.encode_frame_sharded(
        slice_codes, depth, tframe.devices_for(2, backend="cpu"),
        values=slice_vals, steps_q16=STEPS, num_threads=2)
    assert got == want and got[1][1] is None


def test_encode_frame_sharded_retries_an_undersized_cap(monkeypatch):
    """A sparse slice (300 random points at depth 16: ~13 nodes a point
    against the 2.3 the first cap allows) takes the retry with a larger
    cap; the bytes still equal the JAX package's (depth <= 20: hazard
    C1)."""
    depth = 16
    slice_codes = [_codes(300, depth, seed=41), _codes(200, 6, seed=42)]
    calls = []
    real = tops.encode_occ_u8_hdr

    def spy(codes, d, cap):
        calls.append(cap)
        return real(codes, d, cap)

    monkeypatch.setattr(tops, "encode_occ_u8_hdr", spy)
    geom, _ = tframe.encode_frame_sharded(
        slice_codes, depth, tframe.devices_for(2, backend="cpu"),
        num_threads=2)
    jgeom, _ = jframe.encode_frame_sharded(
        slice_codes, depth, jframe.devices_for(2, backend="cpu"),
        num_threads=2)
    assert len(calls) == 3 and calls[2] > calls[0]
    assert geom == jgeom


def test_decode_frame_sharded():
    depth = 6
    slice_codes = [_codes(300, depth, seed=31), _codes(500, depth, seed=32),
                   _codes(120, depth, seed=33)]
    devs = tframe.devices_for(2, backend="cpu")
    geom, _ = tframe.encode_frame_sharded(slice_codes, depth, devs)
    nmax = max(c.size for c in slice_codes) + 64
    outs = tframe.decode_frame_sharded(geom, depth, devs, nmax)
    jouts = jframe.decode_frame_sharded(
        geom, depth, jframe.devices_for(2, backend="cpu"), nmax)
    for s, ((nodes, cnt), (jn, jc)) in enumerate(zip(outs, jouts)):
        assert nodes.device == devs[s % 2]
        assert np.array_equal(nodes.numpy(), np.asarray(jn))
        assert np.array_equal(nodes[:int(cnt)].numpy(), slice_codes[s])
        assert int(cnt) == int(np.asarray(jc))


def test_dryrun_multichip_on_the_host():
    dryrun_multichip(4, backend="cpu")


def test_slices_must_divide_over_the_mesh():
    """S not divisible by the mesh size raises in both packages."""
    blocks = jpar.partition_codes_padded(_codes(200, 5, seed=3), 3)
    jmesh, tmesh = _meshes(2)
    with pytest.raises(ValueError):
        jpar.sharded_encode_analysis(blocks, 5, jmesh)
    with pytest.raises(ValueError, match="divide evenly"):
        tpar.sharded_encode_analysis(blocks, 5, tmesh)
    v, w = _fp_blocks((3, 4, 3), seed=2)
    with pytest.raises(ValueError, match="divide evenly"):
        tpar.sharded_raht_fp_blocks(v, w, tmesh)


def test_more_devices_than_exist(monkeypatch):
    """Asking for more devices than exist raises ValueError: the
    reference's CPU mesh beyond its 8 virtual devices, the port's CUDA
    mesh beyond the cards present."""
    with pytest.raises(ValueError):
        jpar.make_mesh(64, backend="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert tpar.make_mesh(1).devices == (torch.device("cuda", 0),)
    with pytest.raises(ValueError, match="need 2"):
        tpar.make_mesh(2)
    with pytest.raises(ValueError, match="need 3"):
        tframe.devices_for(3)
    with pytest.raises(ValueError, match="unknown backend"):
        tpar.make_mesh(1, backend="tpu")
