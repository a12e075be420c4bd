"""The multi-device dry run: counterpart of
``__graft_entry__.py:dryrun_multichip`` (its lines 39-133).

One full encode compute step over an n-device mesh, on tiny shapes, in
the reference's order: the sharded geometry analysis with its histogram
reduce, the sharded codec round trip (per-slice bytes equal to the host
engine's, the cloud decoded back), the inter analysis against per-slice
reference blocks, the integer and the float RAHT block butterflies on
the mesh, and the per-slice placement of a frame's encode and decode.
It runs on the CUDA devices unless given ``backend="cpu"``.
"""

from __future__ import annotations

import numpy as np

from ..utils import morton
from . import frame as pframe
from . import slices as par


def _make_codes(n: int, depth: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    pos = rng.integers(0, 1 << depth, size=(n, 3), dtype=np.int64)
    return np.sort(morton.encode(pos))


def _check(ok, what):
    if not ok:
        raise AssertionError(what)


def dryrun_multichip(n_devices: int, backend=None) -> None:
    """Run every stage of ``parallel/`` once over ``n_devices`` devices
    (the CUDA devices, or the host with ``backend="cpu"``); raises on the
    first check that fails."""
    depth = 6
    mesh = par.make_mesh(n_devices, backend=backend)
    codes = _make_codes(n_devices * 64, depth)
    blocks = par.partition_codes_padded(codes, n_devices)
    _res, hist = par.sharded_encode_analysis(blocks, depth, mesh)
    _check(int(hist.sum()) > 0, "empty context-base histogram")

    # full codec round trip over the mesh: per-slice bitstreams from
    # the sharded analysis, decoded and compared against the input cloud
    # and the host engine's bytes
    codec_codes = _make_codes(n_devices * 256, depth, seed=3)
    par.sharded_slice_codec_roundtrip(codec_codes, depth, mesh, n_devices)

    # inter stage: sharded predOcc analysis against per-slice
    # motion-compensated reference blocks
    ref = _make_codes(n_devices * 64, depth, seed=5)
    refs = np.full(blocks.shape, np.iinfo(np.int64).max, dtype=np.int64)
    counts = np.zeros(n_devices, dtype=np.int32)
    for s in range(n_devices):
        lo, hi = blocks[s].min(), blocks[s].max()
        rs = ref[(ref >= lo) & (ref <= hi)][:blocks.shape[1]]
        refs[s, :rs.size] = rs
        counts[s] = rs.size
    res_i = par.sharded_encode_analysis_inter(blocks, depth, refs, counts,
                                              mesh)
    _check(par.gather(res_i["occ"]).shape == (n_devices, depth,
                                              blocks.shape[1]),
           "inter analysis shape")

    # attribute stage: the fixed-point RAHT block butterflies on the mesh
    rng = np.random.default_rng(1)
    vals = rng.integers(-1 << 20, 1 << 20, (n_devices, 16, 8, 3))
    w = rng.integers(0, 4, (n_devices, 16, 8))
    w[:, :, 0] = np.maximum(w[:, :, 0], 1)
    dc, _az, _ay, _ax = par.sharded_raht_fp_blocks(vals, w, mesh)
    _check(par.gather(dc).shape == (n_devices, 16, 3), "fp butterfly shape")

    # the float butterfly (B1) on every device
    fv = rng.random((n_devices, 16, 8, 3)).astype(np.float32)
    fw = (rng.random((n_devices, 16, 8)) > 0.4).astype(np.float32)
    cv, _cw, _mask = par.sharded_raht_blocks(fv, fw, mesh)
    _check(par.gather(cv).shape == fv.shape, "float butterfly shape")

    # per-slice device placement (geometry + fp-RAHT attribute payloads,
    # host entropy threads)
    devs = pframe.devices_for(n_devices, backend=backend)
    slice_codes = [np.unique(blocks[s]) for s in range(n_devices)]
    slice_vals = [np.arange(c.size * 3, dtype=np.int64).reshape(-1, 3)
                  % 256 for c in slice_codes]
    geom_p, attr_p = pframe.encode_frame_sharded(
        slice_codes, depth, devs, values=slice_vals,
        steps_q16=[9000, 12000, 12000], num_threads=2)
    _check(all(len(b) > 0 for b in geom_p), "empty geometry payload")
    _check(all(b is not None and len(b) > 0 for b in attr_p),
           "empty attribute payload")
    nmax = max(c.size for c in slice_codes) + 64
    outs = pframe.decode_frame_sharded(geom_p, depth, devs, nmax)
    for s, (nodes, cnt) in enumerate(outs):
        got = nodes[:int(cnt)].cpu().numpy()
        _check(np.array_equal(got, slice_codes[s]),
               f"slice {s} decodes to other codes")

