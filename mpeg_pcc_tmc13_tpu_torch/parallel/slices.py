"""Slice-parallel encoding over a mesh of torch devices: counterpart of
``mpeg_pcc_tmc13_tpu/parallel/slices.py``.

Slices are the standard's parallelism unit (reference partitioning.cpp;
SURVEY.md §2.9): each slice is independently decodable, so the geometry
analysis of S slices shards over devices with no traffic between them
but the sum of the per-slice context-base histograms (the reference's
``psum``).

Layout, as the reference's ``P('slices', None)``: a (S, N) array of
padded, Morton-sorted slice codes is cut into contiguous blocks of S/n
slices, one per device of the mesh, and each device runs its local
slices one after another (the reference's ``vmap`` over the local
block).  ``shard_map`` is one program over the mesh under a single
controller; here one Python thread issues every device's work before
it fetches anything, so the devices run together as JAX's asynchronous
dispatch lets them.  No process group and no launcher: the ``psum``
becomes a sum on the mesh's first device of the per-device histograms
(a peer copy from each other card).

Results stay on the devices that computed them.  Each sharded output is
a list with one tensor per device of the mesh, that device's local
slices along the leading axis, in slice order; ``gather`` brings it to
the host as the reference's (S, ...) array.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from ..ops import octree as ops
from ..utils.device import NoDeviceError

ANALYSIS_KEYS = ("occ", "ctx_base", "node_mask", "node_code")


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: an ordered tuple of torch devices and its axis name.
    A device may stand in it more than once (``backend="cpu"``)."""
    devices: Tuple[torch.device, ...]
    axis: str = "slices"

    @property
    def size(self) -> int:
        return len(self.devices)


def mesh_devices(n_devices=None, backend=None):
    """The first ``n_devices`` devices of ``backend`` (all of them when
    ``n_devices`` is None).  ``backend=None`` (or ``"cuda"``) takes the
    CUDA devices, raising ``NoDeviceError`` without one; ``"cpu"`` gives
    ``n_devices`` entries of the host (one when None), the counterpart of
    the reference's virtual CPU devices.  Fewer devices than asked for
    raise ``ValueError`` (reference slices.py:48-53)."""
    if backend in (None, "cuda"):
        if not torch.cuda.is_available():
            raise NoDeviceError("no CUDA device: pass backend=\"cpu\" to "
                                "build the mesh on the host")
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    elif backend == "cpu":
        devs = [torch.device("cpu")] * (n_devices or 1)
    else:
        raise ValueError(f"unknown backend {backend!r} (cuda or cpu)")
    if n_devices is not None:
        if len(devs) < n_devices:
            raise ValueError(f"need {n_devices} {backend or 'cuda'} devices, "
                             f"have {len(devs)}")
        devs = devs[:n_devices]
    return devs


def make_mesh(n_devices=None, axis: str = "slices", backend=None) -> Mesh:
    """Build a 1-D slice mesh (reference ``make_mesh``, slices.py:42):
    the CUDA devices unless ``backend="cpu"``, as ``mesh_devices``."""
    return Mesh(tuple(mesh_devices(n_devices, backend)), axis)


def _on(dev):
    """Make ``dev`` the current CUDA device (and its stream the current
    one) for the work issued inside; nothing for the host."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def _local_blocks(x, mesh: Mesh, axis: str):
    """Cut ``x`` (numpy or torch, slices on axis 0) into the mesh's
    contiguous per-device blocks, each copied to its device."""
    if axis != mesh.axis:
        raise ValueError(f"mesh has axis {mesh.axis!r}, not {axis!r}")
    s = x.shape[0]
    if s % mesh.size:
        raise ValueError(f"{s} slices do not divide evenly over "
                         f"{mesh.size} devices")
    per = s // mesh.size
    return [torch.as_tensor(x[d * per:(d + 1) * per]).to(dev)
            for d, dev in enumerate(mesh.devices)]


def _per_device(mesh: Mesh, axis: str, run, *arrays):
    """``run(*local_blocks)`` on every device of the mesh: every block is
    uploaded first, then every device's work is issued, and nothing is
    fetched here, so the devices compute together."""
    blocks = [_local_blocks(a, mesh, axis) for a in arrays]
    outs = []
    for d, dev in enumerate(mesh.devices):
        with _on(dev):
            outs.append(run(*(b[d] for b in blocks)))
    return outs


def gather(x):
    """A sharded result on the host: a per-device list of tensors becomes
    one numpy array (slices on axis 0); dicts and tuples of them are
    gathered entry by entry."""
    if isinstance(x, dict):
        return {k: gather(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(gather(v) for v in x)
    return np.concatenate([t.cpu().numpy() for t in x])


def _analysis_with_stats(codes: torch.Tensor, depth: int):
    """Per-slice analysis + context-base histogram (reference
    ``_analysis_with_stats``, slices.py:58-66): a fixed 2048-bin buffer
    filled by ``index_add_`` of the masked bases, weighted by the mask,
    so nothing waits for the device (``bincount`` would read its
    maximum)."""
    res = ops.encode_analysis(codes, depth)
    mask = res["node_mask"]
    hist = torch.zeros(ops.NUM_OCC_BASES, dtype=torch.int32,
                       device=codes.device)
    hist.index_add_(0, torch.where(mask, res["ctx_base"], 0).reshape(-1),
                    mask.reshape(-1).to(torch.int32))
    return res, hist


def _stack(rows):
    return {k: torch.stack([r[k] for r in rows]) for k in ANALYSIS_KEYS}


def sharded_encode_analysis(slice_codes, depth: int, mesh: Mesh,
                            axis: str = "slices"):
    """(S, N) sorted padded codes -> per-slice analysis + global stats
    (reference ``sharded_encode_analysis``, slices.py:69-93).

    Pad a slice's tail with repeats of its last code (repeats collapse
    into the same leaf, adding no tree nodes but keeping shapes static).
    Returns (analysis: a dict of per-device lists of (S/n, depth, N)
    tensors, the global context-base histogram (2048,) int32 on the
    mesh's first device)."""

    def run(block):
        rows = [_analysis_with_stats(c, depth) for c in block]
        hist = torch.stack([h for _, h in rows]).sum(0, dtype=torch.int32)
        return _stack([r for r, _ in rows]), hist

    outs = _per_device(mesh, axis, run, slice_codes)
    res = {k: [r[k] for r, _ in outs] for k in ANALYSIS_KEYS}
    root = mesh.devices[0]
    ghist = torch.stack([h.to(root) for _, h in outs]).sum(
        0, dtype=torch.int32)
    return res, ghist


def sharded_encode_analysis_inter(slice_codes, depth: int, slice_ref_codes,
                                  ref_counts, mesh: Mesh,
                                  axis: str = "slices"):
    """Inter-frame sharded analysis: per-slice occupancy + predOcc
    contexts from each slice's motion-compensated reference block
    (reference ``sharded_encode_analysis_inter``, slices.py:96-118;
    reference encoder geometry_octree_encoder.cpp:1875-1918).

    slice_ref_codes (S, M): sorted reference codes per slice, padded
    with INT64_MAX past ref_counts[s].  Returns a dict of per-device
    lists of (S/n, depth, N) tensors."""

    def run(block, refs, counts):
        return _stack([ops.encode_analysis_inter(c, depth, r, k)
                       for c, r, k in zip(block, refs, counts)])

    outs = _per_device(mesh, axis, run, slice_codes, slice_ref_codes,
                       ref_counts)
    return {k: [o[k] for o in outs] for k in ANALYSIS_KEYS}


def partition_codes_padded(codes_sorted: np.ndarray, n_slices: int):
    """Host-side: split sorted codes into S contiguous, padded rows."""
    n = codes_sorted.shape[0]
    per = -(-n // n_slices)
    out = np.empty((n_slices, per), dtype=np.int64)
    for s in range(n_slices):
        chunk = codes_sorted[s * per:(s + 1) * per]
        if chunk.size == 0:
            chunk = codes_sorted[-1:]
        out[s, :chunk.size] = chunk
        out[s, chunk.size:] = chunk[-1]
    return out


def sharded_raht_blocks(vals, weights, mesh: Mesh, axis: str = "slices"):
    """The float RAHT block butterfly (B1, ``ops.raht_blocks.fwd_blocks``)
    on every device of the mesh (reference ``sharded_raht_blocks``,
    slices.py:135-162; no ``interpret``: the device decides).

    vals (S, B, 8, C) float32 per-slice blocks, weights (S, B, 8): each
    device runs the butterfly once on its slices' flattened blocks.
    Returns (coeffs, wout, ac_mask), each a per-device list with the
    slice axis kept."""
    from ..ops import raht_blocks

    _, b, _, c = vals.shape

    def run(v, w):
        ls = v.shape[0]
        cv, cw, mask = raht_blocks.fwd_blocks(
            v.reshape(-1, 8, c).contiguous(), w.reshape(-1, 8).contiguous())
        return (cv.reshape(ls, b, 8, c), cw.reshape(ls, b, 8),
                mask.reshape(ls, b, 8))

    outs = _per_device(mesh, axis, run, vals, weights)
    return tuple([o[i] for o in outs] for i in range(3))


def sharded_raht_fp_blocks(vals, weights, mesh: Mesh, axis: str = "slices"):
    """The fixed-point RAHT block stage on every device of the mesh
    (reference ``sharded_raht_fp_blocks``, slices.py:165-189).

    vals (S, B, 8, C) int64 Q13 block values, weights (S, B, 8) int64:
    each device runs the integer butterfly
    (``ops.raht_fp_device.fwd_blocks_int``) once on its slices' flattened
    blocks.  Returns (dc (S,B,C), acz, acy, acx), each a per-device list
    with the slice axis kept; bit-identical to the host fp spec."""
    from ..ops import raht_fp_device as fpd

    def run(v, w):
        ls, b, _, c = v.shape
        dc, az, ay, ax = fpd.fwd_blocks_int(
            v.reshape(-1, 8, c).contiguous(), w.reshape(-1, 8).contiguous())
        return (dc.reshape(ls, b, c), az.reshape(ls, b, 4, c),
                ay.reshape(ls, b, 2, c), ax.reshape(ls, b, 1, c))

    outs = _per_device(mesh, axis, run, vals, weights)
    return tuple([o[i] for o in outs] for i in range(4))


def sharded_slice_codec_roundtrip(codes_sorted: np.ndarray, depth: int,
                                  mesh: Mesh, n_slices: int,
                                  axis: str = "slices"):
    """Full sharded codec round trip (reference
    ``sharded_slice_codec_roundtrip``, slices.py:192-256): the per-slice
    analysis on the mesh -> host entropy per slice -> per-slice payload
    bytes -> decode -> equality with the input cloud.

    Every context input is computed on the mesh; the host stage only
    replays entropy coding per slice, as the reference concatenates
    per-slice bricks (encoder.cpp:1503-1529).  Checks that each slice's
    bytes equal the host engine's and that the decode gives the cloud
    back; returns the payload list."""
    from ..bitstream import entropy as ent
    from ..models import geometry_octree as go
    from ..utils import morton

    uniq = np.unique(codes_sorted)
    blocks = partition_codes_padded(uniq, n_slices)
    res, _hist = sharded_encode_analysis(blocks, depth, mesh, axis)
    occ, base, mask = (gather(res[k])
                       for k in ("occ", "ctx_base", "node_mask"))

    payloads = []
    slice_uniq = []
    for s in range(n_slices):
        su = np.unique(blocks[s])
        slice_uniq.append(su)
        enc = ent.RangeEncoder()
        ctx = go.OctreeContexts()
        for l in range(occ.shape[1]):
            m = mask[s, l]
            if not m.any():
                continue
            enc.occupancy_sym(ctx.occupancy_sym,
                              base[s, l][m].astype(np.int32),
                              occ[s, l][m].astype(np.uint8))
        payloads.append(enc.get_bytes())

    # the device-analysis stream must equal the host engine's bytes
    # for the same slice (identical contexts by construction)
    for s in range(n_slices):
        enc = ent.RangeEncoder()
        go.encode(morton.decode(slice_uniq[s]), depth, enc,
                  go.OctreeContexts(), unique_points=True,
                  engine="numpy", need_order=False)
        if enc.get_bytes() != payloads[s]:
            raise AssertionError(f"slice {s}: device-analysis bytes "
                                 "differ from host engine")

    # decode of the per-slice payloads on the host
    got = []
    for s in range(n_slices):
        dec = ent.RangeDecoder(payloads[s])
        pts = go.decode(int(slice_uniq[s].size), depth, dec,
                        go.OctreeContexts(), unique_points=True,
                        engine="numpy")
        got.append(morton.encode(pts))
    got = np.unique(np.concatenate(got))
    if not np.array_equal(got, uniq):
        raise AssertionError("sharded codec round-trip mismatch")
    return payloads
