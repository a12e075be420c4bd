"""Device-sharded frame encode: slices round-robined over devices
(counterpart of ``mpeg_pcc_tmc13_tpu/parallel/frame.py``).

Slices are independently decodable bricks (reference
partitioning.cpp; SURVEY.md §2.9), so a frame's slice set is the
natural multi-device work list: each device runs one slice's geometry
analysis (``ops.octree.encode_occ_u8_hdr``) and fixed-point RAHT closed
loop (``ops.raht_fp_device``) on its own stream, while host threads
drain the (serial, per-slice independent) entropy coding.  The emitted
bytes are identical to the host engines': sharding is layout, not
syntax.

Two layers:
  * ``sharded_encode_analysis`` / ``sharded_encode_analysis_inter``
    (``parallel/slices.py``): the mesh form, used for statistics and the
    dry run.
  * ``encode_frame_sharded`` (here): per-slice placement (the current
    CUDA device round-robin) + a host thread pool for entropy: the
    throughput form.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np
import torch

from .slices import _on, mesh_devices


def devices_for(n: int, backend: Optional[str] = None):
    """The first ``n`` devices, by ``make_mesh``'s rules (the CUDA
    devices unless ``backend="cpu"``; too few raise ``ValueError``)."""
    return mesh_devices(n, backend)


def _slice_cap(n: int, depth: int) -> int:
    # small slices approach depth nodes/point; big ones ~2.3
    return max(64, min(n * depth, int(n * 2.3) + 512)) & ~63


def encode_frame_sharded(slice_codes: List[np.ndarray], depth: int,
                         devices, values: Optional[List] = None,
                         steps_q16=None, num_threads: int = 0):
    """Encode S slices over len(devices) devices (reference
    ``encode_frame_sharded``, frame.py:37-118).

    slice_codes: per-slice sorted unique Morton codes.  values:
    optional per-slice (n_s, C) integer attributes -> fixed-point RAHT
    payloads.  Returns (geom_payloads, attr_payloads): independent
    per-slice byte strings (fresh contexts per brick, the
    entropy-continuation-off layout).
    """
    from ..bitstream import entropy
    from ..models import geometry_octree as go
    from ..models.attributes import AttributeContexts
    from ..ops import octree as ops
    from ..ops import raht_fp_device

    ndev = len(devices)

    def analyse(si, cap):
        dev = devices[si % ndev]
        with _on(dev):
            dc = torch.as_tensor(slice_codes[si], device=dev)
            return ops.encode_occ_u8_hdr(dc, depth, cap)

    # stage 1: issue every slice's device work (round-robin); the
    # devices' streams run while the host stage below drains them
    pending = []
    for i, codes in enumerate(slice_codes):
        geom = analyse(i, _slice_cap(codes.size, depth))
        raht = None
        if values is not None and values[i] is not None:
            dev = devices[i % ndev]
            with _on(dev):
                dv = raht_fp_device.DeviceFpRaht(codes, depth, steps_q16,
                                                 device=dev)
                qs = []
                dv.encode(values[i], qs.append)
            raht = qs
        pending.append((geom, raht))

    # stage 2: host entropy per slice (independent bricks -> thread
    # pool; each worker only touches its own coder state)
    def entropy_one(si_item):
        si, (geom, raht) = si_item
        h = geom.cpu().numpy()
        cnt = h[:4 * depth].view(np.uint32)
        total = int(cnt.sum())
        if total > h.size - 4 * depth:      # undersized cap: redo big
            big = max(64, int(total * 1.25)) & ~63
            h = analyse(si, big).cpu().numpy()
            cnt = h[:4 * depth].view(np.uint32)
            total = int(cnt.sum())
        occ = h[4 * depth:4 * depth + total]
        enc = entropy.RangeEncoder()
        ctx = go.OctreeContexts()
        enc.occ_stream(ctx.occupancy_sym, occ, depth)
        gp = enc.get_bytes()
        ap = None
        if raht is not None:
            aenc = entropy.RangeEncoder()
            actx = AttributeContexts()
            for q in raht:
                aenc.zrow_residuals(actx.zrow, q.astype(np.int32))
            ap = aenc.get_bytes()
        return gp, ap

    items = list(enumerate(pending))
    if num_threads and num_threads > 1:
        with ThreadPoolExecutor(max_workers=num_threads) as ex:
            results = list(ex.map(entropy_one, items))
    else:
        results = [entropy_one(it) for it in items]
    geom_payloads = [r[0] for r in results]
    attr_payloads = [r[1] for r in results]
    return geom_payloads, attr_payloads


def decode_frame_sharded(geom_payloads: List[bytes], depth: int,
                         devices, per_slice_points: int):
    """Mirror (reference ``decode_frame_sharded``, frame.py:121-155):
    host entropy per slice -> device expansion per slice, leaves left on
    the slice's device.  Returns [(codes (nmax,) int64, count 0-d), ...]
    per slice."""
    from ..bitstream import entropy
    from ..models import geometry_octree as go
    from ..ops import octree as ops

    ndev = len(devices)
    outs = []
    for i, payload in enumerate(geom_payloads):
        dec = entropy.RangeDecoder(payload)
        ctx = go.OctreeContexts()
        cap = depth * per_slice_points + 64
        occ = dec.occ_stream(ctx.occupancy_sym, cap, depth)
        counts = np.zeros(depth, dtype=np.int32)
        pos, ln = 0, 1
        pops = np.unpackbits(occ[:, None], axis=1).sum(axis=1)
        for l in range(depth):
            counts[l] = ln
            nxt = int(pops[pos:pos + ln].sum())
            pos += ln
            ln = nxt
        dev = devices[i % ndev]
        with _on(dev):
            pad = np.zeros(-(-occ.size // 64) * 64, dtype=np.uint8)
            pad[:occ.size] = occ
            occ_d = torch.as_tensor(pad, device=dev)
            cnt_d = torch.as_tensor(counts, device=dev)
            outs.append(ops.decode_expand_stream(
                occ_d, cnt_d, depth, per_slice_points))
    return outs
