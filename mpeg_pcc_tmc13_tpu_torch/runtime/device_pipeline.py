"""Device-in-the-loop geometry pipeline: counterpart of
``mpeg_pcc_tmc13_tpu/runtime/device_pipeline.py``.

Per slice:

  1. device: full-depth octree analysis -> level-major occupancy bytes
     (``ops.octree.encode_occ_u8_hdr``; one byte per tree node), or the
     same bytes through the static prefix code
     (``ops.octree.encode_occ_packed_hdr``, ``packed_link=True``),
  2. link: two-step fetch — the counts header, then only the
     size-bucketed used bytes.  With several slices a prefetch thread
     pulls slice s+1 while the host codes slice s,
  3. host: the packed link is unpacked by the native ``occ_unpack``;
     one native call per slice entropy-codes the stream with PARENT
     contexts derived from the stream itself (``occ_stream`` of the
     port's ``bitstream.entropy``).

The stream is the same through either link.  The raw link is the
default here (the reference defaults to the packed one, which its own
docstring and benchmark call the wrong trade).  A slice that overflows
its packed budget is redone through the raw link, as in the reference.

Decode mirrors it: the host entropy stage decodes each slice's
self-delimiting byte stream, the bytes go to the device, and
``ops.octree.decode_expand_stream`` rebuilds the leaf codes there.  The
native range coder is required; there is no pure-Python fallback.
"""

from __future__ import annotations

import ctypes
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from ..bitstream import entropy
from ..ops import octree as ops
from ..utils import timing
from ..utils.device import resolve as resolve_device


def _require_native():
    if entropy._LIB is None:
        raise RuntimeError(
            "the native range coder (libtmc13_entropy.so) is not loaded; "
            "build it with `make -C mpeg_pcc_tmc13_tpu/native`")


def _split_padded(codes_sorted: np.ndarray, num_slices: int):
    """Split sorted codes into equal fixed-shape chunks (pad = repeat of
    the chunk's last code; duplicates collapse at the leaf level)."""
    n = codes_sorted.size
    per = -(-n // num_slices)
    chunks = np.empty((num_slices, per), dtype=np.int64)
    for s in range(num_slices):
        c = codes_sorted[s * per:(s + 1) * per]
        chunks[s, :c.size] = c
        chunks[s, c.size:] = c[-1] if c.size else 0
    return chunks


@dataclass
class PipelineStats:
    wall_s: float = 0.0
    host_entropy_s: float = 0.0
    link_bytes: int = 0
    num_slices: int = 0
    node_counts: List[int] = field(default_factory=list)


def _pow2_bucket(n: int, floor: int = 64) -> int:
    """Quarter-pow2 size bucket >= n: {1, 1.25, 1.5, 1.75} * 2^k.
    Bounds fetch overshoot at 25%."""
    b = floor
    while b < n:
        b <<= 1
    if b > floor and b >= 8:
        for eighths in (5, 6, 7):   # 0.625, 0.75, 0.875 * 2^k
            c = eighths * (b >> 3)
            if c >= n:
                return c
    return b


def encode_pipelined(codes_sorted: np.ndarray, depth: int, enc, ctx,
                     num_slices: int = 8, cap_factor: float = 2.3,
                     packed_link: bool = False,
                     packed_cap_factor: float = 1.6,
                     device_codes: Optional[list] = None,
                     stats: Optional[PipelineStats] = None,
                     device=None) -> None:
    """Encode sorted unique leaf codes through the device pipeline.

    enc/ctx: a native ``entropy.RangeEncoder()`` and an
    ``OctreeContexts``; contexts continue across slices, giving ONE
    stream that ``decode_pipelined`` reads back.  packed_link: compress
    the device->host bytes with the static occupancy prefix code; the
    stream is identical either way.  device_codes: optional pre-staged
    per-slice int64 tensors (then ``device`` is theirs); when None, the
    chunks are uploaded to ``device`` here (default: the current CUDA
    device; ``NoDeviceError`` without one).
    """
    _require_native()
    if device_codes is None:
        device = resolve_device(device)
        chunks = _split_padded(codes_sorted, num_slices)
        device_codes = [torch.as_tensor(chunks[s], device=device)
                        for s in range(num_slices)]
    per = device_codes[0].shape[0]
    cap = max(64, int(per * cap_factor)) & ~63
    cap_packed = max(64, int(per * packed_cap_factor)) & ~63
    hdr = 4 * depth

    t0 = time.perf_counter()
    # stage 1: queue every slice's analysis (asynchronous on a card)
    if packed_link:
        pending = [ops.encode_occ_packed_hdr(dc, depth, cap, cap_packed)
                   for dc in device_codes]
    else:
        pending = [ops.encode_occ_u8_hdr(dc, depth, cap)
                   for dc in device_codes]
    fetched = [0]

    def _fetch_packed(buf):
        h = buf[:hdr + 4].cpu().numpy()
        total = int(h[:hdr].view(np.uint32).sum())
        total_bits = int(h[hdr:].view(np.uint32)[0])
        fetched[0] += h.nbytes
        if total > cap or total_bits > 8 * cap_packed - 24:
            return None, total
        bucket = min(cap_packed, _pow2_bucket(total_bits // 8 + 4))
        packed = np.ascontiguousarray(
            buf[hdr + 4:hdr + 4 + bucket].cpu().numpy())
        fetched[0] += packed.nbytes
        occ = np.empty(total, dtype=np.uint8)
        entropy._LIB.occ_unpack(
            packed.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            occ.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), total)
        return occ, total

    def _fetch_raw(buf):
        h = buf[:hdr].cpu().numpy()
        total = int(h.view(np.uint32).sum())
        fetched[0] += h.nbytes
        if total > cap:
            return None, total
        bucket = min(cap, _pow2_bucket(total))
        body = buf[hdr:hdr + bucket].cpu().numpy()
        fetched[0] += body.nbytes
        return body[:total], total

    # Two-step fetch of one slice: the header, then only the bucketed
    # used prefix.  Returns (occ, total), occ None when the slice
    # overflowed its budget.  ``.cpu()`` waits for the producing
    # kernels, so the host never reads a buffer early.
    fetch_link = _fetch_packed if packed_link else _fetch_raw

    def _fetch(buf):
        with timing.span("geom.fetch"):
            return fetch_link(buf)

    # stages 2+3 overlapped: the prefetch thread pulls slice s+1 through
    # the link while the main thread entropy-codes slice s
    t_host = 0.0
    ncounts = []
    pool = ThreadPoolExecutor(max_workers=1) if len(pending) > 1 else None
    try:
        nxt = pool.submit(_fetch, pending[0]) if pool else None
        for si, buf in enumerate(pending):
            if nxt is not None:
                occ, total = nxt.result()
                if si + 1 < len(pending):
                    nxt = pool.submit(_fetch, pending[si + 1])
            else:
                occ, total = _fetch(buf)
            if occ is None:
                # undersized budget: redo this slice through the raw
                # link with room to spare
                with timing.span("geom.redo"):
                    big = max(64, int(max(total, cap) * 1.25)) & ~63
                    h = ops.encode_occ_u8_hdr(device_codes[si], depth,
                                              big).cpu().numpy()
                    total = int(h[:hdr].view(np.uint32).sum())
                    occ = h[hdr:hdr + total]
                    fetched[0] += h.nbytes
            with timing.timed("geom.entropy") as coding:
                enc.occ_stream(ctx.occupancy_sym, occ, depth)
            t_host += coding.seconds
            ncounts.append(total)
    finally:
        if pool is not None:
            pool.shutdown(wait=True)
    if stats is not None:
        stats.wall_s = time.perf_counter() - t0
        stats.host_entropy_s = t_host
        stats.link_bytes = fetched[0]
        stats.num_slices = len(device_codes)
        stats.node_counts = ncounts


def decode_pipelined(dec, ctx, depth: int, num_slices: int,
                     per_slice_points: int,
                     stats: Optional[PipelineStats] = None,
                     device=None):
    """Decode a pipelined stream back to per-slice leaf codes on
    ``device`` (default: the current CUDA device; ``NoDeviceError``
    without one).

    Returns a list of (codes (nmax,) int64 padded with INT64_MAX, count
    as a 0-d tensor) per slice, left on the device for the attribute
    stages.
    """
    _require_native()
    device = resolve_device(device)
    nmax = per_slice_points
    # host decode uses the worst-case node bound (the stream is
    # self-delimiting); the h2d copy is padded to a half-slice bucket
    host_cap = depth * nmax + 64
    bucket = max(64, nmax // 2)
    t0 = time.perf_counter()
    t_host = 0.0
    link = 0
    outs = []
    for _ in range(num_slices):
        with timing.timed("geom.entropy") as coding:
            occ = dec.occ_stream(ctx.occupancy_sym, host_cap, depth)
        t_host += coding.seconds
        # per-level counts from the self-delimiting stream
        with timing.span("geom.count"):
            counts = np.zeros(depth, dtype=np.int32)
            pos, ln = 0, 1
            pops = ops.popcount8_np(occ)
            for l in range(depth):
                counts[l] = ln
                nxt = int(pops[pos:pos + ln].sum())
                pos += ln
                ln = nxt
        cap = -(-occ.size // bucket) * bucket
        pad = np.zeros(cap, dtype=np.uint8)
        pad[:occ.size] = occ
        link += pad.nbytes + counts.nbytes
        occ_d = torch.from_numpy(pad).to(device)
        cnt_d = torch.from_numpy(counts).to(device)
        outs.append(ops.decode_expand_stream(occ_d, cnt_d, depth, nmax))
    if stats is not None:
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        stats.wall_s = time.perf_counter() - t0
        stats.host_entropy_s = t_host
        stats.link_bytes = link
        stats.num_slices = num_slices
    return outs
