"""On-device octree geometry codec with interleaved rANS entropy coding:
counterpart of ``mpeg_pcc_tmc13_tpu/ops/octree_rans.py``.

Analysis, context modelling and entropy coding all run on the torch
device; the host moves only the compressed payload.  The format is the
reference's, byte for byte:

* K-lane interleaved rANS (u32 states, 16-bit words, M = 2^14): symbol
  i of a level is coded by lane ``i % K``; the words form ONE stream in
  (step, lane) order, so no per-lane lengths are signalled,
* tile-causal adaptive tables: both sides quantise the exact histogram
  of all previously coded symbols (plus a Laplace prior) into a
  cumulative table, refreshed every UPD_TILES tiles of K symbols within
  a level, the histogram carrying across levels,
* occupancy-byte alphabet with PARENT contexts
  ``child_idx << 8 | parent_occupancy`` (2048 contexts).

Payload: [depth x u32 counts][K x u32 final states][u32 total_words]
[total_words x u16 words].

The reference runs each direction as one jitted program over a fixed
step budget ``s_cap``.  Here the host reads the per-level node counts
once and walks the (level, tile) schedule up to its real length G (the
reference's steps past G do nothing).  The lane loops are hand-written
CUDA kernels (``ops.rans_lanes``); between them everything is torch
ops:

* encoder: ``table_pass`` runs the whole forward table pass in one
  launch (one CTA per context row: quantisation is row-separable and the
  encoder knows every symbol, so the rows are independent chains of
  windows), then ``encode_emit`` runs the reverse emission and a
  boolean-mask select compacts the dense (step, lane) words in row-major
  order, the decoder's read order,
* decoder: from the table of the zero histogram, one ``decode_level``
  launch per level decodes its tiles and requantises, after each refresh
  window, the context rows the window touched; between levels the
  expansion of ``ops.octree._expand_level``, whose source row gives each
  child's context ``child << 8 | occ[parent]``.

Codes are native int64 throughout.  The reference's ``_analysis``
splits each code at bit 30 into int32 words and overflows at depth 21
(octree_rans.py:103-109, as ops/octree.py:471), so its depth-21 payload
decodes a different cloud; here the octant is read from the int64 code,
and the analysis equals ``build_levels_np(..., CTX_MODE_PARENT)`` at
every depth.

``plain=True`` runs the plain PyTorch version of every lane kernel and
of the decoder's expansion (``_expand_level_ref``) on any device: the
card-side check that the kernels change no byte.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve as resolve_device
from . import rans_lanes as lanes_ops
from .octree import (I64_MAX, _expand_level, _expand_level_ref,
                     _min_levels, _nth_set_bit_table, _popcount8_table,
                     _u32_le_bytes)
from .rans_lanes import N_CTX, _ceil_div


def _lane_ops(plain: bool):
    """(table_pass, encode_emit, decode_level): the kernel wrappers, or
    the plain versions when ``plain``."""
    L = lanes_ops
    if plain:
        return L.table_pass_ref, L.encode_emit_ref, L.decode_level_ref
    return L.table_pass, L.encode_emit, L.decode_level


# =====================================================================
# analysis: per-level (occupancy, context) rows via closed-form ranks
# =====================================================================


def _analysis(leaf: torch.Tensor, depth: int, nmax: int):
    """Per-level occupancy + context rows, (depth, nmax) int32, and the
    per-level node counts (depth,) int32 (reference ``_analysis``,
    octree_rans.py:83-136).

    leaf: (nmax,) sorted Morton codes (pad = repeats of the last code;
    duplicates collapse).  Row l holds the level-l nodes' occupancy bytes
    and contexts compacted to the front; padding holds occ=1, ctx=0 (safe
    table indices).  The same closed-form ranks as
    ``ops.octree.encode_occ_u8``, with the octants read from the int64
    codes.
    """
    c = leaf
    dev = c.device
    minlev = _min_levels(c, depth)
    lvec = torch.arange(depth, dtype=torch.int64, device=dev)[:, None]
    first = minlev[None, :] <= lvec                          # (depth, N)
    seg = torch.cumsum(first, dim=1) - 1
    counts = seg[:, -1] + 1
    # child octant of point i at level l+1
    octant = (c[None, :] >> (3 * (depth - 1 - lvec))) & 7    # (depth, N)
    dest = (lvec * nmax + seg).reshape(-1)
    contrib = torch.where(minlev[None, :] <= lvec + 1,
                          torch.bitwise_left_shift(1, octant), 0)
    occ2d = torch.zeros(depth * nmax, dtype=torch.int64, device=dev)
    occ2d.index_add_(0, dest, contrib.reshape(-1))
    # node's own octant = the previous row's split; parent byte = the
    # previous level's occ row at the point's previous-level node
    zrow = torch.zeros(1, c.shape[0], dtype=torch.int64, device=dev)
    self_oct = torch.cat([zrow, octant[:-1]])
    pseg = torch.cat([zrow, seg[:-1]])
    pocc = occ2d[(lvec - 1).clamp(min=0) * nmax + pseg]
    ctx_val = torch.where(lvec > 0, (self_oct << 8) | pocc, 0)
    ctx2d = torch.zeros(depth * nmax, dtype=torch.int64, device=dev)
    ctx2d.index_add_(0, dest, torch.where(first, ctx_val, 0).reshape(-1))

    row = torch.arange(nmax, dtype=torch.int64, device=dev)[None, :]
    valid = row < counts[:, None]
    occ = torch.where(valid, occ2d.reshape(depth, nmax), 1)
    ctx = torch.where(valid, ctx2d.reshape(depth, nmax), 0)
    return (occ.to(torch.int32), ctx.to(torch.int32),
            counts.to(torch.int32))


# =====================================================================
# tables and schedule (identical on encoder and decoder)
# =====================================================================


# the reference's ``_quantize_cfull`` and ``_search_sym`` are the plain
# versions of the lane kernels
_quantize_cfull = lanes_ops.quantize_tables_ref
_search_sym = lanes_ops._search_sym


def _step_maps(counts: torch.Tensor, K: int, s_cap: int):
    """Global (level, tile) step schedule from per-level node counts
    (reference ``_step_maps``): (step_lvl (s_cap,), step_base (s_cap,),
    G) — step g codes symbols [step_base[g], step_base[g]+K) of level
    step_lvl[g].  The port walks the same schedule window by window
    (``rans_lanes.windows``); this dense form is the reference's and
    holds ``rans_lanes.windows`` to it in the tests."""
    counts = counts.to(torch.int64)
    T = _ceil_div(counts, K)
    Tc = torch.cumsum(T, dim=0)
    g = torch.arange(s_cap, dtype=torch.int64, device=counts.device)
    lvl = torch.searchsorted(Tc, g, right=True).clamp_(
        max=counts.shape[0] - 1)
    start = Tc - T
    base = (g - start[lvl]) * K
    return lvl.to(torch.int32), base.to(torch.int32), int(Tc[-1])


def _payload(counts, states, words) -> torch.Tensor:
    """[counts u32][states u32][total_words u32][words u16], little
    endian, as one uint8 tensor on the words' device."""
    n = torch.tensor([words.shape[0]], dtype=torch.int64,
                     device=words.device)
    w = words.to(torch.int64)
    w_u8 = torch.stack([w & 0xFF, (w >> 8) & 0xFF], dim=1).reshape(-1)
    return torch.cat([_u32_le_bytes(counts), _u32_le_bytes(states),
                      _u32_le_bytes(n), w_u8.to(torch.uint8)])


# =====================================================================
# encode
# =====================================================================


def _nvalid(counts_host, K: int) -> np.ndarray:
    """Per step of the schedule, its number of valid lanes, (G,) int32."""
    return np.array([min(K, int(counts_host[l]) - t * K)
                     for l, t0, nt, _ in lanes_ops.windows(counts_host, K)
                     for t in range(t0, t0 + nt)], dtype=np.int32)


def encode_device(leaf: torch.Tensor, depth: int, nmax: int,
                  lanes: int = 1024, plain: bool = False):
    """Full on-device geometry encode (reference ``encode_device``).

    leaf: (nmax,) sorted Morton codes on the device (pad = last-code
    repeats).  Returns (payload uint8 tensor on the device, used bytes):
    unlike the reference's fixed-size buffer, the payload holds exactly
    the used bytes.
    """
    K = lanes
    occ2, ctx2, counts = _analysis(leaf, depth, nmax)
    table_pass, emit, _ = _lane_ops(plain)
    counts_host = counts.tolist()
    f_steps, c_steps, _ = table_pass(occ2, ctx2, counts_host, K)
    nvalid = torch.as_tensor(_nvalid(counts_host, K), device=leaf.device)
    states, wdense, flags = emit(f_steps, c_steps, nvalid)
    # single stream in decode read order: (step asc, lane asc)
    words = wdense[flags]
    buf = _payload(counts, states, words)
    return buf, int(buf.shape[0])


# =====================================================================
# decode
# =====================================================================


def decode_device(counts, states0: torch.Tensor, words: torch.Tensor,
                  depth: int, nmax: int, lanes: int = 1024,
                  plain: bool = False):
    """Full on-device geometry decode (reference ``decode_device``).

    counts: (depth,) per-level node counts (read on the host); states0
    (K,) u32 lane states; words (wcap,) int32 of u16 values (the single
    interleaved stream, zero-padded), both on the decode device.
    Returns (leaf codes (nmax,) int64 padded with INT64_MAX, leaf count
    as a 0-d tensor).
    """
    K = lanes
    dev = words.device
    counts_host = [int(c) for c in
                   (counts.tolist() if torch.is_tensor(counts) else counts)]
    _, _, decode_level = _lane_ops(plain)
    expand = _expand_level_ref if plain else _expand_level
    nmax_p = (_ceil_div(nmax, K) + 1) * K
    row = torch.arange(nmax, dtype=torch.int64, device=dev)
    nth_bit = _nth_set_bit_table(dev)
    popcnt = _popcount8_table(dev)

    states = states0.to(device=dev, dtype=torch.int64).clone()
    cursor = torch.zeros(1, dtype=torch.int64, device=dev)
    hist = torch.zeros(N_CTX * 256, dtype=torch.int32, device=dev)
    # the table of the zero histogram (the reference's ``init``); each
    # decode_level leaves it current
    c_flat = _quantize_cfull(hist.view(N_CTX, 256)).reshape(-1)
    nodes = torch.full((nmax,), I64_MAX, dtype=torch.int64, device=dev)
    nodes[0] = 0
    cnt = torch.ones((), dtype=torch.int64, device=dev)
    ctx_row = torch.zeros(nmax_p, dtype=torch.int32, device=dev)
    for l in range(depth):
        syms = torch.zeros(nmax_p, dtype=torch.int32, device=dev)
        decode_level(c_flat, ctx_row, words, states, cursor, syms, hist,
                     counts_host[l])
        occ_l = syms[:nmax].to(torch.int64)
        occ_v = torch.where(row < counts_host[l], occ_l, 0)
        nodes, cnt, src = expand(nodes, occ_v, nmax, nth_bit, popcnt)
        valid_n = row < cnt
        ctx_next = torch.where(valid_n, ((nodes & 7) << 8) | occ_l[src], 0)
        ctx_row = torch.nn.functional.pad(ctx_next.to(torch.int32),
                                          (0, nmax_p - nmax))
    return nodes, cnt


# =====================================================================
# host-side payload helpers
# =====================================================================


def parse_payload(buf: np.ndarray, depth: int, lanes: int = 1024):
    """Split an ``encode_device`` payload (host-side numpy): (counts
    (depth,) int32, states (lanes,) uint32, words int32)."""
    u8 = np.asarray(buf, dtype=np.uint8)
    off = 0
    counts = u8[off:off + 4 * depth].view("<u4").astype(np.int32)
    off += 4 * depth
    states = u8[off:off + 4 * lanes].view("<u4")
    off += 4 * lanes
    total_words = int(u8[off:off + 4].view("<u4")[0])
    off += 4
    words = u8[off:off + 2 * total_words].view("<u2").astype(np.int32)
    return counts, states, words


def roundtrip_host(leaf: np.ndarray, depth: int, nmax: int | None = None,
                   lanes: int = 64, device=None):
    """Encode -> decode round trip from host codes (tests / reference)
    on ``device`` (None: the current CUDA device, raising when there is
    none): returns (decoded sorted unique codes, payload bytes)."""
    device = resolve_device(device)
    leaf = np.asarray(leaf, dtype=np.int64)
    n = leaf.shape[0]
    if nmax is None:
        nmax = max(64, n)
    pad = np.empty(nmax, dtype=np.int64)
    pad[:n] = leaf
    pad[n:] = leaf[-1] if n else 0
    buf, used = encode_device(torch.as_tensor(pad, device=device), depth,
                              nmax, lanes)
    u8 = buf.cpu().numpy()
    counts, states, words = parse_payload(u8, depth, lanes)
    wcap = max(64, words.shape[0])
    words_p = np.zeros(wcap, np.int32)
    words_p[:words.shape[0]] = words
    nodes, cnt = decode_device(
        counts, torch.as_tensor(states.astype(np.int64), device=device),
        torch.as_tensor(words_p, device=device), depth, nmax, lanes)
    return nodes[:int(cnt)].cpu().numpy(), used
