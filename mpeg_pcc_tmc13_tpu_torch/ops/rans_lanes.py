"""The lane loops of the on-device rANS geometry engine: counterpart of
the three loops of ``mpeg_pcc_tmc13_tpu/ops/octree_rans.py`` that torch
has no primitive for.

* ``quantize_tables`` — histogram -> cumulative frequency tables
  (``_quantize_cfull``, octree_rans.py:144-161),
* ``encode_emit`` — the encoder's reverse rANS emission over every
  (level, tile) step (``encode_device``'s ``while_loop``, :264-290),
* ``decode_tiles`` — the decoder's tiles of one table-refresh window
  (``decode_device``'s tile ``while_loop``, :353-391).

A CUDA tensor launches the hand-written kernel of ``csrc/rans_lanes.cu``
(built on first use) or raises.  A CPU tensor runs the plain PyTorch
version (``*_ref``), which is also what the kernels are checked against
on the card.  Both are bit-exact integer arithmetic.

u32 rANS states are held in int64 tensors; the plain versions mask
with ``0xFFFFFFFF`` where the reference's uint32 arithmetic would wrap.

``LAUNCHES`` counts kernel launches per kernel (a launch adds one, the
plain versions add nothing), so a run can show it went through them.
"""

from __future__ import annotations

import torch

from . import _kernels

M_BITS = 14
M = 1 << M_BITS                 # probability precision
RANS_L = 1 << 16                # state lower bound
N_CTX = 2048                    # child_idx(3b) << 8 | parent_occupancy
U32 = 0xFFFFFFFF

LAUNCHES = {"quantize_tables": 0, "encode_emit": 0, "decode_tiles": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# =====================================================================
# plain PyTorch versions
# =====================================================================


def quantize_tables_ref(hist: torch.Tensor) -> torch.Tensor:
    """(R, 256) int32 symbol counts -> (R, 256) int32 cumulative table:
    c[:, 0] = 0, c[:, 255] = M, c[s] = s + cs[s]*(M-255)//tot with cs the
    cumsum of counts+1 over symbols 1..s (Laplace prior; column 0 of
    ``hist`` is unused)."""
    h = hist[:, 1:].to(torch.int64) + 1
    cs = torch.cumsum(h, dim=1)
    scaled = torch.div(cs * (M - 255), cs[:, -1:], rounding_mode="floor")
    sym = torch.arange(1, 256, dtype=torch.int64, device=hist.device)
    zero = torch.zeros(hist.shape[0], 1, dtype=torch.int64,
                       device=hist.device)
    return torch.cat([zero, sym[None, :] + scaled], dim=1).to(torch.int32)


def encode_emit_ref(f_steps: torch.Tensor, c_steps: torch.Tensor,
                    nvalid: torch.Tensor):
    """Reverse rANS emission over G steps of K lanes.

    f_steps/c_steps: (G, K) int32 frequency and cumulative start of each
    (step, lane) symbol; nvalid: (G,) int32, lanes ``< nvalid[g]`` code a
    symbol at step g.  Walks g = G-1..0 from state RANS_L: a valid lane
    whose state reaches ``f << 18`` first emits its low 16 bits, then
    codes ``x -> (x // f << 14) + x % f + c``.

    Returns (states (K,) int64 holding u32, words (G, K) int32 with the
    emitted 16-bit word or 0, flags (G, K) bool: a word was emitted)."""
    G, K = f_steps.shape
    dev = f_steps.device
    lane = torch.arange(K, dtype=torch.int64, device=dev)
    states = torch.full((K,), RANS_L, dtype=torch.int64, device=dev)
    words = torch.zeros(G, K, dtype=torch.int32, device=dev)
    flags = torch.zeros(G, K, dtype=torch.bool, device=dev)
    for g in range(G - 1, -1, -1):
        valid = lane < nvalid[g]
        f = torch.where(valid, f_steps[g].to(torch.int64), 1)
        emit = valid & (states >= (f << (32 - M_BITS)))
        x = torch.where(emit, states >> 16, states)
        q = torch.div(x, f, rounding_mode="floor")
        nxt = ((q << M_BITS) + (x - q * f) + c_steps[g]) & U32
        words[g] = torch.where(emit, states & 0xFFFF, 0).to(torch.int32)
        flags[g] = emit
        states = torch.where(valid, nxt, x)
    return states, words, flags


def _search_sym(c_flat: torch.Tensor, ctxv: torch.Tensor,
                slot: torch.Tensor) -> torch.Tensor:
    """Largest s with c[ctx][s] <= slot, as sym = s + 1 (1..255):
    branchless 8-step binary search (reference ``_search_sym``,
    octree_rans.py:164-176)."""
    base = ctxv * 256
    pos = torch.zeros_like(ctxv)
    for sh in (128, 64, 32, 16, 8, 4, 2, 1):
        cand = pos + sh
        ok = (cand <= 255) & (c_flat[base + cand.clamp(max=255)] <= slot)
        pos = torch.where(ok, cand, pos)
    return pos + 1


def decode_tiles_ref(c_flat: torch.Tensor, ctx_row: torch.Tensor,
                     words: torch.Tensor, states: torch.Tensor,
                     cursor: torch.Tensor, syms: torch.Tensor,
                     hist: torch.Tensor, count: int, t0: int,
                     ntiles: int) -> None:
    """Decode tiles t0 .. t0+ntiles-1 of one level against the frozen
    table ``c_flat`` (N_CTX*256 int32), in place.

    ctx_row: (>= (t0+ntiles)*K,) int32 context of each node of the level;
    words: (wcap,) int32 u16 word stream; states: (K,) int64 u32 lane
    states; cursor: (1,) int64 words consumed so far; syms: int32 row of
    decoded symbols (1 on invalid lanes); hist: (N_CTX*256,) int32
    histogram, +1 at ctx*256+sym per decoded symbol; count: the level's
    node count.  Lanes that need a renorm word pop it in lane order: the
    word index is the cursor plus the exclusive prefix count of the
    needing lanes, clamped to the last word (past the stream reads the
    zero padding)."""
    K = states.shape[0]
    dev = states.device
    wcap = words.shape[0]
    lane = torch.arange(K, dtype=torch.int64, device=dev)
    for t in range(t0, t0 + ntiles):
        base = t * K
        valid = lane < count - base
        ctxv = ctx_row[base:base + K].to(torch.int64)
        st0 = states
        slot = st0 & (M - 1)
        sym = _search_sym(c_flat, ctxv, slot)
        ix = ctxv * 256 + sym
        lo = c_flat[ix - 1].to(torch.int64)
        f = c_flat[ix].to(torch.int64) - lo
        st = (f * (st0 >> M_BITS) + slot - lo) & U32
        need = valid & (st < RANS_L)
        ni = need.to(torch.int64)
        nrank = torch.cumsum(ni, dim=0) - ni
        widx = (cursor + nrank).clamp_(max=wcap - 1)
        w = words[widx].to(torch.int64)
        st = torch.where(need, ((st << 16) | w) & U32, st)
        states.copy_(torch.where(valid, st, st0))
        cursor += ni.sum()
        syms[base:base + K] = torch.where(valid, sym, 1).to(torch.int32)
        hist.index_add_(0, torch.where(valid, ix, 0),
                        valid.to(torch.int32))


# =====================================================================
# kernel wrappers
# =====================================================================


def _require(name, t, dtype, device, ndim=None):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _cuda_device(t):
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for device {t.device}: pass CPU "
                         "tensors for the plain version or CUDA tensors "
                         "for the kernel")
    return t.device


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _launched(name, rc):
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1


def quantize_tables(hist: torch.Tensor) -> torch.Tensor:
    """(R, 256) int32 histogram -> (R, 256) int32 cumulative tables."""
    if hist.device.type == "cpu":
        return quantize_tables_ref(hist)
    dev = _cuda_device(hist)
    _require("hist", hist, torch.int32, dev, 2)
    if hist.shape[1] != 256:
        raise ValueError(f"hist must be (R, 256), got {tuple(hist.shape)}")
    out = torch.empty_like(hist)
    if hist.shape[0] == 0:
        return out
    lib = _kernels.load()
    with torch.cuda.device(dev):
        rc = lib.rans_quantize_tables_launch(
            hist.data_ptr(), out.data_ptr(), hist.shape[0], _stream(dev))
    _launched("quantize_tables", rc)
    return out


def encode_emit(f_steps: torch.Tensor, c_steps: torch.Tensor,
                nvalid: torch.Tensor):
    """Reverse rANS emission; see ``encode_emit_ref``."""
    if f_steps.device.type == "cpu":
        return encode_emit_ref(f_steps, c_steps, nvalid)
    dev = _cuda_device(f_steps)
    _require("f_steps", f_steps, torch.int32, dev, 2)
    _require("c_steps", c_steps, torch.int32, dev, 2)
    _require("nvalid", nvalid, torch.int32, dev, 1)
    G, K = f_steps.shape
    if c_steps.shape != f_steps.shape or nvalid.shape[0] != G:
        raise ValueError("f_steps, c_steps and nvalid disagree on (G, K)")
    states = torch.empty(K, dtype=torch.int64, device=dev)
    words = torch.empty(G, K, dtype=torch.int32, device=dev)
    flags = torch.empty(G, K, dtype=torch.bool, device=dev)
    if K == 0:
        return states, words, flags
    lib = _kernels.load()
    with torch.cuda.device(dev):
        rc = lib.rans_encode_emit_launch(
            f_steps.data_ptr(), c_steps.data_ptr(), nvalid.data_ptr(),
            states.data_ptr(), words.data_ptr(), flags.data_ptr(), G, K,
            _stream(dev))
    _launched("encode_emit", rc)
    return states, words, flags


def decode_tiles(c_flat: torch.Tensor, ctx_row: torch.Tensor,
                 words: torch.Tensor, states: torch.Tensor,
                 cursor: torch.Tensor, syms: torch.Tensor,
                 hist: torch.Tensor, count: int, t0: int,
                 ntiles: int) -> None:
    """Decode the tiles of one refresh window in place; see
    ``decode_tiles_ref``.  The kernel is one CTA of K <= 1024 threads."""
    if states.device.type == "cpu":
        return decode_tiles_ref(c_flat, ctx_row, words, states, cursor,
                                syms, hist, count, t0, ntiles)
    dev = _cuda_device(states)
    _require("c_flat", c_flat, torch.int32, dev, 1)
    _require("ctx_row", ctx_row, torch.int32, dev, 1)
    _require("words", words, torch.int32, dev, 1)
    _require("states", states, torch.int64, dev, 1)
    _require("cursor", cursor, torch.int64, dev, 1)
    _require("syms", syms, torch.int32, dev, 1)
    _require("hist", hist, torch.int32, dev, 1)
    K = states.shape[0]
    if not 0 < K <= 1024:
        raise ValueError(f"lanes must be in 1..1024, got {K}")
    end = (t0 + ntiles) * K
    if c_flat.shape[0] != N_CTX * 256 or hist.shape[0] != N_CTX * 256:
        raise ValueError("c_flat and hist must hold N_CTX*256 entries")
    if ctx_row.shape[0] < end or syms.shape[0] < end:
        raise ValueError("ctx_row/syms are shorter than the window")
    if words.shape[0] == 0 or cursor.shape[0] != 1:
        raise ValueError("words must be non-empty and cursor (1,)")
    if ntiles <= 0:
        return None
    lib = _kernels.load()
    with torch.cuda.device(dev):
        rc = lib.rans_decode_tiles_launch(
            c_flat.data_ptr(), ctx_row.data_ptr(), words.data_ptr(),
            words.shape[0], states.data_ptr(), cursor.data_ptr(),
            syms.data_ptr(), hist.data_ptr(), count, t0, ntiles, K,
            _stream(dev))
    _launched("decode_tiles", rc)
    return None
