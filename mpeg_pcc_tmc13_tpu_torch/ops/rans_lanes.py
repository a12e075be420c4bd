"""The lane loops of the on-device rANS geometry engine: counterpart of
the loops of ``mpeg_pcc_tmc13_tpu/ops/octree_rans.py`` that torch has no
primitive for.

* ``table_pass`` — the encoder's whole forward table pass: per (step,
  lane) the frequency and cumulative start of the symbol in the table of
  its refresh window, and the final histogram (``encode_device``'s
  ``table_body`` scan with ``_quantize_cfull``, octree_rans.py:144-161,
  234-261); one launch per encode,
* ``encode_emit`` — the encoder's reverse rANS emission over every
  (level, tile) step (``encode_device``'s ``while_loop``, :264-290),
* ``decode_level`` — every tile of one level of the decoder, with the
  table refreshed after each window (``decode_device``'s tile
  ``while_loop`` and its refresh ``cond``, :353-391); one launch per
  level.

A CUDA tensor launches the hand-written kernel of ``csrc/rans_lanes.cu``
(built on first use) or raises.  A CPU tensor runs the plain PyTorch
version (``*_ref``), which is also what the kernels are checked against
on the card.  Both are bit-exact integer arithmetic.  The plain versions
are the reference's composition: a full ``quantize_tables_ref`` refresh
per window around ``decode_tiles_ref``, or the encoder's loop over the
windows; the kernels refresh only the context rows that changed.

The emission kernel divides by multiply-high reciprocals;
``emit_reciprocal``, ``emit_quotient`` and ``encode_emit_mirror`` keep
that integer formula in numpy, so the CPU tests can hold it to ``//``
and to the plain version.

u32 rANS states are held in int64 tensors; the plain versions mask
with ``0xFFFFFFFF`` where the reference's uint32 arithmetic would wrap.

``_kernels.LAUNCHES`` counts kernel launches per kernel (a launch adds
one, the plain versions add nothing), so a run can show it went through
them.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _kernels

M_BITS = 14
M = 1 << M_BITS                 # probability precision
RANS_L = 1 << 16                # state lower bound
N_CTX = 2048                    # child_idx(3b) << 8 | parent_occupancy
U32 = 0xFFFFFFFF
UPD_TILES = 4                   # tiles of K symbols between table refreshes
EMIT_TABLE = M + 4              # the emission kernel's magic numbers, padded

def _ceil_div(a, b):
    return (a + b - 1) // b


def windows(counts, K: int):
    """The refresh windows of the (level, tile) schedule, in coding
    order: tuples (level, first tile t0, tiles nt, global step g0 of tile
    t0).  A window is up to UPD_TILES tiles of one level; a refresh
    happens when the tile index within the level is a multiple of
    UPD_TILES."""
    g = 0
    out = []
    for l, cnt in enumerate(counts):
        T = _ceil_div(int(cnt), K)
        for t0 in range(0, T, UPD_TILES):
            out.append((l, t0, min(UPD_TILES, T - t0), g + t0))
        g += T
    return out


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


def table_pass_ref(occ2: torch.Tensor, ctx2: torch.Tensor, counts,
                   K: int):
    """Forward table pass over the refresh windows in coding order.

    occ2/ctx2: (depth, nmax) int32 occupancy symbols and contexts of
    each level's nodes; counts: the per-level node counts (host ints).
    Each window requantises the whole table from the histogram of every
    earlier symbol, looks up its own symbols, then counts them.

    Returns (f_steps (G, K) int32, c_steps (G, K) int32: per (step,
    lane) the symbol's frequency and cumulative start, f=1 and c=0 on
    invalid lanes; hist (N_CTX, 256) int32 after the last symbol)."""
    dev = occ2.device
    nmax = occ2.shape[1]
    G = sum(_ceil_div(int(c), K) for c in counts)
    f_steps = torch.empty(G, K, dtype=torch.int32, device=dev)
    c_steps = torch.empty(G, K, dtype=torch.int32, device=dev)
    hist = torch.zeros(N_CTX * 256, dtype=torch.int32, device=dev)
    pad = _ceil_div(nmax, K) * K - nmax      # the last tile's tail
    occF = torch.nn.functional.pad(occ2, (0, pad), value=1)
    ctxF = torch.nn.functional.pad(ctx2, (0, pad))
    lane = torch.arange(UPD_TILES * K, dtype=torch.int64, device=dev)
    for l, t0, nt, g0 in windows(counts, K):
        c_flat = quantize_tables_ref(hist.view(N_CTX, 256)).reshape(-1)
        n = nt * K
        sym = occF[l, t0 * K:t0 * K + n].to(torch.int64)
        ctxv = ctxF[l, t0 * K:t0 * K + n].to(torch.int64)
        valid = lane[:n] < int(counts[l]) - t0 * K
        ix = ctxv * 256 + sym
        lo = c_flat[ix - 1]
        f_steps[g0:g0 + nt] = torch.where(valid, c_flat[ix] - lo, 1) \
            .view(nt, K)
        c_steps[g0:g0 + nt] = torch.where(valid, lo, 0).view(nt, K)
        hist.index_add_(0, torch.where(valid, ix, 0),
                        valid.to(torch.int32))
    return f_steps, c_steps, hist.view(N_CTX, 256)


def table_pass_groups(occ2: torch.Tensor, ctx2: torch.Tensor, counts,
                      K: int):
    """The table pass's valid symbols grouped by context row, the
    kernel's input.

    Every valid symbol (level l, node i < counts[l]) is tagged with its
    (step, lane) slot ``g*K + lane`` (= the level's first step times K,
    plus i) and its global refresh-window index, then the symbols are
    sorted by context, stably, so each row keeps coding order (and so
    window order).  Returns (sym, win, pos (n,) int32, row_off (N_CTX+1,)
    int32: row r holds [row_off[r], row_off[r+1])).  Only host-known
    sizes, so a CUDA graph can capture it."""
    dev = occ2.device
    syms, ctxs, pos, win = [], [], [], []
    for w, (l, t0, _, g) in enumerate(windows(counts, K)):
        if t0:
            continue
        # a level's first window: the level's symbols lie in windows
        # w, w+1, ... from step g on
        n = int(counts[l])
        i = torch.arange(n, dtype=torch.int32, device=dev)
        syms.append(occ2[l, :n])
        ctxs.append(ctx2[l, :n])
        pos.append(i + g * K)
        win.append(torch.div(i, UPD_TILES * K, rounding_mode="floor") + w)
    if not syms:
        empty = torch.zeros(0, dtype=torch.int32, device=dev)
        return (empty, empty, empty,
                torch.zeros(N_CTX + 1, dtype=torch.int32, device=dev))
    ctx_sorted, order = torch.sort(torch.cat(ctxs), stable=True)
    row_off = torch.searchsorted(
        ctx_sorted, torch.arange(N_CTX + 1, dtype=torch.int32, device=dev))
    return (torch.cat(syms)[order], torch.cat(win)[order],
            torch.cat(pos)[order], row_off.to(torch.int32))


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


def emit_reciprocal(f):
    """The emission kernel's division-free quotient, its integer formula
    in numpy: for frequencies ``f`` in 1..M returns uint64 arrays
    (m, inc, sh) with ``x // f == ((m * (x + inc)) >> 32) >> sh`` for
    every x < 2^32 (``emit_quotient``).

    For f >= 2: sh = ceil(log2 f) - 1, N = 32 + sh, m_d = 2^N // f and
    e = 2^N - m_d * f.  e = 0 keeps m_d; 0 < e <= 2^sh keeps m_d and
    multiplies x + 1 (the round-down magic number); a larger e takes
    m_d + 1 (the round-up one, whose excess f - e is below 2^sh).  f = 1
    takes m = 2^32 - 1 on x + 1.  The argument for exactness stands at
    ``emit_prep`` in ``csrc/rans_lanes.cu``."""
    f = np.asarray(f, dtype=np.uint64)
    if f.size and (f.min() < 1 or f.max() > M):
        raise ValueError(f"frequencies must lie in 1..{M}")
    one = np.uint64(1)
    # bit_length(f - 1) - 1; frexp's exponent of an integer is its length
    sh = (np.frexp((np.maximum(f, 2) - one).astype(np.float64))[1] - 1) \
        .astype(np.uint64)
    two_n = one << (np.uint64(32) + sh)
    m = two_n // f
    e = two_n - m * f
    up = e > (one << sh)
    inc = ((e != 0) & ~up).astype(np.uint64)
    m = m + up.astype(np.uint64)
    is1 = f == 1
    return (np.where(is1, np.uint64(U32), m), np.where(is1, one, inc),
            np.where(is1, np.uint64(0), sh))


def emit_quotient(x, m, inc, sh):
    """``x // f`` from ``emit_reciprocal(f)``: a multiply, its high
    word, a shift (uint64 arrays; x < 2^32).  The kernel adds ``inc`` in
    32 bits, which the x of its loop (below ``f << 18``) cannot wrap."""
    x = np.asarray(x, dtype=np.uint64)
    return ((m * (x + inc)) >> np.uint64(32)) >> sh


def encode_emit_mirror(f_steps, c_steps, nvalid):
    """The emission kernel's arithmetic in numpy, for the CPU tests:
    per (step, lane) the parameters the kernel prepares off the chain
    (reciprocal, threshold ``(f << 18) - 1``, multiplier ``M - f``; an
    invalid lane gets a step that is the identity and never emits), then
    the chain ``xi + (c - inc) + (x // f) * (M - f)`` mod 2^32 on them,
    ``xi = x + inc`` being what the reciprocal multiplies.  Takes
    and returns numpy arrays shaped and typed as ``encode_emit_ref``'s
    tensors."""
    f_steps = np.asarray(f_steps, dtype=np.int64)
    G, K = f_steps.shape
    valid = np.arange(K)[None, :] < np.asarray(nvalid)[:, None]
    f = np.where(valid, f_steps, 1).astype(np.uint64)
    m, inc, sh = emit_reciprocal(f)
    mask = np.uint64(U32)
    m = np.where(valid, m, 0)
    thr = np.where(valid, ((f << np.uint64(18)) - np.uint64(1)) & mask, mask)
    c = np.where(valid, np.asarray(c_steps, dtype=np.int64), 0) \
        .astype(np.uint64) & mask
    mul = np.where(valid, np.uint64(M) - f, 0)
    inc = np.where(valid, inc, 0)
    cz = (c - inc) & mask                   # the kernel's c - inc
    s = np.full(K, RANS_L, dtype=np.uint64)
    words = np.zeros((G, K), dtype=np.int32)
    flags = np.zeros((G, K), dtype=bool)
    for g in range(G - 1, -1, -1):
        emit = s > thr[g]
        xi = np.where(emit, s >> np.uint64(16), s) + inc[g]
        q = ((m[g] * xi) >> np.uint64(32)) >> sh[g]
        words[g] = np.where(emit, s & np.uint64(0xFFFF), 0)
        flags[g] = emit
        s = (q * mul[g] + xi + cz[g]) & mask
    return s.astype(np.int64), words, flags


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


def decode_level_ref(c_flat: torch.Tensor, ctx_row: torch.Tensor,
                     words: torch.Tensor, states: torch.Tensor,
                     cursor: torch.Tensor, syms: torch.Tensor,
                     hist: torch.Tensor, count: int) -> None:
    """Decode every tile of one level in place, the table ``c_flat``
    (N_CTX*256 int32) current on entry and on exit: per refresh window
    of UPD_TILES tiles ``decode_tiles_ref`` against the frozen table,
    then the whole table requantised from ``hist``.  Arguments as in
    ``decode_tiles_ref``."""
    K = states.shape[0]
    T = _ceil_div(int(count), K)
    for t0 in range(0, T, UPD_TILES):
        decode_tiles_ref(c_flat, ctx_row, words, states, cursor, syms,
                         hist, count, t0, min(UPD_TILES, T - t0))
        c_flat.copy_(quantize_tables_ref(hist.view(N_CTX, 256)).view(-1))


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


def table_pass(occ2: torch.Tensor, ctx2: torch.Tensor, counts, K: int):
    """The encoder's forward table pass; see ``table_pass_ref``.  The
    kernel runs one CTA per context row over ``table_pass_groups``, each
    row's table requantised only at the windows that touch it."""
    if occ2.device.type == "cpu":
        return table_pass_ref(occ2, ctx2, counts, K)
    dev = _cuda_device(occ2)
    _require("occ2", occ2, torch.int32, dev, 2)
    _require("ctx2", ctx2, torch.int32, dev, 2)
    if ctx2.shape != occ2.shape or len(counts) != occ2.shape[0]:
        raise ValueError("occ2, ctx2 and counts disagree on (depth, nmax)")
    if K <= 0 or any(not 0 <= int(c) <= occ2.shape[1] for c in counts):
        raise ValueError("counts must lie in 0..nmax and K be positive")
    G = sum(_ceil_div(int(c), K) for c in counts)
    if G * K >= 1 << 31:
        raise ValueError(f"{G} steps of {K} lanes overflow int32 slots")
    f_steps = torch.ones(G, K, dtype=torch.int32, device=dev)
    c_steps = torch.zeros(G, K, dtype=torch.int32, device=dev)
    hist = torch.empty(N_CTX, 256, dtype=torch.int32, device=dev)
    sym, win, pos, row_off = table_pass_groups(occ2, ctx2, counts, K)
    lib = _kernels.load()
    with torch.cuda.device(dev):
        rc = lib.rans_table_pass_launch(
            sym.data_ptr(), win.data_ptr(), pos.data_ptr(),
            row_off.data_ptr(), f_steps.data_ptr(), c_steps.data_ptr(),
            hist.data_ptr(), _stream(dev))
    _kernels.launched("table_pass", rc)
    return f_steps, c_steps, hist


def encode_emit(f_steps: torch.Tensor, c_steps: torch.Tensor,
                nvalid: torch.Tensor):
    """Reverse rANS emission; see ``encode_emit_ref``.  The kernel gives
    every 32 lanes a block of three warps: two stage f and c into shared
    memory slabs ahead of the state and turn each step's division into a
    multiply-high reciprocal (``emit_reciprocal`` is its formula; the
    launch tabulates it for every frequency first), the third runs the
    lanes' chains on those parameters alone, so a chain reads no global
    memory and divides nothing.  Frequencies of valid lanes must lie in
    1..M, and (G + 8) * K must fit an int32."""
    if f_steps.device.type == "cpu":
        return encode_emit_ref(f_steps, c_steps, nvalid)
    dev = _cuda_device(f_steps)
    _require("f_steps", f_steps, torch.int32, dev, 2)
    _require("c_steps", c_steps, torch.int32, dev, 2)
    _require("nvalid", nvalid, torch.int32, dev, 1)
    G, K = f_steps.shape
    if c_steps.shape != f_steps.shape or nvalid.shape[0] != G:
        raise ValueError("f_steps, c_steps and nvalid disagree on (G, K)")
    if (G + 8) * K >= 1 << 31:
        raise ValueError(f"{G} steps of {K} lanes overflow int32 slots")
    states = torch.empty(K, dtype=torch.int64, device=dev)
    words = torch.empty(G, K, dtype=torch.int32, device=dev)
    flags = torch.empty(G, K, dtype=torch.bool, device=dev)
    if K == 0:
        return states, words, flags
    # the kernel's scratch: the magic number of every frequency 0..M
    magic = torch.empty(EMIT_TABLE, dtype=torch.int32, device=dev)
    lib = _kernels.load()
    with torch.cuda.device(dev):
        rc = lib.rans_encode_emit_launch(
            f_steps.data_ptr(), c_steps.data_ptr(), nvalid.data_ptr(),
            magic.data_ptr(), states.data_ptr(), words.data_ptr(),
            flags.data_ptr(), G, K, _stream(dev))
    _kernels.launched("encode_emit", rc)
    return states, words, flags


def decode_level(c_flat: torch.Tensor, ctx_row: torch.Tensor,
                 words: torch.Tensor, states: torch.Tensor,
                 cursor: torch.Tensor, syms: torch.Tensor,
                 hist: torch.Tensor, count: int) -> None:
    """Decode every tile of one level in place; see ``decode_level_ref``.
    The kernel runs one cluster of 16 CTAs: the lead (K <= 1024 threads)
    decodes the tiles, the others hold the histogram and the table of
    their context rows and refresh, after each window, the rows it
    touched."""
    if states.device.type == "cpu":
        return decode_level_ref(c_flat, ctx_row, words, states, cursor,
                                syms, hist, count)
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
    end = _ceil_div(int(count), K) * K
    if c_flat.shape[0] != N_CTX * 256 or hist.shape[0] != N_CTX * 256:
        raise ValueError("c_flat and hist must hold N_CTX*256 entries")
    if ctx_row.shape[0] < end or syms.shape[0] < end:
        raise ValueError("ctx_row/syms are shorter than the level's tiles")
    if words.shape[0] == 0 or cursor.shape[0] != 1:
        raise ValueError("words must be non-empty and cursor (1,)")
    if count <= 0:
        return None
    # the kernel's scratch: one window's symbols, lead to owners
    wsyms = torch.empty(UPD_TILES * 1024, dtype=torch.int32, device=dev)
    lib = _kernels.load()
    with torch.cuda.device(dev):
        rc = lib.rans_decode_level_launch(
            c_flat.data_ptr(), hist.data_ptr(), wsyms.data_ptr(),
            ctx_row.data_ptr(), words.data_ptr(), words.shape[0],
            states.data_ptr(), cursor.data_ptr(), syms.data_ptr(), int(count),
            K, _stream(dev))
    _kernels.launched("decode_level", rc)
    return None


def emit_magic_table(device) -> torch.Tensor:
    """The table the emission kernel builds at each launch, alone:
    (M + 1,) int64 with, at f >= 1, ``emit_reciprocal(f)``'s m with its
    top bit (always set) replaced by inc; entry 0 is unused.  For
    holding the kernel's double-division route to the integer formula
    on the card; it counts no launch."""
    dev = _cuda_device(torch.empty(0, device=device))
    magic = torch.empty(EMIT_TABLE, dtype=torch.int32, device=dev)
    lib = _kernels.load()
    with torch.cuda.device(dev):
        rc = lib.rans_emit_table_launch(magic.data_ptr(), _stream(dev))
    _kernels.launched("rans_emit_table", rc, 0)
    return magic[:M + 1].to(torch.int64) & U32


def emit_chain_probe(device, f: int = 1000, c: int = 5000,
                     nsteps: int = 1 << 18):
    """Time the emission kernel's chain alone on the card: one warp
    runs ``nsteps`` (a multiple of 16) dependent steps on register
    parameters of a symbol (f, c).  Returns (SM cycles a step,
    nanoseconds a step): what floors ``encode_emit`` per step.  A
    measurement, not a kernel of the codec: it counts no launch."""
    dev = _cuda_device(torch.empty(0, device=device))
    out = torch.zeros(3, dtype=torch.int64, device=dev)
    lib = _kernels.load()
    with torch.cuda.device(dev):
        rc = lib.rans_emit_chain_probe_launch(f, c, nsteps, out.data_ptr(),
                                              _stream(dev))
    _kernels.launched("rans_emit_chain_probe", rc, 0)
    cycles, ns, _ = out.tolist()
    return cycles / nsteps, ns / nsteps
