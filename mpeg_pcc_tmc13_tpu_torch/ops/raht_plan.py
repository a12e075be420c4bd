"""The RAHT card plan: a frame's per-level structure and its format, for
both closed loops that run over it, the fixed-point one
(``ops/raht_fp_device.py``, kernels of ``csrc/raht_fp_loop.cu``) and
the float one (``ops/raht_float_device.py``, ``csrc/raht_float_loop.cu``).

``build_plan`` builds it from a frame's sorted leaf codes on their
device: on a CUDA tensor the three launches of ``csrc/raht_fp_plan.cu``
and one host read of the counts, on a CPU tensor their plain version
``build_plan_ref``.  Either gives a ``FramePlan``: per level, finest
first, a dict of tensors (block gathers, Q15 butterfly coefficients,
pair masks, coded-order compaction indices, 18-neighbour tables, sqrt
scales, prediction gates) and each stage's row offsets, every tensor
equal to the host spec's (``raht_fp_device.build_fp_plan`` with
``plans_to_torch`` and ``row_offsets``).

The format lives here alone: the keys and the order in which each
kernel family reads them (``kernel_plan``, ``float_kernel_plan``, and
their pointer packing), the coded order of a frame's q rows
(``FramePlan.coded_rows``), the bits of ``NBR_OCTANTS``.  So do the
kernels' integer square root and division, mirrored in plain torch
(``isqrt64_dev``, ``fdiv_mirror``), which the planner's plain version
and the group kernel's mirror share.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from . import _kernels, raht_fp
from .raht import _NBR_OFFSETS, _TOUCH_TABLE

_I64 = torch.int64


# ---------------------------------------------------------------------
# the kernels' integer arithmetic, in plain torch
# ---------------------------------------------------------------------

# the bound of the kernels' fast division's numerators and divisors
# (csrc/raht_fp_loop.cu and csrc/raht_fp_plan.cu: kFastLim)
FAST_DIV_LIMIT = 1 << 51


def isqrt64_dev(x: torch.Tensor) -> torch.Tensor:
    """floor(sqrt(x)) of int64 x, identical to ``raht_fp.isqrt64``: a
    float64 seed truncated, then two integer corrections (reference
    ``isqrt64_dev``, ops/raht_fp_device.py:292-300)."""
    y = torch.sqrt(x.to(torch.float64)).to(_I64)
    for _ in range(2):
        y = torch.where((y + 1) * (y + 1) <= x, y + 1, y)
        y = torch.where(y * y > x, y - 1, y)
    return y.clamp(min=0)


def floordiv_mirror(a, b):
    """The kernels' ``floordiv``: C's truncating quotient, one less where
    the remainder is non-zero and its sign differs from the divisor's
    (b > 0 here, so: a negative numerator with a remainder)."""
    q = torch.div(a, b, rounding_mode="trunc")
    r = a - q * b
    return q - ((r != 0) & ((r < 0) != (b < 0))).to(_I64)


def fast_rcp_mirror(d):
    """The kernels' ``fast_rcp``: float64 1 / d (IEEE, correctly
    rounded) where 1 <= d <= ``FAST_DIV_LIMIT``, else 0 (the general
    path)."""
    ok = (d >= 1) & (d <= FAST_DIV_LIMIT)
    return torch.where(ok, 1.0 / torch.where(ok, d, 1).to(torch.float64),
                       0.0)


def fdiv_mirror(a, d, r, count=None, use=None):
    """The kernels' ``fdiv``: floor(a / d) for d >= 1 with r =
    ``fast_rcp_mirror(d)``.  Fast path where r != 0 and |a| <= 2^51: the
    float64 product a * r (round to nearest), floored, then one step
    against the remainder a - q d; elsewhere ``floordiv_mirror`` on int64
    (the general path).  ``count``: a (2,) int64 tensor that the fast and
    general divisions among ``use`` (default: all) are added to."""
    a, d, r = torch.broadcast_tensors(a, d, r)
    fast = (r != 0) & (a >= -FAST_DIV_LIMIT) & (a <= FAST_DIV_LIMIT)
    af = torch.where(fast, a, 0)
    df = torch.where(fast, d, 1)
    q = torch.floor(af.to(torch.float64) * r).to(_I64)
    rem = af - q * df
    q = q - (rem < 0).to(_I64) + (rem >= df).to(_I64)
    gen = floordiv_mirror(torch.where(fast, 0, a), torch.where(fast, 1, d))
    if count is not None:
        use = torch.ones_like(fast) if use is None else use
        count[0] += (fast & use).sum()
        count[1] += (~fast & use).sum()
    return torch.where(fast, q, gen)


# ---------------------------------------------------------------------
# the plan's format
# ---------------------------------------------------------------------

# each stage's coded-order compaction index and its pairs a block
FLAT_KEYS = (("flat_z", 4), ("flat_y", 2), ("flat_x", 1))
# the plan tensors a fixed-point kernel reads, in the launcher's pointer
# order: the butterflies' (what the truth kernel reads), the row offsets
# (``row_offsets``), the prediction's
BUTTERFLY_KEYS = ("blk_gather", "az", "bz", "vz", "sz", "ay", "by", "vy",
                  "sy", "ax", "bx", "vx", "sx")
PREDICTION_KEYS = ("sw_p", "sw_c", "nbr_idx", "nbr_ok", "en_base", "cnt_p")
PLAN_NAMES = BUTTERFLY_KEYS + ("off_z", "off_y", "off_x") + PREDICTION_KEYS
# bit o of entry j: neighbour offset j touches octant o
NBR_OCTANTS = tuple(int(sum(1 << o for o in range(8) if _TOUCH_TABLE[o, j]))
                    for j in range(_TOUCH_TABLE.shape[1]))


def row_offsets(p):
    """(off_z, off_y, off_x), each (mp,) int64: the zrow row of each
    block's first valid pair of a stage, i.e. the valid pairs of the
    blocks before it (``flat_z`` etc. list the pairs in that order)."""
    out = []
    for k, width in (("vz", 4), ("vy", 2), ("vx", 1)):
        per = p[k].reshape(-1, width).sum(dim=1, dtype=_I64)
        out.append(torch.cumsum(per, 0) - per)
    return tuple(out)


def kernel_plan(p, offsets):
    """The 22 tensors a fixed-point kernel reads, in the launcher's
    pointer order (``PLAN_NAMES``)."""
    return ([p[k] for k in BUTTERFLY_KEYS] + list(offsets)
            + [p[k] for k in PREDICTION_KEYS])


def float_kernel_plan(p, offsets):
    """The 7 tensors a float kernel reads (csrc/raht_float_loop.cu's
    ``plan_from``), in its pointer order."""
    return [p["blk_gather"], *offsets, p["nbr_idx"], p["nbr_ok"],
            p["en_base"]]


def _contiguous_ptrs(ts):
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("a plan tensor is not contiguous")
    return _kernels.ptrs(ts)


def plan_ptrs(p, offsets):
    """``kernel_plan``'s pointers for a launcher that reads them in
    place."""
    return _contiguous_ptrs(kernel_plan(p, offsets))


def staged_plan_ptrs(p, offsets):
    """``kernel_plan``'s pointers for the group kernel, which stages each
    plan tensor with 16-byte copies: a tensor not on 16 bytes is copied
    (``_kernels.aligned``)."""
    return _kernels.ptrs([_kernels.aligned(t)
                          for t in kernel_plan(p, offsets)])


def float_plan_ptrs(p, offsets):
    """``float_kernel_plan``'s pointers."""
    return _contiguous_ptrs(float_kernel_plan(p, offsets))


class CodedRows(NamedTuple):
    """A frame's q rows in coded order as slices of one (total, C)
    buffer: ``root``, the roots' rows, then ``levels``, per coded level
    (coarsest first) its z, y, x slices, the three contiguous."""
    total: int
    root: slice
    levels: list

    def slices(self):
        """Every slice in coded order: the root's, then each level's z,
        y, x."""
        return [self.root] + [s for lv in self.levels for s in lv]


class FramePlan(NamedTuple):
    """A frame's plan: ``plans``, finest level first, each a dict of the
    keys and tensors ``plans_to_torch`` gives; ``offsets``, each plan's
    ``row_offsets``; ``pair_counts``, (nz, ny, nx) a plan; ``n_roots``."""
    plans: list
    offsets: list
    pair_counts: list
    n_roots: int

    def coded_rows(self) -> CodedRows:
        """Where each q row of the frame lies in coded order: the roots,
        then the levels from the coarsest (the last plan) down."""
        bounds = [self.n_roots] + [n for counts in reversed(self.pair_counts)
                                   for n in counts]
        edges = np.cumsum([0] + bounds).tolist()
        cuts = [slice(a, b) for a, b in zip(edges[:-1], edges[1:])]
        return CodedRows(edges[-1], cuts[0],
                         [tuple(cuts[1 + 3 * gi:4 + 3 * gi])
                          for gi in range(len(self.pair_counts))])


# ---------------------------------------------------------------------
# the planner (csrc/raht_fp_plan.cu) and its plain version
# ---------------------------------------------------------------------

# the kernels' buffers in their launcher's pointer order (csrc/
# raht_fp_plan.cu: Buf): name, rows ("c": a level's children, "b": its
# parent blocks, "z", "y", "x": its pairs of that stage), width, bool.
# Each holds every level; a name starting with "_" is the kernels' own.
CARD_BUFS = (
    ("pidx", "c", 1, False), ("oct", "c", 1, False), ("sw_c", "c", 1, False),
    ("_ls", "c", 1, False),
    ("blk_gather", "b", 8, False), ("az", "b", 4, False),
    ("bz", "b", 4, False), ("vz", "b", 4, True), ("sz", "b", 4, False),
    ("ay", "b", 2, False), ("by", "b", 2, False), ("vy", "b", 2, True),
    ("sy", "b", 2, False), ("ax", "b", 1, False), ("bx", "b", 1, False),
    ("vx", "b", 1, True), ("sx", "b", 1, False), ("sw_p", "b", 1, False),
    ("off_z", "b", 1, False), ("off_y", "b", 1, False),
    ("off_x", "b", 1, False), ("nbr_idx", "b", 18, False),
    ("nbr_ok", "b", 18, True), ("cnt_p", "b", 1, False),
    ("en_base", "b", 1, True), ("_cstart", "b", 1, False),
    ("_pc", "b", 1, False),
    ("flat_z", "z", 1, False), ("flat_y", "y", 1, False),
    ("flat_x", "x", 1, False),
)
# the deepest tree of 63-bit Morton codes (csrc/raht_fp_plan.cu:
# kMaxDepth), and the rows each level's view starts on a multiple of
PLAN_MAX_DEPTH = 21
PLAN_ROW_ALIGN = 16


def _check_plan_codes(codes, depth):
    if codes.dtype != _I64 or codes.dim() != 1:
        raise TypeError(f"need (N,) int64 codes, got {codes.dtype} "
                        f"{tuple(codes.shape)}")
    if not 0 <= depth <= PLAN_MAX_DEPTH:
        raise ValueError(f"depth {depth} outside [0, {PLAN_MAX_DEPTH}]")


def _unsorted(what):
    return ValueError(f"the planner needs distinct non-negative leaf codes "
                      f"in increasing order ({what})")


def _msb_ref(x):
    """floor(log2(x)) of int64 x >= 1 (the kernel's 63 - clz)."""
    r = torch.zeros_like(x)
    for s in (32, 16, 8, 4, 2, 1):
        big = (x >> s) > 0
        r = r + big.to(_I64) * s
        x = torch.where(big, x >> s, x)
    return r


def _stage_ref(w):
    """One stage's pairs from its (mp, 2k) cell weights, with the
    kernel's division: (a, b, valid, single source, merged weights)."""
    w0, w1 = w[:, 0::2], w[:, 1::2]
    ws = (w0 + w1).clamp(min=1)
    r = fast_rcp_mirror(ws)
    a = isqrt64_dev(fdiv_mirror(w0 << 30, ws, r))
    b = isqrt64_dev(fdiv_mirror(w1 << 30, ws, r))
    s = torch.where(w0 > 0, 0, torch.where(w1 > 0, 1, -1))
    return a, b, (w0 > 0) & (w1 > 0), s, w0 + w1


# raht.py's per-axis Morton masks and units, in (dx, dy, dz) order
_AXES = tuple((0x1249249249249249 << (2 - a), 1 << (2 - a)) for a in range(3))


def _neighbours_ref(pc, level_dims):
    """``_offset_neighbor_codes`` in torch: (mp, 18) lower-bound rows of
    the 18 masked Morton steps of the sorted codes ``pc`` and their hits.
    (c | ~mask) is negative and (c & mask) non-negative, so no step
    overflows int64."""
    mp = pc.numel()
    if mp == 0:
        return (pc.new_zeros(0, len(_NBR_OFFSETS)),
                torch.zeros(0, len(_NBR_OFFSETS), dtype=torch.bool,
                            device=pc.device))
    bits = min(3 * max(level_dims, 0), 62)
    outside = ~((1 << bits) - 1)
    codes, oks = [], []
    for off in _NBR_OFFSETS:
        c = pc
        ok = torch.ones_like(pc, dtype=torch.bool)
        for d, (mask, unit) in zip(off, _AXES):
            if d > 0:
                c = (((c | ~mask) + unit) & mask) | (c & ~mask)
                ok = ok & ((c & outside) == 0)
            elif d < 0:
                ok = ok & ((c & mask) != 0)
                c = (((c & mask) - unit) & mask) | (c & ~mask)
        codes.append(c)
        oks.append(ok)
    nc = torch.stack(codes, 1)
    idx = torch.searchsorted(pc, nc).clamp(max=mp - 1)
    return idx, torch.stack(oks, 1) & (pc[idx] == nc)


def build_plan_ref(codes: torch.Tensor, depth: int,
                   t1: int = raht_fp._PRED_T1) -> FramePlan:
    """Plain version of ``build_plan``: the passes of
    ``csrc/raht_fp_plan.cu`` as PyTorch ops on ``codes`` (N,) int64,
    distinct and increasing, on any device.  Leaf i > 0 first differs
    from leaf i - 1 at bit m: it opens a node at every level g <= h =
    min(m / 3, depth) (leaf 0 at all) and closes one butterfly pair, at
    level m / 3 and stage m % 3 (count); ranks among those leaves give
    every row (scatter); each parent block then takes its children's
    weights, coefficients and neighbours (blocks)."""
    _check_plan_codes(codes, depth)
    n = codes.numel()
    if n and (codes[0] < 0 or bool((codes[1:] <= codes[:-1]).any())):
        raise _unsorted("plain version")
    if depth == 0:
        return FramePlan([], [], [], n)
    m = torch.full((n,), -1, dtype=_I64, device=codes.device)
    if n > 1:
        m[1:] = _msb_ref(codes[1:] ^ codes[:-1])
    h = torch.clamp(torch.div(m, 3, rounding_mode="floor"), max=depth)
    h[:1] = depth
    opens = [h >= g for g in range(depth + 1)]
    first = [torch.nonzero(o).flatten() for o in opens]   # nodes' 1st leaf
    plans, offsets, pair_counts = [], [], []
    for g in range(depth):
        ls, lp = first[g], first[g + 1]
        mc, mp = ls.numel(), lp.numel()
        upto = torch.cumsum(opens[g + 1].to(_I64), 0)   # parents opened
        pidx = upto[ls] - 1
        oct_ = (codes[ls] >> (3 * g)) & 7
        p = {"pidx": pidx, "oct": oct_}
        offs = []
        for st, ((key, width), shift) in enumerate(zip(FLAT_KEYS,
                                                       (1, 2, 3))):
            closes = (m == 3 * g + st).to(_I64)
            offs.append((torch.cumsum(closes, 0) - closes)[lp])
            at = torch.nonzero(closes).flatten()
            p[key] = (upto[at] - 1) * width + \
                (((codes[at] >> (3 * g)) & 7) >> shift)
        w = torch.diff(ls, append=ls.new_full((1,), n))
        gather = torch.full((mp, 8), -1, dtype=_I64, device=codes.device)
        gather[pidx, oct_] = torch.arange(mc, dtype=_I64,
                                          device=codes.device)
        blk_w = torch.where(gather >= 0, w[gather.clamp(min=0)], 0)
        p["az"], p["bz"], p["vz"], p["sz"], wz = _stage_ref(blk_w)
        p["ay"], p["by"], p["vy"], p["sy"], wy = _stage_ref(wz)
        ax, bx, vx, sx, wx = _stage_ref(wy)
        p.update(ax=ax[:, 0], bx=bx[:, 0], vx=vx[:, 0], sx=sx[:, 0],
                 blk_gather=gather, sw_c=isqrt64_dev(w << 30),
                 sw_p=isqrt64_dev(wx[:, 0] << 30))
        p["nbr_idx"], p["nbr_ok"] = _neighbours_ref(
            codes[lp] >> (3 * (g + 1)), depth - 1 - g)
        p["cnt_p"] = 1 + p["nbr_ok"].sum(dim=1)
        p["en_base"] = p["cnt_p"] >= t1
        plans.append(p)
        offsets.append(tuple(offs))
        pair_counts.append(tuple(p[k].numel() for k, _ in FLAT_KEYS))
    return FramePlan(plans, offsets, pair_counts, first[depth].numel())


def _row_bases(rows):
    """Each level's first row, every level starting on a multiple of
    ``PLAN_ROW_ALIGN`` rows, and the rows of all."""
    padded = [-(-r // PLAN_ROW_ALIGN) * PLAN_ROW_ALIGN for r in rows]
    ends = np.cumsum([0] + padded).tolist()
    return ends[:-1], ends[-1]


def _plan_kernels(codes, depth, t1):
    """``build_plan`` on a CUDA tensor: three launches, one host read of
    the counts."""
    dev, n = codes.device, codes.numel()
    nv = 4 * depth + 1
    lib = _kernels.load()
    stream = _kernels.stream(codes)
    if n:
        scratch = torch.empty(lib.raht_fp_plan_scratch_words(n, depth),
                              dtype=_I64, device=dev)
        with torch.cuda.device(dev):
            rc = lib.raht_fp_plan_count_launch(codes.data_ptr(), n, depth,
                                               scratch.data_ptr(), stream)
        _kernels.launched("raht_fp_plan", rc)
        fault, *tot = scratch[1:2 + nv].tolist()   # the one synchronisation
        if fault:
            raise _unsorted("card")
    else:
        tot = [0] * nv
    nodes = tot[:depth + 1]
    pair_counts = [tuple(tot[depth + 1 + 3 * g:depth + 4 + 3 * g])
                   for g in range(depth)]
    rows = {"c": nodes[:depth], "b": nodes[1:]}
    rows.update({k: [pc[s] for pc in pair_counts]
                 for s, k in enumerate("zyx")})
    bases = {k: _row_bases(r) for k, r in rows.items()}
    bufs = [torch.empty((bases[kind][1], w) if w > 1 else bases[kind][1],
                        dtype=torch.bool if flag else _I64, device=dev)
            for _, kind, w, flag in CARD_BUFS]
    if n:
        pad = PLAN_MAX_DEPTH - depth
        blk0 = np.cumsum([0] + nodes[1:]).tolist()
        layout = (nodes + [0] * pad
                  + [x for k in "cbzyx" for x in bases[k][0] + [0] * pad]
                  + blk0 + [blk0[-1]] * pad)
        with torch.cuda.device(dev):
            rc = lib.raht_fp_plan_build_launch(
                codes.data_ptr(), n, depth, t1, scratch.data_ptr(),
                _kernels.ptrs(bufs), (ctypes.c_int64 * len(layout))(*layout),
                stream)
        _kernels.launched("raht_fp_plan", rc, 2)
    plans, offsets = [], []
    for g in range(depth):
        p = {}
        for (name, kind, _, _), buf in zip(CARD_BUFS, bufs):
            if name[0] != "_":
                base = bases[kind][0][g]
                p[name] = buf[base:base + rows[kind][g]]
        offsets.append((p.pop("off_z"), p.pop("off_y"), p.pop("off_x")))
        plans.append(p)
    return FramePlan(plans, offsets, pair_counts, nodes[depth])


def build_plan(codes: torch.Tensor, depth: int,
               t1: int = raht_fp._PRED_T1) -> FramePlan:
    """The frame's plan from its leaf codes ``codes`` (N,) int64, distinct
    and increasing, at ``depth`` <= 21: every tensor equal to
    ``plans_to_torch(build_fp_plan(...))`` and ``row_offsets``, and the
    counts the loops need, on the codes' device.  A CUDA tensor launches
    the three passes of ``csrc/raht_fp_plan.cu`` (counting, one host
    read of the counts, scatter, blocks; every tensor 16-byte aligned)
    or raises; a CPU tensor runs ``build_plan_ref``.  Codes out of order,
    repeated or negative raise ``ValueError``."""
    if not _kernels.on_card(codes):
        return build_plan_ref(codes, depth, t1)
    _check_plan_codes(codes, depth)
    if depth == 0:
        return FramePlan([], [], [], codes.numel())
    return _plan_kernels(codes.contiguous(), depth, t1)
