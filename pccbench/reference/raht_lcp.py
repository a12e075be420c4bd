"""Plain reference of ``tmc3-cuda``'s default colour path: G-PCC's
predicted RAHT with last-component prediction (LCP), from the frame
alone.

What it computes, for a frame of sorted unique Morton codes and 8-bit
RGB, under the CTC octree-raht condition at the CLI's defaults:

1. the BT.709 forward conversion to YCbCr (16-bit-style coefficients,
   the offset inside a round half away from zero, clipped to 8 bits);
2. the slice's local positions (each axis less its minimum) and their
   Morton order, in which the transform runs;
3. the predicted float RAHT: ``3 * depth`` dyadic pair-merge sweeps with
   the orthonormal butterfly of subtree weights, coded top down, each
   octree level predicted from the reconstructed parents' means over the
   19-node parent neighbourhood (self 9, face 3, edge 1; a neighbour
   kept only where 10x its luma mean lies strictly between 2x and 25x
   the parent's; a block predicted only where the parent has 6 or more
   neighbours and the grandparent 2 or more);
4. per coded layer (the root and every sweep), rate-distortion zeroing of
   rows (RDOQ, the port's run-length approximation of the reference),
   the deadzone quantiser |q| = floor(|c| / step + 1/3) with the steps of
   qp and qp + qpChromaOffset (6 QPs an octave, Q16), and LCP: the
   coefficient k = round(4 s12 / s11) clipped to [-8, 8] from the least
   squares of the third component on the second, and the third
   component's residual taken after subtracting k / 4 times the second's
   dequantised coefficient;
5. the decoder's reconstruction, rounded half to even, and the inverse
   BT.709 conversion.

It returns the decoded RGB in the frame's code order and the LCP
coefficients in the order the attribute brick signals them.

Departures from the published description, each to follow the port
(``models/attr_raht.py``, ``ops/raht.py``, ``ops/processing.py``) so
that a correct program matches exactly:

- the operation order is the port's, elementwise in float64; where the
  port reduces with numpy, the sums here are sequential (a running sum):
  the rows of three components in column order, and the two LCP sums
  over a layer as ``torch.cumsum``'s last element.  numpy's dot product
  (BLAS) may sum in another order, so an LCP coefficient can differ only
  where 4 s12 / s11 lies within rounding of a half;
- the decoder's inverse repeats the encoder's reconstruction step by
  step from the same quantised rows and coefficients, so the decoded
  values are the encoder's closed-loop reconstruction, rounded: it is
  computed once;
- RDOQ, the LCP coefficient's estimate and the run-length rate model
  are the port's encoder choices, which the stream carries the results
  of (its q rows and coefficients); the reference makes the same
  choices.

``dtype`` (float64 by default) is the precision of the whole transform;
the check's control runs it in float32, and with ``lcp=False``.

Plain PyTorch on the CPU: imports nothing of the port, of ``jax`` or of
the JAX package.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from pccbench.frames import step_q16

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

I64 = torch.int64
W_SELF, W_FACE, W_EDGE = 9, 3, 1
THRESHOLD0, THRESHOLD1 = 2, 6     # grandparent, parent neighbour counts

# per-axis Morton bit masks (x at bits 2, 5, 8..., y at 1, 4, 7..., z at
# 0, 3, 6...)
_MZ = 0x1249249249249249
_AXIS_MASK = (_MZ << 2, _MZ << 1, _MZ)
_AXIS_UNIT = (4, 2, 1)

# the 18 face and edge neighbour offsets, faces first
_NBR_OFFSETS = [
    (+1, 0, 0), (-1, 0, 0), (0, +1, 0), (0, -1, 0), (0, 0, +1),
    (0, 0, -1),
    (+1, +1, 0), (+1, -1, 0), (-1, +1, 0), (-1, -1, 0),
    (+1, 0, +1), (+1, 0, -1), (-1, 0, +1), (-1, 0, -1),
    (0, +1, +1), (0, +1, -1), (0, -1, +1), (0, -1, -1),
]

# the RDOQ rate model's tables
_LUTLOG = torch.tensor([0, 256, 406, 512, 594, 662, 719, 768, 812, 850,
                        886, 918, 947, 975, 1000, 1024], dtype=I64)
_LUTBINS = torch.tensor([1, 2, 3, 5, 5, 7, 7, 9, 9, 11, 11], dtype=I64)


def _touch_table() -> List[List[bool]]:
    """[octant][offset]: the child octant o touches neighbour j where on
    every axis with a non-zero offset it sits on that side of its
    parent."""
    t = [[True] * len(_NBR_OFFSETS) for _ in range(8)]
    for o in range(8):
        side = ((o >> 2) & 1, (o >> 1) & 1, o & 1)
        for j, off in enumerate(_NBR_OFFSETS):
            for a, d in enumerate(off):
                if (d > 0 and side[a] != 1) or (d < 0 and side[a] != 0):
                    t[o][j] = False
    return t


_TOUCH = _touch_table()


# ---- Morton codes ---------------------------------------------------

def _spread(v: torch.Tensor) -> torch.Tensor:
    out = torch.zeros_like(v)
    for b in range(21):
        out |= ((v >> b) & 1) << (3 * b)
    return out


def _gather(c: torch.Tensor) -> torch.Tensor:
    out = torch.zeros_like(c)
    for b in range(21):
        out |= ((c >> (3 * b)) & 1) << b
    return out


def morton_encode(pos: torch.Tensor) -> torch.Tensor:
    """(N, 3) int64 positions -> codes, x in the highest bit of each
    triple."""
    return (_spread(pos[:, 0]) << 2) | (_spread(pos[:, 1]) << 1) \
        | _spread(pos[:, 2])


def morton_decode(codes: torch.Tensor) -> torch.Tensor:
    return torch.stack([_gather(codes >> 2), _gather(codes >> 1),
                        _gather(codes)], dim=1)


# ---- colour conversion (BT.709, 8 bits) -----------------------------

def _c_round(x: torch.Tensor) -> torch.Tensor:
    """Round half away from zero."""
    return torch.where(x >= 0, torch.floor(x + 0.5), torch.ceil(x - 0.5))


def rgb_to_ycbcr(rgb: torch.Tensor, bitdepth: int = 8) -> torch.Tensor:
    r, g, b = (rgb[:, i].to(torch.float64) for i in range(3))
    off = float(1 << (bitdepth - 1))
    y = _c_round(0.212600 * r + 0.715200 * g + 0.072200 * b)
    cb = _c_round(-0.114572 * r - 0.385428 * g + 0.5 * b + off)
    cr = _c_round(0.5 * r - 0.454153 * g - 0.045847 * b + off)
    out = torch.stack([y, cb, cr], dim=1)
    return out.clamp(0, (1 << bitdepth) - 1).to(I64)


def ycbcr_to_rgb(ycc: torch.Tensor, bitdepth: int = 8) -> torch.Tensor:
    off = float(1 << (bitdepth - 1))
    y = ycc[:, 0].to(torch.float64)
    cb = ycc[:, 1].to(torch.float64) - off
    cr = ycc[:, 2].to(torch.float64) - off
    r = _c_round(y + 1.57480 * cr)
    g = _c_round(y - 0.18733 * cb - 0.46813 * cr)
    b = _c_round(y + 1.85563 * cb)
    out = torch.stack([r, g, b], dim=1)
    return out.clamp(0, (1 << bitdepth) - 1).to(I64)


# ---- the transform's structure --------------------------------------

def sweeps_of(codes: torch.Tensor, depth: int, dtype) -> List[dict]:
    """Per dyadic sweep, fine to coarse: its input codes and subtree
    weights, the pair masks (first and second of a pair, kept rows) and
    the butterfly's coefficients sqrt(w1 / (w1 + w2)), sqrt(w2 / ...)."""
    w = torch.ones(codes.shape[0], dtype=I64)
    out = []
    for _ in range(3 * depth):
        parent = codes >> 1
        n = codes.shape[0]
        first = torch.zeros(n, dtype=torch.bool)
        if n > 1:
            first[:-1] = parent[:-1] == parent[1:]
        second = torch.zeros(n, dtype=torch.bool)
        second[1:] = first[:-1]
        keep = ~second
        w1 = w[first].to(dtype)
        w2 = w[second].to(dtype)
        rs = torch.sqrt(w1 + w2)
        out.append({"codes": codes, "w": w, "first": first,
                    "second": second, "keep": keep,
                    "a": (torch.sqrt(w1) / rs)[:, None],
                    "b": (torch.sqrt(w2) / rs)[:, None]})
        nw = w.clone()
        nw[first] += w[second]
        codes = (codes >> 1)[keep]
        w = nw[keep]
    return out


def forward_sweeps(sweeps, lo: int, hi: int, vals: torch.Tensor):
    """Sweeps [lo, hi) forward: (their AC rows, the coarse values)."""
    acs = []
    for s in range(lo, hi):
        sw = sweeps[s]
        a, b = sw["a"], sw["b"]
        v1, v2 = vals[sw["first"]], vals[sw["second"]]
        dc = a * v1 + b * v2
        ac = -b * v1 + a * v2
        nv = vals.clone()
        nv[sw["first"]] = dc
        vals = nv[sw["keep"]]
        acs.append(ac)
    return acs, vals


def inverse_sweeps(sweeps, lo: int, hi: int, coarse: torch.Tensor, acs):
    """Inverse of ``forward_sweeps``: coarse values and ACs -> fine."""
    vals = coarse
    for s in range(hi - 1, lo - 1, -1):
        sw = sweeps[s]
        a, b = sw["a"], sw["b"]
        ac = acs[s - lo]
        expanded = torch.zeros((sw["codes"].shape[0], vals.shape[1]),
                               dtype=vals.dtype)
        expanded[sw["keep"]] = vals
        dc = expanded[sw["first"]]
        expanded[sw["first"]] = a * dc - b * ac
        expanded[sw["second"]] = b * dc + a * ac
        vals = expanded
    return vals


# ---- intra prediction -----------------------------------------------

def _neighbours(parent_codes: torch.Tensor, level: int):
    """(M, 18) rows of each parent's face and edge neighbours among the
    parents, and whether each is occupied."""
    m = parent_codes.shape[0]
    bits = min(3 * max(level, 0), 62)
    lvl_mask = (1 << bits) - 1
    ncodes, valid = [], []
    for off in _NBR_OFFSETS:
        c = parent_codes
        ok = torch.ones(m, dtype=torch.bool)
        for a, d in enumerate(off):
            if d == 0:
                continue
            mask, unit = _AXIS_MASK[a], _AXIS_UNIT[a]
            if d > 0:
                c = (((c | ~mask) + unit) & mask) | (c & ~mask)
                ok &= (c & ~lvl_mask) == 0
            else:
                ok &= (c & mask) != 0
                c = (((c & mask) - unit) & mask) | (c & ~mask)
        ncodes.append(c)
        valid.append(ok)
    flat = torch.stack(ncodes, dim=1).reshape(-1)
    idx = torch.searchsorted(parent_codes, flat).clamp(max=m - 1)
    hit = torch.stack(valid, dim=1).reshape(-1) & (parent_codes[idx] == flat)
    return idx.reshape(m, -1), hit.reshape(m, -1)


def predict(parent_codes, parent_dc, parent_w, child_codes, child_w, level,
            grand_counts):
    """Each child's prediction (its transform-domain value) from the
    reconstructed parents, and each child's parent neighbourhood size
    (the next level's grandparent count)."""
    dtype = parent_dc.dtype
    pf = parent_dc / torch.sqrt(parent_w.to(dtype))[:, None]
    nbr_idx, nbr_ok = _neighbours(parent_codes, level)
    m, nc = pf.shape
    parent_counts = 1 + nbr_ok.sum(dim=1)
    enable = parent_counts >= THRESHOLD1
    if grand_counts is not None:
        enable &= grand_counts >= THRESHOLD0

    pv = pf[:, 0]
    nv = pf[nbr_idx, 0]
    keep = nbr_ok & (10 * nv > 2 * pv[:, None]) & (10 * nv < 25 * pv[:, None])

    pc = child_codes >> 3
    step = torch.zeros(child_codes.shape[0], dtype=I64)
    step[1:] = (pc[1:] != pc[:-1]).to(I64)
    pidx = torch.cumsum(step, 0)
    cidx = child_codes & 7

    weight = [W_FACE] * 6 + [W_EDGE] * 12
    s_oct = torch.zeros((m, 8, nc), dtype=dtype)
    w_oct = torch.zeros((m, 8), dtype=dtype)
    for j in range(len(_NBR_OFFSETS)):
        kj = keep[:, j]
        if not bool(kj.any()):
            continue
        vj = pf[nbr_idx[:, j]] * kj[:, None]
        wk = kj.to(dtype)
        for o in range(8):
            if _TOUCH[o][j]:
                s_oct[:, o] += vj * float(weight[j])
                w_oct[:, o] += wk * float(weight[j])
    acc = pf[pidx] * W_SELF + s_oct[pidx, cidx]
    wsum = W_SELF + w_oct[pidx, cidx]
    pred = acc / wsum[:, None]
    pred = pred * torch.sqrt(child_w.to(dtype))[:, None]
    pred[~enable[pidx]] = 0.0
    return pred, parent_counts[pidx]


# ---- quantisation, RDOQ and LCP -------------------------------------

def quantize(c: torch.Tensor, step: int) -> torch.Tensor:
    s = c * 65536.0 / step
    return (torch.sign(s) * torch.floor(torch.abs(s) + (1.0 / 3.0))).to(I64)


def dequantize(q: torch.Tensor, step: int, dtype) -> torch.Tensor:
    return q.to(dtype) * step / 65536.0


def _row_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of each row, column by column."""
    out = x[:, 0]
    for c in range(1, x.shape[1]):
        out = out + x[:, c]
    return out


def rdoq_zero_rows(arr: torch.Tensor, steps, train_in: int):
    """(rows to zero, the zero run carried out) of a layer's rows: a row
    of one or two quantised units is zeroed where its rate, from the run
    of zero rows before it and the log2 of its magnitudes, costs more
    than lambda = step_luma^2 * (25 | 35) buys in distortion; zeroing
    lengthens the next runs, so the decision is iterated (four rounds at
    most) to its fixpoint."""
    m, nc = arr.shape
    if m == 0:
        return torch.zeros(0, dtype=torch.bool), train_in
    aq = torch.stack([torch.floor(torch.abs(arr[:, c]) * 65536.0 / steps[c]
                                  + (1.0 / 3.0)).to(I64)
                      for c in range(nc)], dim=1)
    sumc = aq.sum(dim=1)
    dist2 = _row_sum(arr * arr)
    ratec = _LUTLOG[aq.clamp(max=15)].sum(dim=1)
    step_luma = steps[0] / 65536.0
    lam = step_luma * step_luma * (25.0 if nc == 1 else 35.0)
    idx = torch.arange(m, dtype=I64)
    extra = (ratec + 128) >> 8
    flag = torch.zeros(m, dtype=torch.bool)
    for _ in range(4):
        z = (sumc == 0) | flag
        last_nz = torch.cummax(torch.where(~z, idx, torch.full_like(idx, -1)),
                               dim=0).values
        before = torch.cat([torch.tensor([-1], dtype=I64), last_nz[:-1]])
        train = idx - 1 - before
        train[before == -1] += train_in + 1
        rate = _LUTBINS[train.clamp(max=10)].clone()
        long_run = train > 10
        if bool(long_run.any()):
            bits = torch.frexp((train[long_run] - 10).to(torch.float64))[1]
            rate[long_run] += 2 * bits.to(I64) - 1 + 2
        rate += extra
        new_flag = (sumc > 0) & (sumc < 3) \
            & (dist2 * 1024.0 < lam * rate.to(torch.float64))
        if bool((new_flag == flag).all()):
            break
        flag = new_flag
    zeroed = (sumc == 0) | flag
    if bool(zeroed.all()):
        return flag, train_in + m
    return flag, m - 1 - int(torch.nonzero(~zeroed)[-1])


def _running_sum(x: torch.Tensor) -> float:
    return float(torch.cumsum(x, 0)[-1]) if x.numel() else 0.0


def lcp_coefficient(c1: torch.Tensor, c2: torch.Tensor) -> int:
    """round(4 * <c1, c2> / <c1, c1>) clipped to [-8, 8]: c2 ~ (k/4) c1."""
    s11 = _running_sum(c1 * c1)
    if s11 <= 0.0:
        return 0
    s12 = _running_sum(c1 * c2)
    return int(min(max(round(4.0 * s12 / s11), -8), 8))


class Layers:
    """Quantises and dequantises the coded layers in order, carrying the
    RDOQ zero run and signalling one LCP coefficient a layer."""

    def __init__(self, steps_luma: int, steps_chroma: int, lcp: bool,
                 dtype):
        self.steps = [steps_luma, steps_chroma, steps_chroma]
        self.lcp, self.dtype = lcp, dtype
        self.train = 0
        self.coeffs: List[int] = []

    def code(self, arr: torch.Tensor, tag: int) -> torch.Tensor:
        """The layer's reconstructed coefficients (the AC rows, or the
        root at ``tag`` -1, which RDOQ leaves alone)."""
        steps, dtype = self.steps, self.dtype
        if tag >= 0:
            flag, self.train = rdoq_zero_rows(arr, steps, self.train)
            if bool(flag.any()):
                arr = arr.clone()
                arr[flag] = 0
        q = [quantize(arr[:, c], steps[c]) for c in range(3)]
        dq = [dequantize(q[c], steps[c], dtype) for c in range(3)]
        if self.lcp:
            k = lcp_coefficient(arr[:, 1], arr[:, 2])
            self.coeffs.append(k)
            q[2] = quantize(arr[:, 2] - k * dq[1] / 4.0, steps[2])
            dq[2] = dequantize(q[2], steps[2], dtype) + k * dq[1] / 4.0
        return torch.stack(dq, dim=1)


# ---- the colour path ------------------------------------------------

def encode_decode(codes, rgb, qp: int = 34, qp_chroma_offset: int = 0,
                  lcp: bool = True, dtype=torch.float64
                  ) -> Tuple[torch.Tensor, List[int]]:
    """(decoded RGB (N, 3) int64 in the order of ``codes``, the LCP
    coefficients in signalled order) of one slice's frame: ``codes``
    (N,) sorted unique Morton codes, ``rgb`` (N, 3) 8-bit values."""
    codes = torch.as_tensor(codes, dtype=I64)
    rgb = torch.as_tensor(rgb, dtype=I64)
    pos = morton_decode(codes)
    local = morton_encode(pos - pos.min(dim=0).values)
    order = torch.argsort(local, stable=True)
    leaves = local[order]
    hi = int(leaves[-1]) if leaves.numel() else 0
    depth = max((hi.bit_length() + 2) // 3, 1)
    ycc = rgb_to_ycbcr(rgb[order])
    layers = Layers(step_q16(qp), step_q16(qp + qp_chroma_offset), lcp,
                    dtype)

    sweeps = sweeps_of(leaves, depth, dtype)
    n = len(sweeps)
    acs_true, root = forward_sweeps(sweeps, 0, n, ycc.to(dtype))
    recon = layers.code(root, -1)
    grand = None
    for g in range(depth):
        g_hi = n - 3 * g
        g_lo = g_hi - 3
        if g_hi < n:
            parent_codes, parent_w = sweeps[g_hi]["codes"], sweeps[g_hi]["w"]
        else:
            parent_codes = torch.zeros(1, dtype=I64)
            parent_w = torch.tensor([leaves.shape[0]], dtype=I64)
        pred, grand = predict(parent_codes, recon, parent_w,
                              sweeps[g_lo]["codes"], sweeps[g_lo]["w"], g,
                              grand)
        acs_pred, _ = forward_sweeps(sweeps, g_lo, g_hi, pred)
        acs_rec = [acs_pred[s] + layers.code(acs_true[g_lo + s] - acs_pred[s],
                                             g)
                   for s in range(3)]
        recon = inverse_sweeps(sweeps, g_lo, g_hi, recon, acs_rec)
    decoded = torch.empty_like(rgb)
    decoded[order] = ycbcr_to_rgb(torch.round(recon).to(I64))
    return decoded, layers.coeffs
