"""The float64 predicted RAHT of the colour brick on the card: the
closed loop of ``ops/raht.py``'s ``forward_predicted`` and
``inverse_predicted`` (no reference pyramid, no integer Haar) over the
card plan, with the quantiser and the coder left on the host.

The structure is ``raht_plan.build_plan``'s, unchanged: blocks
(``blk_gather``), each stage's row offsets, the 18-neighbour tables and
the block-skip base (``en_base``); its Q15 coefficients are not read.
The float path carries the integer subtree weights itself, summing the
children into blocks as the truth pass climbs.  Three hand-written
kernels of ``csrc/raht_float_loop.cu`` run it, a launch each a level:

  ``raht_float_truth``    the true ACs in coded order, the blocks' DC and
                          weights (with no values: the weights alone);
  ``raht_float_predict``  the children's prediction from the parents'
                          reconstruction, its forward network and, in the
                          encoder, the residual rows truth - prediction;
  ``raht_float_inverse``  the prediction's ACs plus the dequantised rows,
                          the inverse network: the children's
                          reconstruction.

Every operation is the numpy path's, one IEEE double operation at a
time in its order, so the residual rows the host quantises, and with
them the stream, are the numpy path's byte for byte (ROADMAP C3, C11).

  encode: the truth pass bottom-up; the root DC to the host, quantised
  there and its dequantised value back; then a level at a time: predict,
  ONE copy of the level's residual rows to the host, the caller's
  ``quant`` on each of its three layers (z, y, x) and ``dequant`` of what
  it returns, ONE copy of the dequantised rows back, inverse (the last
  level needs no inverse).
  decode: the weights pass, the host's entropy decoding and dequantising
  of every layer up front (the row counts are geometry-static) and ONE
  upload; then predict and inverse a level with no host round trip and
  ONE copy of the leaves' reconstruction back.

Each kernel has its plain PyTorch version beside it (``truth_ref``,
``predict_ref``, ``inverse_ref``), with the launcher's signature;
``launchers_for`` takes them off a CUDA device, and ``PLAIN_LAUNCHERS``
drives the card's orchestration through them on any device (the tests,
on the CPU).  ``_kernels.LAUNCHES`` counts the kernels' launches.
Nothing here is module state a call keeps: the host buffers belong to
the call, so slices coded in threads may run the loop together.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _kernels, raht_plan

_F64 = torch.float64
_I64 = torch.int64

# the octants each neighbour offset j touches, as the kernel's bits
_TOUCH = tuple(tuple(o for o in range(8) if (bits >> o) & 1)
               for bits in raht_plan.NBR_OCTANTS)


# ---------------------------------------------------------------------
# plain versions (any device)
# ---------------------------------------------------------------------

def _sqrt_rn(x):
    """The IEEE round-to-nearest square root of a float64 tensor, as
    numpy and the kernels take it: torch's on a CUDA device; numpy's on
    the host, where torch's vectorised kernel may be an ulp off."""
    if x.device.type == "cuda":
        return torch.sqrt(x)
    return torch.from_numpy(np.sqrt(x.numpy()))


def _child_weights(p, w_c):
    """(mp, 8) int64 weights of the blocks' children (0 absent; w_c None:
    every child weighs 1)."""
    g = p["blk_gather"]
    if w_c is None:
        return (g >= 0).to(_I64)
    return torch.where(g >= 0, w_c[g.clamp(min=0)], 0)


def _coefs(w8):
    """The three stages' (a, b, both present, lone second) from the
    children's weights, and the blocks' weights."""
    out, w = [], w8
    for _ in range(3):
        w0, w1 = w[:, 0::2], w[:, 1::2]
        rs = _sqrt_rn(w0.to(_F64) + w1.to(_F64))
        out.append((_sqrt_rn(w0.to(_F64)) / rs,
                    _sqrt_rn(w1.to(_F64)) / rs,
                    (w0 > 0) & (w1 > 0), w0 == 0))
        w = w0 + w1
    return out, w[:, 0]


def _forward(v, coefs):
    """(mp, 8, C) -> dc (mp, C) and the z (mp, 4, C), y, x AC grids."""
    acs = []
    for a, b, both, hi in coefs:
        a, b, both, hi = a[..., None], b[..., None], both[..., None], \
            hi[..., None]
        v0, v1 = v[:, 0::2], v[:, 1::2]
        dc = a * v0 + b * v1
        ac = (-b) * v0 + a * v1
        v = torch.where(both, dc, torch.where(hi, v1, v0))
        acs.append(torch.where(both, ac, 0.0))
    return v[:, 0], acs


def _inverse(dc, acs, coefs):
    """dc (mp, C) and the z, y, x AC grids -> (mp, 8, C)."""
    v = dc[:, None]
    for (a, b, both, hi), ac in zip(reversed(coefs), reversed(acs)):
        a, b, both, hi = a[..., None], b[..., None], both[..., None], \
            hi[..., None]
        v0 = torch.where(both, a * v - b * ac, torch.where(hi, 0.0, v))
        v1 = torch.where(both, b * v + a * ac, torch.where(hi, v, 0.0))
        mp, k, c = v.shape
        v = torch.stack([v0, v1], dim=2).reshape(mp, 2 * k, c)
    return v


def _to_rows(acs, p):
    """AC grids -> the (pairs, C) rows of each stage in coded order."""
    return [ac.reshape(-1, ac.shape[-1])[p[k]] for ac, (k, _) in
            zip(acs, raht_plan.FLAT_KEYS)]


def _to_grids(rows, p, mp):
    """The stages' rows -> AC grids (0 at invalid pairs)."""
    out = []
    for r, (k, width) in zip(rows, raht_plan.FLAT_KEYS):
        grid = r.new_zeros(mp * width, r.shape[-1])
        grid[p[k]] = r
        out.append(grid.reshape(mp, width, -1))
    return out


def truth_ref(p, offsets, mp, vals, w_c, dc, w_p, rows):
    """Plain version of ``raht_float_truth``: the blocks of plan ``p``
    gathered from ``vals`` (mc, C) float64 and the children's weights
    ``w_c`` (mc,) int64 (None: every weight 1) -> the blocks' DC into
    ``dc`` (mp, C), their weights into ``w_p`` (mp,) and the true ACs
    into ``rows`` (the z, y, x row views).  With ``vals`` None only
    ``w_p`` is written."""
    coefs, w = _coefs(_child_weights(p, w_c))
    w_p.copy_(w)
    if vals is None:
        return
    g = p["blk_gather"]
    v8 = torch.where((g >= 0)[..., None], vals[g.clamp(min=0)], 0.0)
    d, acs = _forward(v8, coefs)
    dc.copy_(d)
    for out, r in zip(rows, _to_rows(acs, p)):
        out.copy_(r)


def predict_ref(p, offsets, mp, recon_p, w_p, w_c, coarser, t0, weights,
                truth, res, pred):
    """Plain version of ``raht_float_predict`` (``ops/raht.py``
    ``predict_children`` and the prediction's forward network): from the
    parents' reconstruction ``recon_p`` (mp, C) and weights ``w_p``, the
    children's weights ``w_c`` (None: 1) and the coarser plan
    ``coarser`` (None at the root: no grandparent rule), writes the
    prediction's AC rows into ``pred`` and, with ``truth`` given (the
    encoder), truth - prediction into ``res`` (which may be ``truth``).
    ``weights``: (w_self, w_face, w_edge)."""
    w_self, w_face, w_edge = (float(x) for x in weights)
    w8 = _child_weights(p, w_c)
    coefs, _ = _coefs(w8)
    mean = recon_p / _sqrt_rn(w_p.to(_F64))[:, None]
    en = p["en_base"]
    if coarser is not None:
        en = en & (coarser["cnt_p"][coarser["pidx"]] >= t0)
    nb = p["nbr_idx"].clamp(0, mp - 1)
    nv = mean[nb][..., 0]
    pv = mean[:, 0:1]
    keep = p["nbr_ok"] & (10 * nv > 2 * pv) & (10 * nv < 25 * pv)
    s = torch.zeros((mp, 8) + mean.shape[1:], dtype=_F64,
                    device=mean.device)
    ws = torch.zeros((mp, 8), dtype=_F64, device=mean.device)
    for j, octs in enumerate(_TOUCH):
        wj = w_face if j < 6 else w_edge
        kj = keep[:, j]
        t = mean[nb[:, j]] * wj
        for o in octs:
            s[:, o] = torch.where(kj[:, None], s[:, o] + t, s[:, o])
            ws[:, o] = torch.where(kj, ws[:, o] + wj, ws[:, o])
    pm = (mean[:, None] * w_self + s) / (w_self + ws)[..., None]
    v8 = pm * _sqrt_rn(w8.to(_F64))[..., None]
    v8 = torch.where(((w8 > 0) & en[:, None])[..., None], v8, 0.0)
    _, acs = _forward(v8, coefs)
    for k, r in enumerate(_to_rows(acs, p)):
        pred[k].copy_(r)
        if truth is not None:
            res[k].copy_(truth[k] - r)


def inverse_ref(p, offsets, mp, recon_p, w_c, pred, deq, recon_c):
    """Plain version of ``raht_float_inverse``: the AC rows ``pred`` +
    ``deq`` (each z, y, x) and the parents' reconstruction ``recon_p``
    through the inverse network into the children's ``recon_c`` (mc,
    C)."""
    coefs, _ = _coefs(_child_weights(p, w_c))
    acs = _to_grids([a + b for a, b in zip(pred, deq)], p, mp)
    v8 = _inverse(recon_p, acs, coefs)
    g = p["blk_gather"]
    present = g >= 0
    recon_c[g[present]] = v8[present]


# ---------------------------------------------------------------------
# the kernels (csrc/raht_float_loop.cu)
# ---------------------------------------------------------------------

def _cuda_truth(p, offsets, mp, vals, w_c, dc, w_p, rows):
    """Launch ``raht_float_truth`` (see ``truth_ref``)."""
    lib = _kernels.load()
    nc = 1 if vals is None else vals.shape[1]
    rows = [None] * 3 if rows is None else rows
    with torch.cuda.device(w_p.device):
        rc = lib.raht_float_truth_launch(
            raht_plan.float_plan_ptrs(p, offsets), mp, nc,
            _kernels.ptr(vals), _kernels.ptr(w_c), _kernels.ptr(dc),
            w_p.data_ptr(), *(_kernels.ptr(r) for r in rows),
            _kernels.stream(w_p))
    _kernels.launched("raht_float_truth", rc)


def _cuda_predict(p, offsets, mp, recon_p, w_p, w_c, coarser, t0, weights,
                  truth, res, pred):
    """Launch ``raht_float_predict`` (see ``predict_ref``)."""
    lib = _kernels.load()
    octs = (ctypes.c_uint8 * len(raht_plan.NBR_OCTANTS))(
        *raht_plan.NBR_OCTANTS)
    wts = (ctypes.c_double * 3)(*(float(x) for x in weights))
    truth = [None] * 3 if truth is None else truth
    res = [None] * 3 if res is None else res
    g_cnt, g_pidx = ((None, None) if coarser is None
                     else (coarser["cnt_p"], coarser["pidx"]))
    with torch.cuda.device(recon_p.device):
        rc = lib.raht_float_predict_launch(
            raht_plan.float_plan_ptrs(p, offsets), mp, recon_p.shape[1],
            recon_p.data_ptr(), w_p.data_ptr(), _kernels.ptr(w_c),
            _kernels.ptr(g_cnt), _kernels.ptr(g_pidx), t0, wts,
            _kernels.ptrs(truth), _kernels.ptrs(res), _kernels.ptrs(pred),
            octs, _kernels.stream(recon_p))
    _kernels.launched("raht_float_predict", rc)


def _cuda_inverse(p, offsets, mp, recon_p, w_c, pred, deq, recon_c):
    """Launch ``raht_float_inverse`` (see ``inverse_ref``)."""
    lib = _kernels.load()
    with torch.cuda.device(recon_c.device):
        rc = lib.raht_float_inverse_launch(
            raht_plan.float_plan_ptrs(p, offsets), mp, recon_c.shape[1],
            recon_p.data_ptr(), _kernels.ptr(w_c), _kernels.ptrs(pred),
            _kernels.ptrs(deq), recon_c.data_ptr(), _kernels.stream(recon_c))
    _kernels.launched("raht_float_inverse", rc)


CUDA_LAUNCHERS = (_cuda_truth, _cuda_predict, _cuda_inverse)
PLAIN_LAUNCHERS = (truth_ref, predict_ref, inverse_ref)


def launchers_for(device):
    """The kernels on a CUDA device, their plain versions elsewhere."""
    return CUDA_LAUNCHERS if device.type == "cuda" else PLAIN_LAUNCHERS


# ---------------------------------------------------------------------
# the closed loop
# ---------------------------------------------------------------------

class _Frame:
    """A brick's plan on ``device`` and its coded-order rows
    (``raht_plan.CodedRows``: the root's, then per coded level gi,
    coarsest first, its z, y, x slices of one (total, C) buffer)."""

    def __init__(self, codes: np.ndarray, depth: int, t1: int, device):
        self.device, self.depth = device, depth
        c = torch.as_tensor(np.ascontiguousarray(codes, dtype=np.int64),
                            device=device)
        fp = raht_plan.build_plan(c, depth, t1)
        self.plans, self.offsets, self.n_roots = \
            fp.plans, fp.offsets, fp.n_roots
        self.total, self.root, self.levels = fp.coded_rows()

    def plan(self, gi):
        """(plan index, plan, offsets, parent blocks, children, coarser
        plan or None) of coded level gi."""
        g = self.depth - 1 - gi
        p = self.plans[g]
        coarser = self.plans[g + 1] if g + 1 < self.depth else None
        return (g, p, self.offsets[g], p["blk_gather"].shape[0],
                p["pidx"].shape[0], coarser)

    def span(self, gi):
        """The rows (first, end) of coded level gi's three layers."""
        lv = self.levels[gi]
        return lv[0].start, lv[2].stop

    def host(self, rows, nc):
        """A host buffer of ``rows`` x ``nc`` float64, pinned for a card."""
        return torch.empty((rows, nc), dtype=_F64,
                           pin_memory=self.device.type == "cuda")

    def weights_pass(self, truth_launch, vals=None, rows_buf=None):
        """The truth launches bottom-up: each plan's parent weights (and,
        with ``vals``, the true ACs into ``rows_buf``).  Returns (the
        weights a plan, the roots' DC or None)."""
        w, cur, w_c = [], vals, None
        for g in range(self.depth):
            p = self.plans[g]
            mp = p["blk_gather"].shape[0]
            w_p = torch.empty(mp, dtype=_I64, device=self.device)
            dc = rows = None
            if vals is not None:
                dc = torch.empty((mp, vals.shape[1]), dtype=_F64,
                                 device=self.device)
                rows = [rows_buf[r] for r in self.levels[self.depth - 1 - g]]
            truth_launch(p, self.offsets[g], mp, cur, w_c, dc, w_p, rows)
            w.append(w_p)
            cur, w_c = dc, w_p
        return w, cur


def encode(codes: np.ndarray, values: np.ndarray, depth: int, quant,
           dequant, thresholds, weights, device, launchers=None) -> None:
    """The encoder's closed loop of ``ops/raht.py`` ``forward_predicted``
    on ``device``: ``codes`` (N,) distinct sorted leaf codes, ``values``
    (N, C) ints, ``quant(res (m, C) float64, tag) -> q`` and
    ``dequant(q, tag) -> (m, C) float64`` the caller's host quantiser,
    called in the numpy path's order (the root with tag -1, then every
    level's z, y, x layers with its index, coarsest first) on the same
    residuals.  ``launchers``: default ``launchers_for(device)``."""
    truth_l, pred_l, inv_l = launchers or launchers_for(device)
    fr = _Frame(codes, depth, thresholds[1], device)
    nc = values.shape[1]
    vals = torch.as_tensor(np.asarray(values, dtype=np.float64),
                           device=device)
    buf = torch.empty((fr.total, nc), dtype=_F64, device=device)
    predbuf = torch.empty_like(buf)
    deqbuf = torch.empty_like(buf)
    w, root = fr.weights_pass(truth_l, vals, buf)
    q = quant(root.cpu().numpy(), -1)
    recon = torch.as_tensor(np.asarray(dequant(q, -1), dtype=np.float64),
                            device=device)
    most = max(b - a for a, b in map(fr.span, range(depth)))
    host_res, host_deq = fr.host(most, nc), fr.host(most, nc)
    for gi in range(depth):
        g, p, off, mp, mc, coarser = fr.plan(gi)
        rows = fr.levels[gi]
        w_c = w[g - 1] if g else None
        pred_l(p, off, mp, recon, w[g], w_c, coarser, thresholds[0],
               weights, [buf[r] for r in rows], [buf[r] for r in rows],
               [predbuf[r] for r in rows])
        lo, hi = fr.span(gi)
        res = host_res[:hi - lo]
        res.copy_(buf[lo:hi])                 # waits for the level
        res_np, deq_np = res.numpy(), host_deq[:hi - lo].numpy()
        for r in rows:
            at = slice(r.start - lo, r.stop - lo)
            deq_np[at] = dequant(quant(np.array(res_np[at]), gi), gi)
        if gi == depth - 1:
            break                             # no level reads the leaves
        deqbuf[lo:hi].copy_(host_deq[:hi - lo], non_blocking=True)
        recon_c = torch.empty((mc, nc), dtype=_F64, device=device)
        inv_l(p, off, mp, recon, w_c, [predbuf[r] for r in rows],
              [deqbuf[r] for r in rows], recon_c)
        recon = recon_c


def decode(codes: np.ndarray, depth: int, read_q, dequant, ncomp: int,
           thresholds, weights, device, launchers=None) -> np.ndarray:
    """The decoder's closed loop of ``ops/raht.py`` ``inverse_predicted``
    on ``device``: ``read_q(count, tag)`` gives a layer's (count, ncomp)
    q rows and ``dequant(q, tag)`` their (count, ncomp) float64 values,
    each called in the numpy path's order.  Returns the leaves'
    reconstruction (N, ncomp) float64 on the host."""
    truth_l, pred_l, inv_l = launchers or launchers_for(device)
    fr = _Frame(codes, depth, thresholds[1], device)
    w, _ = fr.weights_pass(truth_l)          # overlaps the host's decoding
    host = fr.host(fr.total, ncomp)
    h = host.numpy()
    h[fr.root] = dequant(read_q(fr.n_roots, -1), -1)
    for gi in range(depth):
        for r in fr.levels[gi]:
            h[r] = dequant(read_q(r.stop - r.start, gi), gi)
    deq = host.to(device, non_blocking=True)
    pred = torch.empty_like(deq)
    recon = deq[fr.root]
    for gi in range(depth):
        g, p, off, mp, mc, coarser = fr.plan(gi)
        rows = fr.levels[gi]
        w_c = w[g - 1] if g else None
        pr = [pred[r] for r in rows]
        pred_l(p, off, mp, recon, w[g], w_c, coarser, thresholds[0],
               weights, None, None, pr)
        recon_c = torch.empty((mc, ncomp), dtype=_F64, device=device)
        inv_l(p, off, mp, recon, w_c, pr, [deq[r] for r in rows], recon_c)
        recon = recon_c
    return recon.cpu().numpy()
