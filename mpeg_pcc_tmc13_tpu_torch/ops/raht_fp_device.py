"""Device fixed-point RAHT on int64 tensors: counterpart of
``mpeg_pcc_tmc13_tpu/ops/raht_fp_device.py:159-515`` (and
``isqrt64_dev``/``fwd_blocks_int``, :292-329).

Every data-dependent step is an integer add, multiply, arithmetic shift
or floor division on int64 tensors, so the quantised coefficients are
bit-identical to the numpy spec (``ops/raht_fp.py``) and to the JAX
device codec, and the zrow stream is the same whichever codes it.

The per-frame structure (block gathers, Q15 butterfly coefficients,
18-neighbour tables, sqrt scales, pair masks, coded-order compaction
indices) is the plan, whose format ``ops/raht_plan.py`` owns.  The host
planner ``build_fp_plan``, numpy copied line for line from the reference
module (its lines 38-153), is its spec and the CPU path,
``plans_to_torch`` carrying it over.  On a CUDA device
``raht_plan.build_plan`` builds the same tensors there from the uploaded
leaf codes.

  encode: truth bottom-up (block butterflies), then top-down per
  group: prediction from reconstructed parent means -> forward network
  -> residual -> deadzone quantise.  All q rows reach the host in ONE
  copy; the host's only job is the serial zrow range coding.
  decode: the host entropy-decodes every group's q rows up front (the
  row counts are geometry-static), uploads them in one copy, and the
  device runs the prediction + inverse network top-down.

The mesh's attribute stage, ``fwd_blocks_int`` (reference
``isqrt64_dev``/``fwd_blocks_int``, :292-329), computes the butterfly
coefficients on the device from the block weights: a CUDA tensor
launches the hand-written kernel of ``csrc/raht_fp_blocks.cu`` once per
run of at most four channels, a CPU tensor runs its plain version
``fwd_blocks_int_ref``.  The kernel's fast path is mirrored in plain
torch beside it for the tests (``fwd_blocks_int_mirror``).

The closed loop itself (B6) runs on hand-written kernels on a CUDA
device: ``raht_fp_truth_level`` (one launch a truth level: gather,
forward network, compaction) and ``raht_fp_group`` (one launch a coded
group: prediction, forward network, quantisation, inverse network, the
children's reconstruction) of ``csrc/raht_fp_loop.cu``.  The public
level steps ``_truth_level``, ``_enc_group`` and ``_dec_group`` launch
them on a CUDA tensor and run their plain versions (``_ref``) on a CPU
tensor; ``DeviceFpRaht.encode``/``decode`` drive the kernels over a
whole frame on a card (``_encode_kernels``/``_decode_kernels``: the
first group also (de)quantises the roots, each group hands the next its
children's Q13 means, the last decode group shifts out the fraction).
``truth_level_mirror`` and ``group_mirror`` are the kernels' arithmetic
in plain torch, with the launchers' signatures, so the tests run the
card's orchestration on the CPU (``MIRROR_LAUNCHERS``).

Translation rules from the JAX form: ``jnp.floor_divide`` is
``torch.div(..., rounding_mode="floor")``; ``>>`` on int64 is
arithmetic in both; ``.at[].set``/``.at[].add`` are ``index_put_`` /
``index_add_``; gather indices are clamped (the plans already keep them
in range).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from ..utils import timing
from ..utils.device import resolve as resolve_device
from . import _kernels, raht_fp, raht_plan
from .raht import _offset_neighbor_codes, _TOUCH_TABLE

F = raht_fp.F
QA = raht_fp.QA
QAH = 1 << (QA - 1)
HALF = raht_fp.HALF


# ---------------------------------------------------------------------
# host-side plan
# ---------------------------------------------------------------------

@dataclass
class GroupPlan:
    mp: int
    mc: int
    blk_gather: np.ndarray      # (mp, 8) i32 child row per octant, -1
    blk_present: np.ndarray     # (mp, 8) bool
    pidx: np.ndarray            # (mc,) parent row per child
    oct: np.ndarray             # (mc,) child octant
    sw_c: np.ndarray            # (mc,) Q15 sqrt(child weight)
    sw_p: np.ndarray            # (mp,) Q15 sqrt(parent weight)
    w_p: np.ndarray             # (mp,) parent weights
    # butterfly coefficients + pair masks per stage (z, y, x)
    az: np.ndarray              # (mp, 4) Q15
    bz: np.ndarray
    vz: np.ndarray              # (mp, 4) bool: both children present
    sz: np.ndarray              # (mp, 4) i8: single-source octant (rel)
    ay: np.ndarray              # (mp, 2)
    by: np.ndarray
    vy: np.ndarray
    sy: np.ndarray
    ax: np.ndarray              # (mp,)
    bx: np.ndarray
    vx: np.ndarray
    sx: np.ndarray
    # coded-order compaction: flat indices into the padded (mp, k)
    # pair grid per stage, in zrow order
    flat_z: np.ndarray
    flat_y: np.ndarray
    flat_x: np.ndarray
    # prediction
    nbr_idx: np.ndarray         # (mp, 18) i32
    nbr_ok: np.ndarray          # (mp, 18) bool
    cnt_p: np.ndarray           # (mp,) 1 + present neighbours
    en_base: np.ndarray         # (mp,) cnt >= t1 (t0 term joins later)


def _stage_coeffs(w_cells: np.ndarray, occ: np.ndarray):
    """Per-block pair data for one stage: w_cells (mp, 2k) weights of
    the stage's input cells (0 = absent).  Returns merged weights
    (mp, k) plus (a, b, valid, single_src)."""
    w0 = w_cells[:, 0::2].astype(np.int64)
    w1 = w_cells[:, 1::2].astype(np.int64)
    both = (w0 > 0) & (w1 > 0)
    ws = np.maximum(w0 + w1, 1)
    a = raht_fp.isqrt64((w0 << 30) // ws)
    b = raht_fp.isqrt64((w1 << 30) // ws)
    # single-source: which input cell flows through (0/1; -1 dead)
    ssrc = np.where(w0 > 0, 0, np.where(w1 > 0, 1, -1)).astype(np.int8)
    return (w0 + w1), both, a, b, ssrc


def build_fp_plan(leaf_codes: np.ndarray, depth: int,
                  thresholds=(raht_fp._PRED_T0, raht_fp._PRED_T1)):
    """Per-frame static structure, finest group first
    (plans[0] merges leaves)."""
    codes = leaf_codes.astype(np.int64)
    w = np.ones(codes.shape[0], dtype=np.int64)
    plans: List[GroupPlan] = []
    for g in range(depth):
        parent = codes >> 3
        oct_ = (codes & 7).astype(np.int32)
        first = np.concatenate([[True], parent[1:] != parent[:-1]]) \
            if codes.size else np.zeros(0, bool)
        pidx = (np.cumsum(first) - 1).astype(np.int32)
        mp = int(pidx[-1]) + 1 if codes.size else 0
        mc = codes.shape[0]
        gather = np.full((mp, 8), -1, dtype=np.int32)
        gather[pidx, oct_] = np.arange(mc, dtype=np.int32)
        present = gather >= 0
        blk_w = np.where(present, w[np.maximum(gather, 0)], 0)

        wz, vz, az, bz, sz = _stage_coeffs(blk_w, present)
        wy, vy, ay, by, sy = _stage_coeffs(wz, wz > 0)
        wx, vx, ax, bx, sx = _stage_coeffs(wy, wy > 0)

        parent_codes = parent[first]
        parent_w = wx[:, 0]
        with timing.counted("raht.plan.search_s"):
            nbr_idx, nbr_ok = _offset_neighbor_codes(
                parent_codes, depth - 1 - g)
        cnt_p = 1 + nbr_ok.sum(axis=1).astype(np.int64)

        plans.append(GroupPlan(
            mp=mp, mc=mc,
            blk_gather=gather, blk_present=present,
            pidx=pidx, oct=oct_,
            sw_c=raht_fp.sqrt_q15(w), sw_p=raht_fp.sqrt_q15(parent_w),
            w_p=parent_w,
            az=az, bz=bz, vz=vz, sz=sz,
            ay=ay, by=by, vy=vy, sy=sy,
            ax=ax[:, 0], bx=bx[:, 0], vx=vx[:, 0], sx=sx[:, 0],
            flat_z=np.flatnonzero(vz.reshape(-1)).astype(np.int32),
            flat_y=np.flatnonzero(vy.reshape(-1)).astype(np.int32),
            flat_x=np.flatnonzero(vx).astype(np.int32),
            nbr_idx=nbr_idx.astype(np.int32), nbr_ok=nbr_ok,
            cnt_p=cnt_p,
            en_base=cnt_p >= thresholds[1],
        ))
        codes = parent_codes
        w = parent_w
    return plans


_I64 = torch.int64

# per octant: the 6 neighbour offsets j that touch it
_TOUCH_JS = np.stack([np.nonzero(_TOUCH_TABLE[o])[0] for o in range(8)])
_TOUCH_IDX = {}


def _touch_index(device) -> torch.Tensor:
    """(8, 6) int64 offsets touching each octant, kept on ``device``."""
    key = str(device)
    if key not in _TOUCH_IDX:
        _TOUCH_IDX[key] = torch.as_tensor(_TOUCH_JS, dtype=_I64,
                                          device=device)
    return _TOUCH_IDX[key]


def _floordiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


# ---------------------------------------------------------------------
# host plan -> device
# ---------------------------------------------------------------------

_INDEX_KEYS = ("blk_gather", "pidx", "oct", "flat_z", "flat_y", "flat_x",
               "nbr_idx")
_INT_KEYS = ("sw_c", "sw_p", "az", "bz", "ay", "by", "ax", "bx", "sz", "sy",
             "sx", "cnt_p")
_BOOL_KEYS = ("vz", "vy", "vx", "nbr_ok", "en_base")


def plans_to_torch(host_plans, device) -> List[dict]:
    """The per-frame state carried across: each ``GroupPlan`` of
    ``build_fp_plan`` as a dict of tensors on ``device`` (indices and
    integers int64, masks bool)."""
    out = []
    for hp in host_plans:
        d = {}
        for k in _INDEX_KEYS + _INT_KEYS:
            d[k] = torch.as_tensor(np.asarray(getattr(hp, k), np.int64),
                                   device=device)
        for k in _BOOL_KEYS:
            d[k] = torch.as_tensor(np.asarray(getattr(hp, k), bool),
                                   device=device)
        out.append(d)
    return out


# ---------------------------------------------------------------------
# device steps (int64 math identical to the numpy spec)
# ---------------------------------------------------------------------

def _fwd_block(vals8, p):
    """Forward network on (mp, 8, C) block values.  Returns (dc (mp, C),
    acz (mp,4,C), acy (mp,2,C), acx (mp,1,C)); invalid pair slots hold
    zeros."""

    def stage(v, a, b, valid, ssrc):
        # v: (mp, 2k, C) -> (mp, k, C); a/b (mp, k)
        v0 = v[:, 0::2]
        v1 = v[:, 1::2]
        a = a[..., None]
        b = b[..., None]
        dc = (a * v0 + b * v1 + QAH) >> QA
        ac = (a * v1 - b * v0 + QAH) >> QA
        single = torch.where(ssrc[..., None] == 1, v1, v0)
        out = torch.where(valid[..., None], dc, single)
        ac = torch.where(valid[..., None], ac, 0)
        return out, ac

    vz, acz = stage(vals8, p["az"], p["bz"], p["vz"], p["sz"])
    vy, acy = stage(vz, p["ay"], p["by"], p["vy"], p["sy"])
    vx, acx = stage(vy, p["ax"][:, None], p["bx"][:, None],
                    p["vx"][:, None], p["sx"][:, None])
    return vx[:, 0], acz, acy, acx


def _inv_block(dc, acz, acy, acx, p):
    """Inverse network: dc (mp, C) + per-stage AC grids -> (mp, 8, C)."""

    def unstage(v, ac, a, b, valid, ssrc):
        # v (mp, k, C) -> (mp, 2k, C)
        a = a[..., None]
        b = b[..., None]
        v0 = (a * v - b * ac + QAH) >> QA
        v1 = (b * v + a * ac + QAH) >> QA
        s = ssrc[..., None] == 1
        out0 = torch.where(valid[..., None], v0, torch.where(s, 0, v))
        out1 = torch.where(valid[..., None], v1, torch.where(s, v, 0))
        mp, k, c = v.shape
        return torch.stack([out0, out1], dim=2).reshape(mp, 2 * k, c)

    vy = unstage(dc[:, None], acx, p["ax"][:, None], p["bx"][:, None],
                 p["vx"][:, None], p["sx"][:, None])
    vz = unstage(vy, acy, p["ay"], p["by"], p["vy"], p["sy"])
    return unstage(vz, acz, p["az"], p["bz"], p["vz"], p["sz"])


def _predict(recon_p, grand_p, p, t0, t1, weights, have_grand):
    """Fixed-point prediction per child (mc, C) from the parents'
    reconstruction; also returns the next group's grandparent counts,
    one per child."""
    w_self, w_face, w_edge = weights
    pf = _floordiv(recon_p << QA, p["sw_p"][:, None])    # Q13 means
    pv = pf[:, 0]
    nv = pf[p["nbr_idx"]]                                 # (mp, 18, C)
    nl = nv[..., 0]
    keep = p["nbr_ok"] & (10 * nl > 2 * pv[:, None]) \
        & (10 * nl < 25 * pv[:, None])
    en = p["en_base"]
    if have_grand:
        en = en & (grand_p >= t0)

    # per-octant sums over the 6 offsets touching each octant: s_oct
    # (mp, 8, C) of keep*w_j*nv, w_oct (mp, 8) of keep*w_j, with w_j
    # w_face for the 6 face offsets and w_edge for the 12 edges.
    # Integer sums, so any order is exact.
    kw = keep.to(_I64)
    kw = torch.cat([kw[:, :6] * w_face, kw[:, 6:] * w_edge], dim=1)
    terms = nv * kw[..., None]
    touch = _touch_index(pf.device)
    s_oct = torch.stack([terms[:, js].sum(dim=1) for js in touch], 1)
    w_oct = torch.stack([kw[:, js].sum(dim=1) for js in touch], 1)

    pi = p["pidx"]
    oc = p["oct"]
    acc = pf[pi] * w_self + s_oct[pi, oc]
    wsum = w_self + w_oct[pi, oc]
    pm = _floordiv(acc, wsum[:, None])
    pred = (pm * p["sw_c"][:, None] + QAH) >> QA
    pred = torch.where(en[pi][:, None], pred, 0)
    return pred, p["cnt_p"][pi]


def _quant(res, steps):
    a = res.abs()
    st = steps[None, :]
    q = _floordiv(24 * a + st, 3 * st)
    return torch.where(res < 0, -q, q)


def _dequant(q, steps):
    a = q.abs()
    d = (a * steps[None, :] + 4) >> 3
    return torch.where(q < 0, -d, d)


def _gather_blocks(vals, p):
    g = p["blk_gather"]
    return torch.where((g >= 0)[..., None], vals[g.clamp(min=0)], 0)


def _compact(acz, acy, acx, p):
    """Padded AC grids -> (npairs, C) rows in zrow coded order per
    stage (the per-group emission order is z|y|x)."""
    c = acz.shape[2]
    return tuple(ac.reshape(-1, c)[p[k]] for ac, (k, _) in
                 zip((acz, acy, acx), raht_plan.FLAT_KEYS))


# ---------------------------------------------------------------------
# the block butterfly with on-device coefficients (the mesh's attribute
# stage, parallel/slices.py:sharded_raht_fp_blocks)
# ---------------------------------------------------------------------

# the most channels one launch takes (csrc/raht_fp_blocks.cu: kMaxRun);
# more go through the kernel in runs, a launch each
KERNEL_RUN_MAX = 4
# the kernel's fast path: blocks whose weights are non-negative and sum
# below this (csrc/raht_fp_blocks.cu: kFastLimit)
FAST_WEIGHT_SUM = 1 << 22


def fwd_blocks_int_ref(blk_v: torch.Tensor, blk_w: torch.Tensor):
    """Plain PyTorch integer block butterfly (reference
    ``fwd_blocks_int``, ops/raht_fp_device.py:303-329, line for line):
    the Q15 coefficients of each pair from ``isqrt64_dev((w << 30) //
    ws)``, rounding by ``(x + QAH) >> QA``."""

    def stage(v, w):
        w0, w1 = w[:, 0::2], w[:, 1::2]
        ws = (w0 + w1).clamp(min=1)
        a = raht_plan.isqrt64_dev(_floordiv(w0 << 30, ws))
        b = raht_plan.isqrt64_dev(_floordiv(w1 << 30, ws))
        return _mix_stage(v, w0, w1, a, b)

    vz, acz, wz = stage(blk_v, blk_w)
    vy, acy, wy = stage(vz, wz)
    vx, acx, _ = stage(vy, wy)
    return vx[:, 0], acz, acy, acx


def _mix_stage(v, w0, w1, a, b):
    """One butterfly stage from its pair coefficients (int64 wrap-around,
    arithmetic rounding shift): (passed values, ACs, merged weights)."""
    v0, v1 = v[:, 0::2], v[:, 1::2]
    both = ((w0 > 0) & (w1 > 0))[..., None]
    a, b = a[..., None], b[..., None]
    dc = (a * v0 + b * v1 + QAH) >> QA
    ac = (a * v1 - b * v0 + QAH) >> QA
    single = torch.where((w0 > 0)[..., None], v0, v1)
    return (torch.where(both, dc, single), torch.where(both, ac, 0),
            w0 + w1)


# ---- the kernel's fast path, mirrored in plain torch (tests only) ------

def isqrt_fast_mirror(q: torch.Tensor) -> torch.Tensor:
    """The kernel's floor(sqrt(q)) for int64 q in [0, 2^30 + 1]: the fp32
    square root of q rounded to fp32, truncated, then the two correction
    rounds in 32-bit unsigned arithmetic (products kept mod 2^32)."""
    y = torch.sqrt(q.to(torch.float32)).to(_I64)
    m = 0xFFFFFFFF
    for _ in range(2):
        y = torch.where(((y + 1) * (y + 1)) & m <= q, y + 1, y)
        y = torch.where((y * y) & m > q, y - 1, y)
    return y


def fast_pair_coeffs_mirror(w0: torch.Tensor, w1: torch.Tensor):
    """The kernel's fast-path coefficients (a, b) of pairs with w0, w1 >= 0
    and w0 + w1 < 2^22, int64 tensors: the quotient q_a of w0 2^30 / ws
    from a float64 reciprocal-multiply truncated and one step against
    its remainder (kept mod 2^32, as the kernel's int), q_b = 2^30 - q_a
    - [r_a > 0] (0 when ws = 0), then ``isqrt_fast_mirror``.  Equal to
    ``isqrt64_dev(floor((w << 30) / max(ws, 1)))`` for each."""
    ws = w0 + w1
    d = ws.clamp(min=1)
    num = w0.to(torch.float64) * float(1 << 30)
    q = torch.trunc(num * (1.0 / d.to(torch.float64))).to(_I64)
    r = (w0 << 30) - q * d
    r = ((r + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)
    low = r < 0
    q, r = torch.where(low, q - 1, q), torch.where(low, r + d, r)
    high = r >= d
    q, r = torch.where(high, q + 1, q), torch.where(high, r - d, r)
    qb = torch.where(ws == 0, 0, (1 << 30) - q - (r > 0).to(_I64))
    return isqrt_fast_mirror(q), isqrt_fast_mirror(qb)


def fast_blocks(blk_w: torch.Tensor) -> torch.Tensor:
    """(B,) bool: the blocks the kernel takes through its fast path."""
    small = ((blk_w >= 0) & (blk_w < FAST_WEIGHT_SUM)).all(dim=1)
    return small & (torch.where(small[:, None], blk_w, 0).sum(dim=1)
                    < FAST_WEIGHT_SUM)


def fwd_blocks_int_mirror(blk_v: torch.Tensor, blk_w: torch.Tensor):
    """The kernel's arithmetic in plain torch: fast blocks take
    ``fast_pair_coeffs_mirror``, the rest ``isqrt64_dev`` of the floor
    division; the mix as ``fwd_blocks_int_ref`` (the kernel's 64x32-bit
    products wrap as int64 does, so torch's int64 products equal them)."""
    fast = fast_blocks(blk_w)[:, None]

    def stage(v, w):
        w0, w1 = w[:, 0::2], w[:, 1::2]
        ws = (w0 + w1).clamp(min=1)
        a = raht_plan.isqrt64_dev(_floordiv(w0 << 30, ws))
        b = raht_plan.isqrt64_dev(_floordiv(w1 << 30, ws))
        af, bf = fast_pair_coeffs_mirror(torch.where(fast, w0, 0),
                                         torch.where(fast, w1, 0))
        return _mix_stage(v, w0, w1, torch.where(fast, af, a),
                          torch.where(fast, bf, b))

    vz, acz, wz = stage(blk_v, blk_w)
    vy, acy, wy = stage(vz, wz)
    vx, acx, _ = stage(vy, wy)
    return vx[:, 0], acz, acy, acx


# ---- the wrapper -------------------------------------------------------

def channel_runs(nchan: int):
    """(start, width) runs of at most ``KERNEL_RUN_MAX`` channels, in
    channel order, one launch each (5 -> 4+1, 28 -> 7 x 4)."""
    return [(c, min(KERNEL_RUN_MAX, nchan - c))
            for c in range(0, nchan, KERNEL_RUN_MAX)]


def _in_channel_runs(run, blk_v: torch.Tensor, blk_w: torch.Tensor):
    """``run(values, weights)`` over (B, 8, C) values in the runs of
    ``channel_runs(C)``: a contiguous copy of each run's channels goes in,
    its four outputs land in those channels (no copies for one run).
    Right for any ``run`` that treats channels independently."""
    nb, _, nc = blk_v.shape
    runs = channel_runs(nc)
    if len(runs) == 1:
        return run(blk_v, blk_w)
    out = (blk_v.new_empty(nb, nc), blk_v.new_empty(nb, 4, nc),
           blk_v.new_empty(nb, 2, nc), blk_v.new_empty(nb, 1, nc))
    for c0, n in runs:
        part = run(blk_v[..., c0:c0 + n].contiguous(), blk_w)
        for o, p in zip(out, part):
            o[..., c0:c0 + n] = p
    return out


def fwd_blocks_int(blk_v: torch.Tensor, blk_w: torch.Tensor):
    """blk_v (B, 8, C) int64 Q13 values, blk_w (B, 8) int64 subtree
    weights (0 = empty slot) -> (dc (B, C), acz (B, 4, C), acy (B, 2, C),
    acx (B, 1, C)) int64, any C >= 1 and any layout.

    A CPU tensor runs ``fwd_blocks_int_ref``; a CUDA tensor launches
    ``raht_fwd_blocks_int`` of ``csrc/raht_fp_blocks.cu`` (bit-identical
    to it), once per run of ``channel_runs(C)``, or raises.  The kernel's
    domain is the plain version's: non-negative weights whose sum in a
    block stays below 2^33, so no ``w << 30`` wraps; blocks whose weights
    sum below 2^22 (every block of a real cloud) take its fast path."""
    dev = blk_v.device
    if dev.type == "cpu":
        return fwd_blocks_int_ref(blk_v, blk_w)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}: pass CPU tensors for "
                         "the plain version or CUDA tensors for the kernel")
    if blk_w.device != dev:
        raise ValueError(f"weights are on {blk_w.device}, values on {dev}")
    if blk_v.dtype != _I64 or blk_w.dtype != _I64:
        raise TypeError("values and weights must be int64")
    if (blk_v.dim() != 3 or blk_v.shape[1] != 8
            or tuple(blk_w.shape) != tuple(blk_v.shape[:2])):
        raise ValueError(f"need values (B, 8, C) and weights (B, 8), got "
                         f"{tuple(blk_v.shape)} and {tuple(blk_w.shape)}")
    nb, _, nc = blk_v.shape
    if nb == 0 or nc == 0:             # a grid of 0 is no valid launch
        return (blk_v.new_empty(nb, nc), blk_v.new_empty(nb, 4, nc),
                blk_v.new_empty(nb, 2, nc), blk_v.new_empty(nb, 1, nc))
    lib = _kernels.load()
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch(v, w):
        n = v.shape[2]
        out = (v.new_empty(nb, n), v.new_empty(nb, 4, n),
               v.new_empty(nb, 2, n), v.new_empty(nb, 1, n))
        with torch.cuda.device(dev):
            rc = lib.raht_fwd_blocks_int_launch(
                v.data_ptr(), w.data_ptr(), *(t.data_ptr() for t in out),
                nb, n, stream)
        _kernels.launched("fwd_blocks_int", rc)
        return out

    return _in_channel_runs(launch, _kernels.aligned(blk_v),
                            _kernels.aligned(blk_w))


def _truth_level_ref(vals, p):
    """Plain version of ``_truth_level`` (reference ``_truth_level``,
    ops/raht_fp_device.py:335)."""
    dc, acz, acy, acx = _fwd_block(_gather_blocks(vals, p), p)
    z, y, x = _compact(acz, acy, acx, p)
    return dc, z, y, x


def _inverse_group_pure(recon_p, rec_parts, p):
    mp = p["az"].shape[0]
    c = recon_p.shape[-1]
    dev = recon_p.device
    grids = []
    for (key, k), rec in zip(raht_plan.FLAT_KEYS, rec_parts):
        grid = torch.zeros((mp * k, c), dtype=_I64, device=dev)
        grid[p[key]] = rec
        grids.append(grid.reshape(mp, k, c))
    v8 = _inv_block(recon_p, *grids, p)
    g = p["blk_gather"]
    occ = g >= 0
    mc = p["pidx"].shape[0]
    flat = torch.zeros((mc, c), dtype=_I64, device=dev)
    flat.index_add_(0, g.clamp(min=0).reshape(-1),
                    torch.where(occ[..., None], v8, 0).reshape(-1, c))
    return flat


def _pred_ac(recon_p, grand_p, p, t0, t1, weights, have_grand):
    """Prediction pushed through the forward network, compacted like
    the truth ACs; plus the next group's grandparent counts."""
    pred, cnt = _predict(recon_p, grand_p, p, t0, t1, weights,
                         have_grand)
    _, pz, py, px = _fwd_block(_gather_blocks(pred, p), p)
    return _compact(pz, py, px, p), cnt


def _enc_group_ref(recon_p, grand_p, tz, ty, tx, steps, p,
                   t0, t1, weights, have_grand):
    """Plain version of ``_enc_group`` (reference ``_enc_group``,
    ops/raht_fp_device.py:342)."""
    preds, cnt = _pred_ac(recon_p, grand_p, p, t0, t1, weights,
                          have_grand)
    qs = []
    recs = []
    for tr, pr in zip((tz, ty, tx), preds):
        qq = _quant(tr - pr, steps)
        qs.append(qq)
        recs.append(pr + _dequant(qq, steps))
    recon_c = _inverse_group_pure(recon_p, recs, p)
    return qs[0], qs[1], qs[2], recon_c, cnt


def _dec_group_ref(recon_p, grand_p, qz, qy, qx, steps, p,
                   t0, t1, weights, have_grand):
    """Plain version of ``_dec_group`` (reference ``_dec_group``,
    ops/raht_fp_device.py:359)."""
    preds, cnt = _pred_ac(recon_p, grand_p, p, t0, t1, weights,
                          have_grand)
    recs = [pr + _dequant(qq, steps)
            for pr, qq in zip(preds, (qz, qy, qx))]
    return _inverse_group_pure(recon_p, recs, p), cnt


# ---------------------------------------------------------------------
# the closed loop's hand-written kernels (csrc/raht_fp_loop.cu)
# ---------------------------------------------------------------------

# raht_fp_group's mode bits
MODE_DECODE = 1       # q rows in (else truth rows in, q rows out)
MODE_ROOT = 2         # the parents are the roots: (de)quantise them first
MODE_FINAL = 4        # write (v + HALF) >> F
MODE_HAVE_GRAND = 8   # gate the prediction on the grandparent counts
MODE_Q32 = 16         # q rows out as int32 (else int64)
# the group kernel's tile of parent blocks and its channel window
# (csrc/raht_fp_loop.cu: kGT, kGMaxW)
GROUP_TILE = 32
GROUP_WINDOW = 4


def _cuda_truth(p, offsets, mp, vals, shift, dc, z, y, x):
    """Launch ``raht_fp_truth_level``: block values gathered from ``vals``
    (mc, C) << ``shift`` -> dc (mp, C) and the z, y, x AC rows."""
    lib = _kernels.load()
    with torch.cuda.device(vals.device):
        rc = lib.raht_fp_truth_level_launch(
            raht_plan.plan_ptrs(p, offsets), mp, vals.shape[1],
            vals.data_ptr(), shift,
            dc.data_ptr(), z.data_ptr(), y.data_ptr(), x.data_ptr(),
            _kernels.stream(vals))
    _kernels.launched("raht_fp_truth_level", rc)


def _cuda_group(p, offsets, mp, mode, recon_p, pf_p, grand_p, steps,
                rows_in, q_root_in, q_out, q_root_out, recon_c, pf_c, cnt_c,
                t0, weights, stats=None):
    """Launch ``raht_fp_group`` over the ``mp`` parent blocks of plan
    ``p``: see ``group_mirror`` for each argument."""
    dev = recon_c.device
    lib = _kernels.load()
    ints = (ctypes.c_int64 * 4)(t0, *weights)
    octs = (ctypes.c_uint8 * len(raht_plan.NBR_OCTANTS))(
        *raht_plan.NBR_OCTANTS)
    with torch.cuda.device(dev):
        rc = lib.raht_fp_group_launch(
            raht_plan.staged_plan_ptrs(p, offsets), mp, steps.shape[0], mode,
            _kernels.ptr(recon_p), _kernels.ptr(pf_p), _kernels.ptr(grand_p),
            steps.data_ptr(), _kernels.ptrs(rows_in),
            _kernels.ptr(q_root_in), _kernels.ptrs(q_out),
            _kernels.ptr(q_root_out), recon_c.data_ptr(), _kernels.ptr(pf_c),
            cnt_c.data_ptr(), ints, octs, _kernels.ptr(stats),
            _kernels.stream(recon_c))
    _kernels.launched("raht_fp_group", rc)


def _group_shapes(p):
    """(mp, mc, (nz, ny, nx)) of a plan."""
    return (p["az"].shape[0], p["pidx"].shape[0],
            tuple(p[k].shape[0] for k, _ in raht_plan.FLAT_KEYS))


def _truth_level(vals, p):
    """One truth level (reference ``_truth_level``, ops/raht_fp_device.py
    :335): the blocks' values gathered from ``vals`` (mc, C) int64, their
    forward network, the ACs compacted in zrow order.  Returns (dc (mp,
    C), z, y, x rows).  A CUDA tensor launches ``raht_fp_truth_level``
    (with the plan's ``row_offsets``) or raises; a CPU tensor runs
    ``_truth_level_ref``."""
    if not _kernels.on_card(vals):
        return _truth_level_ref(vals, p)
    mp, _, counts = _group_shapes(p)
    vals = vals.contiguous()
    c = vals.shape[1]
    dc = vals.new_empty(mp, c)
    z, y, x = (vals.new_empty(n, c) for n in counts)
    if mp:
        _cuda_truth(p, raht_plan.row_offsets(p), mp, vals, 0, dc, z, y, x)
    return dc, z, y, x


def _group_call(recon_p, grand_p, rows, steps, p, t0, weights, have_grand,
                decode):
    mp, mc, counts = _group_shapes(p)
    c = steps.shape[0]
    recon_p = recon_p.contiguous()
    rows = [r.contiguous() for r in rows]
    recon_c = recon_p.new_empty(mc, c)
    cnt = recon_p.new_empty(mc)
    q = [None] * 3 if decode else [recon_p.new_empty(n, c) for n in counts]
    mode = (MODE_DECODE if decode else 0) | \
        (MODE_HAVE_GRAND if have_grand else 0)
    if mp:
        _cuda_group(p, raht_plan.row_offsets(p), mp, mode, recon_p, None,
                    grand_p.contiguous() if have_grand else None, steps,
                    rows, None, q, None, recon_c, None, cnt, t0, weights)
    return q, recon_c, cnt


def _enc_group(recon_p, grand_p, tz, ty, tx, steps, p,
               t0, t1, weights, have_grand):
    """One encoder group (reference ``_enc_group``, ops/raht_fp_device.py
    :342): prediction from the parents' reconstruction, its forward
    network, the residuals' q rows, the children's reconstruction.
    Returns (qz, qy, qx, recon_c, next group's grandparent counts).  A
    CUDA tensor launches ``raht_fp_group`` (the parents' means computed
    per read) or raises; a CPU tensor runs ``_enc_group_ref``.  ``t1``
    is in the plan already (``en_base``)."""
    if not _kernels.on_card(recon_p):
        return _enc_group_ref(recon_p, grand_p, tz, ty, tx, steps, p,
                              t0, t1, weights, have_grand)
    q, recon_c, cnt = _group_call(recon_p, grand_p, (tz, ty, tx), steps, p,
                                  t0, weights, have_grand, decode=False)
    return q[0], q[1], q[2], recon_c, cnt


def _dec_group(recon_p, grand_p, qz, qy, qx, steps, p,
               t0, t1, weights, have_grand):
    """One decoder group (reference ``_dec_group``, ops/raht_fp_device.py
    :359): returns (recon_c, next group's grandparent counts).  A CUDA
    tensor launches ``raht_fp_group`` or raises; a CPU tensor runs
    ``_dec_group_ref``."""
    if not _kernels.on_card(recon_p):
        return _dec_group_ref(recon_p, grand_p, qz, qy, qx, steps, p,
                              t0, t1, weights, have_grand)
    _, recon_c, cnt = _group_call(recon_p, grand_p, (qz, qy, qx), steps, p,
                                  t0, weights, have_grand, decode=True)
    return recon_c, cnt


# ---- the kernels' arithmetic in plain torch (tests only) ---------------

def quant_f_mirror(res, st, d3, r3, count=None, use=None):
    """The group kernel's ``quant_f``: ``_quant`` of res (n, W) with the
    channels' steps st, 3 st and ``fast_rcp_mirror(3 st)`` through
    ``fdiv_mirror`` (``raht_plan``'s)."""
    a = res.abs()
    q = raht_plan.fdiv_mirror(24 * a + st, d3, r3, count, use)
    return torch.where(res < 0, -q, q)


def _coef_mirror(p):
    """(a, b, valid, hi) of the 7 butterflies a block, (mp, 7): z pairs
    k = 0..3, y k = 4, 5, x k = 6 (the kernel's ``Coef``)."""
    a = torch.cat([p["az"], p["ay"], p["ax"][:, None]], 1)
    b = torch.cat([p["bz"], p["by"], p["bx"][:, None]], 1)
    valid = torch.cat([p["vz"], p["vy"], p["vx"][:, None]], 1)
    hi = torch.cat([p["sz"], p["sy"], p["sx"][:, None]], 1) == 1
    return a, b, valid, hi


def _pair_rows_mirror(offsets, valid):
    """(mp, 7) zrow row of each butterfly, -1 where it is no pair."""
    oz, oy, ox = offsets
    off = torch.cat([oz[:, None].expand(-1, 4), oy[:, None].expand(-1, 2),
                     ox[:, None]], 1)
    v = valid.to(_I64)
    rank = torch.cat([torch.cumsum(v[:, :4], 1), torch.cumsum(v[:, 4:6], 1),
                      v[:, 6:]], 1) - v
    return torch.where(valid, off + rank, -1)


def _forward_mirror(cf, v8):
    """The kernel's ``forward`` on (mp, 8, C): (dc (mp, C), ac (mp, 7,
    C))."""
    a, b, valid, hi = (t[..., None] for t in cf)

    def pair(k, v0, v1):
        dc = (a[:, k] * v0 + b[:, k] * v1 + QAH) >> QA
        ac = (a[:, k] * v1 - b[:, k] * v0 + QAH) >> QA
        return (torch.where(valid[:, k], dc, torch.where(hi[:, k], v1, v0)),
                torch.where(valid[:, k], ac, 0))

    vz, acs = [], []
    for s in range(4):
        o, ac = pair(s, v8[:, 2 * s], v8[:, 2 * s + 1])
        vz.append(o)
        acs.append(ac)
    vy = []
    for s in range(2):
        o, ac = pair(4 + s, vz[2 * s], vz[2 * s + 1])
        vy.append(o)
        acs.append(ac)
    dc, ac = pair(6, vy[0], vy[1])
    acs.append(ac)
    return dc, torch.stack(acs, 1)


def _inverse_mirror(cf, dc, ac):
    """The kernel's ``inverse``: dc (mp, C), ac (mp, 7, C) -> (mp, 8, C)."""
    a, b, valid, hi = (t[..., None] for t in cf)

    def unpair(k, v, acv):
        o0 = (a[:, k] * v - b[:, k] * acv + QAH) >> QA
        o1 = (b[:, k] * v + a[:, k] * acv + QAH) >> QA
        return (torch.where(valid[:, k], o0, torch.where(hi[:, k], 0, v)),
                torch.where(valid[:, k], o1, torch.where(hi[:, k], v, 0)))

    vy = unpair(6, dc, ac[:, 6])
    vz = []
    for s in range(2):
        vz.extend(unpair(4 + s, vy[s], ac[:, 4 + s]))
    v8 = []
    for s in range(4):
        v8.extend(unpair(s, vz[s], ac[:, s]))
    return torch.stack(v8, 1)


def _put_rows(cf_valid, rows, k, stage_out, vals):
    """stage_out[rows[:, k]] = vals where pair k is valid."""
    sel = cf_valid[:, k]
    stage_out[rows[sel, k]] = vals[sel].to(stage_out.dtype)


def truth_level_mirror(p, offsets, mp, vals, shift, dc, z, y, x):
    """``raht_fp_truth_level`` in plain torch, in place, with the
    launcher's signature."""
    cf = _coef_mirror(p)
    rows = _pair_rows_mirror(offsets, cf[2])
    g = p["blk_gather"]
    v8 = torch.where((g >= 0)[..., None], vals[g.clamp(min=0)] << shift, 0)
    d, ac = _forward_mirror(cf, v8)
    dc.copy_(d)
    for k, out in enumerate((z, z, z, z, y, y, x)):
        _put_rows(cf[2], rows, k, out, ac[:, k])


def group_mirror(p, offsets, mp, mode, recon_p, pf_p, grand_p, steps,
                 rows_in, q_root_in, q_out, q_root_out, recon_c, pf_c, cnt_c,
                 t0, weights, stats=None, tile=GROUP_TILE):
    """``raht_fp_group`` in plain torch, in place, with the launcher's
    signature and the kernel's algorithm (``tile``: parent blocks a
    tile, the kernel's unless a test asks for another).  offsets: the plan's
    ``row_offsets``; recon_p (mp, C): the parents' reconstruction (at the
    root: the roots' DC truth when encoding, None when decoding); pf_p:
    the parents' Q13 means or None (computed as they are gathered);
    grand_p (mp,) or None; rows_in: z, y, x truth rows (encode) or q rows
    (decode); q_root_in: the roots' q rows (decoding at the root); q_out,
    q_root_out: where encoding writes q rows; recon_c, pf_c (or None),
    cnt_c: the children's reconstruction, Q13 means and next grandparent
    counts; stats: None or a (2,) int64 tensor that the fast and the
    general divisions are added to, as the kernel counts them.

    The kernel's steps, tile by tile of parent blocks: the tile's rows
    of every plan tensor but ``sw_c`` and ``sw_p`` (the staged tile); the
    means of the 18 neighbour rows the planner marks and the block's own,
    ``GROUP_WINDOW`` channels at a time, and each child's ``sw_c`` (the
    gather); per block the keep mask from channel 0 and the enable bit,
    per child 1 / sw_c (the prologue); per (block, channel) the weight
    sums and the prediction, its forward network, the q rows, the
    inverse network and the children's rows.  Every
    division goes through ``raht_plan.fdiv_mirror``."""
    w_self, w_face, w_edge = weights
    decode, root = mode & MODE_DECODE, mode & MODE_ROOT
    dev = steps.device
    nc = steps.shape[0]
    win = min(nc, GROUP_WINDOW)
    count = torch.zeros(2, dtype=_I64, device=dev)
    plan = dict(zip(raht_plan.PLAN_NAMES, raht_plan.kernel_plan(p, offsets)))
    touch = torch.tensor([[(m >> o) & 1 for o in range(8)]
                          for m in raht_plan.NBR_OCTANTS], dtype=torch.bool,
                         device=dev)                        # (18, 8)
    wj = torch.tensor([w_face] * 6 + [w_edge] * 12, dtype=_I64, device=dev)
    d3 = 3 * steps
    r3 = raht_plan.fast_rcp_mirror(d3)

    def parent_recon(r, cs, use):
        st, d, rc = steps[cs], d3[cs], r3[cs]
        if not root:
            return recon_p[r][:, cs]
        if decode:
            return _dequant(q_root_in[r][:, cs], st)
        q = quant_f_mirror(recon_p[r][:, cs], st, d, rc, count, use)
        return _dequant(q, st)

    for b0 in range(0, mp, tile):
        rows = min(tile, mp - b0)
        t = {k: v[b0:b0 + rows] for k, v in plan.items()
             if k not in ("sw_c", "sw_p")}
        blk = torch.arange(b0, b0 + rows, dtype=_I64, device=dev)
        ridx = torch.cat([t["nbr_idx"], blk[:, None]], 1)   # (rows, 19)
        rok = torch.cat([t["nbr_ok"],
                         torch.ones(rows, 1, dtype=torch.bool, device=dev)],
                        1)
        g = t["blk_gather"]
        child = g >= 0
        swc = torch.where(child, p["sw_c"][g.clamp(min=0)], 1)
        keep = en = wsum = rw = rs = None
        for c0 in range(0, nc, win):
            cs = list(range(c0, min(c0 + win, nc)))
            cols = torch.tensor(cs, dtype=_I64, device=dev)
            # the gather: (rows, 19, W) means of the marked rows
            r = ridx[rok]
            use = torch.ones(r.numel(), len(cs), dtype=torch.bool,
                             device=dev)
            if pf_p is not None:
                got = pf_p[r][:, cs]
            else:
                sw = p["sw_p"][r][:, None]
                got = raht_plan.fdiv_mirror(
                    parent_recon(r, cs, use) << QA, sw,
                    raht_plan.fast_rcp_mirror(sw), count, use)
            nmean = torch.zeros(rows, 19, len(cs), dtype=_I64, device=dev)
            nmean[rok] = got
            if c0 == 0:                  # the prologue, one a block
                pv = nmean[:, 18, 0, None]
                nl = 10 * nmean[:, :18, 0]
                keep = t["nbr_ok"] & (nl > 2 * pv) & (nl < 25 * pv)
                kw = torch.where(keep, wj, 0)               # (rows, 18)
                wsum = w_self + (kw[:, :, None] * touch).sum(1)   # (rows, 8)
                en = t["en_base"]
                if mode & MODE_HAVE_GRAND:
                    en = en & (grand_p[b0:b0 + rows] >= t0)
                rw = raht_plan.fast_rcp_mirror(wsum)
                rs = raht_plan.fast_rcp_mirror(swc)
            # per (block, channel): the prediction
            kw = torch.where(keep, wj, 0)[..., None]        # (rows, 18, 1)
            s = ((nmean[:, :18] * kw)[:, :, None, :]
                 * touch[None, :, :, None]).sum(1)          # (rows, 8, W)
            self_ = nmean[:, 18, None, :] * w_self
            use = (child & en[:, None])[..., None].expand(-1, -1, len(cs))
            pm = raht_plan.fdiv_mirror(self_ + s, wsum[..., None],
                                       rw[..., None], count, use)
            pred = torch.where(use, (pm * swc[..., None] + QAH) >> QA, 0)
            cf = _coef_mirror(t)
            rows_k = _pair_rows_mirror((t["off_z"], t["off_y"], t["off_x"]),
                                       cf[2])
            _, pac = _forward_mirror(cf, pred)
            st, d, rc = steps[cs], d3[cs], r3[cs]
            rec = torch.zeros_like(pac)
            for k in range(7):
                stage = 0 if k < 4 else (1 if k < 6 else 2)
                sel = cf[2][:, k]
                rr = rows_k[sel, k]
                if decode:
                    q = rows_in[stage][rr][:, cs]
                else:
                    q = quant_f_mirror(rows_in[stage][rr][:, cs] - pac[sel, k],
                                       st, d, rc, count)
                    q_out[stage][rr[:, None], cols] = \
                        q.to(q_out[stage].dtype)
                rec[sel, k] = pac[sel, k] + _dequant(q, st)
            every = torch.ones(rows, len(cs), dtype=torch.bool, device=dev)
            dc = parent_recon(blk, cs, every)
            if root and not decode:
                q_root_out[blk[:, None], cols] = quant_f_mirror(
                    recon_p[blk][:, cs], st, d, rc, count).to(
                        q_root_out.dtype)
            v8 = _inverse_mirror(cf, dc, rec)
            val, dst = v8[child], g[child]
            recon_c[dst[:, None], cols] = ((val + HALF) >> F) \
                if mode & MODE_FINAL else val
            if pf_c is not None:
                pf_c[dst[:, None], cols] = raht_plan.fdiv_mirror(
                    val << QA, swc[child][:, None], rs[child][:, None], count)
            if c0 == 0:
                cnt_c[dst] = t["cnt_p"][:, None].expand(-1, 8)[child]
    if stats is not None:
        stats += count


CUDA_LAUNCHERS = (_cuda_truth, _cuda_group)
MIRROR_LAUNCHERS = (truth_level_mirror, group_mirror)


class DeviceFpRaht:
    """Per-frame device codec state: the frame's plan, then
    encode()/decode() run the closed loop on ``device`` (default: the
    current CUDA device; ``NoDeviceError`` without one).  On a CUDA
    device the plan is built there from the uploaded codes
    (``raht_plan.build_plan``'s kernels); elsewhere ``build_fp_plan``
    builds it on the host and ``plans_to_torch`` carries it over."""

    def __init__(self, leaf_codes: np.ndarray, depth: int, steps_q16,
                 thresholds=(raht_fp._PRED_T0, raht_fp._PRED_T1),
                 weights=(raht_fp._W_SELF, raht_fp._W_FACE,
                          raht_fp._W_EDGE),
                 device=None):
        self.device = resolve_device(device)
        self.depth = depth
        self.t0, self.t1 = thresholds
        self.weights = tuple(int(w) for w in weights)
        self.steps = torch.as_tensor(np.asarray(steps_q16, dtype=np.int64),
                                     device=self.device)
        if self.device.type == "cuda":
            with timing.span("raht.plan.upload"):
                codes = torch.as_tensor(np.asarray(leaf_codes, np.int64),
                                        device=self.device)
            with timing.span("raht.plan.build"):
                plan = raht_plan.build_plan(codes, depth, self.t1)
            timing.count("raht.plan.device_levels", depth)
        else:
            with timing.span("raht.plan.build"):
                host_plans = build_fp_plan(leaf_codes, depth, thresholds)
            with timing.span("raht.plan.upload"):
                plans = plans_to_torch(host_plans, self.device)
                offsets = [raht_plan.row_offsets(p) for p in plans]
            plan = raht_plan.FramePlan(
                plans, offsets,
                [(hp.flat_z.size, hp.flat_y.size, hp.flat_x.size)
                 for hp in host_plans],
                host_plans[-1].mp if host_plans else leaf_codes.shape[0])
        self.plans, self.offsets, self.pair_counts, self.n_roots = plan
        self.rows = plan.coded_rows()     # where each q row lies

    def _group_kw(self, gi):
        return dict(t0=self.t0, t1=self.t1, weights=self.weights,
                    have_grand=gi > 0)

    def encode(self, values: np.ndarray, emit):
        """values (N, C) ints.  emit(q_rows int32 (m, C)) is called in
        coded order (root, then groups coarse->fine, z|y|x per group)
        with host arrays.  Returns the device reconstruction (Q13).  On a
        CUDA device the loop is the kernels' (``_encode_kernels``), else
        the plain versions' (``_encode_plain``); the q rows reach the
        host in ONE copy either way."""
        vals = torch.as_tensor(np.asarray(values, dtype=np.int64),
                               device=self.device)
        if self.device.type == "cuda" and self.depth > 0:
            recon, qbuf = self._encode_kernels(vals, CUDA_LAUNCHERS)
            host = qbuf.cpu().numpy()
            for cut in self.rows.slices():
                emit(host[cut])
            return recon
        return self._encode_plain(vals, emit)

    def _encode_plain(self, vals, emit):
        """The closed loop of the plain versions (any device)."""
        vals = vals << F
        acs_true = []          # per group (z, y, x) compacted
        cur = vals
        for g in range(self.depth):
            cur, z, y, x = _truth_level_ref(cur, self.plans[g])
            acs_true.append((z, y, x))
        root = cur                                   # (n_roots, C)

        q_root = _quant(root, self.steps)
        recon = _dequant(q_root, self.steps)
        grand = torch.zeros((self.n_roots,), dtype=_I64, device=self.device)
        pending = [q_root]
        for gi in range(self.depth):
            g = self.depth - 1 - gi                  # plan index
            tz, ty, tx = acs_true[g]
            qz, qy, qx, recon, grand = _enc_group_ref(
                recon, grand, tz, ty, tx, self.steps, self.plans[g],
                **self._group_kw(gi))
            pending.extend((qz, qy, qx))
        # ONE device->host copy of every q row, split on the host
        c = pending[0].shape[-1]
        host = torch.cat([q.to(torch.int32).reshape(-1) for q in pending]
                         ).cpu().numpy()
        off = 0
        for q in pending:
            m = q.shape[0]
            emit(host[off:off + m * c].reshape(m, c))
            off += m * c
        return recon

    def _encode_kernels(self, vals, launchers):
        """The encoder's loop as the card runs it: ``_truth_kernels``,
        then ``_enc_group_kernels``.  ``launchers``: ``CUDA_LAUNCHERS``
        or ``MIRROR_LAUNCHERS``.  Returns (reconstruction (N, C) Q13, q
        buffer (total, C) int32 in coded order)."""
        truth, root = self._truth_kernels(vals, launchers)
        return self._enc_group_kernels(truth, root, launchers)

    def _truth_kernels(self, vals, launchers):
        """``depth`` truth-level launches, the first shifting the values
        (N, C) to Q13 as it reads them, writing the truth ACs into one
        (total, C) int64 buffer in coded order.  Returns (buffer, the
        roots' DC (n_roots, C))."""
        truth_launch = launchers[0]
        total, _, groups = self.rows
        c = vals.shape[1]
        truth = vals.new_empty(total, c)
        cur, shift = vals.contiguous(), F
        for g in range(self.depth):
            p = self.plans[g]
            mp = _group_shapes(p)[0]
            dc = vals.new_empty(mp, c)
            truth_launch(p, self.offsets[g], mp, cur, shift, dc,
                         *(truth[r] for r in groups[self.depth - 1 - g]))
            cur, shift = dc, 0
        return truth, cur

    def _enc_group_kernels(self, truth, root, launchers):
        """``depth`` encode-group launches over ``_truth_kernels``'
        outputs: the first quantises the roots, each hands the next its
        children's Q13 means, the q rows land as int32 in one (total, C)
        buffer in coded order.  Returns (reconstruction, q buffer)."""
        group_launch = launchers[1]
        total, root_rows, groups = self.rows
        c = root.shape[1]
        qbuf = torch.empty((total, c), dtype=torch.int32, device=root.device)
        recon, pf, grand = root, None, None
        for gi in range(self.depth):
            g = self.depth - 1 - gi
            p = self.plans[g]
            mp, mc, _ = _group_shapes(p)
            last = gi == self.depth - 1
            recon_c, cnt = root.new_empty(mc, c), root.new_empty(mc)
            pf_c = None if last else root.new_empty(mc, c)
            mode = MODE_Q32 | (MODE_ROOT if gi == 0 else MODE_HAVE_GRAND)
            group_launch(p, self.offsets[g], mp, mode, recon, pf, grand,
                         self.steps, [truth[r] for r in groups[gi]], None,
                         [qbuf[r] for r in groups[gi]],
                         qbuf[root_rows] if gi == 0 else None, recon_c,
                         pf_c, cnt, self.t0, self.weights)
            recon, pf, grand = recon_c, pf_c, cnt
        return recon, qbuf

    def decode(self, read_q, ncomp: int):
        """read_q(m) -> (m, ncomp) int host rows, called in coded order
        (the counts are geometry-static).  Returns the (N, ncomp) int64
        values on the device.  The host entropy-decodes every row up
        front and uploads them in ONE copy; on a CUDA device the loop is
        the kernels' (``_decode_kernels``), else the plain versions'."""
        counts = [c.stop - c.start for c in self.rows.slices()]
        host = np.concatenate(
            [np.asarray(read_q(m), dtype=np.int64).reshape(m, ncomp)
             for m in counts], axis=0)
        rows = torch.as_tensor(host, device=self.device)
        if self.device.type == "cuda" and self.depth > 0:
            return self._decode_kernels(rows, CUDA_LAUNCHERS)
        return self._decode_plain(rows, counts)

    def _decode_plain(self, rows, counts):
        rows = rows.split(counts)
        recon = _dequant(rows[0], self.steps)
        grand = torch.zeros((self.n_roots,), dtype=_I64, device=self.device)
        for gi in range(self.depth):
            g = self.depth - 1 - gi
            qz, qy, qx = rows[1 + 3 * gi:4 + 3 * gi]
            recon, grand = _dec_group_ref(
                recon, grand, qz, qy, qx, self.steps, self.plans[g],
                **self._group_kw(gi))
        return (recon + HALF) >> F

    def _decode_kernels(self, rows, launchers):
        """The decoder's loop as the card runs it: ``depth`` group
        launches over the (total, C) int64 q rows, the first
        dequantising the roots, each handing the next its children's
        Q13 means, the last writing (v + HALF) >> F."""
        _, group_launch = launchers
        _, root_rows, groups = self.rows
        c = rows.shape[1]
        recon, pf, grand = None, None, None
        for gi in range(self.depth):
            g = self.depth - 1 - gi
            p = self.plans[g]
            mp, mc, _ = _group_shapes(p)
            last = gi == self.depth - 1
            recon_c, cnt = rows.new_empty(mc, c), rows.new_empty(mc)
            pf_c = None if last else rows.new_empty(mc, c)
            mode = MODE_DECODE | (MODE_ROOT if gi == 0 else MODE_HAVE_GRAND) \
                | (MODE_FINAL if last else 0)
            group_launch(p, self.offsets[g], mp, mode, recon, pf, grand,
                         self.steps, [rows[r] for r in groups[gi]],
                         rows[root_rows] if gi == 0 else None,
                         [None] * 3, None, recon_c, pf_c, cnt, self.t0,
                         self.weights)
            recon, pf, grand = recon_c, pf_c, cnt
        return recon
