"""RAHT 2x2x2 block butterflies: counterpart of
``mpeg_pcc_tmc13_tpu/ops/pallas_raht.py`` (``fwd_blocks``, ``inv_blocks``).

Same public layout and dtypes as the JAX functions: values/coefficients
(B, 8, C) float32, weights (B, 8) float32, AC mask (B, 8) int32.

* A CUDA tensor launches the hand-written kernel of
  ``csrc/raht_blocks.cu`` (built on first use) or raises.  The kernels
  are built for 1 and 3 channels; any other count goes through them in
  groups of 3 and 1 channels (``channel_groups``), since the butterfly
  treats channels independently and the output weights and the AC mask
  depend on the weights alone.
* A CPU tensor runs the plain PyTorch version, ``fwd_blocks_ref`` /
  ``inv_blocks_ref``, which is also what the kernels are checked against
  on the card.

``_kernels.LAUNCHES`` counts kernel launches per kernel (a launch adds
one, the plain versions add nothing), so a run can show it went through
them.
"""

from __future__ import annotations

import torch

from . import _kernels

# dyadic pair schedule (lo, hi): z, then y, then x
_STAGES = (
    ((0, 1), (2, 3), (4, 5), (6, 7)),
    ((0, 2), (4, 6)),
    ((0, 4),),
)


def channel_groups(nchan: int):
    """Split ``nchan`` channels into runs of the widths the kernels are
    built for (colour, 3, and reflectance, 1): (start, width) pairs in
    channel order, as many runs of 3 as fit and runs of 1 for the rest
    (2 -> 1+1, 5 -> 3+1+1, 7 -> 3+3+1)."""
    threes = nchan // 3
    return ([(3 * i, 3) for i in range(threes)]
            + [(c, 1) for c in range(3 * threes, nchan)])


def _pair(wl, wh):
    both = (wl > 0.0) & (wh > 0.0)
    only_hi = (wl <= 0.0) & (wh > 0.0)
    rs = torch.sqrt(torch.clamp(wl + wh, min=1e-30))
    a = torch.sqrt(torch.clamp(wl, min=0.0)) / rs
    b = torch.sqrt(torch.clamp(wh, min=0.0)) / rs
    w_lo = torch.where(both, wl + wh, torch.where(only_hi, wh, wl))
    return both, only_hi, a, b, w_lo


def fwd_blocks_ref(vals: torch.Tensor, weights: torch.Tensor):
    """Plain PyTorch forward block butterflies (the Pallas
    ``_block_kernel``, pallas_raht.py:48-82, slot by slot)."""
    v = [vals[:, j] for j in range(8)]               # (B, C) each
    w = [weights[:, j] for j in range(8)]            # (B,) each
    zero_v = torch.zeros_like(v[0])
    zero_w = torch.zeros_like(w[0])
    ac = [zero_v] * 8
    ac_on = [zero_w.to(torch.int32)] * 8
    for pairs in _STAGES:
        for lo, hi in pairs:
            both, only_hi, a, b, w_lo = _pair(w[lo], w[hi])
            a_, b_ = a[:, None], b[:, None]
            dc = a_ * v[lo] + b_ * v[hi]
            acv = -b_ * v[lo] + a_ * v[hi]
            v[lo] = torch.where(both[:, None], dc,
                                torch.where(only_hi[:, None], v[hi], v[lo]))
            w[lo] = w_lo
            ac[hi] = torch.where(both[:, None], acv, 0.0)
            ac_on[hi] = both.to(torch.int32)
    coeffs = torch.stack([v[0]] + ac[1:], dim=1)
    wout = torch.stack([w[0]] + [zero_w] * 7, dim=1)
    mask = torch.stack(ac_on, dim=1)
    return coeffs, wout, mask


def inv_blocks_ref(coeffs: torch.Tensor, weights: torch.Tensor):
    """Plain PyTorch inverse block butterflies (the Pallas
    ``_inv_block_kernel``, pallas_raht.py:140-174).  An empty lo slot
    keeps the pair's DC, as in the reference; callers mask it."""
    v_in = [coeffs[:, j] for j in range(8)]
    w = [weights[:, j] for j in range(8)]
    snaps = []
    for pairs in _STAGES:
        for lo, hi in pairs:
            both, only_hi, a, b, w[lo] = _pair(w[lo], w[hi])
            snaps.append((lo, hi, both[:, None], only_hi[:, None],
                          a[:, None], b[:, None]))
    v = [None] * 8
    v[0] = v_in[0]
    for lo, hi, both, only_hi, a, b in reversed(snaps):
        dc = v[lo]
        ac = v_in[hi]
        v1 = a * dc - b * ac
        v2 = b * dc + a * ac
        v[lo] = torch.where(both, v1, dc)
        v[hi] = torch.where(both, v2, torch.where(only_hi, dc, 0.0))
    return torch.stack(v, dim=1)


def _check(name, t, ndim, dtype, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim or t.shape[1] != 8:
        raise ValueError(f"{name} must be (B, 8{', C' if ndim == 3 else ''})"
                         f", got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _kernel_inputs(vals, weights):
    """Validate a kernel call; returns (B, C) or raises for what the
    kernels do not take."""
    dev = vals.device
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}: pass CPU tensors for "
                         "the plain version or CUDA tensors for the kernel")
    _check("values", vals, 3, torch.float32, dev)
    _check("weights", weights, 2, torch.float32, dev)
    if weights.shape[0] != vals.shape[0]:
        raise ValueError("values and weights disagree on B")
    return vals.shape[0], vals.shape[2]


def _by_channel_runs(launch, src: torch.Tensor, out: torch.Tensor) -> None:
    """``out = f(src)`` for (B, 8, C) tensors of any C through an ``f``
    that takes 1 or 3 channels: ``launch(part, res)`` runs on a
    contiguous copy of each run of ``channel_groups(C)`` and its result
    lands in the run's channels of ``out`` (no copies when C is 1 or 3).
    Right for any ``f`` that treats channels independently."""
    nc = src.shape[2]
    for c0, n in channel_groups(nc):
        part = src[:, :, c0:c0 + n].contiguous()
        res = out if n == nc else torch.empty_like(part)
        launch(part, res)
        if res is not out:
            out[:, :, c0:c0 + n] = res


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def fwd_blocks(vals: torch.Tensor, weights: torch.Tensor):
    """(B,8,C) float32 values + (B,8) float32 weights ->
    (coeffs (B,8,C), wout (B,8), ac_mask (B,8) int32).

    coeffs slot 0 is the block DC (weight wout[:, 0]); slots with
    ac_mask != 0 hold the block's ACs."""
    if vals.device.type == "cpu":
        return fwd_blocks_ref(vals, weights)
    nb, nc = _kernel_inputs(vals, weights)
    coeffs = torch.empty_like(vals)
    wout = torch.empty_like(weights)
    mask = torch.empty(weights.shape, dtype=torch.int32, device=vals.device)
    if nb == 0:                        # a grid of 0 is no valid launch
        return coeffs, wout, mask
    lib = _kernels.load()

    def launch(part, res):
        # wout and mask follow from the weights: every run writes the same
        with torch.cuda.device(vals.device):
            rc = lib.raht_fwd_blocks_launch(
                part.data_ptr(), weights.data_ptr(), res.data_ptr(),
                wout.data_ptr(), mask.data_ptr(), nb, part.shape[2],
                _stream(vals))
        _kernels.launched("fwd_blocks", rc)

    if nc == 0:                        # wout and mask need one launch still
        launch(vals.new_zeros(nb, 8, 1), vals.new_empty(nb, 8, 1))
    _by_channel_runs(launch, vals, coeffs)
    return coeffs, wout, mask


def inv_blocks(coeffs: torch.Tensor, weights: torch.Tensor):
    """Inverse of fwd_blocks: (B,8,C) coeffs (slot 0 DC + ACs) and the
    ORIGINAL per-slot child weights (B,8) -> (B,8,C) child values."""
    if coeffs.device.type == "cpu":
        return inv_blocks_ref(coeffs, weights)
    nb, nc = _kernel_inputs(coeffs, weights)
    out = torch.empty_like(coeffs)
    if nb == 0 or nc == 0:
        return out
    lib = _kernels.load()

    def launch(part, res):
        with torch.cuda.device(coeffs.device):
            rc = lib.raht_inv_blocks_launch(
                part.data_ptr(), weights.data_ptr(), res.data_ptr(), nb,
                part.shape[2], _stream(coeffs))
        _kernels.launched("inv_blocks", rc)

    _by_channel_runs(launch, coeffs, out)
    return out
