"""Device-side float RAHT, forward and inverse: counterpart of
``mpeg_pcc_tmc13_tpu/ops/raht_device.py``.

The host derives the per-level block structure from the sorted Morton
codes (``build_block_plan``, numpy); the device gathers each octree
level's occupied 2x2x2 blocks into dense (B, 8, C) tensors and runs the
block-butterfly kernels of ``ops.raht_blocks`` level by level.  DCs
(slot 0 of each block) become the next level's values; ACs are the
transform coefficients.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..utils.device import resolve as resolve_device
from . import raht_blocks


def build_block_plan(leaf_codes: np.ndarray, depth: int):
    """Host: per octree level, the block gather plan.

    Returns list over levels (fine -> coarse) of dicts:
      gather  (B, 8) int32 — index into the level's node array per
              slot, -1 for empty slots,
      parent_codes (B,)   — the block's parent node codes (sorted).
    """
    plan = []
    codes = leaf_codes.astype(np.int64)
    for l in range(depth):
        parent = codes >> 3
        slot = (codes & 7).astype(np.int64)
        first = np.concatenate([[True], parent[1:] != parent[:-1]])
        block_of = np.cumsum(first) - 1
        nblocks = int(block_of[-1]) + 1 if codes.size else 0
        gather = np.full((nblocks, 8), -1, dtype=np.int32)
        gather[block_of, slot] = np.arange(codes.size, dtype=np.int32)
        parent_codes = parent[first]
        plan.append({"gather": gather, "parent_codes": parent_codes})
        codes = parent_codes
    return plan


def stage_plan(leaf_codes: np.ndarray, depth: int, device) -> List:
    """Upload the block gather plan once, as int64 (B, 8) tensors on
    ``device``; forward_device/inverse_device(staged=...) then run
    without host transfers."""
    return [torch.as_tensor(p["gather"], dtype=torch.int64, device=device)
            for p in build_block_plan(leaf_codes, depth)]


def _as_values(values, device) -> torch.Tensor:
    v = torch.as_tensor(values, dtype=torch.float32, device=device)
    return v[:, None] if v.dim() == 1 else v


def forward_device(leaf_codes: np.ndarray, values, depth: int,
                   staged=None, device=None):
    """Full bottom-up RAHT.

    Returns (acs_per_level, root_dc): acs_per_level[l] is the level's
    (coeffs (B_l, 8, C) float32, ac_mask (B_l, 8) int32) — slots with
    ac_mask != 0 hold the level's AC coefficients — and root_dc the
    (1, C) root DC.  With ``staged`` the plan's device is used, else
    ``device`` (default: the current CUDA device; ``NoDeviceError``
    without one).
    """
    gathers = staged if staged is not None else stage_plan(
        leaf_codes, depth, resolve_device(device))
    if gathers:
        device = gathers[0].device
    vals = _as_values(values, device)
    w = torch.ones((vals.shape[0],), dtype=torch.float32, device=device)
    acs_out: List = []
    for g in gathers:
        occ = g >= 0
        gi = g.clamp(min=0)
        blk_v = torch.where(occ[..., None], vals[gi], 0.0)   # (B,8,C)
        blk_w = torch.where(occ, w[gi], 0.0)                 # (B,8)
        coeffs, wout, ac_mask = raht_blocks.fwd_blocks(blk_v, blk_w)
        acs_out.append((coeffs, ac_mask))
        # next level: the block DC collapses to slot 0
        vals = coeffs[:, 0, :]
        w = wout[:, 0]
    return acs_out, vals


def inverse_device(leaf_codes: np.ndarray, acs_per_level, root_vals,
                   depth: int, staged=None, device=None):
    """Top-down block un-butterflies.

    acs_per_level: forward_device's per-level (coeffs, ac_mask); slot 0
    of each block is overridden by the running reconstruction (closed
    loop decode passes dequantised ACs in the same layout).  Returns
    the (N, C) leaf values.  The device is chosen as in
    ``forward_device``.
    """
    gathers = staged if staged is not None else stage_plan(
        leaf_codes, depth, resolve_device(device))
    if gathers:
        device = gathers[0].device
    # upward weight pass (geometry-derived; elementwise)
    n = leaf_codes.shape[0]
    w = torch.ones((n,), dtype=torch.float32, device=device)
    blk_ws: List = []
    for g in gathers:
        blk_w = torch.where(g >= 0, w[g.clamp(min=0)], 0.0)
        blk_ws.append(blk_w)
        w = blk_w.sum(dim=1)
    vals = _as_values(root_vals, device)
    for l in range(len(gathers) - 1, -1, -1):
        blk = acs_per_level[l][0].clone()
        blk[:, 0, :] = vals
        child = raht_blocks.inv_blocks(blk, blk_ws[l])
        g = gathers[l]
        occ = g >= 0
        # level l holds the leaves (l == 0) or the blocks of level l-1;
        # known from the plan's shapes, so no device sync
        nl = n if l == 0 else gathers[l - 1].shape[0]
        flat = torch.zeros((nl, child.shape[-1]), dtype=torch.float32,
                           device=device)
        # scatter-add: empty slots add zero to row 0 instead of
        # clobbering a real row
        flat.index_add_(0, g.clamp(min=0).reshape(-1),
                        torch.where(occ[..., None], child, 0.0)
                        .reshape(-1, child.shape[-1]))
        vals = flat
    return vals
