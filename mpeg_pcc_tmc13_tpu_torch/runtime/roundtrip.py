"""The device round trip, end to end: counterpart of the device lanes of
``bench.py:151-363`` (``device_numbers``).

``device_roundtrip`` runs the four stages of the slice on one device:

  1. geometry encode: sorted Morton codes -> level-major occupancy bytes
     on the device -> two-step fetch -> native host range coder,
  2. geometry decode: host entropy decode -> leaf codes rebuilt on the
     device,
  3. colour attributes, fixed-point RAHT (the CLI default,
     ``rahtFixedPoint=1``): ``DeviceFpRaht`` encode with host zrow
     coding, then decode on a decoder-side plan built from the DECODED
     leaf codes,
  4. the float RAHT lane: ``forward_device`` over the encoder's codes,
     ``inverse_device`` over the decoded codes, both through the
     hand-written block-butterfly kernels on a CUDA device.

Each stage's wall time is taken after ``torch.cuda.synchronize()`` and
a materialised device->host copy of its result.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np
import torch

from ..bitstream import entropy
from ..models.attr_raht import qp_to_step_q16
from ..models.attributes import AttributeContexts
from ..models.geometry_octree import OctreeContexts
from ..ops import _kernels, raht_device, raht_fp_device
from ..utils import morton
from ..utils.device import resolve as resolve_device
from . import device_pipeline as dp


def make_surface_cloud(n: int, depth: int, seed: int = 0) -> np.ndarray:
    """Height-field surface, dense-ish occupancy like CTC solid clouds
    (the cloud ``bench.py`` codes)."""
    rng = np.random.default_rng(seed)
    size = 1 << depth
    side = int(np.sqrt(n)) + 1
    xs = rng.integers(0, size, side * side)
    ys = rng.integers(0, size, side * side)
    fx = rng.uniform(0.5, 3.0, 4)
    fy = rng.uniform(0.5, 3.0, 4)
    ph = rng.uniform(0, 2 * np.pi, 4)
    am = rng.uniform(0.05, 0.25, 4)
    z = np.zeros(side * side)
    for i in range(4):
        z += am[i] * np.sin(2 * np.pi * fx[i] * xs / size
                            + 2 * np.pi * fy[i] * ys / size + ph[i])
    zs = ((z - z.min()) / (z.max() - z.min() + 1e-9) * (size - 1)).astype(
        np.int64)
    pos = np.stack([xs, ys, zs], axis=1)[:n]
    return pos.astype(np.int64)


def _colors_for(uniq_codes: np.ndarray, depth: int) -> np.ndarray:
    """Smooth 8-bit RGB over the cloud plus noise (``bench.py``'s)."""
    rng = np.random.default_rng(1)
    p = morton.decode(uniq_codes) / float(1 << depth)
    colors = np.stack([
        128 + 90 * np.sin(3.1 * p[:, 0] + 1.7 * p[:, 1]),
        128 + 90 * np.cos(2.3 * p[:, 1] + 0.9 * p[:, 2]),
        128 + 90 * np.sin(1.3 * p[:, 2] + 2.9 * p[:, 0]),
    ], axis=1)
    return np.clip(colors + rng.normal(0, 4, colors.shape), 0,
                   255).astype(np.int64)


def sorted_unique_codes(pos: np.ndarray) -> np.ndarray:
    """Positions (N, 3) -> sorted unique Morton codes (the leaf set)."""
    return np.unique(morton.encode(pos))


@dataclass
class RoundTrip:
    """What ``device_roundtrip`` hands back; arrays are host numpy."""
    geom_payload: bytes
    decoded_codes: np.ndarray
    attr_payload: bytes
    q_rows: List[np.ndarray]
    decoded_colors: np.ndarray
    # float lane: per level (coeffs (B,8,C), ac_mask (B,8)), root DC
    # (1, C), and the inverse's (N, C) reconstruction
    raht_acs: List[tuple]
    raht_root: np.ndarray
    raht_recon: np.ndarray
    stage_s: Dict[str, float] = field(default_factory=dict)
    # the float lane's block kernels' launches
    launches: Dict[str, int] = field(default_factory=dict)
    geom_stats: dp.PipelineStats = None


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_roundtrip(uniq: np.ndarray, depth: int, colors: np.ndarray,
                     qp: int = 22, device=None) -> RoundTrip:
    """Run the slice's four stages on ``device`` (default: the current
    CUDA device; ``NoDeviceError`` without one).

    uniq: (N,) sorted unique leaf Morton codes; colors: (N, C) integer
    attributes in the same order.  A CPU device runs every stage with
    the kernels' plain versions; a CUDA device launches the kernels.
    """
    device = resolve_device(device)
    n = uniq.size
    ncomp = colors.shape[1]
    times: Dict[str, float] = {}
    before = dict(_kernels.LAUNCHES)

    def clock(name, t0):
        _sync(device)
        times[name] = time.perf_counter() - t0

    # 1. geometry encode (codes resident on the device beforehand, as the
    #    production pipeline keeps them)
    codes_dev = torch.as_tensor(uniq, device=device)
    _sync(device)
    enc = entropy.RangeEncoder()
    gstats = dp.PipelineStats()
    t0 = time.perf_counter()
    dp.encode_pipelined(uniq, depth, enc, OctreeContexts(), num_slices=1,
                        device_codes=[codes_dev], stats=gstats)
    geom_payload = enc.get_bytes()
    clock("geom_encode", t0)

    # 2. geometry decode: leaves land on the device; one D2H of them
    #    feeds the decoder-side attribute plans
    t0 = time.perf_counter()
    dec = entropy.RangeDecoder(geom_payload)
    (nodes, cnt), = dp.decode_pipelined(dec, OctreeContexts(), depth, 1, n,
                                        device=device)
    decoded = nodes[:int(cnt)].cpu().numpy()
    clock("geom_decode", t0)

    # 3. fixed-point RAHT colour, encoder side on the encoder's codes
    steps = [qp_to_step_q16(qp)] * ncomp
    t0 = time.perf_counter()
    fp_enc = raht_fp_device.DeviceFpRaht(uniq, depth, steps, device=device)
    clock("attr_plan_encoder", t0)
    q_rows: List[np.ndarray] = []
    aenc = entropy.RangeEncoder()
    actx = AttributeContexts()

    def emit(q):
        q_rows.append(q)
        aenc.zrow_residuals(actx.zrow, q.astype(np.int32))
    t0 = time.perf_counter()
    fp_enc.encode(colors, emit)
    attr_payload = aenc.get_bytes()
    clock("attr_encode", t0)

    #    decoder side: its own plan from the decoded codes
    t0 = time.perf_counter()
    fp_dec = raht_fp_device.DeviceFpRaht(decoded, depth, steps,
                                         device=device)
    clock("attr_plan_decoder", t0)
    t0 = time.perf_counter()
    adec = entropy.RangeDecoder(attr_payload)
    dctx = AttributeContexts()
    dec_vals = fp_dec.decode(
        lambda m: adec.zrow_residuals(dctx.zrow, m, ncomp), ncomp)
    decoded_colors = dec_vals.cpu().numpy()
    clock("attr_decode", t0)

    # 4. float RAHT lane: forward over the encoder's codes, inverse over
    #    the decoded codes' own plan
    t0 = time.perf_counter()
    staged_enc = raht_device.stage_plan(uniq, depth, device)
    staged_dec = raht_device.stage_plan(decoded, depth, device)
    vals_dev = torch.as_tensor(colors, dtype=torch.float32, device=device)
    clock("raht_plan", t0)
    t0 = time.perf_counter()
    acs, root = raht_device.forward_device(uniq, vals_dev, depth,
                                           staged=staged_enc)
    root_host = root.cpu().numpy()
    clock("raht_forward", t0)
    t0 = time.perf_counter()
    recon = raht_device.inverse_device(decoded, acs, root, depth,
                                       staged=staged_dec)
    recon_host = recon.cpu().numpy()
    clock("raht_inverse", t0)

    launches = {k: _kernels.LAUNCHES[k] - before[k]
                for k in ("fwd_blocks", "inv_blocks")}
    return RoundTrip(
        geom_payload=geom_payload, decoded_codes=decoded,
        attr_payload=attr_payload, q_rows=q_rows,
        decoded_colors=decoded_colors,
        raht_acs=[(c.cpu().numpy(), m.cpu().numpy()) for c, m in acs],
        raht_root=root_host, raht_recon=recon_host,
        stage_s=times, launches=launches, geom_stats=gstats)


def parseval_rel_err(values: np.ndarray, acs, root) -> float:
    """|energy(coefficients) - energy(values)| / energy(values) in
    float64; RAHT is orthonormal, so this is rounding error only."""
    energy = float(np.sum(np.asarray(root, np.float64) ** 2))
    for coeffs, mask in acs:
        sel = np.asarray(mask) > 0
        energy += float(np.sum(np.asarray(coeffs, np.float64)[sel] ** 2))
    ref = float(np.sum(np.asarray(values, np.float64) ** 2))
    return abs(energy - ref) / max(ref, 1.0)
