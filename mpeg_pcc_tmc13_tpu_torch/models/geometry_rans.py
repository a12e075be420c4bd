"""rANS geometry engine: brick-payload wrapper over ``ops.octree_rans``,
counterpart of ``mpeg_pcc_tmc13_tpu/models/geometry_rans.py``.

The payload is a self-contained on-device bitstream: analysis, context
modelling and entropy coding run on the torch device (K-lane interleaved
rANS with tile-causal adaptive tables), and the host only moves the
compressed bytes.  Payloads are byte-identical to the reference engine
(at depth <= 20, where the reference is right).

Payload layout: [u8 lanes_log2][``encode_device`` payload].  Slice
shapes are padded to the next power-of-two node budget, as in the
reference (there it bounds the compiled shapes; here it keeps ``nmax``,
and so the decoder's buffers, equal to the reference's).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import octree_rans as R
from ..utils import morton
from ..utils.device import resolve as resolve_device


def _lanes_for(n: int) -> int:
    """Lane count: 1024 for big slices, fewer for small ones (the
    payload header carries 4 bytes per lane)."""
    if n >= (1 << 17):
        return 1024
    if n >= (1 << 13):
        return 256
    return 64


def _bucket(n: int) -> int:
    """Next power-of-two node budget >= n (>= 64)."""
    b = 64
    while b < n:
        b <<= 1
    return b


def encode(positions_local: np.ndarray, depth: int, device=None) -> bytes:
    """Encode integer slice-local positions into a rANS brick payload on
    ``device`` (None: the current CUDA device, raising when there is
    none).  Duplicate points collapse (unique-points bricks)."""
    device = resolve_device(device)
    codes = np.sort(morton.encode(positions_local.astype(np.int64)))
    uniq = codes[np.concatenate(
        [[True], codes[1:] != codes[:-1]])] if codes.size else codes
    n = int(uniq.size)
    if n == 0:
        return bytes([0])
    nmax = _bucket(n)
    lanes = min(_lanes_for(n), nmax)
    # pad with copies of the last code: duplicates collapse at every
    # level of the analysis, so the node structure is unchanged
    leaf = np.empty(nmax, dtype=np.int64)
    leaf[:n] = uniq
    leaf[n:] = uniq[-1]
    buf, _ = R.encode_device(torch.as_tensor(leaf, device=device), depth,
                             nmax, lanes)
    return bytes([lanes.bit_length() - 1]) + buf.cpu().numpy().tobytes()


def decode(payload: bytes, num_points: int, depth: int,
           device=None) -> np.ndarray:
    """Decode a rANS brick payload on ``device`` (None: as in
    ``encode``) back to slice-local positions (Morton order, unique
    points)."""
    device = resolve_device(device)
    u8 = np.frombuffer(payload, dtype=np.uint8)
    if num_points == 0 or u8.size <= 1:
        return np.zeros((0, 3), dtype=np.int64)
    lanes = 1 << int(u8[0])
    counts, states, words = R.parse_payload(u8[1:], depth, lanes)
    nmax = _bucket(num_points)
    wp = np.zeros(_bucket(max(64, words.shape[0])), np.int32)
    wp[:words.shape[0]] = words
    nodes, cnt = R.decode_device(
        counts, torch.as_tensor(states.astype(np.int64), device=device),
        torch.as_tensor(wp, device=device), depth, nmax, lanes)
    return morton.decode(nodes[:int(cnt)].cpu().numpy())
