"""3-D Morton (Z-order) codes: counterpart of
``mpeg_pcc_tmc13_tpu/utils/morton.py:26-102``.

Interleaving matches the reference: x in the highest bit of each triple,
so a node's child index is ``(x<<2)|(y<<1)|z``.  Codes are int64 (21 bits
per axis, 63-bit codes).

numpy arrays go through the native ``morton_encode64``/``morton_decode64``
of the port's native library when it is loaded, as the reference does;
torch tensors (on any device) use the bit-spreading below, which is the
same arithmetic on int64 tensors.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

def _part1by2_64(v):
    """Spread the low 21 bits of v so two zero bits sit between each.

    Works on int64 numpy arrays and int64 torch tensors alike."""
    x = v & 0x1FFFFF
    x = (x | (x << 32)) & 0x1F00000000FFFF
    x = (x | (x << 16)) & 0x1F0000FF0000FF
    x = (x | (x << 8)) & 0x100F00F00F00F00F
    x = (x | (x << 4)) & 0x10C30C30C30C30C3
    x = (x | (x << 2)) & 0x1249249249249249
    return x


def _compact1by2_64(x):
    """Inverse of _part1by2_64: gather every third bit."""
    x = x & 0x1249249249249249
    x = (x ^ (x >> 2)) & 0x10C30C30C30C30C3
    x = (x ^ (x >> 4)) & 0x100F00F00F00F00F
    x = (x ^ (x >> 8)) & 0x1F0000FF0000FF
    x = (x ^ (x >> 16)) & 0x1F00000000FFFF
    x = (x ^ (x >> 32)) & 0x1FFFFF
    return x


def _native_lib():
    from ..bitstream import entropy
    return entropy._LIB


def encode(pos):
    """positions (..., 3) int -> Morton codes (...,) int64.

    A torch tensor stays on its device; a numpy array returns numpy."""
    if isinstance(pos, torch.Tensor):
        p = pos.to(torch.int64)
    else:
        pos = np.asarray(pos)
        lib = _native_lib()
        if lib is not None and pos.ndim == 2 and pos.shape[1] == 3:
            p = np.ascontiguousarray(pos, dtype=np.int64)
            out = np.empty(p.shape[0], dtype=np.int64)
            i64p = ctypes.POINTER(ctypes.c_int64)
            lib.morton_encode64(p.ctypes.data_as(i64p), p.shape[0],
                                out.ctypes.data_as(i64p))
            return out
        p = pos.astype(np.int64)
    return ((_part1by2_64(p[..., 0]) << 2)
            | (_part1by2_64(p[..., 1]) << 1)
            | _part1by2_64(p[..., 2]))


def decode(code):
    """Morton codes (...,) int64 -> positions (..., 3) int64."""
    if isinstance(code, torch.Tensor):
        c = code.to(torch.int64)
        return torch.stack([_compact1by2_64(c >> 2),
                            _compact1by2_64(c >> 1),
                            _compact1by2_64(c)], dim=-1)
    code = np.asarray(code)
    lib = _native_lib()
    if lib is not None and code.ndim == 1:
        cc = np.ascontiguousarray(code, dtype=np.int64)
        out = np.empty((cc.shape[0], 3), dtype=np.int64)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.morton_decode64(cc.ctypes.data_as(i64p), cc.shape[0],
                            out.ctypes.data_as(i64p))
        return out
    c = code.astype(np.int64)
    return np.stack([_compact1by2_64(c >> 2), _compact1by2_64(c >> 1),
                     _compact1by2_64(c)], axis=-1)
