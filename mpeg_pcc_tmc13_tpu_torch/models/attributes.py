"""Attribute coding front-end: per-attribute dispatch to codec families.

Counterpart of the reference's `AttributeEncoder::encode`
(AttributeEncoder.cpp:465-634) / `AttributeDecoder::decode`
(AttributeDecoder.cpp:193-260) and `makeAttributeEncoder`
(AttributeEncoder.cpp:456).  Families (reference hls.h:132-138):
RAHT=0, Pred=1, Lift=2, Raw=3.

Attributes arrive already in geometry coding order (the permutation
returned by the geometry codec), as the reference codes attributes over
the decode-ordered cloud.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..bitstream import entropy
from ..bitstream.hls import (AttributeDescription, AttributeEncoding,
                             AttributeParameterSet)

# residual coder context layout (bitstream/entropy.py residuals op):
# ctx[0..1] zero-run flag by prev, ctx[2..2+prefix] ueg prefix
_RES_PREFIX_MAX = 3
_RES_K = 2
RES_CTX_SIZE = 2 + _RES_PREFIX_MAX + 8
# zero-run residual layout (entropy.py zrun_residuals): run prefix then
# magnitude prefix
ZRUN_CTX_SIZE = entropy.ZRUN_PREFIX + _RES_PREFIX_MAX + 8
# joint row coder (entropy.py zrow_residuals; native kZrowCtx)
ZROW_CTX_SIZE = 31


@dataclass
class AttributeContexts:
    """Entropy contexts for attribute residual coding (reference
    AttributeContexts, AttributeCommon.h:49-66)."""
    residuals: np.ndarray = field(
        default_factory=lambda: entropy.new_contexts(3 * RES_CTX_SIZE))
    # sparse zero-run streams (RAHT coefficients)
    zrun: np.ndarray = field(
        default_factory=lambda: entropy.new_contexts(3 * ZRUN_CTX_SIZE))
    # joint row streams (RAHT coefficient rows)
    zrow: np.ndarray = field(
        default_factory=lambda: entropy.new_contexts(ZROW_CTX_SIZE))
    # per-point prediction mode bits (reference predMode coding)
    pred_modes: np.ndarray = field(
        default_factory=lambda: entropy.new_contexts(2))

    def copy(self):
        return AttributeContexts(self.residuals.copy(),
                                 self.zrun.copy(),
                                 self.zrow.copy(),
                                 self.pred_modes.copy())


def encode_raw(values: np.ndarray, desc: AttributeDescription) -> bytes:
    """Fixed-width uncompressed attribute payload (reference
    attribute_raw.h:47-55).  Vectorised MSB-first bit packing."""
    flat = values.reshape(values.shape[0], -1).astype(np.int64).ravel()
    bd = desc.bitdepth
    if flat.size and (flat.min() < 0 or flat.max() >= (1 << bd)):
        raise ValueError(
            f"RAW attribute value out of range for bitdepth {bd}: "
            f"[{flat.min()}, {flat.max()}] (check attr_scale/attr_offset)")
    shifts = np.arange(bd - 1, -1, -1, dtype=np.int64)
    bits = ((flat[:, None] >> shifts[None, :]) & 1).astype(np.uint8)
    return np.packbits(bits.ravel()).tobytes()


def decode_raw(data: bytes, count: int,
               desc: AttributeDescription) -> np.ndarray:
    ncomp = desc.num_components
    bd = desc.bitdepth
    total = count * ncomp
    bits = np.unpackbits(np.frombuffer(data, dtype=np.uint8),
                         count=total * bd)
    weights = (np.int64(1) << np.arange(bd - 1, -1, -1)).astype(np.int64)
    vals = bits.reshape(total, bd).astype(np.int64) @ weights
    out = vals.reshape(count, ncomp)
    if ncomp == 1:
        return out[:, 0]
    return out


def _morton_perm(positions: np.ndarray):
    """Transform codecs operate in Morton order; geometry coding order
    is already Morton for the octree codec (perm = identity there) but
    not for the predictive-tree chain order."""
    from ..utils import morton
    return np.argsort(morton.encode(positions.astype(np.int64)),
                      kind="stable")


def encode(values: np.ndarray, positions: np.ndarray,
           aps: AttributeParameterSet, desc: AttributeDescription,
           ctx: AttributeContexts, ref=None, abh=None,
           device=None) -> bytes:
    """Encode one attribute of a slice; returns the brick body bytes.

    positions: coding-grid positions in geometry coding order (the
    transform codecs need them for LoD / RAHT tree construction).
    ref: optional (ref_positions, ref_values) for inter attribute
    prediction (slice-local compensated reference points).
    abh: the brick header carrying slice/per-layer QP deltas.
    device: the torch device a float predicted RAHT brick runs its
    transform on (models/attr_raht.py), the same bytes; None: the host.
    """
    if aps.attr_encoding == AttributeEncoding.RAW:
        return encode_raw(values, desc)
    perm = _morton_perm(positions)
    values = np.asarray(values)[perm]
    positions = positions[perm]
    if aps.attr_encoding == AttributeEncoding.RAHT:
        from . import attr_raht
        return attr_raht.encode(values, positions, aps, desc, ctx,
                                ref=ref, abh=abh, device=device)
    if aps.attr_encoding in (AttributeEncoding.PRED, AttributeEncoding.LIFT):
        from . import attr_predlift
        return attr_predlift.encode(values, positions, aps, desc, ctx,
                                    ref=ref, abh=abh)
    raise ValueError(f"unsupported attr_encoding {aps.attr_encoding}")


def decode(data: bytes, positions: np.ndarray,
           aps: AttributeParameterSet, desc: AttributeDescription,
           ctx: AttributeContexts, ref=None,
           max_lod_levels: int = 0, abh=None, device=None) -> np.ndarray:
    count = positions.shape[0]
    if aps.attr_encoding == AttributeEncoding.RAW:
        return decode_raw(data, count, desc)
    perm = _morton_perm(positions)
    if aps.attr_encoding == AttributeEncoding.RAHT:
        from . import attr_raht
        vals = attr_raht.decode(data, positions[perm], aps, desc, ctx,
                                ref=ref, abh=abh, device=device)
    elif aps.attr_encoding in (AttributeEncoding.PRED,
                               AttributeEncoding.LIFT):
        from . import attr_predlift
        vals = attr_predlift.decode(data, positions[perm], aps, desc,
                                    ctx, ref=ref,
                                    max_levels=max_lod_levels, abh=abh)
    else:
        raise ValueError(f"unsupported attr_encoding {aps.attr_encoding}")
    out = np.empty_like(np.asarray(vals))
    out[perm] = vals
    return out
