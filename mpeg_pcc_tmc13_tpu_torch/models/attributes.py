"""Attribute coding front-end: counterpart of
``mpeg_pcc_tmc13_tpu/models/attributes.py``.

The context memories, the raw codec and the context-layout constants
are the reference's own (that module is jax-free at its top) and are
re-exported here.  ``encode``/``decode`` are copied: their Morton order
and codec dispatch reach the port's ``utils.morton``, ``attr_raht`` and
``attr_predlift`` instead of the reference's.
"""

from __future__ import annotations

import numpy as np

from mpeg_pcc_tmc13_tpu.bitstream.hls import (AttributeDescription,
                                              AttributeEncoding,
                                              AttributeParameterSet)
from mpeg_pcc_tmc13_tpu.models.attributes import (  # noqa: F401
    _RES_K, _RES_PREFIX_MAX, RES_CTX_SIZE, ZRUN_CTX_SIZE, AttributeContexts,
    decode_raw, encode_raw)


def _morton_perm(positions: np.ndarray):
    """Transform codecs operate in Morton order; geometry coding order
    is already Morton for the octree codec (perm = identity there) but
    not for the predictive-tree chain order."""
    from ..utils import morton
    return np.argsort(morton.encode(positions.astype(np.int64)),
                      kind="stable")


def encode(values: np.ndarray, positions: np.ndarray,
           aps: AttributeParameterSet, desc: AttributeDescription,
           ctx: AttributeContexts, ref=None, abh=None) -> bytes:
    """Encode one attribute of a slice; returns the brick body bytes.

    positions: coding-grid positions in geometry coding order (the
    transform codecs need them for LoD / RAHT tree construction).
    ref: optional (ref_positions, ref_values) for inter attribute
    prediction (slice-local compensated reference points).
    abh: the brick header carrying slice/per-layer QP deltas.
    """
    if aps.attr_encoding == AttributeEncoding.RAW:
        return encode_raw(values, desc)
    perm = _morton_perm(positions)
    values = np.asarray(values)[perm]
    positions = positions[perm]
    if aps.attr_encoding == AttributeEncoding.RAHT:
        from . import attr_raht
        return attr_raht.encode(values, positions, aps, desc, ctx,
                                ref=ref, abh=abh)
    if aps.attr_encoding in (AttributeEncoding.PRED, AttributeEncoding.LIFT):
        from . import attr_predlift
        return attr_predlift.encode(values, positions, aps, desc, ctx,
                                    ref=ref, abh=abh)
    raise ValueError(f"unsupported attr_encoding {aps.attr_encoding}")


def decode(data: bytes, positions: np.ndarray,
           aps: AttributeParameterSet, desc: AttributeDescription,
           ctx: AttributeContexts, ref=None,
           max_lod_levels: int = 0, abh=None) -> np.ndarray:
    count = positions.shape[0]
    if aps.attr_encoding == AttributeEncoding.RAW:
        return decode_raw(data, count, desc)
    perm = _morton_perm(positions)
    if aps.attr_encoding == AttributeEncoding.RAHT:
        from . import attr_raht
        vals = attr_raht.decode(data, positions[perm], aps, desc, ctx,
                                ref=ref, abh=abh)
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
