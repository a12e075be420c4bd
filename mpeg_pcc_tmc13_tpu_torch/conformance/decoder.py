"""The native engine behind the reference-syntax codec: the part of
``mpeg_pcc_tmc13_tpu/conformance/decoder.py`` this package uses.

``_load`` returns the package's own native library (built by
``bitstream.entropy`` from ``native/``) with the reference octree
decoder's entry point bound; ``geom_params_array`` packs a ``RefGps``
into the engine's parameter block.  Both serve the OBUF geometry engine
(``models.geometry_obuf``).  Decoding tmc3-syntax streams is not ported
yet.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..bitstream import entropy


def _load() -> ctypes.CDLL:
    lib = entropy._LIB
    if lib is None:
        raise RuntimeError("the native library of mpeg_pcc_tmc13_tpu_torch "
                           "did not build (see bitstream/entropy.py)")
    c = ctypes
    lib.tmc13ref_decode_octree_intra.argtypes = [
        c.POINTER(c.c_uint8), c.c_int,
        c.POINTER(c.c_int32), c.c_int,
        c.c_int,
        c.POINTER(c.c_int32),
        c.POINTER(c.c_int32), c.c_int,
    ]
    lib.tmc13ref_decode_octree_intra.restype = c.c_int
    return lib


def geom_params_array(gps, bypass_no_update=False,
                      cabac_bypass=False) -> "np.ndarray":
    """Pack the RefGps tool flags into the native GeomParams layout
    (native/obuf_core.h GeomParams)."""
    return np.array([
        gps.neighbour_avail_boundary_log2_minus1 + 1,
        1 if gps.adjacent_child_contextualization else 0,
        1 if gps.unique_points else 0,
        1 if gps.planar_enabled else 0,
        0 if gps.planar_buffer_disabled else 1,
        1 if gps.multiple_planar else 0,
        1 if gps.depth_planar_eligibility else 0,
        1 if gps.planar_dynamic_obuf_eligibility else 0,
        gps.planar_threshold0, gps.planar_threshold1,
        gps.planar_threshold2,
        1 if bypass_no_update else 0,
        gps.inferred_direct_coding_mode,
        1 if gps.joint_2pt_idcm else 0,
        gps.idcm_rate_minus1,
        1 if cabac_bypass else 0,
    ], dtype=np.int32)
